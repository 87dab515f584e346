"""The plain reference: PyTorch and numpy in float32, importing nothing of the program."""

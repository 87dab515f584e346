"""``train_checkpoint_ms``: the union of the program's ``train.checkpoint``
spans (``checkpoint.save_state`` and ``save_validated``, which holds a
``save_state``) in the traced window ÷ its ``train_step`` spans, in ms."""

from portbench.spans import train_ms_per_step


def read(rec):
    return train_ms_per_step(rec, "train.checkpoint")

"""Decoding of the port: likelihood emission, CTC text decoding, attention
rescoring and the test-set streams."""

from tfkaldi_tpu_torch.decode.decoder import Decoder

__all__ = ["Decoder"]

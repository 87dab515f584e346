"""``decode_compute_ms``: the mean of the program's ``decode.compute`` spans
(``Decoder.compute_batch``: the copy of the padded features in and the
forward's launches) in the traced window, in ms a batch."""

from portbench.spans import decode_mean_ms


def read(rec):
    return decode_mean_ms(rec, "decode.compute")

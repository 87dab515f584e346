"""``decode_fetch_ms``: the mean of the program's ``decode.fetch`` spans (the
wait for the device and the copy of the batch's likelihoods to the host)
in the traced window, in ms a batch."""

from portbench.spans import decode_mean_ms


def read(rec):
    return decode_mean_ms(rec, "decode.fetch")

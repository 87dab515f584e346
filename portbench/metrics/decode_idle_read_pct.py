"""``decode_idle_read_pct``: the share of the traced window with no device
operation while the host was inside the program's ``decode.read`` span
(the feature reader: arks, CMVN, splicing, padding), in %."""

from portbench.spans import decode_idle_pct


def read(rec):
    return decode_idle_pct(rec, "decode.read")

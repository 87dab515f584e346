"""``decode_idle_write_pct``: the share of the traced window with no device
operation while the host was inside the program's ``decode.write`` span
(the batch's ark records), in %."""

from portbench.spans import decode_idle_pct


def read(rec):
    return decode_idle_pct(rec, "decode.write")

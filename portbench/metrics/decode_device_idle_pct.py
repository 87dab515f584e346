"""``decode_device_idle_pct``: the share of the traced window, from the first
decode batch to the last, with no operation on the device, in %."""

from portbench.metrics import idle_pct


def read(rec):
    return idle_pct(rec) if rec.batches else None

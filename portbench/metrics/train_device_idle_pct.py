"""``train_device_idle_pct``: the share of the traced window, from the first
``train_step`` span to the last, with no operation on the device (rank
0's on a grid), in %."""

from portbench.metrics import idle_pct


def read(rec):
    return idle_pct(rec) if rec.steps else None

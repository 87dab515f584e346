"""``train_mfu``: the model operations of the window's real frames (three
times the forward's products; no padding, no recompute) ÷ the window's
seconds ÷ the chips' peak of the configuration's compute type, in %."""

from portbench import roofline
from portbench.metrics import forward_flops


def read(rec):
    if not rec.steps or rec.window_s <= 0:
        return None
    flops = 3.0 * forward_flops(rec) * rec.frames
    return 100.0 * flops / rec.window_s / (rec.chips * roofline.PEAK_FLOPS[rec.compute_dtype])

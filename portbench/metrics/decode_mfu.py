"""``decode_mfu``: the forward's operations of the real frames decoded in the
window ÷ its seconds ÷ the peak of the configuration's compute type, in %."""

from portbench import roofline
from portbench.metrics import forward_flops


def read(rec):
    if not rec.batches or rec.window_s <= 0:
        return None
    return 100.0 * forward_flops(rec) * rec.frames / rec.window_s / roofline.PEAK_FLOPS[rec.compute_dtype]

"""``rnnt_train_mfu``: three times the forward operations of the window's
real frames (:mod:`portbench.conformer_flops`: each utterance at its own
``T'`` and ``U``; no padding, no recompute) ÷ the window's seconds ÷ the
chips' bfloat16 peak, in %. A traced run traces its steps ahead of the
window, so the window is untraced here too."""

from portbench import conformer_flops, roofline


def read(rec):
    if not rec.steps or rec.window_s <= 0 or "utterances" not in rec.steps[0]:
        return None
    w = conformer_flops.Widths.from_config(rec.config)
    flops = 3.0 * sum(conformer_flops.forward_flops(w, t, u) for s in rec.steps for t, u in s["utterances"])
    return 100.0 * flops / rec.window_s / (rec.chips * roofline.PEAK_FLOPS["bfloat16"])

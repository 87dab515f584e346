"""``train_frames_per_s``: real frames of the optimizer steps completed in
the window, summed over the ranks, ÷ the window's seconds (host clock)."""


def read(rec):
    if not rec.steps or rec.window_s <= 0:
        return None
    return rec.frames / rec.window_s

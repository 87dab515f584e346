"""``decode_frames_per_s``: real frames whose log pseudo-likelihoods were
computed, copied to the host and serialised in the window ÷ its seconds
(host clock)."""


def read(rec):
    if not rec.batches or rec.window_s <= 0:
        return None
    return rec.frames / rec.window_s

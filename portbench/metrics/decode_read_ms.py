"""``decode_read_ms``: the feature reader's time a batch (reading the arks,
CMVN, splicing, padding), by the host clock from one batch's last write
to the next ``compute_batch`` call; the window's sum ÷ its batches, in
ms."""


def read(rec):
    if not rec.batches or "read_s" not in rec.window:
        return None
    return 1e3 * rec.window["read_s"] / len(rec.batches)

"""``decode_serialise_ms``: the serialiser's time a batch, by the host
clock inside the writer (each matrix written as a Kaldi ark record by the
program's ``write_ark_matrix``); the window's sum ÷ its batches, in ms."""


def read(rec):
    if not rec.batches or "serialise_s" not in rec.window:
        return None
    return 1e3 * rec.window["serialise_s"] / len(rec.batches)

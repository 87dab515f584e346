"""``setup_s``: process start until the window opens (host clock)."""


def read(rec):
    return rec.setup_s

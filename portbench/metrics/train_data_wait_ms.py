"""``train_data_wait_ms``: the host clock around each ``source.next()`` the
controller calls in the window (the prefetched batch, or the wait for it),
mean a step, in ms."""


def read(rec):
    if not rec.data_waits_s:
        return None
    return 1e3 * sum(rec.data_waits_s) / len(rec.data_waits_s)

"""``decode_device_ms``: the time a batch that the host waits on the device,
by the host clock from the ``compute_batch`` call (the copy in, the eval
forward, softmax ÷ prior → floor → log) to its likelihoods on the host
(the pageable copy out); the window's sum ÷ its batches, in ms."""


def read(rec):
    if not rec.batches or "device_s" not in rec.window:
        return None
    return 1e3 * rec.window["device_s"] / len(rec.batches)

"""``rnnt_encode_ms``: device time a step of the encoder
(``Transducer.encode``: the front end and the blocks), the forward's
launches under the program's ``rnnt.encode`` span and their backward
(:mod:`portbench.regions`), in the traced steps, in ms."""


def region_ms(rec, name: str):
    """The device seconds of region ``name`` in the traced window ÷ its
    ``train_step`` spans, in ms; None where the program has no such span."""
    got = rec.window.get("device_s") if rec.trace is not None else None
    steps = rec.trace.spans.get("train_step", []) if rec.trace is not None else []
    if not got or name not in got or not steps:
        return None
    return 1e3 * got[name] / len(steps)


def read(rec):
    return region_ms(rec, "rnnt.encode")

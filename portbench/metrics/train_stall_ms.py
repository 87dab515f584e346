"""``train_stall_ms``: the traced window's time outside the program's
``train_step`` spans (validation, rollback, checkpoints, logging, the
benchmark's hook), ÷ the steps, in ms."""


def read(rec):
    if rec.trace is None:
        return None
    spans = rec.trace.spans.get("train_step", [])
    if len(spans) < 2:
        return None
    lo, hi = spans[0][0], max(e for _, e in spans)
    inside = sum(e - s for s, e in spans)
    return (hi - lo - inside) * 1e-3 / len(spans)

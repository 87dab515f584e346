"""The program's own spans in the traced window, for the readers of
``portbench/metrics`` whose source is ``program_span``.

A name's spans may nest (a validated checkpoint save holds its state's
save), so a reader sums the union of their intervals, clipped to the
window. A name the trace never holds (a program without the span) reads
``None``; a name it holds with nothing in the window reads 0.
"""

from __future__ import annotations


def union(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals of ``spans`` clipped to ``[lo, hi]`` and merged, in order."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_us(a, b) -> float:
    """Time that two ordered lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def train_ms_per_step(rec, name: str) -> float | None:
    """Σ the union of ``name`` from the first ``train_step``'s start to the
    last one's end, ÷ the ``train_step`` spans, in ms."""
    if rec.trace is None or name not in rec.trace.spans:
        return None
    steps = rec.trace.spans.get("train_step", [])
    if not steps:
        return None
    lo, hi = steps[0][0], max(e for _, e in steps)
    return sum(e - s for s, e in union(rec.trace.spans[name], lo, hi)) * 1e-3 / len(steps)


def decode_mean_ms(rec, name: str) -> float | None:
    """Mean length of the ``name`` spans in the traced window, each clipped
    to it, in ms."""
    if rec.trace is None or rec.trace_extent is None or name not in rec.trace.spans:
        return None
    lo, hi = rec.trace_extent
    clipped = [min(e, hi) - max(s, lo) for s, e in rec.trace.spans[name] if min(e, hi) > max(s, lo)]
    return sum(clipped) * 1e-3 / len(clipped) if clipped else None


def decode_idle_pct(rec, name: str) -> float | None:
    """The share of the traced window in which no device operation ran and
    the host was inside a ``name`` span, in %."""
    if rec.trace is None or rec.trace_extent is None or name not in rec.trace.spans:
        return None
    lo, hi = rec.trace_extent
    if hi <= lo:
        return None
    inside = overlap_us(rec.trace.gaps(lo, hi), union(rec.trace.spans[name], lo, hi))
    return 100.0 * inside / (hi - lo)

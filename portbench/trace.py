"""The traced run: torch.profiler over the measured window, and the one
parser that every per-layer reader of the trace goes through.

The profiler records the host's operations and annotations and the
device's kernels, copies and sets. :class:`Trace` keeps, from the
exported Chrome trace, the device operations (with the host time of the
call that launched each, by its correlation id), the annotations by name
(the program's ``train_step`` spans and the benchmark's own), and the
host operations of the annotating thread, which name what the host was
doing while the device sat idle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_MARK = "portbench.window_open"


def mark_window() -> None:
    """An empty annotation at the window's opening (see :class:`Trace`)."""
    import torch

    with torch.profiler.record_function(WINDOW_MARK):
        pass


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float  # us, the trace's clock
    end: float
    launch: float | None  # host time of its launch call


class Profile:
    """torch.profiler around the window, started by the driver ahead of it
    (the profiler's own start-up takes seconds) and stopped after it;
    :meth:`stop` exports the trace to ``outdir`` and parses it."""

    def __init__(self, outdir: str, device_type: str):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device_type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.outdir = outdir
        self._prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self) -> "Trace":
        self._prof.__exit__(None, None, None)
        os.makedirs(self.outdir, exist_ok=True)
        path = os.path.join(self.outdir, "trace.json")
        self._prof.export_chrome_trace(path)
        try:
            return Trace.load(path)
        finally:
            os.remove(path)


class Trace:
    def __init__(self, events: list[dict]):
        launches = {}
        ops = []
        self.spans: dict[str, list[tuple[float, float]]] = collections.defaultdict(list)
        span_tid = collections.Counter()
        host = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                ops.append((e, ts, ts + dur))
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = ts
            elif cat == "user_annotation":
                self.spans[e["name"]].append((ts, ts + dur))
                span_tid[e.get("tid")] += 1
                host.append((ts, ts + dur, e["name"], e.get("tid")))
            elif cat == "cpu_op":
                host.append((ts, ts + dur, e["name"], e.get("tid")))
        self.device_ops = sorted(
            (DeviceOp(e["name"], s, t, launches.get((e.get("args") or {}).get("correlation"))) for e, s, t in ops),
            key=lambda o: o.start)
        for v in self.spans.values():
            v.sort()
        # the profiler starts ahead of the window; the window's mark drops
        # the spans that started before it
        opened = self.spans.pop(WINDOW_MARK, None)
        if opened:
            lo = opened[0][0]
            for name in list(self.spans):
                self.spans[name] = [s for s in self.spans[name] if s[0] >= lo]
        tid = span_tid.most_common(1)[0][0] if span_tid else None
        self._host = sorted((h for h in host if h[3] == tid), key=lambda h: h[0])
        self._host_starts = [h[0] for h in self._host]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # ------------------------------------------------------------------

    def extent(self, span: str) -> tuple[float, float] | None:
        """From the first ``span``'s start to the last one's end."""
        s = self.spans.get(span)
        return (s[0][0], max(e for _, e in s)) if s else None

    def busy_us(self, lo: float, hi: float) -> float:
        """Time in ``[lo, hi]`` in which some device operation ran."""
        busy, cur_s, cur_e = 0.0, None, None
        for op in self.device_ops:
            s, e = max(op.start, lo), min(op.end, hi)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def gaps(self, lo: float, hi: float) -> list[tuple[float, float]]:
        out, at = [], lo
        for op in self.device_ops:
            if op.end <= at:
                continue
            if op.start >= hi:
                break
            if op.start > at:
                out.append((at, op.start))
            at = max(at, op.end)
        if at < hi:
            out.append((at, hi))
        return out

    def ops_by_span(self, span: str, match) -> list[list[DeviceOp]]:
        """The device operations whose name ``match`` accepts, grouped by
        the ``span`` whose interval holds their launch call (one list a
        span, in order)."""
        spans = self.spans.get(span, [])
        starts = [s for s, _ in spans]
        out: list[list[DeviceOp]] = [[] for _ in spans]
        for op in self.device_ops:
            if op.launch is None or not match(op.name):
                continue
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= spans[i][1]:
                out[i].append(op)
        return out

    def host_activity(self, t: float) -> str:
        """The innermost host operation of the annotating thread at ``t``."""
        i = bisect.bisect_right(self._host_starts, t) - 1
        for j in range(i, max(i - 4000, -1), -1):
            s, e, name, _ = self._host[j]
            if e >= t:
                return name
        return "(host outside any operation)"

    def breakdown(self, lo: float, hi: float, top: int = 10) -> dict:
        """The device operations that took most time in ``[lo, hi]``, and
        the idle time by what the host was doing, in seconds."""
        by_op = collections.Counter()
        for op in self.device_ops:
            d = min(op.end, hi) - max(op.start, lo)
            if d > 0:
                by_op[op.name[:160]] += d * 1e-6
        by_host = collections.Counter()
        for s, e in self.gaps(lo, hi):
            by_host[self.host_activity((s + e) / 2)[:160]] += (e - s) * 1e-6
        return {"device_ops": [[n, v] for n, v in by_op.most_common(top)],
                "idle_gaps": [[n, v] for n, v in by_host.most_common(top)]}

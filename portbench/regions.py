"""Device time of the program's transducer spans, their backward included.

The forward's launches run inside the program's ``rnnt.*`` spans on the
thread that calls the model. The backward runs outside them (on a card, on
autograd's own thread), one ``autograd::engine::evaluate_function`` event
a node, and each such event carries the ``Sequence number`` of the forward
operation that made the node and the ``Fwd thread id`` of the thread it ran
on. A backward launch therefore belongs to the span that held the forward
operation of the same sequence number on the same forward thread. The
checkpoint's recompute runs inside the joint's span on autograd's thread
and is attributed, with its own backward, the same way.

``Fwd thread id`` is the profiler's own count of threads, not the trace's
``tid``: :class:`Regions` maps each to the trace thread whose forward
sequence numbers its backward events name most often.
"""

from __future__ import annotations

import bisect
import collections
import json

from portbench.trace import DEVICE_CATS, LAUNCH_CATS, Profile

NAMES = ("rnnt.encode", "rnnt.predict", "rnnt.joint", "rnnt.lattice")
BACKWARD = "autograd::engine::evaluate_function"


class _Intervals:
    """Named intervals on one thread; :meth:`at` gives the innermost one
    holding a time."""

    def __init__(self, items):
        self.items = sorted(items)  # (start, end, name)
        self.starts = [s for s, _, _ in self.items]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        best = None
        for j in range(i, max(i - 64, -1), -1):
            s, e, name = self.items[j]
            if s <= t <= e and (best is None or s >= best[0]):
                best = (s, e, name)
        return best[2] if best else None


class Regions:
    """From a Chrome trace's events: each device operation's region (one of
    ``NAMES``, or None), by where its launch call ran."""

    def __init__(self, events: list[dict], names=NAMES):
        spans = collections.defaultdict(list)  # tid -> (start, end, name)
        forward = []  # (tid, ts, seq)
        backward = []  # (tid, ts, end, fwd_thread, seq)
        launches = {}
        ops = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            ts, end = float(e.get("ts", 0.0)), float(e.get("ts", 0.0)) + float(e.get("dur", 0.0))
            if cat == "user_annotation" and e.get("name") in names:
                spans[e.get("tid")].append((ts, end, e["name"]))
            elif cat == "cpu_op" and "Sequence number" in args:
                if e["name"].startswith(BACKWARD):
                    backward.append((e.get("tid"), ts, end, args.get("Fwd thread id"), args["Sequence number"]))
                elif not args.get("Fwd thread id"):
                    forward.append((e.get("tid"), ts, args["Sequence number"]))
            elif cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (e.get("tid"), ts)
            elif cat in DEVICE_CATS:
                ops.append((ts, end, args.get("correlation")))
        fwd_spans = {tid: _Intervals(v) for tid, v in spans.items()}
        seq_region = {}
        for tid, ts, seq in forward:
            name = fwd_spans[tid].at(ts) if tid in fwd_spans else None
            if name is not None:
                seq_region[(tid, seq)] = name
        # the profiler's forward-thread count -> the trace's tid, by vote
        votes = collections.Counter()
        fwd_seqs = collections.defaultdict(set)
        for tid, _, seq in forward:
            fwd_seqs[tid].add(seq)
        for _, _, _, fwd_thread, seq in backward:
            for tid, seqs in fwd_seqs.items():
                if seq in seqs:
                    votes[(fwd_thread, tid)] += 1
        thread_of = {}
        for (fwd_thread, tid), n in votes.most_common():
            thread_of.setdefault(fwd_thread, tid)
        bwd = collections.defaultdict(list)
        for tid, ts, end, fwd_thread, seq in backward:
            name = seq_region.get((thread_of.get(fwd_thread), seq))
            if name is not None:
                bwd[tid].append((ts, end, name))
        bwd_spans = {tid: _Intervals(v) for tid, v in bwd.items()}
        self.ops = []  # (start, end, region or None)
        for ts, end, corr in ops:
            region = None
            launch = launches.get(corr)
            if launch is not None:
                tid, t = launch
                region = fwd_spans[tid].at(t) if tid in fwd_spans else None
                if region is None and tid in bwd_spans:
                    region = bwd_spans[tid].at(t)
            self.ops.append((ts, end, region))

    def device_s(self, lo: float, hi: float) -> dict:
        """Device seconds in ``[lo, hi]`` by region (``None``: the rest)."""
        out = collections.Counter()
        for s, e, region in self.ops:
            d = min(e, hi) - max(s, lo)
            if d > 0:
                out[region] += d * 1e-6
        return dict(out)


class RegionProfile(Profile):
    """:class:`portbench.trace.Profile` that also keeps :class:`Regions` of
    the trace it exports (``self.regions``)."""

    regions: Regions | None = None

    def __init__(self, outdir: str, device_type: str):
        super().__init__(outdir, device_type)
        export = self._prof.export_chrome_trace

        def export_and_keep(path: str) -> None:
            export(path)
            with open(path) as f:
                data = json.load(f)
            self.regions = Regions(data["traceEvents"] if isinstance(data, dict) else data)

        self._prof.export_chrome_trace = export_and_keep

"""Kernel 1 (the fused FFN block, ``ops/csrc/fused_ffn.cu``) on one GPU
below one wave of tiles: the streamed DNN's rows and the hybrid gate's
narrow layers, by route, tile and split count; and the streamed DNN's
chunk times.

    python3 -m tfkaldi_tpu_torch.profile_ffn [--sweep] [--out result.json]
    python3 -m tfkaldi_tpu_torch.profile_ffn --stream
    python3 -m tfkaldi_tpu_torch.profile_ffn --calibrate result.json

At every shape of :data:`SHAPES` (``[n, k] @ [k, m]``, f32 and bf16) it
checks the planned route against the plain version (within
:data:`FFN_TOL`) and, on the split route, that two calls are bit-equal,
then prints and returns:

- ``device_ms``: the device time of everything one call puts on the card
  (the GEMM and, on the split route, the reduction) under
  ``torch.profiler`` over :data:`CALLS` calls, divided by the calls
  (:func:`device_ms`);
- ``events_ms``: CUDA events around :data:`CALLS` calls of the wrapper,
  the median of 3 windows (:func:`events_ms`); where the host enqueues
  slower than the card runs, that is the host's time;
- ``host_us``: the wrapper's host time a call, the median of 3 windows of
  :data:`CALLS` calls on the host clock, synchronised only after each
  window (:func:`host_us`), and ``host_parts_us``, the same taken apart
  (:func:`host_parts_us`; ``entry`` less ``entry_tma`` is what a split's
  second launch costs the host);
- ``plain_ms`` (the plain version), ``library_ms`` (``torch.matmul`` of
  x and w alone) and ``bound_ms`` (:func:`ffn_bound`);
- the plan (route, tile, grid, splits, slabs).

``--sweep`` adds the device time of every tile (128 rows and the 64-row
half tile) and split count at each shape (1 is the TMA route), the
readings ``ops/gemm_plan.tile_and_split``'s model is held to;
``--calibrate FILE`` reads such a result back (no card needed) and prints,
at each shape, the model's pick and a plain rule's beside the fastest
measured, with the measured cost of each (:func:`calibrate`). ``--stream``
times the streamed DNN (440 -> 6 x 2048 relu+BN -> 2000, seeded weights)
through ``OnlineSplicedDecoder`` at 40, 160 and 640 ms chunks in f32 and
bf16 (:func:`stream_times`); run it from another checkout's root with
``runpy`` to time that checkout's package the same way. Prints the card as
``nvidia-smi`` names it and the result as one JSON object on the last line
(also written to ``--out``). Needs one CUDA device and ``nvcc``.

This module holds the card's one set of timers, peaks and bound: the
device timer :func:`device_ms` (torch.profiler's self device time, of
every kernel or of those a name picks), the events timer
:func:`events_ms` (the median of windows of calls) and the host timer
:func:`host_us`; ``PEAK_*`` and :func:`bound`; and the kernel table's
rows (``*_ROWS``) with their :func:`work`. chip_smoke.py, profile_frame.py,
profile_rnn.py and the card tests (``-m cuda``) take them from here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import time

import torch

# [n, k, m]: the streamed DNN's rows (B x T_pad, T padded to 8) at layer 0
# and layers 1-5, and the hybrid gate's two layers
SHAPES = tuple((n, k, 2048) for k in (440, 2048) for n in (8, 16, 64, 72, 600)) + ((2048, 48, 64), (2048, 64, 64))
# kernel 1 against its plain version (tests/test_torch_cuda_kernels.py says why)
FFN_TOL = {"float32": 1e-4, "bfloat16": 0.0625}
CALLS = 20
# H100 SXM peaks (NVIDIA data sheet): f32 and f64 outside the tensor cores, HBM
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_BF16 = 989e12  # dense, tensor cores
PEAK_BYTES = 3.35e12
STREAM_CHUNKS = (4, 16, 64)  # frames a feature chunk: 40, 160 and 640 ms at the 10 ms step
STREAM_AUDIO_S = 10.0  # audio a timed sweep pushes


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32) -> dict:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def ffn_work(n: int, k: int, m: int, dtype, affine: bool = True) -> tuple[int, int]:
    """The operations and bytes of ``act((x @ w + b) * scale + shift)``: x,
    w, the vectors and the output each moved once."""
    size = torch.finfo(dtype).bits // 8
    ops = 2 * n * k * m + (2 + 2 * affine) * n * m
    nbytes = (n * k + k * m + n * m) * size + (3 if affine else 1) * m * 4
    return ops, nbytes


def ffn_bound(n: int, k: int, m: int, dtype, affine: bool = True) -> dict:
    """:func:`bound` of :func:`ffn_work`."""
    return bound(*ffn_work(n, k, m, dtype, affine), PEAK_F32 if dtype == torch.float32 else PEAK_BF16)


# the kernel table of PERF.md §6 (chip_smoke.py times it). Kernel 1: [n, k] @ [k, m], dtype, the BN
# affine, the timer: the recipe's [8192, 2048]² (the served path's decode batch), the streamed DNN's rows
# below one wave of tiles, the hybrid held-out gate's narrow layers and the flagship gate's validation batch
FFN_ROWS = tuple((8192, 2048, 2048, dt, True, "events") for dt in ("float32", "bfloat16")) + tuple(
    (n, k, 2048, dt, True, "device") for dt in ("float32", "bfloat16") for n, k in ((8, 2048), (72, 2048),
                                                                                  (600, 2048), (8, 440))) + (
    (2048, 48, 64, "float32", False, "device"), (2048, 64, 64, "float32", False, "device"),
    (16384, 2048, 2048, "float32", False, "events"), (16384, 2048, 2048, "bfloat16", False, "events"))
# kernel 2: [B, S] at 16 kHz, 25 ms frames every 10 ms, f32 samples to f64 frames
FRAME_ROWS = ((16, 5 * 16000), (16, 8 * 16000))
# kernel 3: g, z [n, h], w [k, h], the product on (the training step's 128 x 512 frames)
BN_ROWS = ((65536, 2048, 2048, "float32"), (65536, 2048, 2048, "bfloat16"))
# kernels 4-7: cell, [T, B, H], directions, the library call's input width, dtype: one layer of the
# recipe's BiLSTM / BiGRU, the transducer's prediction network, two of the held-out gates' layers
RNN_ROWS = (("lstm", (512, 128, 512), 2, 1024, "bfloat16"), ("gru", (512, 128, 512), 2, 1024, "bfloat16"),
            ("lstm", (129, 128, 320), 1, 128, "bfloat16"), ("lstm", (128, 16, 64), 2, 16, "float32"),
            ("lstm", (129, 16, 32), 1, 16, "float32"))
# the split of layers.product's tensor-core backward: the Conformer (L) transducer cell's joint
# cotangent (whole float4s: the vectorised read) and attention scores' (T' 415: the scalar read)
SPLIT_ROWS = {"vec4": (32 * 32 * 129, 1024), "scalar": (32, 8, 415, 415)}
RNN_SEEDS = {"lstm": 5, "gru": 6}
PEAKS = {"float32": PEAK_F32, "bfloat16": PEAK_BF16, "float64": PEAK_F64}
SIZES = {"float32": 4, "bfloat16": 2, "float64": 8}


def rnn_lengths(cell: str, t: int, b: int):
    """The rows' real lengths of a kernel 4-7 row: 2/5 T to T, the first
    T, drawn from the cell's seed; and the generator, for the operands."""
    gen = torch.Generator().manual_seed(RNN_SEEDS[cell])
    lengths = torch.randint(t * 2 // 5, t + 1, (b,), generator=gen)
    lengths[0] = t
    return lengths, gen


def work(kernel: str, row) -> tuple[float, float, str]:
    """The operations, bytes and compute type of a kernel table row
    (``kernel``: ``ffn``, ``frame``, ``bn``, ``rnn_fwd``, ``rnn_bwd``,
    ``split``): each input read once and each output written once."""
    if kernel == "ffn":
        n, k, m, dtype, affine, _ = row
        return (*ffn_work(n, k, m, getattr(torch, dtype), affine), dtype)
    if kernel == "frame":  # two f64 operations a sample; the signal and eff_len read, the frames written
        b, s = row
        t_max = 1 + (s - 400) // 160
        return 2 * b * s, b * s * 4 + b * 4 + b * t_max * 400 * 8, "float64"
    if kernel == "bn":  # the dz pass (10 operations an element) and dh = dz @ wᵀ
        n, h, k, dtype = row
        size = SIZES[dtype]
        return 2 * n * h * k + 10 * n * h, 3 * n * h * size + n * 4 + k * h * size + 5 * h * 4 + n * k * size, dtype
    if kernel == "split":  # the f32 cotangent read, its three bf16 terms written (both last dims padded to 8)
        *lead, m, n = SPLIT_ROWS[row]
        numel, pad = math.prod(SPLIT_ROWS[row]), lambda x: -(-x // 8) * 8
        return 5 * numel, numel * 4 + math.prod(lead) * pad(m) * 3 * pad(n) * 2, "float32"
    from tfkaldi_tpu_torch.ops import gru_bidi, lstm_bidi

    cell, (t, b, h), dirs, _, dtype = row
    g, cs = (lstm_bidi.CELL if cell == "lstm" else gru_bidi.CELL).gates, SIZES[dtype]
    frames = int(rnn_lengths(cell, t, b)[0].sum())
    mm = dirs * 2 * frames * h * g * h
    acts, state = t * b * g * h * 4, t * b * h * 4
    gh_n = state if cell == "gru" else 0
    if kernel == "rnn_fwd":  # gx, W_h, ys and every residual (acts, state, h in the compute type, GRU's gh_n)
        return (mm + dirs * frames * 12 * h, dirs * (acts + h * g * h * cs + state + acts + state + t * b * h * cs
                                                     + gh_n) + t * b * 4, dtype)
    # the backward reads dy, the residuals but h and W_h, writes dgx (and the GRU's dgh)
    return (mm + dirs * frames * 20 * h, dirs * (state + acts + state + gh_n + h * g * h * cs + acts
                                                 + (acts if cell == "gru" else 0)) + t * b * 4, dtype)


def row_bound(kernel: str, row) -> dict:
    """:func:`bound` of a kernel table row's :func:`work`."""
    flops, nbytes, dtype = work(kernel, row)
    return bound(flops, nbytes, PEAKS[dtype])


def self_device_us(event) -> float:
    """A torch.profiler average's self device time in microseconds."""
    # renamed from self_cuda_time_total in newer torch releases
    value = getattr(event, "self_device_time_total", None)
    return float(event.self_cuda_time_total if value is None else value)


def device_ms(fn, calls: int = CALLS, tries: int = 3, match: str | None = None) -> float:
    """``fn`` called ``calls`` times under ``torch.profiler`` after 3
    warm-up calls: the self device time of all its kernels (or of those
    whose name holds ``match``), summed, over ``calls``. A profile that saw
    no such kernel is taken again (after some hundred profiles in one
    process CUPTI has returned an empty one), at most ``tries`` times, then
    it raises."""
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and (match is None or match in e.key)]
        if kernels:
            return sum(self_device_us(e) for e in kernels) / 1e3 / calls
    raise RuntimeError(f"torch.profiler saw no device kernel{f' named *{match}*' if match else ''} in {tries} "
                       f"profiles")


def events_ms(fn, calls: int = CALLS, windows: int = 3) -> float:
    """ms a call: CUDA events around ``calls`` calls, the median of
    ``windows`` windows, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def host_us(fn, calls: int = CALLS, windows: int = 3) -> float:
    """The host's microseconds a call: ``calls`` calls on the host clock,
    synchronised after the window only, the median of ``windows``."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def bench_sweep(push, chunk_s: float, audio_s: float = STREAM_AUDIO_S, warmup: int = 8) -> dict:
    """bench.py's streaming sweep (bench.py:1017-1038) over ``audio_s`` of
    audio: ``push()`` once per chunk after ``warmup`` pushes, each push's
    wall time (the likelihoods read back on the host, as serving reads
    them); p50 and p99 in ms, and bench's ``rtf``, audio seconds per wall
    second."""
    import numpy as np

    n = max(8, int(round(audio_s / chunk_s)))
    for _ in range(warmup):
        push()
    lat = np.empty(n)
    t_start = time.perf_counter()
    for i in range(n):
        t0 = time.perf_counter()
        push()
        lat[i] = time.perf_counter() - t0
    wall = time.perf_counter() - t_start
    return {"p50_ms": float(np.percentile(lat, 50) * 1e3), "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "rtf": n * chunk_s / wall, "chunks": n}


def operands(n: int, k: int, m: int, dtype, seed: int, affine: bool = True):
    """Seeded ``x [n, k]``, ``w [k, m]`` in ``dtype`` and f32 ``b``,
    ``scale``, ``shift`` (None without ``affine``), on the card."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, k, generator=gen).to("cuda", dtype)
    w = (torch.randn(k, m, generator=gen) / k ** 0.5).to("cuda", dtype)
    b = (torch.randn(m, generator=gen) * 0.1).cuda()
    scale = (torch.rand(m, generator=gen) + 0.5).cuda() if affine else None
    shift = (torch.randn(m, generator=gen) * 0.1).cuda() if affine else None
    return x, w, b, scale, shift


def plan_dict(plan) -> dict:
    return {"route": plan.route, "tile": [plan.bm, plan.bn, plan.bk, plan.stages], "grid": list(plan.grid),
            "splits": plan.splits, "slabs": plan.slabs, "ctas": plan.ctas, "smem_bytes": plan.smem_bytes}


def variant(plan, n: int, k: int, dtype, bm: int, splits: int):
    """``plan`` (TMA or split route) on ``bm``-row tiles with K in
    ``splits`` ranges; 1 gives the TMA route."""
    from tfkaldi_tpu_torch.ops.gemm_plan import tma_smem

    nk = -(-k // plan.bk)
    common = {"bm": bm, "grid": (plan.grid[0], -(-n // bm)), "smem_bytes": tma_smem(dtype, bm)}
    if splits == 1:
        return dataclasses.replace(plan, route="tma", splits=1, slabs=nk, **common)
    return dataclasses.replace(plan, route="splitk", splits=-(-nk // -(-nk // splits)), slabs=-(-nk // splits),
                               **common)


def host_parts_us(plan, x, w, b, scale, shift) -> dict:
    """The wrapper's host microseconds a call (:func:`host_us`) taken
    apart: ``wrapper`` (``fused_ffn_block``: checks, plan, launch),
    ``launch`` (``fused_mlp.launch`` on a made plan: the output's
    allocation, the stream, the workspace, the C entry, counting),
    ``alloc`` (the output's ``torch.empty``), ``entry`` (the C entry alone
    on buffers allocated once: tensor maps and kernel launches) and
    ``entry_tma`` (the same on the shape's full-tile TMA plan: one
    launch)."""
    from tfkaldi_tpu_torch.ops import _build, fused_mlp

    (n, k), m = x.shape, w.shape[1]
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    shape = plan.workspace_shape(n, m)
    ws = torch.empty(shape, dtype=torch.float32, device=x.device) if shape else None
    entry = getattr(_build.load(), fused_mlp._ENTRY[x.dtype])
    ptrs = [t.data_ptr() if t is not None else None for t in (x, w, b, scale, shift, out)]
    stream = torch.cuda.current_stream().cuda_stream
    tma = variant(plan, n, k, x.dtype, 128, 1)

    def call_entry(p, buf):
        _build.check(entry(*ptrs, n, k, m, 1, p.code, p.bm, buf, p.splits, p.slabs, stream), "entry")

    return {"wrapper": host_us(lambda: fused_mlp.fused_ffn_block(x, w, b, scale, shift)),
            "launch": host_us(lambda: fused_mlp.launch(plan, x, w, b, scale, shift)),
            "alloc": host_us(lambda: torch.empty((n, m), dtype=x.dtype, device=x.device)),
            "entry": host_us(lambda: call_entry(plan, None if ws is None else ws.data_ptr())),
            "entry_tma": host_us(lambda: call_entry(tma, None))}


def profile_shape(n: int, k: int, m: int, dtype, *, sweep: bool = False, seed: int = 0) -> dict:
    """Every reading above at ``[n, k] @ [k, m]`` in ``dtype``."""
    from tfkaldi_tpu_torch.ops import fused_mlp
    from tfkaldi_tpu_torch.ops.gemm_plan import HALF_BM, gemm_plan

    name = str(dtype).replace("torch.", "")
    x, w, b, scale, shift = operands(n, k, m, dtype, seed)
    plan = gemm_plan(n, k, m, dtype, "mn", (x.data_ptr(), w.data_ptr()))
    before = dict(fused_mlp.launches_by_route)
    got = fused_mlp.fused_ffn_block(x, w, b, scale, shift)
    again = fused_mlp.fused_ffn_block(x, w, b, scale, shift)
    want = fused_mlp.fused_ffn_block_ref(x, w, b, scale, shift)
    torch.cuda.synchronize()
    if fused_mlp.launches_by_route != {**before, plan.route: before[plan.route] + 2}:
        raise AssertionError(f"fused_ffn [{n},{k}]x[{k},{m}] {dtype}: launches not on route {plan.route}")
    err = (got.float() - want.float()).abs().max().item()
    if not (err <= FFN_TOL[name] and torch.isfinite(got.float()).all()):
        raise AssertionError(f"fused_ffn [{n},{k}]x[{k},{m}] {dtype}: max|diff| {err} > {FFN_TOL[name]}")
    if not torch.equal(got, again):
        raise AssertionError(f"fused_ffn [{n},{k}]x[{k},{m}] {dtype} on {plan.route}: two calls differ")
    call = lambda: fused_mlp.fused_ffn_block(x, w, b, scale, shift)  # noqa: E731
    row = {"n": n, "k": k, "m": m, "dtype": name, "plan": plan_dict(plan),
           "max_abs_err": err, "bit_equal_repeat": True, "device_ms": device_ms(call), "events_ms": events_ms(call),
           "host_us": host_us(call),
           "plain_ms": events_ms(lambda: fused_mlp.fused_ffn_block_ref(x, w, b, scale, shift)),
           "library_ms": events_ms(lambda: torch.matmul(x, w)), **ffn_bound(n, k, m, dtype),
           "host_parts_us": host_parts_us(plan, x, w, b, scale, shift)}
    if sweep:
        vecs = (b, scale, shift)
        row["sweep"] = []
        nk = -(-k // plan.bk)
        for bm in (128, HALF_BM):
            for splits in sorted({variant(plan, n, k, dtype, bm, s).splits for s in range(1, min(nk, 32) + 1)}):
                p = variant(plan, n, k, dtype, bm, splits)
                out = fused_mlp.launch(p, x, w, *vecs)
                torch.cuda.synchronize()
                e = (out.float() - want.float()).abs().max().item()
                if not e <= FFN_TOL[name]:
                    raise AssertionError(f"fused_ffn [{n},{k}]x[{k},{m}] {dtype} at bm {bm}, {splits} splits: "
                                         f"max|diff| {e}")
                row["sweep"].append({"bm": bm, "splits": p.splits, "slabs": p.slabs, "ctas": p.ctas,
                                     "max_abs_err": e,
                                     "device_ms": device_ms(lambda: fused_mlp.launch(p, x, w, *vecs))})
    del x, w, got, again, want
    torch.cuda.empty_cache()
    return row


def plain_rule(n: int, k: int, m: int, dtype) -> tuple[int, int]:
    """The rule the model is held against: full tiles, and the most
    whole-slab splits with tiles x splits <= SMS (1 where the tiles alone
    reach SMS)."""
    from tfkaldi_tpu_torch.ops import gemm_plan as gp

    full, bn, bk, _ = gp.TMA_TILE[dtype]
    tiles = -(-m // bn) * -(-n // full)
    return full, max(gp.whole_splits(-(-k // bk), max(1, gp.SMS // tiles)))


def calibrate(result: dict) -> dict:
    """For each swept row of a ``--sweep`` result: the (tile rows, split
    count) that ``gemm_plan.tile_and_split`` picks now, the plain rule's
    (:func:`plain_rule`), the cheapest measured, and the measured cost of
    each: its device time, a split's plus ``gemm_plan.SPLIT_GAIN_US`` (the
    objective the plan minimises); a pick's ``regret`` is its cost over
    the cheapest's, less 1 (0 where it is the cheapest). Also the median
    over the split rows of ``entry`` less ``entry_tma``, the host's
    microseconds of a split's second launch, which SPLIT_GAIN_US is set
    to."""
    from tfkaldi_tpu_torch.ops import gemm_plan as gp

    rows, regrets, second = [], {"model": [], "rule": []}, []
    for row in result["rows"]:
        parts = row.get("host_parts_us", {})
        if row["plan"]["route"] == "splitk" and "entry_tma" in parts:
            second.append(parts["entry"] - parts["entry_tma"])
        if "sweep" not in row:
            continue
        cost = {(s.get("bm", 128), s["splits"]): s["device_ms"] * 1e3 + (gp.SPLIT_GAIN_US if s["splits"] > 1 else 0.0)
                for s in row["sweep"]}
        dtype = getattr(torch, row["dtype"])
        best = min(cost, key=cost.get)
        out = {"n": row["n"], "k": row["k"], "m": row["m"], "dtype": row["dtype"], "best": list(best),
               "best_us": cost[best]}
        for who, pick in (("model", gp.tile_and_split(row["n"], row["k"], row["m"], dtype)),
                          ("rule", plain_rule(row["n"], row["k"], row["m"], dtype))):
            if pick not in cost:  # a sweep taken before the pick's tile was built
                out.update({who: list(pick), f"{who}_us": None, f"{who}_regret": None})
                continue
            regret = cost[pick] / cost[best] - 1
            regrets[who].append(regret)
            out.update({who: list(pick), f"{who}_us": cost[pick], f"{who}_regret": regret})
        rows.append(out)
    return {"rows": rows, **{f"{who}_mean_regret": sum(r) / len(r) for who, r in regrets.items() if r},
            **{f"{who}_max_regret": max(r) for who, r in regrets.items() if r},
            "second_launch_us": statistics.median(second) if second else None, "split_rows": len(second)}


def stream_times(seed: int = 0) -> dict:
    """The streamed DNN's chunk times: the flagship's shape (440 = 40 x 11
    spliced inputs, 6 x 2048 relu with batchnorm, 2000 outputs, context 5)
    with seeded weights, in f32 and bf16, through ``OnlineSplicedDecoder``
    at batch 1, one seeded chunk pushed over and over (:func:`bench_sweep`)
    at STREAM_CHUNKS frames. Returns ``{"dnn_hybrid_<dtype>_<ms>ms": ...}``
    with kernel 1's launches by route over each sweep."""
    import numpy as np

    from tfkaldi_tpu_torch.decode.online import OnlineSplicedDecoder
    from tfkaldi_tpu_torch.models.dnn import DNN, DNNConfig
    from tfkaldi_tpu_torch.ops import fused_mlp

    prior = np.full((2000,), 1.0 / 2000, np.float32)
    rng = np.random.default_rng(seed)
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        model = DNN(DNNConfig(input_dim=440, num_labels=2000, batch_norm=True, compute_dtype=dtype))
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model = model.to("cuda").eval()
        for frames in STREAM_CHUNKS:
            chunk = rng.standard_normal((1, frames, 40)).astype(np.float32)
            dec = OnlineSplicedDecoder(model, prior, 5)
            dec.reset(1)
            before = dict(fused_mlp.launches_by_route)
            t = bench_sweep(lambda: dec.step(chunk, [frames]), frames / 100)
            t["launches_by_route"] = {r: c - before.get(r, 0) for r, c in fused_mlp.launches_by_route.items()}
            out[f"dnn_hybrid_{tag}_{frames * 10}ms"] = t
            print(json.dumps({f"dnn_hybrid_{tag}_{frames * 10}ms": t}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true", help="also time every tile and split count")
    ap.add_argument("--stream", action="store_true", help="time the streamed DNN's chunks instead")
    ap.add_argument("--calibrate", metavar="FILE", default=None,
                    help="print the model's and the plain rule's picks against a --sweep result in FILE, then stop")
    ap.add_argument("--dtype", choices=("float32", "bfloat16", "both"), default="both")
    ap.add_argument("--out", default=None, help="also write the JSON result here")
    args = ap.parse_args(argv)
    if args.calibrate:
        with open(args.calibrate) as f:
            fit = calibrate(json.load(f))
        for row in fit["rows"]:
            print(json.dumps(row))
        print(json.dumps({key: value for key, value in fit.items() if key != "rows"}))
        return 0
    from tfkaldi_tpu_torch.device import resolve_device
    from tfkaldi_tpu_torch.ops import _build

    resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.load()
    if args.stream:
        result = {"card": card, "stream": stream_times()}
    else:
        dtypes = (torch.float32, torch.bfloat16) if args.dtype == "both" else (getattr(torch, args.dtype),)
        rows = []
        for dtype in dtypes:
            for n, k, m in SHAPES:
                row = profile_shape(n, k, m, dtype, sweep=args.sweep)
                print(json.dumps(row), flush=True)
                rows.append(row)
        result = {"card": card, "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

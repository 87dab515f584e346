"""Times the port's hand kernels, runs the card suite, then times the
paths no benchmark cell measures, on one card.

    python3 chip_smoke.py > chip_smoke.log

1. The kernel table of PERF.md §6, one row a kernel, shape and dtype
   (``profile_ffn``'s ``FFN_ROWS``, ``FRAME_ROWS``, ``BN_ROWS``,
   ``RNN_ROWS``, ``SPLIT_ROWS``): the kernel's time, its plain version's,
   the library call's (``torch.matmul`` of the product alone, cuDNN's
   LSTM/GRU on a packed batch; none for kernel 2 and the split), the bound
   (``profile_ffn.row_bound``: operations at the compute type's peak or
   bytes at the memory rate, each input read once and each output written
   once), the launch plan and the timed calls' route. Timers
   (``profile_ffn``): ``events_ms``, the median of 3 windows of 20 calls,
   for the recipe-sized kernels 1 and 3, kernels 4-7 and the split (the
   plain recurrences over one window of 2 calls); ``device_ms``,
   torch.profiler's self device time over 20 calls, for kernel 1 below one
   wave of tiles (with ``events_ms`` and the host's µs a call beside it)
   and for kernel 2 (its own kernel by name, beside the wrapper's events).
   The table is timed first, in a fresh process.
2. The card suite (:data:`SUITE_FILES`: ``tests/test_torch_cuda_*.py`` and
   the card tests of ``tests/test_torch_decode_copy_out.py``, ``-m cuda
   --noconftest``) in this process, through ``pytest.main``: it holds every
   kernel to its plain version and drives every recipe through ``cli.main``
   and ``cli.serve``. A failure ends the script with pytest's exit code.
   Each check lives in the suite alone: this script asserts nothing the
   suite asserts, and guards only that what it times is finite and that a
   timer saw what it times. Each table row then gets the main paths'
   launches of its kernel by route (:func:`path_launches`: the suite's
   ``cli.main`` / ``cli.serve`` runs, each counted from 0).
3. The paths that ROADMAP items name and no cell measures, on the models
   step 2 trained in this process (``tests/card_support.RUNS``): items 21b
   and 29, the BiLSTM, BiGRU and CTC BiLSTM training step by parts and the
   attention step by parts; item 24, the transducer's greedy and beam-8
   decode of the test set (encoder and search), its LM-fused beam, the
   attention beam 10 unfused and fused (and 10 of its steps under
   torch.profiler: device against host time), the fused CTC beam 16, and
   ``cli.serve --stream`` with the transducer at 16 slots and 16 clients
   (chunk reply p50 / p95, engine tick p50).
4. Prints the result as one JSON line, the last, each reading with the
   card's name and power limit.

Needs one CUDA device, ``nvcc`` and pytest.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import subprocess
import sys
import time
import warnings

from tests import card_support
from tfkaldi_tpu_torch.profile_ffn import (BN_ROWS, FFN_ROWS, FRAME_ROWS, PEAK_BYTES, PEAKS, RNN_ROWS, SPLIT_ROWS,
                                           device_ms, events_ms, host_us, rnn_lengths, row_bound, self_device_us)

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SUITE_FILES = sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_cuda_*.py"))) + [
    os.path.join(ROOT, "tests", "test_torch_decode_copy_out.py")]
# the recipes whose models step 3 times
TIMED_RECIPES = ("lstm", "gru", "ctc", "attention", "transducer")


def log(*parts) -> None:
    print(*parts, flush=True)


def finite(x) -> None:
    """The one guard on what is timed: a finite result."""
    import torch

    for t in x if isinstance(x, (list, tuple)) else (x,):
        if t is not None and torch.is_tensor(t) and t.is_floating_point() and not torch.isfinite(t).all():
            raise RuntimeError("a timed call gave a non-finite result")


def routes_since(before: dict, after: dict) -> dict:
    return {r: after[r] - before.get(r, 0) for r in after if after[r] != before.get(r, 0)}


def plan_text(plan) -> str:
    split = f" x {plan.splits} splits of {plan.slabs} slabs" if plan.route == "splitk" else ""
    return (f"route {plan.route}, tile {plan.bm}x{plan.bn}x{plan.bk} x {plan.stages} stages, grid "
            f"{plan.grid[0]}x{plan.grid[1]}{split}, {plan.smem_bytes} B of shared memory")


# ---------------------------------------------------------------------------
# 2. the card suite
# ---------------------------------------------------------------------------

def run_suite(files: list) -> tuple[int, dict]:
    """The card suite's ``files`` in this process: pytest's exit code and
    the tests' outcomes (passed, failed, skipped) with the seconds taken."""
    import pytest

    class Tally:
        def __init__(self):
            self.outcomes = collections.Counter()

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.outcomes[report.outcome] += 1

    tally = Tally()
    t0 = time.perf_counter()
    rc = pytest.main([*files, "-m", "cuda", "--noconftest", "-q", "-rfEs", "-p", "no:cacheprovider",
                      "--rootdir", ROOT], plugins=[tally])
    return int(rc), {**tally.outcomes, "seconds": time.perf_counter() - t0}


def path_launches() -> dict:
    """The main paths' launches by route: the card suite's ``cli.main`` and
    ``cli.serve`` runs of this process (``card_support.RUNS``; the counters
    reset to 0 before each), by run, and summed by kernel and the run's
    compute dtype (kernel 2 and the split over every run)."""
    runs, totals = {}, collections.defaultdict(collections.Counter)
    for name, run in card_support.RUNS.items():
        dtype = run.config.get("nnet", "compute_dtype", fallback="float32")
        c = run.counts
        kernels = {f"fused_ffn {dtype}": c["ffn_routes"], "frame_preemph": c["frame_routes"],
                   f"bn_dgrad {dtype}": c["bn_routes"], "bf16_split": c["split"]}
        for cell in ("lstm", "gru"):
            kernels[f"{cell} {dtype}"] = {"fwd_persistent": c[f"{cell}_fwd_persistent"], "fwd_step": c[f"{cell}_fwd"],
                                          "bwd_persistent": c[f"{cell}_bwd_persistent"], "bwd_step": c[f"{cell}_bwd"]}
        kernels = {k: {r: v for r, v in routes.items() if v} for k, routes in kernels.items()}
        runs[name] = {k: routes for k, routes in kernels.items() if routes}
        for k, routes in runs[name].items():
            totals[k].update(routes)
    return {"runs": runs, "totals": {k: dict(v) for k, v in totals.items()}}


def row_key(row: dict) -> str:
    """The :func:`path_launches` total a kernel table row reads."""
    kernel = row["kernel"]
    if kernel in (2, "bf16_split"):
        return {2: "frame_preemph", "bf16_split": "bf16_split"}[kernel]
    name = {1: "fused_ffn", 3: "bn_dgrad"}.get(kernel) or kernel.split("_")[0]
    return f"{name} {row['dtype']}"


# ---------------------------------------------------------------------------
# 1. the kernel table
# ---------------------------------------------------------------------------

def time_ffn(card: str) -> list:
    import torch

    from tfkaldi_tpu_torch.ops import fused_mlp
    from tfkaldi_tpu_torch.ops.gemm_plan import gemm_plan

    gen = torch.Generator().manual_seed(1)
    rows = []
    for row in FFN_ROWS:
        n, k, m, name, affine, timer = row
        dtype = getattr(torch, name)
        x = torch.randn(n, k, generator=gen).to("cuda", dtype)
        w = (torch.randn(k, m, generator=gen) / k ** 0.5).to("cuda", dtype)
        b = (torch.randn(m, generator=gen) * 0.1).cuda()
        scale, shift = ((torch.rand(m, generator=gen) + 0.5).cuda(), (torch.randn(m, generator=gen) * 0.1).cuda()) \
            if affine else (None, None)
        plan = gemm_plan(n, k, m, dtype, "mn", (x.data_ptr(), w.data_ptr()))
        before = dict(fused_mlp.launches_by_route)
        call = lambda: fused_mlp.fused_ffn_block(x, w, b, scale, shift)  # noqa: E731
        finite(call())
        out = {"kernel": 1, "shape": [n, k, m], "dtype": name, "timer": timer,
               "events_ms": events_ms(call), "plain_ms": events_ms(lambda: fused_mlp.fused_ffn_block_ref(
                   x, w, b, scale, shift)), "library_ms": events_ms(lambda: torch.matmul(x, w)),
               **row_bound("ffn", row)}
        if timer == "device":
            out.update(device_ms=device_ms(call), host_us=host_us(call))
        out["ms"] = out["device_ms" if timer == "device" else "events_ms"]
        out["launches_by_route"] = routes_since(before, fused_mlp.launches_by_route)
        log(f"fused_ffn [{n},{k}]x[{k},{m}] {name}: {json.dumps(out)}; {plan_text(plan)} [{card}]")
        rows.append(out)
        del x, w
        torch.cuda.empty_cache()
    return rows


def time_frame(card: str) -> list:
    import torch

    from tfkaldi_tpu_torch import profile_frame as pf
    from tfkaldi_tpu_torch.ops import frame_preemph as fp

    rows = []
    for b, s in FRAME_ROWS:
        sig, eff, args = pf.inputs(b, s)
        shifted = torch.empty(b * s + 1, device="cuda")
        shifted[1:].copy_(sig.reshape(-1))
        edge = shifted[1:].view(b, s)  # one float into its buffer: the edge route
        before = dict(fp.launches_by_route)
        finite(fp.frame_preemph(sig, eff, **args))
        plan = fp.plan_for(sig, fp.frame_preemph(sig, eff, **args), args["t_max"], pf.WL, pf.WS)
        out = {"kernel": 2, "shape": [b, s, args["t_max"], pf.WL], "dtype": "float64", "timer": "device",
               "ms": device_ms(lambda: fp.frame_preemph(sig, eff, **args), match=pf.KERNEL_NAME),
               "edge_ms": device_ms(lambda: fp.frame_preemph(edge, eff, **args), match=pf.KERNEL_NAME),
               "wrapper_ms": events_ms(lambda: fp.frame_preemph(sig, eff, **args)),
               "plain_ms": events_ms(lambda: fp.frame_preemph_ref(sig, eff, **args)), "library_ms": None,
               **row_bound("frame", (b, s)), "launches_by_route": routes_since(before, fp.launches_by_route)}
        log(f"frame_preemph [{b},{s}]: {json.dumps(out)}; route {plan.route}, {plan.frames} frames a tile, "
            f"{plan.tiles} tiles on {plan.grid} CTAs, {plan.smem_bytes} B of shared memory [{card}]")
        rows.append(out)
        del sig, eff, shifted, edge
        torch.cuda.empty_cache()
    return rows


def time_bn(card: str) -> list:
    import torch

    from tfkaldi_tpu_torch.ops import bn_fused_bwd as bf
    from tfkaldi_tpu_torch.ops.gemm_plan import gemm_plan

    gen = torch.Generator().manual_seed(2)
    rows = []
    for row in BN_ROWS:
        n, h, k, name = row
        dtype = getattr(torch, name)
        mask = (torch.arange(n) % 512 < 400).float().cuda()  # 400 real frames of 512
        g = (torch.randn(n, h, generator=gen).cuda() * mask[:, None] * 1e-3).to(dtype)
        z = torch.randn(n, h, generator=gen).to("cuda", dtype)
        w = (torch.randn(k, h, generator=gen) / h ** 0.5).cuda()
        vecs = [(torch.randn(h, generator=gen) * 0.1).cuda(), (torch.rand(h, generator=gen) + 0.5).cuda(),
                (torch.randn(h, generator=gen) * 0.1).cuda(), (torch.randn(h, generator=gen) * 1e-5).cuda(),
                (torch.randn(h, generator=gen) * 1e-5).cuda()]
        args = (g, z, mask, w, *vecs)
        before = dict(bf.launches_by_route)
        dh, dz = bf.bn_dgrad(*args)
        finite([dh, dz])
        wt = w.to(dtype)
        plan = gemm_plan(n, h, k, dtype, "k", (dz.data_ptr(), wt.data_ptr()))
        out = {"kernel": 3, "shape": [n, h, k], "dtype": name, "timer": "events",
               "ms": events_ms(lambda: bf.bn_dgrad(*args)), "plain_ms": events_ms(lambda: bf.bn_dgrad_ref(*args, dtype)),
               "library_ms": events_ms(lambda: torch.matmul(dz, wt.t())), **row_bound("bn", row),
               "launches_by_route": routes_since(before, bf.launches_by_route)}
        log(f"bn_dgrad g,z [{n},{h}] w [{k},{h}] {name}: {json.dumps(out)}; dz pass, then {plan_text(plan)} [{card}]")
        rows.append(out)
        del args, g, z, dh, dz
        torch.cuda.empty_cache()
    return rows


def cudnn_rnn(cell: str, width: int, h: int, cd, dirs: int):
    """cuDNN's LSTM/GRU of ``dirs`` directions in the compute dtype, its
    weights compacted once into cuDNN's flat buffer (``flatten_parameters``
    skips bf16, and a module so left re-compacts them on every call, with
    RNN.cpp's "contiguous chunk" warning: :func:`time_rnn` raises on it)."""
    import torch
    from torch.backends.cudnn import rnn as cudnn

    lib = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(width, h, bidirectional=dirs == 2).to("cuda", cd)
    with torch.no_grad():
        torch._cudnn_rnn_flatten_weight(lib._flat_weights, 4, lib.input_size, cudnn.get_cudnn_mode(lib.mode),
                                        lib.hidden_size, lib.proj_size, lib.num_layers, lib.batch_first,
                                        bool(lib.bidirectional))
    return lib


def time_rnn(card: str) -> list:
    import torch

    from tfkaldi_tpu_torch.ops import gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops.rnn_bidi import STEP_BWD, bwd_plan, fwd_plan

    rows = []
    for row in RNN_ROWS:
        cell, (t, b, h), dirs, width, name = row
        c, cd = (lstm_bidi.CELL if cell == "lstm" else gru_bidi.CELL), getattr(torch, name)
        lengths, gen = rnn_lengths(cell, t, b)
        mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[:, :, None].cuda()
        gxs = [torch.randn(t, b, c.gates * h, generator=gen).cuda() for _ in range(dirs)]
        whs = [(torch.randn(h, c.gates * h, generator=gen) / h ** 0.5).to("cuda", cd) for _ in range(dirs)]
        dys = [torch.randn(t, b, h, generator=gen).cuda() for _ in range(dirs)]
        counts = (c.fwd_persistent_launches, c.fwd_launches, c.bwd_persistent_launches, c.bwd_launches)
        outs = c.fwd(gxs, whs, mask, residuals=True)
        res = [r for _, r in outs]
        finite([y for y, _ in outs] + [g for g, _ in c.bwd(dys, res, mask, whs)])
        x = torch.randn(t, b, width, device="cuda", dtype=cd, requires_grad=True)
        lib = cudnn_rnn(cell, width, h, cd, dirs)
        packed = torch.nn.utils.rnn.pack_padded_sequence(x, lengths, enforce_sorted=False)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            lib_out = lib(packed)[0].data
        if any("contiguous chunk" in str(w.message) for w in seen):  # a call would time a copy with it
            raise RuntimeError(f"cuDNN's {cell} re-compacts its weights on every call")
        cot = torch.randn_like(lib_out)
        fwd = {"ms": events_ms(lambda: c.fwd(gxs, whs, mask, residuals=True)),
               "eval_ms": events_ms(lambda: c.fwd(gxs, whs, mask, residuals=False)),
               "plain_ms": events_ms(lambda: c.fwd_ref(gxs, whs, mask, residuals=True), calls=2, windows=1),
               "library_ms": events_ms(lambda: lib(packed))}
        bwd = {"ms": events_ms(lambda: c.bwd(dys, res, mask, whs)),
               "step_route_ms": events_ms(lambda: c.bwd(dys, res, mask, whs, plan=STEP_BWD)),
               "plain_ms": events_ms(lambda: c.bwd_ref(dys, res, mask, whs), calls=2, windows=1),
               "library_ms": events_ms(lambda: torch.autograd.grad(lib_out, [x, *lib.parameters()], cot,
                                                                   retain_graph=True))}
        after = (c.fwd_persistent_launches, c.fwd_launches, c.bwd_persistent_launches, c.bwd_launches)
        launches = dict(zip(("fwd_persistent", "fwd_step", "bwd_persistent", "bwd_step"),
                            (a - b_ for a, b_ in zip(after, counts))))
        for way, times, plan in (("fwd", fwd, fwd_plan(b, h, c.gates, cd, dirs)),
                                 ("bwd", bwd, bwd_plan(b, h, c.gates, cd, dirs))):
            out = {"kernel": f"{cell}_{way}", "shape": [t, b, h, dirs], "dtype": name, "timer": "events", **times,
                   **row_bound(f"rnn_{way}", row), "plan_route": plan.route, "ctas": plan.ctas,
                   "smem_bytes": plan.smem_bytes, "launches": launches}
            log(f"{cell} {way} [{t},{b},{h}] x {dirs} {name}: {json.dumps(out)} [{card}]")
            rows.append(out)
        del gxs, whs, dys, res, outs, x, lib, lib_out
        torch.cuda.empty_cache()
    return rows


def time_split(card: str) -> list:
    import torch

    from tfkaldi_tpu_torch.ops import bf16_split

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for route, shape in SPLIT_ROWS.items():
        g = torch.randn(*shape, generator=gen, device="cuda") * 1e-3
        before = dict(bf16_split.launches_by_route)
        finite(bf16_split.split3(g))
        out = {"kernel": "bf16_split", "shape": list(shape), "dtype": "float32", "timer": "events", "route": route,
               "ms": events_ms(lambda: bf16_split.split3(g)), "plain_ms": events_ms(lambda: bf16_split.split3_ref(g)),
               "library_ms": None, **row_bound("split", route),
               "launches_by_route": routes_since(before, bf16_split.launches_by_route)}
        log(f"bf16_split {list(shape)}: {json.dumps(out)} [{card}]")
        rows.append(out)
        del g
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# 3. the paths no cell measures
# ---------------------------------------------------------------------------

def step_ms(fn, calls: int = 3) -> float:
    """A training step's ms (CUDA events around ``calls`` calls after 3)."""
    return events_ms(fn, calls=calls, windows=1)


def time_rnn_step(card: str, tag: str, cell: str, trainer, state, batch, num_out: int,
                  loss_parts: dict | None = None) -> dict:
    """A recurrent model's training step by parts: the whole update, the
    gradient pass and the forward, then each part on its own at the step's
    shapes: the input projections, the kernels of both layers, the wgrads,
    the output layer and ``loss_parts``; the rest (loss, dropout, casts,
    concat, bias sums) is what remains of the gradient pass."""
    import torch

    from tfkaldi_tpu_torch.layers import product
    from tfkaldi_tpu_torch.ops import gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops.lstm_scan import weight_grad
    from tfkaldi_tpu_torch.train import checkpoint as ckpt

    c = lstm_bidi.CELL if cell == "lstm" else gru_bidi.CELL
    layers = trainer.model_config.num_layers
    s = ckpt.device_snapshot(state)
    parts = {"update": step_ms(lambda: trainer.update(s, batch)),
             "gradients": step_ms(lambda: trainer.gradients(s, batch, trainer.dropout_generator(s))),
             "forward": step_ms(lambda: trainer.loss_sum(s.model, batch, train=True,
                                                         generator=trainer.dropout_generator(s),
                                                         loss_type=trainer.config.loss_type,
                                                         blank_id=trainer.config.ctc_blank_id))}
    b, t_pad, input_dim = batch.inputs.shape
    cd, h, gates, n = trainer.model_config.compute_dtype, trainer.model_config.hidden_units, c.gates, b * t_pad
    x0, x1 = torch.randn(n, input_dim, device="cuda"), torch.randn(n, 2 * h, device="cuda")
    wx0, wx1 = torch.randn(input_dim, gates * h, device="cuda"), torch.randn(2 * h, gates * h, device="cuda")
    dg = torch.randn(n, gates * h, device="cuda")
    wout, dlogits = torch.randn(2 * h, num_out, device="cuda"), torch.randn(n, num_out, device="cuda")
    parts["input projections"] = 2 * (step_ms(lambda: product(x0, wx0, cd), 5) + step_ms(lambda: product(x1, wx1, cd), 5)
                                      + step_ms(lambda: product(dg, wx1.t(), cd), 5))
    mask = (torch.arange(t_pad, device="cuda")[:, None] < batch.input_lengths.cuda()[None, :])[:, :, None].float()
    gxs = [dg.reshape(t_pad, b, gates * h).contiguous() for _ in range(2)]
    whs = [torch.randn(h, gates * h, device="cuda").div(h ** 0.5).to(cd) for _ in range(2)]
    dys = [torch.randn(t_pad, b, h, device="cuda") for _ in range(2)]
    res = [r for _, r in c.fwd(gxs, whs, mask, residuals=True)]
    parts[f"{c.name}_fwd"] = layers * step_ms(lambda: c.fwd(gxs, whs, mask, residuals=True))
    parts[f"{c.name}_bwd"] = layers * step_ms(lambda: c.bwd(dys, res, mask, whs))
    dgx3 = dg.reshape(t_pad, b, gates * h)
    parts["wgrads"] = (2 * layers * step_ms(lambda: weight_grad(res[0][2], dgx3, cd), 5)
                       + 2 * step_ms(lambda: product(x0.t(), dg, cd), 5) + 2 * step_ms(lambda: product(x1.t(), dg, cd), 5)
                       + step_ms(lambda: product(x1.t(), dlogits, cd), 5))
    parts["output layer"] = step_ms(lambda: product(x1, wout, cd), 5) + step_ms(lambda: product(dlogits, wout.t(), cd), 5)
    parts.update(loss_parts or {})
    parts["rest"] = parts["gradients"] - sum(v for k, v in parts.items() if k not in ("update", "gradients", "forward"))
    parts["Adam"] = parts["update"] - parts["gradients"]
    frames = int(batch.input_lengths.sum().item())
    out = {"batch": [b, t_pad], "real_frames": frames, "frames_per_s": frames / parts["update"] * 1e3, "ms": parts}
    log(f"{tag} train step: {json.dumps(out)} [{card}]")
    return out


def time_attention_step(card: str, cfg_path: str, savedir: str, featdir: str) -> dict:
    """One step of the attention recipe from its step-2 checkpoint on the
    first training batch, by parts (the median of 3 calls after 3):
    encoder forward, decoder forward with the attention CE, CTC head and
    loss forward, the backward (the gradient pass less those), Adam."""
    from configparser import ConfigParser

    import torch

    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.models import Seq2SeqConfig
    from tfkaldi_tpu_torch.train import checkpoint as ckpt
    from tfkaldi_tpu_torch.train import ctc
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

    config = ConfigParser()
    config.read(cfg_path)
    conf = dict(config.items("nnet"))
    cfg = Seq2SeqConfig.from_config(conf, 40, TextCoder(aurora4_normalizer).num_labels)
    batch = card_support.train_batch(featdir, conf, text=True).to("cuda")
    trainer = Trainer(cfg, TrainerConfig(num_steps=6, loss_type="attention"), device="cuda")
    state = ckpt.restore_state(os.path.join(savedir, "training", "step2.pt"), trainer.init_state(0))
    model, gen = state.model, trainer.dropout_generator(state)
    labels = [ctc.host(a) for a in (batch.input_lengths, batch.targets, batch.target_lengths)]
    labels[0] = model.output_lengths(labels[0])
    memory = model.encode(batch.inputs, batch.input_lengths, train=True, generator=gen).detach().requires_grad_()

    def median3(fn):
        return events_ms(fn, calls=1, windows=3)

    parts = {"encoder forward": median3(lambda: model.encode(batch.inputs, batch.input_lengths, train=True,
                                                             generator=gen)),
             "decoder forward": median3(lambda: torch.log_softmax(model.teacher_forced(
                 memory, batch.input_lengths, batch.targets, batch.target_lengths, train=True, generator=gen),
                 dim=-1).sum()),
             "CTC head + loss forward": median3(lambda: ctc.ctc_loss(model.ctc_logits(memory), *labels,
                                                                     model.sos_eos_id).sum())}
    s = ckpt.device_snapshot(state)
    grad_ms = median3(lambda: trainer.gradients(s, batch, trainer.dropout_generator(s)))
    update_ms = median3(lambda: trainer.update(s, batch))
    parts["backward"] = grad_ms - sum(parts.values())
    parts["Adam"] = update_ms - grad_ms
    frames = int(batch.input_lengths.sum().item())
    out = {"batch": list(batch.inputs.shape[:2]), "decoder_positions": batch.targets.shape[1] + 1,
           "real_frames": frames, "update_ms": update_ms, "frames_per_s": frames / update_ms * 1e3, "ms": parts}
    log(f"attention train step: {json.dumps(out)} [{card}]")
    return out


def beam_step_profile(dec, x, lengths, steps: int = 10) -> dict:
    """``steps`` steps of the attention beam on a padded batch under
    torch.profiler (after 3 untraced ones): a step's top-level aten ops and
    device kernels, its device time (the kernels' self time summed) and its
    host time, and the device's idle share of the window. Raises where the
    profile saw no kernel."""
    import torch
    from torch.autograd import DeviceType

    with torch.inference_mode():
        st = dec.begin(x, lengths)
        for _ in range(3):
            cand = dec.candidates(st)
            dec.advance(st, cand, dec.select(cand))
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                dec.live(st)
                cand = dec.candidates(st)
                dec.advance(st, cand, dec.select(cand))
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / steps
    ops = sum(1 for e in prof.events() if e.name.startswith("aten::") and
              (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device = sum(self_device_us(e) for e in kernels) / 1e3 / steps
    if not device:  # a profile that saw no kernel would read the card idle
        raise RuntimeError("torch.profiler saw no device kernel in the attention beam's steps")
    return {"aten_ops": ops / steps, "kernels": sum(e.count for e in kernels) / steps, "device_ms": device,
            "host_ms": host_ms, "idle": 1.0 - device / host_ms}


def time_text_decodes(card: str, models: dict, arpa: str) -> dict:
    """Item 24's host-paced decodes of the test set (host clock, features
    read; the card warm): the transducer's greedy and beam-8 search split
    into encoder and search, its beam 8 with the trigram; the attention
    beam 10 unfused and fused, with the ``seconds`` split and 10 steps
    under torch.profiler; the fused CTC beam 16 (the Python beam)."""
    from configparser import ConfigParser

    import torch

    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode.streaming import stream_padded_batches
    from tfkaldi_tpu_torch.decode.transducer import TransducerDecoder
    from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
    from tfkaldi_tpu_torch.nnet import Nnet

    coder = TextCoder(aurora4_normalizer)
    att_test, ctc_test = models["att_dirs"]["test"], models["ws"]["test_featdir"]
    eval_reader = card_support.eval_reader
    frames = sum(int(n) for _, _, l in stream_padded_batches(eval_reader(att_test), batch_size=16) for n in l)
    out = {"test_frames": frames}

    def nnet(kind: str, tag: str = "", **keys):
        path = card_support.variant_config(models[kind][0], os.path.join(WORK, f"config_{kind}{tag}.cfg"), keys)
        config = ConfigParser()
        config.read(path)
        return Nnet(config, 40, coder.num_labels, device="cuda")

    def timed(decoder, featdir: str, context: int = 0) -> float:
        if hasattr(decoder, "seconds"):
            decoder.seconds = dict.fromkeys(decoder.seconds, 0.0)
            decoder.steps = 0
        reader = eval_reader(featdir, context)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decoder.decode_to_file(reader, os.devnull)
        torch.cuda.synchronize()
        reader.close()
        return time.perf_counter() - t0

    # the transducer: greedy and beam 8 by encoder and search, then beam 8 with the trigram
    net = nnet("transducer")
    model = net._load_model().eval()
    beam, max_sym = int(net.conf["beam_width"]), int(net.conf["max_symbols_per_frame"])
    reader = eval_reader(att_test)
    batches = list(stream_padded_batches(reader, batch_size=16))
    reader.close()
    for name, d in (("greedy", TransducerDecoder(model, coder, max_symbols_per_frame=max_sym)),
                    (f"beam{beam}", TransducerBeamDecoder(model, coder, beam_width=beam,
                                                          max_symbols_per_frame=max_sym))):
        for _ in range(2):  # a warm-up, then the timed pass
            enc_s = search_s = 0.0
            for _, xb, lb in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                encoded = d.encode(xb, lb)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                [o.cpu() for o in d.search(*encoded)]
                enc_s, search_s = enc_s + t1 - t0, search_s + time.perf_counter() - t1
        out[f"transducer_{name}"] = {"frames_per_s": frames / (enc_s + search_s), "encoder_ms": enc_s * 1e3,
                                     "search_ms": search_s * 1e3}
    del model, net
    fused = nnet("transducer", "_lm", lm_path=arpa, lm_alpha=0.5).load_text_decoder(coder)
    out[f"transducer_beam{beam}_lm"] = {"frames_per_s": frames / timed(fused, att_test)}
    del fused

    # the attention beam, unfused and fused
    _, x, lengths = next(iter(stream_padded_batches(eval_reader(att_test), batch_size=16)))
    for tag, keys in (("beam10", {}), ("beam10_lm", {"lm_path": arpa, "lm_alpha": 0.5})):
        dec = nnet("attention", f"_{tag}", decode_mode="beam", **keys).load_text_decoder(coder)
        if tag == "beam10":
            out["attention_beam10_step"] = beam_step_profile(dec, x, lengths)
        seconds = timed(dec, att_test)
        out[f"attention_{tag}"] = {"frames_per_s": frames / seconds, "steps": dec.steps,
                                   **{f"{part}_ms": v * 1e3 for part, v in dec.seconds.items()}}
        del dec

    # the CTC beam 16 with the FusionScorer
    ctc = nnet("ctc", "_lm", lm_path=arpa, lm_alpha=0.5)
    out["ctc_beam16_lm"] = {"frames_per_s": frames / timed(ctc.load_text_decoder(coder), ctc_test, ctc.context_width)}
    log(f"text decodes of the test set ({frames} frames): {json.dumps(out)} [{card}]")
    return out


def time_streaming(card: str, models: dict) -> dict:
    """``cli.serve --stream`` with the transducer recipe as written (beam
    8, 16 slots) and 16 clients over the 32 test wavs in 100 ms chunks:
    the clients' chunk reply p50 / p95, the engine's tick p50 against the
    chunk period, ticks, rows a tick and the real-time factor."""
    from configparser import ConfigParser

    import numpy as np

    from tfkaldi_tpu_torch.io import read_wav, read_wavfiles

    config = ConfigParser()
    config.read(models["ws"]["cfg_path"])
    wavs = read_wavfiles(os.path.join(config.get("directories", "test_data"), "wav.scp"))
    audio = [np.asarray(read_wav(path)[1], np.float32) for path in wavs.values()]
    with card_support.stream_server(models["transducer"][0], "--device", "cuda") as (host, port, server):
        server.tick_durations.clear()
        ticks, rows = server.ticks, server.rows_pushed
        res = card_support.stream_clients(host, port, audio, 16)
        ticks, rows, tick_s = server.ticks - ticks, server.rows_pushed - rows, list(server.tick_durations)
    audio_s = sum(len(a) for a in audio) / 16000

    def pct(values, q):
        return float(np.percentile(np.asarray(values, np.float64), q)) * 1e3 if len(values) else None

    out = {"streams": 16, "slots": server.num_slots, "chunk_ms": card_support.STREAM_CHUNK / 16, "audio_s": audio_s,
           "chunk_reply_p50_ms": pct(res["chunk_s"], 50), "chunk_reply_p95_ms": pct(res["chunk_s"], 95),
           "finish_reply_p50_ms": pct(res["finish_s"], 50), "tick_p50_ms": pct(tick_s, 50), "ticks": ticks,
           "rows_a_tick": rows / max(ticks, 1), "rtf": res["wall_s"] / audio_s}
    log(f"streaming transducer beam 8: {json.dumps(out)} [{card}]")
    return out


def suite_models() -> dict:
    """The training workspace, the attention featdirs and the models of
    TIMED_RECIPES as the card suite's runs of this process left them."""
    runs = card_support.RUNS
    missing = [kind for kind in ("dnn", *TIMED_RECIPES) if kind not in runs]
    if missing:
        raise RuntimeError(f"the card suite ran no {missing} in this process: step 3 times its models")
    att = card_support.workspace(runs["attention"].cfg_path)
    return {"ws": card_support.workspace(runs["dnn"].cfg_path),
            "att_dirs": {"train": att["train_featdir"], "test": att["test_featdir"]},
            **{kind: (runs[kind].cfg_path, runs[kind].savedir) for kind in TIMED_RECIPES}}


def time_paths(card: str) -> dict:
    from configparser import ConfigParser

    import torch

    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.models import RNNConfig
    from tfkaldi_tpu_torch.train import checkpoint as ckpt
    from tfkaldi_tpu_torch.train import ctc as ctc_loss
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

    models = suite_models()
    ws = models["ws"]
    os.makedirs(WORK, exist_ok=True)
    arpa = os.path.join(WORK, "char3.arpa")
    synthetic.write_char_arpa(arpa, [os.path.join(ws["train_featdir"], "text"),
                                     os.path.join(models["att_dirs"]["train"], "text")])
    out = {}
    for kind in ("lstm", "gru", "ctc"):
        config = ConfigParser()
        config.read(models[kind][0])
        conf = dict(config.items("nnet"))
        context = int(conf["context_width"])
        ctc = kind == "ctc"
        num_out = card_support.CTC_CLASSES if ctc else card_support.NUM_PDFS
        rcfg = RNNConfig.from_config(conf, 40 * (2 * context + 1), num_out)
        tcfg = TrainerConfig(num_steps=6, loss_type="ctc", ctc_blank_id=num_out - 1) if ctc else TrainerConfig(
            num_steps=6)
        batch = card_support.train_batch(ws["train_featdir"], conf, text=ctc, context=context,
                                         alifile=None if ctc else card_support.alifile_of(config)).to("cuda")
        trainer = Trainer(rcfg, tcfg, device="cuda")
        state = ckpt.restore_state(os.path.join(models[kind][1], "training", "step2.pt"), trainer.init_state(0))
        loss_parts = {}
        if ctc:  # the CTC loss, forward and backward, on the step's logits
            with torch.no_grad():
                logits = state.model(batch.inputs, batch.input_lengths, train=True,
                                     generator=trainer.dropout_generator(state)).float()
            host = [ctc_loss.host(a) for a in (batch.input_lengths, batch.targets, batch.target_lengths)]

            def loss_step():
                x = logits.clone().requires_grad_(True)
                ctc_loss.ctc_loss(x, *host, num_out - 1).sum().backward()

            loss_parts["CTC loss"] = step_ms(loss_step, 5)
        tag = {"lstm": "BiLSTM", "gru": "BiGRU", "ctc": "CTC BiLSTM"}[kind]
        out[f"{kind}_step"] = time_rnn_step(card, tag, "gru" if kind == "gru" else "lstm", trainer, state, batch,
                                            num_out, loss_parts)
        del trainer, state, batch
        torch.cuda.empty_cache()
    out["attention_step"] = time_attention_step(card, *models["attention"], models["att_dirs"]["train"])
    out["text_decodes"] = time_text_decodes(card, models, arpa)
    out["streaming"] = time_streaming(card, models)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    from tfkaldi_tpu_torch.device import resolve_device
    from tfkaldi_tpu_torch.ops import _build

    resolve_device("cuda")
    t0 = time.perf_counter()
    _build.load()
    result = {"card": card, "build_s": time.perf_counter() - t0, "peaks": {**PEAKS, "bytes": PEAK_BYTES}}
    t0 = time.perf_counter()
    result["kernels"] = time_ffn(card) + time_frame(card) + time_bn(card) + time_rnn(card) + time_split(card)
    result["kernels_s"] = time.perf_counter() - t0
    rc, result["suite"] = run_suite(SUITE_FILES)
    log(f"the card suite ({len(SUITE_FILES)} files): rc {rc}, {json.dumps(result['suite'])} [{card}]")
    if rc != 0:
        log("chip_smoke: the card suite failed")
        return rc
    result["path_launches"] = path_launches()
    log(f"the main paths' launches by route: {json.dumps(result['path_launches'])}")
    for row in result["kernels"]:
        row["path_launches"] = result["path_launches"]["totals"].get(row_key(row), {})
    t0 = time.perf_counter()
    result["paths"] = time_paths(card)
    result["paths_s"] = time.perf_counter() - t0
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, the served
path, the training path in f32 and in bf16, the BiLSTM and BiGRU paths,
the character-CTC recipe, the joint CTC-attention conformer recipe, then
the conformer-transducer recipe.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi``); exits non-zero without CUDA.
2. Builds the CUDA kernels of ``tfkaldi_tpu_torch/ops/csrc`` (one nvcc per
   source, in parallel) and prints the build time.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes and times the kernel, the plain version and, where
   one exists, the PyTorch call that computes the same product
   (``library_ms``): fused FFN [N,440]x[440,2048] and
   [N,2048]x[2048,2048], N 8192 (the served path's decode batches) and
   65,536 (the training paths' validation batches), f32 and bf16; framing
   (kernel 2) 16 x 5 s and 16 x 8 s at 16 kHz, bit-equal on the bulk
   route and on the edge route (a misaligned view), each timed by its own
   device time (torch.profiler) beside the wrapper's time; BN backward
   (kernel 3) [65536,2048] with
   w [2048,2048] and [440,2048] and the dz-only launch of the first layer,
   f32 and bf16, and a bf16 case at N = 8192. Kernels 1 and 3 must take
   the TMA route of the GEMM core at all these shapes; each row prints its
   route, tile, grid and shared memory (``gemm_plan``); the recurrences (kernels 4-7) at one layer of the repo's
   BiLSTM/BiGRU, T 512, B 128, H 512, f32 and bf16, ragged lengths of
   204-512 frames with garbage in the padding: every output and residual,
   the backward alone on the plain residuals, and their times beside
   cuDNN's packed bidirectional LSTM/GRU (see ``check_rnn_kernels`` for
   the library yardstick); the forward's and the backward's routes
   (persistent, one launch per call), grids and time a step, and the
   backward's step route on the same inputs; kernels 4 and 5 again at the
   transducer's prediction network, one direction, T 129, B 128, H 320,
   beside cuDNN's unidirectional LSTM (``check_predictor_kernels``).
4. Drives the served path at full width (440 -> 6x2048 -> 2000, batchnorm)
   on a seeded synthetic workspace (32 + 32 wavs of 1-8 s, 4 speakers):
   ``cli.main --steps dnn_train_features,dnn_test_features``, then
   ``cli.main --steps test_nnet``, then ``cli.serve --once`` answering 3
   spool jobs. The kernels' launch counts are reset just before and read
   just after; the path's kernels must each be > 0, kernel 2's all on the
   bulk route.
5. Checks the outputs: every ark finite and of the right shape, features
   against the numpy oracle of the reference (tests/reference_port) and
   against the plain framing, likelihoods against the plain versions of
   both kernels on the same card.
6. Drives the training path at full width on a separate seeded workspace
   (800 train wavs of 2-5.1 s, so T_pad = 512 and a batch of 128 is
   65,536 frames; 32 test wavs; a pdf alignment over 2000 pdfs):
   ``cli.main --steps dnn_train_features,dnn_test_features,train_nnet,
   test_nnet`` with the recipe's ``[nnet]`` (6x2048 relu+BN, batch 128,
   valid_batches 2) and only num_epochs, valid_frequency and check_freq
   lowered. Counts reset before, read after: bn_dgrad launches = 6 per
   train step; the step-0 loss is ln 2000 (zero output layer); the ark
   covers the test set; kernel 3's launches are on the TMA route (layer 0: the dz pass
   alone), kernel 1's all on the TMA route, kernel 2's all on the bulk
   route. Then, from the step-2 checkpoint, with the kernels and with the
   plain versions: the validation loss over the validation batches (the number that decides a
   rollback) and the eval logits agree; one full-width step on one batch
   gives the same loss and gradients; and the step is timed by parts.
   The same again for bench.py's configuration, the DNN in bf16
   (``bf16_dnn_path``: ``cli.main --steps train_nnet,test_nnet`` with
   ``compute_dtype = bfloat16`` on the same features, its own savedir).
7. Drives the BiLSTM, then the BiGRU hybrid path at full width on the
   training workspace's features and alignments: ``cli.main --steps
   train_nnet,test_nnet`` with the ``[nnet]`` of config_AURORA4_ctc.cfg
   under frame CE (2 x 512 bidirectional, context 2, bf16, batch 128,
   dropout 0.8) and only num_epochs, valid_frequency and check_freq
   lowered. Counts reset before, read after: the backward kernel launches
   once per layer in each train step and the forward kernel once per layer
   call (training, validation and decode), both on the persistent route;
   step-0 loss ln 2000; the ark covers the test set and
   matches the plain versions' decode; one step from the step-2 checkpoint
   with the kernels and with the plain versions agrees; and the step is
   timed by parts (``rnn_train_path``, ``check_rnn_step``).
8. Drives the character-CTC recipe at full width on the training
   workspace's features and seeded transcripts: ``cli.main --steps
   train_nnet,test_nnet`` with the ``[nnet]`` of config_AURORA4_ctc.cfg as
   written (loss ctc, aurora4 normaliser, beam 16, the same BiLSTM) and the
   same three keys lowered. Counts reset before, read after: kernels 4 and
   5 as on the BiLSTM path, no other kernel, the CTC loss on its
   F.ctc_loss route, the beam on the native beam; the step-0 loss is the
   uniform-posterior value over 36 classes; the text decode covers the
   test set; CER and WER are printed. Then, kernels against the plain
   versions: the test set's log-posteriors, the greedy transcripts, one
   CTC step from the step-2 checkpoint, and the CTC loss's F.ctc_loss
   route against its plain recursion at the step's shape; greedy and
   beam-16 decode timed, and the step by parts with the CTC loss as its
   own part (``ctc_path``, ``check_ctc_step``).
9. Drives the joint CTC-attention conformer recipe at full width on the
   training workspace's features with transcripts of their own (at most
   T/8 labels, in featdirs beside the others): ``cli.main --steps
   train_nnet,test_nnet`` with the ``[nnet]`` of
   config_AURORA4_attention.cfg as written (12 x 256 conformer-s4, 4
   decoder blocks, ctc_weight 0.3, bf16, batch 128, dropout 0.9,
   average_last 5, rescoring decode with beam 10) and the same three keys
   lowered. Counts reset before, read after: no hand kernel (all seven
   counters 0), the CTC loss on its F.ctc_loss route only, pass 2 once per
   decode batch; the step-0 loss is the uniform-posterior value of both
   heads; the text decode covers the test set; CER and WER are printed.
   Then the test set's encoder memory, CTC log-posteriors and pass-2
   attention scores from ``final.pt`` on the card against the port on the
   CPU by the bf16 rule, the transcripts where the score margins allow;
   the rescoring decode timed by pass; one step timed by parts beside the
   model FLOPs (``attention_path``, ``check_attention``).
10. Drives the conformer-transducer recipe at full width on the attention
   phase's featdirs: ``cli.main --steps train_nnet,test_nnet`` with the
   ``[nnet]`` of config_AURORA4_transducer.cfg as written (12 x 256
   conformer-s4, 1 x 320 LSTM predictor, joint 320, the banded loss at S
   16, bf16, batch 128, dropout 0.9, average_last 5, beam 8) and the same
   three keys lowered. Counts reset before, read after, against the
   schedule printed before the run: the banded loss on every train and
   validation batch (22) and the dense route never; kernel 4 once per
   loss call (22) and kernel 5 once per train step (6), both persistent;
   the other counters 0; the decode covers the test set, CER and WER
   printed. Then a full-width band against the dense loss and the S 16
   band at or above it on every row, the card against the CPU on
   ``final.pt`` (encoder, band scores, per-row loss by the bf16 rule; the
   greedy and beam transcripts where the margins decide), greedy and
   beam-8 decode timed by encoder and search, and one step timed by parts
   beside the model FLOPs (``transducer_path``, ``check_transducer``).
11. Prints one JSON line of per-kernel results (all seven; kernels 4 and 5
   count the BiLSTM, the CTC and the transducer paths), then the final
   JSON line.

Any failure raises and exits non-zero; nothing is caught and passed over.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
TRAIN_WORK = os.path.join(ROOT, "build", "chip_smoke_train")
# 800 utterances: 2 validation batches of 128 and 4.25 training batches;
# num_batches = 800 / 128 = 6.25, so one epoch is 6 steps
TRAIN_UTTS = 800
TRAIN_NNET = {"num_epochs": 1, "valid_frequency": 2, "check_freq": 2}
# bench.py's DNN: the same [nnet] in bf16 (bench.py:48), in its own savedir
BF16_DNN_NNET = {"compute_dtype": "bfloat16", "name": "dnn_bf16"}

# full width of the flagship recipe (config/config_AURORA4.cfg, bench.py:22)
NUM_PDFS = 2000
HIDDEN_UNITS = 2048
HIDDEN_LAYERS = 6
FFN_TOL = {"float32": 1e-4, "bfloat16": 0.0625}  # see check_ffn
LIKE_TOL = 1e-3
# kernel 3 vs its plain version, max|diff| / max|ref| (see check_bn_dgrad)
BN_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# the validation pass and one training step, kernels vs plain versions
# (see check_train_step)
STEP_LOSS_TOL = 1e-5
BF16_STEP_TOL = 2e-2
STEP_GRAD_TOL = 1e-4
BN_BIAS_NOISE = 1e-2
# the recurrent layer of the repo's BiLSTM (config_AURORA4_ctc.cfg:75-108): T_pad, batch, hidden
RNN_SHAPE = (512, 128, 512)
RNN_LAYERS = 2
RNN_TRAIN_NNET = {"num_epochs": 1, "valid_frequency": 2, "check_freq": 2}
# kernels 4-7 vs their plain versions (see check_rnn_kernels, check_rnn_step)
RNN_F32_TOL = 1e-5
RNN_BF16_RATIO = 2.0
RNN_LOSS_TOL = 1e-4
# the character-CTC recipe (config_AURORA4_ctc.cfg as written, the same three keys lowered):
# 35 characters + the blank; the step-0 loss against the uniform-posterior value (relative);
# the CTC loss's F.ctc_loss route against its plain recursion (per-row loss relative, logit
# gradient absolute)
CTC_CLASSES = 36
CTC_STEP0_TOL = 1e-4
CTC_LOSS_TOL = 1e-5
# the joint CTC-attention recipe (config_AURORA4_attention.cfg as written, the same three keys
# lowered): 35 characters + SOS/EOS (also the CTC blank); transcripts of at most T/8 labels, so
# every row is feasible for the CTC head on every fourth frame
ATT_CLASSES = 36
ATT_TEXT_DENSITY = 8
# the conformer-transducer recipe (config_AURORA4_transducer.cfg as written, the same three keys
# lowered) on the attention phase's featdirs: 35 characters + the blank; its prediction network's
# recurrent layer, kernels 4 and 5 with one direction: T = U_pad + 1, B, H, and the 128-wide label
# embedding it reads; a full-width band against the dense loss, and the banded NLL's shortfall
# below the dense one, per row (relative, f32 compute)
RNNT_CLASSES = 36
PRED_SHAPE = (129, 128, 320)
PRED_WIDTH = 128
RNNT_TOL = 1e-5
# bench.py's TDNN and CNN (bench.py:163-222) on the training workspace: the CNN's f32 conv
# stack on the card against the CPU, max|diff| / max|ref| (f32 sums in another order; TF32 would
# give about 1e-3)
CONV_F32_TOL = 1e-4


def bf16_close(mine: float, theirs: float) -> bool:
    """The bf16 rule of check_rnn_kernels: the kernels' distance from the
    plain f32 result within RNN_BF16_RATIO of the plain bf16 version's, plus
    RNN_F32_TOL for an output the bf16 rounding hardly moves (there both
    distances are f32 rounding noise: the output bias's gradient read 1.1e-7
    against 5.5e-8 in the first run of this check)."""
    return mine <= RNN_BF16_RATIO * theirs + RNN_F32_TOL


def bf16_rounds(mine: float, theirs: float) -> bool:
    """The other side of the bf16 rule: against the plain version run in f32
    on the bf16-rounded weights, which lacks only the roundings of h and of
    the gate cotangents, the kernels' distance at least 1/RNN_BF16_RATIO of
    the plain bf16 version's, less RNN_F32_TOL. A kernel that skipped those
    roundings would sit near zero there."""
    return mine >= theirs / RNN_BF16_RATIO - RNN_F32_TOL
# H100 SXM peaks (NVIDIA data sheet): f32 and f64 outside the tensor cores, HBM
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_BF16 = 989e12  # dense, tensor cores
PEAK_BYTES = 3.35e12


def log(*parts) -> None:
    print(*parts, flush=True)


def ms_per_call(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def ms_median(fn, calls: int = 20, windows: int = 3) -> float:
    """ms a call: the median over ``windows`` windows of ``calls`` calls each
    (CUDA events around each window), after 3 warm-up calls. The
    recurrences and their library yardstick are timed so: a single short
    window let cuDNN's bf16 backward wander from run to run."""
    import statistics

    return statistics.median(ms_per_call(fn, iters=calls) for _ in range(windows))


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32) -> dict:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory rate."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def plan_text(plan) -> str:
    return (f"route {plan.route}, tile {plan.bm}x{plan.bn}x{plan.bk} x {plan.stages} stages, grid "
            f"{plan.grid[0]}x{plan.grid[1]} of {plan.threads} threads, {plan.smem_bytes} B of shared memory")


def check_plan(plan, dtype) -> None:
    """A recipe shape must take the TMA route, and the plan's shared memory
    must be the one the source sets (``tk_gemm_smem``)."""
    import torch

    from tfkaldi_tpu_torch.ops import _build

    if plan.route != "tma":
        raise AssertionError(f"a recipe shape took the {plan.route} route")
    want = _build.load().tk_gemm_smem(int(dtype == torch.bfloat16))
    if plan.smem_bytes != want:
        raise AssertionError(f"gemm_plan's shared memory {plan.smem_bytes} B, the source's {want} B")


def check_ffn(card: str) -> dict:
    """Kernel 1 vs plain at the DNN's layer shapes, f32 and bf16. f32: both
    contract in full f32 (TF32 off), differing only in summation order, so
    1e-4 absolute on O(1..10) outputs is far above the ~1e-6 seen and far
    below any wrong-tile error. bf16: outputs are rounded to bf16, whose
    spacing at the outputs' magnitude (< 16) is at most 0.0625; the two
    sides round f32 sums that differ in order, so they may land one spacing
    apart. Every case takes the TMA route (printed with its tile, grid and
    shared memory). Returns the rows of [8192,2048]x[2048,2048] per dtype."""
    import torch

    from tfkaldi_tpu_torch.ops import fused_mlp
    from tfkaldi_tpu_torch.ops.gemm_plan import gemm_plan

    gen = torch.Generator().manual_seed(0)
    rows = {}
    # the served path's decode batches and the training paths' validation
    # batches (whole 128 x 512 batches), f32 and bf16
    cases = [(n, k, dtype) for dtype in (torch.float32, torch.bfloat16) for n in (8192, 65536) for k in (440, 2048)]
    m = HIDDEN_UNITS
    for n, k, dtype in cases:
        x = torch.randn(n, k, generator=gen).to("cuda", dtype)
        w = (torch.randn(k, m, generator=gen) / k ** 0.5).to("cuda", dtype)
        b = (torch.randn(m, generator=gen) * 0.1).cuda()
        scale = (torch.rand(m, generator=gen) + 0.5).cuda()
        shift = (torch.randn(m, generator=gen) * 0.1).cuda()
        plan = gemm_plan(n, k, m, dtype, "mn", (x.data_ptr(), w.data_ptr()))
        check_plan(plan, dtype)
        before = fused_mlp.launches_by_route["tma"]
        got = fused_mlp.fused_ffn_block(x, w, b, scale, shift, relu=True)
        want = fused_mlp.fused_ffn_block_ref(x, w, b, scale, shift, relu=True)
        torch.cuda.synchronize()
        if fused_mlp.launches_by_route["tma"] != before + 1:
            raise AssertionError("fused_ffn did not launch on the TMA route")
        err = (got.float() - want.float()).abs().max().item()
        name = str(dtype).replace("torch.", "")
        kernel_ms = ms_per_call(lambda: fused_mlp.fused_ffn_block(x, w, b, scale, shift))
        plain_ms = ms_per_call(lambda: fused_mlp.fused_ffn_block_ref(x, w, b, scale, shift))
        # the yardstick: the product alone (bf16 on the tensor cores)
        library_ms = ms_per_call(lambda: torch.matmul(x, w))
        b_ = bound(2 * n * k * m + 4 * n * m, nbytes(x, w, b, scale, shift, got),
                   PEAK_F32 if dtype == torch.float32 else PEAK_BF16)
        log(f"fused_ffn [{n},{k}]x[{k},{m}] {name}: max|diff| {err!r} (tol {FFN_TOL[name]}), "
            f"kernel {kernel_ms!r} ms, plain {plain_ms!r} ms, library (torch.matmul) "
            f"{library_ms!r} ms ({kernel_ms / library_ms!r}x), bound {b_['bound_ms']!r} ms by {b_['bound_by']}; "
            f"{plan_text(plan)} [{card}]")
        if not err <= FFN_TOL[name]:
            raise AssertionError(f"fused_ffn {name} [{n},{k},{m}]: max|diff| {err} > {FFN_TOL[name]}")
        if (n, k) == (8192, 2048):  # the served path's dominant layer
            rows[name] = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, **b_}
        del x, w, got, want
        torch.cuda.empty_cache()
    return rows


def check_framing(card: str) -> dict:
    """Kernel 2 vs its plain version, bit-equal (both round x - c*prev twice
    in f64, no FMA), at ``profile_frame.SHAPES``: 16 x 5 s at 16 kHz (the
    row of the kernels line) and 16 x 8 s, the longest bucket the served
    run pads to. At each shape: route ``bulk`` as planned, and route
    ``edge`` on the same samples one float into their buffer (a view the
    bulk copy cannot read); each launch counted on its route, and each
    plan's shared memory the source's (``tk_frame_smem``). Times: each
    route's own device time (``profile_frame.device_ms``: torch.profiler's
    events of the kernel over 20 calls, summed, over their count); the
    wrapper's (CUDA events around 20 calls, the median of 3 windows; where
    the host enqueues more slowly than the card runs, that is the host's
    time); the plain version's; the bound. Returns the first shape's row
    (``ms`` is the device time of the planned route), the other shape's
    readings under ``shapes``."""
    import torch

    from tfkaldi_tpu_torch import profile_frame as pf
    from tfkaldi_tpu_torch.ops import _build
    from tfkaldi_tpu_torch.ops import frame_preemph as fp

    lib = _build.load()
    rows = []
    for b, s in pf.SHAPES:
        sig, eff, args = pf.inputs(b, s)
        t_max, wl, ws = args["t_max"], args["frame_len"], args["frame_step"]
        want = fp.frame_preemph_ref(sig, eff, **args)
        shifted = torch.empty(b * s + 1, device="cuda")
        shifted[1:].copy_(sig.reshape(-1))
        views = {"bulk": sig, "edge": shifted[1:].view(b, s)}
        plans = {name: fp.plan_for(x, want, t_max, wl, ws) for name, x in views.items()}
        if [p.route for p in plans.values()] != list(plans):
            raise AssertionError(f"frame_plan at [{b},{s}]: {plans}")
        device, errs = {}, {}
        for name, plan in plans.items():
            if plan.smem_bytes != lib.tk_frame_smem(wl, ws, plan.frames, plan.code):
                raise AssertionError(f"frame_plan's shared memory {plan.smem_bytes} B is not the source's: {plan}")
            x = views[name]
            before = dict(fp.launches_by_route)
            got = fp.frame_preemph(x, eff, **args)
            torch.cuda.synchronize()
            if fp.launches_by_route != {**before, plan.route: before[plan.route] + 1}:
                raise AssertionError(f"frame_preemph {name}: launch not counted on route {plan.route}")
            errs[name] = (got - want).abs().max().item()
            if not torch.equal(got, want):
                raise AssertionError(f"frame_preemph {name} [{b},{s}] differs from the plain version "
                                     f"(max|diff| {errs[name]})")
            device[name], _ = pf.device_ms(lambda: fp.frame_preemph(x, eff, **args))
            log(f"frame_preemph [{b},{s}] -> [{b},{t_max},{wl}] f64, {name}: bit-equal, device "
                f"{device[name]!r} ms; route {plan.route}, {plan.frames} frames a tile, "
                f"{plan.tiles} tiles on {plan.grid} CTAs of {plan.threads}, {plan.smem_bytes} B of shared memory "
                f"[{card}]")
        wrapper_ms = ms_median(lambda: fp.frame_preemph(sig, eff, **args))
        plain_ms = ms_median(lambda: fp.frame_preemph_ref(sig, eff, **args))
        b_ = bound(2 * b * s, nbytes(sig, eff, want), PEAK_F64)
        log(f"frame_preemph [{b},{s}]: device {device['bulk']!r} ms ({b_['bound_ms'] / device['bulk']!r} of the "
            f"bound), wrapper {wrapper_ms!r} ms, plain {plain_ms!r} ms, bound {b_['bound_ms']!r} ms by "
            f"{b_['bound_by']}; edge route {device['edge']!r} ms [{card}]")
        rows.append({"max_abs_err": max(errs.values()), "ms": device["bulk"], "plain_ms": plain_ms, "library_ms": None,
                     **b_, "wrapper_ms": wrapper_ms, "edge_ms": device["edge"], "shape": [b, s, t_max, wl]})
        del sig, eff, want, got, shifted, views
        torch.cuda.empty_cache()
    return {**rows[0], "shapes": rows[1:]}


def check_frame_routes(tag: str) -> dict:
    """A feature path's kernel-2 launches by route: prepare_data pads to
    whole seconds, so every launch takes the bulk route."""
    from tfkaldi_tpu_torch.ops import frame_preemph as fp

    routes = dict(fp.launches_by_route)
    log(f"{tag}: frame_preemph launches by route {routes}")
    if not (routes["bulk"] > 0 and routes["edge"] == 0):
        raise AssertionError(f"{tag}: frame_preemph routes {routes}, want all on bulk")
    return routes


def check_bn_dgrad(card: str) -> tuple[dict, dict]:
    """Kernel 3 vs plain at the training step's shapes (N = 128 x 512
    frames), f32 and bf16: w [2048,2048] and [440,2048] with dh, and the
    dz-only launch of the first layer; bf16 also at N = 8192, the shape of
    earlier runs. dz is the same f32 arithmetic in the same order on both
    sides (no FMA contraction), dh a 2048- or 440-term f32 sum in another
    order: 1e-5 of max|ref| is far above that and far below any wrong-tile
    error. bf16: both round f32 values that may differ in the last bits to
    bf16, so they may land one bf16 step (2^-7 of the largest magnitude)
    apart. Every case takes the vector dz pass and, with dh, the TMA route.
    ``library_ms`` is ``torch.matmul(dz, w.t())`` alone, the product without
    the dz pass. Returns the rows of w [2048,2048] and the dz-only times,
    per dtype."""
    import torch

    from tfkaldi_tpu_torch.ops import bn_fused_bwd as bf
    from tfkaldi_tpu_torch.ops.gemm_plan import gemm_plan

    gen = torch.Generator().manual_seed(2)
    rows, dz_only_ms = {}, {}
    cases = [(65536, 2048, k, dtype, need_dh) for dtype in (torch.float32, torch.bfloat16)
             for k, need_dh in ((2048, True), (440, True), (440, False))]
    cases.append((8192, 2048, 2048, torch.bfloat16, True))
    for n, h, k, dtype, need_dh in cases:
        mask = (torch.arange(n) % 512 < 400).float().cuda()  # 400 real frames of 512
        g = (torch.randn(n, h, generator=gen).cuda() * mask[:, None] * 1e-3).to(dtype)
        z = torch.randn(n, h, generator=gen).to("cuda", dtype)
        w = (torch.randn(k, h, generator=gen) / h ** 0.5).cuda()
        mean = (torch.randn(h, generator=gen) * 0.1).cuda()
        r = (torch.rand(h, generator=gen) + 0.5).cuda()
        beta = (torch.randn(h, generator=gen) * 0.1).cuda()
        c1 = (torch.randn(h, generator=gen) * 1e-5).cuda()
        c2 = (torch.randn(h, generator=gen) * 1e-5).cuda()
        args = (g, z, mask, w, mean, r, beta, c1, c2)
        wt = w.to(dtype)
        route = "tma" if need_dh else "dz"
        before = bf.launches_by_route[route]
        dh, dz = bf.bn_dgrad(*args, need_dh=need_dh)
        dh0, dz0 = bf.bn_dgrad_ref(*args, dtype, need_dh=need_dh)
        torch.cuda.synchronize()
        if bf.launches_by_route[route] != before + 1:
            raise AssertionError(f"bn_dgrad did not launch on the {route} route")
        plan_note = "dz pass alone"
        if need_dh:
            plan = gemm_plan(n, h, k, dtype, "k", (dz.data_ptr(), wt.data_ptr()))
            check_plan(plan, dtype)
            plan_note = "dz pass, then the product on " + plan_text(plan)
        name = str(dtype).replace("torch.", "")
        errs = {"dz": (dz.float() - dz0.float()).abs().max().item()}
        if need_dh:
            errs["dh"] = (dh.float() - dh0.float()).abs().max().item()
        rel = max(errs["dz"] / dz0.float().abs().max().item(),
                  errs.get("dh", 0.0) / (dh0.float().abs().max().item() if need_dh else 1.0))
        kernel_ms = ms_per_call(lambda: bf.bn_dgrad(*args, need_dh=need_dh))
        plain_ms = ms_per_call(lambda: bf.bn_dgrad_ref(*args, dtype, need_dh=need_dh))
        library_ms = ms_per_call(lambda: torch.matmul(dz0, wt.t())) if need_dh else None
        flops = (2 * n * h * k if need_dh else 0) + 10 * n * h
        b_ = bound(flops, nbytes(g, z, mask, wt if need_dh else None, mean, r, beta, c1, c2, dz, dh),
                   PEAK_F32 if dtype == torch.float32 else PEAK_BF16)
        ratio = f" ({kernel_ms / library_ms!r}x)" if need_dh else ""
        log(f"bn_dgrad g,z [{n},{h}] w [{k},{h}] {name}{'' if need_dh else ' (dz only)'}: "
            f"max|diff| {errs!r}, /max|ref| {rel!r} (tol {BN_TOL[name]}), kernel {kernel_ms!r} ms, "
            f"plain {plain_ms!r} ms, library {library_ms!r} ms{ratio}, bound {b_['bound_ms']!r} ms by "
            f"{b_['bound_by']}; {plan_note} [{card}]")
        if not rel <= BN_TOL[name] or not torch.equal(dz, dz0):
            raise AssertionError(f"bn_dgrad {name} [{n},{h},{k}]: {errs} (/max|ref| {rel}) > {BN_TOL[name]} "
                                 f"or dz not bit-equal")
        if (n, k, need_dh) == (65536, 2048, True):  # 5 of the 6 launches of a step
            rows[name] = {"max_abs_err": max(errs.values()), "ms": kernel_ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, **b_}
        if not need_dh:  # the first layer's launch
            dz_only_ms[name] = kernel_ms
        del args, g, z, dh, dz, dh0, dz0
        torch.cuda.empty_cache()
    return rows, dz_only_ms


def _rnn_cell(cell: str):
    """The ``rnn_bidi.Cell`` of a recurrence: its kernels, plain versions
    and launch counts."""
    from tfkaldi_tpu_torch.ops import gru_bidi, lstm_bidi

    return lstm_bidi.CELL if cell == "lstm" else gru_bidi.CELL


def cudnn_rnn(cell: str, width: int, h: int, cd, *, flat: bool = True, dirs: int = 2):
    """cuDNN's bidirectional (``dirs = 2``) or unidirectional LSTM/GRU
    (``width`` inputs, ``h`` units) in the compute dtype ``cd``, its weights compacted once into cuDNN's flat
    buffer. ``flatten_parameters`` skips bf16, which is not in
    ``torch.backends.cudnn.CUDNN_TENSOR_DTYPES`` though cuDNN runs it, and
    a module so left re-compacts its weights on every call (RNN.cpp's
    UserWarning); the same torch call ``flatten_parameters`` makes, without
    that dtype gate, compacts them here. ``flat=False`` leaves them as they
    are, the yardstick this harness had before."""
    import torch
    from torch.backends.cudnn import rnn as cudnn

    lib = (torch.nn.LSTM if cell == "lstm" else torch.nn.GRU)(width, h, bidirectional=dirs == 2).to("cuda", cd)
    if flat:
        with torch.no_grad():
            torch._cudnn_rnn_flatten_weight(lib._flat_weights, 4, lib.input_size, cudnn.get_cudnn_mode(lib.mode),
                                            lib.hidden_size, lib.proj_size, lib.num_layers, lib.batch_first,
                                            bool(lib.bidirectional))
    return lib


def cudnn_times(lib, x, lengths) -> tuple[float, float, bool]:
    """(forward ms, backward ms, whether a call re-compacts the weights) of
    a cuDNN module on a packed batch, by ``ms_median``; the backward is one
    ``torch.autograd.grad`` call for the input and every weight."""
    import warnings

    import torch

    packed = torch.nn.utils.rnn.pack_padded_sequence(x, lengths, enforce_sorted=False)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = lib(packed)[0].data
    compacts = any("contiguous chunk" in str(w.message) for w in seen)
    fwd_ms = ms_median(lambda: lib(packed))
    cot = torch.randn_like(out)
    wrt = [x, *lib.parameters()]
    bwd_ms = ms_median(lambda: torch.autograd.grad(out, wrt, cot, retain_graph=True))
    return fwd_ms, bwd_ms, compacts


def _rnn_chain(cell: str, gxs, whs, mask, dys, cd, *, kernel: bool, residuals=None) -> dict:
    """Forward with residuals, backward and dW_h of both directions, through
    the kernels or their plain versions; with ``residuals`` given, only the
    backward runs, on them. Returns every output by name, per direction."""
    from tfkaldi_tpu_torch.ops.lstm_scan import weight_grad

    c = _rnn_cell(cell)
    whs_cd = [w.to(cd) for w in whs]
    out = {}
    if residuals is None:
        outs = (c.fwd if kernel else c.fwd_ref)(gxs, whs_cd, mask, residuals=True)
        residuals = [res for _, res in outs]
        out["ys"] = [ys for ys, _ in outs]
        names = ("acts", "cs", "h_cd") if cell == "lstm" else ("acts", "hs", "h_cd", "gh_n")
        for i, name in enumerate(names):
            out[name] = [res[i] for res in residuals]
    grads = (c.bwd if kernel else c.bwd_ref)(dys, residuals, mask, whs_cd)
    out["dgx"] = [g for g, _ in grads]
    if cell == "gru":
        out["dgh"] = [g for _, g in grads]
    out["dW_h"] = [weight_grad(res[2], g, cd) for res, (_, g) in zip(residuals, grads)]
    out["_residuals"] = residuals
    return out


def _rel(got: dict, ref: dict) -> dict:
    """max|got - ref| / max|ref| per output (the worse direction)."""
    return {name: max(((g.float() - r.float()).abs().max() / r.float().abs().max().clamp(min=1e-30)).item()
                      for g, r in zip(got[name], ref[name]))
            for name in ref if not name.startswith("_")}


def check_rnn_kernels(card: str, cell: str, shape=RNN_SHAPE, dirs: int = 2, width: int | None = None) -> dict:
    """Kernels 4 and 5 (LSTM) or 6 and 7 (GRU) against their plain versions
    on the card at one BiLSTM/BiGRU layer of the recipe (``shape`` T 512,
    B 128, H 512, ``dirs`` 2; or another layer, such as the transducer's
    one-direction prediction network, [129, 128, 320] with 1), with ragged
    lengths of 2/5 T to T frames and garbage (7.7) in the padding of gx;
    every output: ys, each residual, dgx (and dgh), dW_h.

    - f32: the kernels and the plain versions differ only in the summation
      order of the recurrent products, so every output within RNN_F32_TOL
      (1e-5) of its max|ref| (measured at most 1.8e-6 in the first chip run
      of these kernels).
    - bf16: h (forward) and dgates/dgh (backward) are rounded to bf16 at
      each of 512 steps; an f32 sum in another order can land on the other
      side of a rounding boundary, and that one-step difference then
      travels on through the recurrence. The yardstick is the effect of the
      bf16 rounding itself: each output of the kernels, against the plain
      version run in f32, must lie within RNN_BF16_RATIO (2x) of the plain
      bf16 version's own distance from it (the rule the DNN's bf16 card
      gradients are held to), plus RNN_F32_TOL (``bf16_close``). And the
      kernels must round as the plain version does: against the plain
      version run in f32 on the bf16-rounded weights (no rounding of h or
      dgates), each output's distance at least half of the plain bf16
      version's, less RNN_F32_TOL (``bf16_rounds``). The direct
      kernel-vs-plain distance is printed.
    - The backward alone, on the plain forward's residuals (so kernel 5 or 7
      sees the plain version's inputs): the same rules.

    Times (CUDA events; the kernels and the library call by ``ms_median``,
    the plain versions over 2 calls): the kernels, the plain versions, and
    the library call, cuDNN's LSTM/GRU of the same directions on a packed
    batch of the same lengths, whose forward includes its own input
    projection (input ``width`` wide, by default 2H, the second layer's)
    and whose backward (one
    ``torch.autograd.grad`` call) its input and weight gradients. The
    forward and the backward must take the persistent route (one launch
    per call); each route, grid and shared memory is printed with its time
    at T 1 and the time a step after it, and the backward's step route
    (``STEP_BWD``, one launch per time step) is timed on the
    same inputs. Returns the bf16 rows (the recipe's compute dtype) of both
    kernels."""
    import torch

    from tfkaldi_tpu_torch.ops.rnn_bidi import STEP_BWD, bwd_plan, fwd_plan

    c = _rnn_cell(cell)
    gates = c.gates
    t, b, h = shape
    width = width or 2 * h
    gen = torch.Generator().manual_seed(5 if cell == "lstm" else 6)
    lengths = torch.randint(t * 2 // 5, t + 1, (b,), generator=gen)  # 204-512 frames at T 512
    lengths[0] = t
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[:, :, None].cuda()
    gxs = [torch.randn(t, b, gates * h, generator=gen).cuda() for _ in range(dirs)]
    for gx in gxs:
        gx[mask[:, :, 0] == 0] = 7.7  # garbage in the padding must not leak
    whs = [(torch.randn(h, gates * h, generator=gen) / h ** 0.5).cuda() for _ in range(dirs)]
    dys = [torch.randn(t, b, h, generator=gen).cuda() for _ in range(dirs)]
    frames = int(lengths.sum())
    ref32 = _rnn_chain(cell, gxs, whs, mask, dys, torch.float32, kernel=False)
    whs_rounded = [w.bfloat16().float() for w in whs]  # bf16 values, f32 compute
    rows = {}
    for cd in (torch.float32, torch.bfloat16):
        name = str(cd).replace("torch.", "")
        got = _rnn_chain(cell, gxs, whs, mask, dys, cd, kernel=True)
        plain = ref32 if cd == torch.float32 else _rnn_chain(cell, gxs, whs, mask, dys, cd, kernel=False)
        same_in = _rnn_chain(cell, gxs, whs, mask, dys, cd, kernel=True, residuals=plain["_residuals"])
        torch.cuda.synchronize()
        direct = _rel(got, plain)
        bwd_direct = _rel(same_in, {k: plain[k] for k in same_in if not k.startswith("_")})
        if cd == torch.float32:
            verdict = {k: v <= RNN_F32_TOL for k, v in {**direct, **bwd_direct}.items()}
            log(f"{cell} kernels [{t},{b},{h}] f32, kernels vs plain max|diff|/max|ref|: chain {direct!r}, "
                f"backward on the plain residuals {bwd_direct!r} (tol {RNN_F32_TOL})")
        else:
            plain_err = _rel(plain, ref32)
            chain = _rel(got, ref32)
            back = _rel(same_in, {k: ref32[k] for k in same_in if not k.startswith("_")})
            back_plain = {k: plain_err[k] for k in back}
            verdict = {k: bf16_close(chain[k], plain_err[k]) for k in chain}
            verdict.update({f"bwd {k}": bf16_close(back[k], back_plain[k]) for k in back})
            # the lower side: against f32 compute on the rounded weights, the whole
            # chain, and the backward alone on the plain residuals
            unrounded = _rnn_chain(cell, gxs, whs_rounded, mask, dys, torch.float32, kernel=False)
            rounds, rounds_plain = _rel(got, unrounded), _rel(plain, unrounded)
            unrounded = _rnn_chain(cell, gxs, whs_rounded, mask, dys, torch.float32, kernel=False,
                                   residuals=plain["_residuals"])
            rounds_bwd = _rel(same_in, {k: unrounded[k] for k in same_in if not k.startswith("_")})
            rounds_bwd_plain = _rel({k: plain[k] for k in rounds_bwd}, {k: unrounded[k] for k in rounds_bwd})
            del unrounded
            verdict.update({f"rounds {k}": bf16_rounds(rounds[k], rounds_plain[k]) for k in rounds})
            verdict.update({f"rounds bwd {k}": bf16_rounds(rounds_bwd[k], rounds_bwd_plain[k])
                            for k in rounds_bwd})
            log(f"{cell} kernels [{t},{b},{h}] bf16, distance from the plain f32 run (/max|ref|): kernels "
                f"{chain!r}, plain bf16 {plain_err!r} (each kernel value within {RNN_BF16_RATIO}x of the plain "
                f"one + {RNN_F32_TOL}); backward on the plain residuals {back!r}; distance from the plain f32 "
                f"run on the bf16 weights (no rounding of h or dgates): kernels {rounds!r}, plain bf16 "
                f"{rounds_plain!r}, backward alone {rounds_bwd!r} vs {rounds_bwd_plain!r} (each kernel value at "
                f"least 1/{RNN_BF16_RATIO} of the plain one - {RNN_F32_TOL}); kernels vs plain bf16 directly "
                f"{direct!r}, backward alone {bwd_direct!r}")
        if not all(verdict.values()):
            raise AssertionError(f"{cell} kernels {name}: outside tolerance: "
                                 f"{[k for k, ok in verdict.items() if not ok]}")
        del same_in

        # times at the recipe's shapes, residuals on (the training forward)
        whs_cd = [w.to(cd) for w in whs]
        res = got["_residuals"]
        plan, bplan = fwd_plan(b, h, gates, cd, dirs), bwd_plan(b, h, gates, cd, dirs)
        if (plan.route, bplan.route) != ("persistent", "persistent"):
            raise AssertionError(f"{cell} {name}: the recipe's shape takes the {plan.route} forward and the "
                                 f"{bplan.route} backward")
        fwd_ms = ms_median(lambda: c.fwd(gxs, whs_cd, mask, residuals=True))
        eval_ms = ms_median(lambda: c.fwd(gxs, whs_cd, mask, residuals=False))
        # a persistent call at T 1 (launch, W_h slice load, one step without
        # product or barrier), and the time a step after it
        one_ms = ms_median(lambda: c.fwd([x[:1] for x in gxs], whs_cd, mask[:1], residuals=True))
        step_us = (fwd_ms - one_ms) / (t - 1) * 1e3
        bwd_ms = ms_median(lambda: c.bwd(dys, res, mask, whs_cd))
        res1 = [tuple(x_[:1] for x_ in r) for r in res]
        bwd_one_ms = ms_median(lambda: c.bwd([d[:1] for d in dys], res1, mask[:1], whs_cd))
        bwd_step_us = (bwd_ms - bwd_one_ms) / (t - 1) * 1e3
        # the step route's library entry on the same inputs, one launch per time step
        bwd_steps_ms = ms_median(lambda: c.bwd(dys, res, mask, whs_cd, plan=STEP_BWD))
        plain_fwd_ms = ms_per_call(lambda: c.fwd_ref(gxs, whs_cd, mask, residuals=True), iters=2)
        plain_bwd_ms = ms_per_call(lambda: c.bwd_ref(dys, res, mask, whs_cd), iters=2)
        x = torch.randn(t, b, width, device="cuda", dtype=cd, requires_grad=True)
        lib_fwd_ms, lib_bwd_ms, compacts = cudnn_times(cudnn_rnn(cell, width, h, cd, dirs=dirs), x, lengths)
        if compacts:
            raise AssertionError(f"cuDNN {cell} {name}: the flattened module still re-compacts its weights")
        # the yardstick as it was: bf16 weights left where the module made them
        loose = (cudnn_times(cudnn_rnn(cell, width, h, cd, flat=False, dirs=dirs), x, lengths)
                 if cd == torch.bfloat16 and dirs == 2 else None)
        peak = PEAK_F32 if cd == torch.float32 else PEAK_BF16
        # the work these lengths need: the recurrent product and the gate math
        # of the real frames of every direction; the forward writes every
        # residual, the backward reads all but h_cd (res[2], which only the
        # weight gradient outside the kernel reads)
        mm_flops = dirs * 2 * frames * h * gates * h
        fwd_b = bound(mm_flops + dirs * frames * 12 * h,
                      nbytes(*gxs, *whs_cd, mask[:, :, 0], *got["ys"], *(x_ for r in res for x_ in r)), peak)
        bwd_read = [x_ for r in res for i, x_ in enumerate(r) if i != 2]
        bwd_b = bound(mm_flops + dirs * frames * 20 * h,
                      nbytes(*dys, *bwd_read, *whs_cd, mask[:, :, 0], *got["dgx"], *got.get("dgh", [])), peak)
        log(f"{cell} kernels [{t},{b},{h}] {name} ({frames} real frames): forward {fwd_ms!r} ms "
            f"(eval, no residuals, {eval_ms!r}), plain {plain_fwd_ms!r} ms, cuDNN {lib_fwd_ms!r} ms, bound "
            f"{fwd_b['bound_ms']!r} ms by {fwd_b['bound_by']}; backward {bwd_ms!r} ms, plain {plain_bwd_ms!r} "
            f"ms, cuDNN {lib_bwd_ms!r} ms, bound {bwd_b['bound_ms']!r} ms by {bwd_b['bound_by']} [{card}]")
        if loose is not None:
            log(f"cuDNN {cell} {name} with its weights left unflattened (re-compacted each call: "
                f"{loose[2]!r}): forward {loose[0]!r} ms, backward {loose[1]!r} ms [{card}]")
        for way, p_, one, per_step in (("forward", plan, one_ms, step_us), ("backward", bplan, bwd_one_ms,
                                                                            bwd_step_us)):
            log(f"{cell} {name} {way} route {p_.route}: {p_.ctas} CTAs ({p_.row_ctas} row CTAs x "
                f"{p_.tiles_per_cta} tile(s) of 64 rows per direction and 16-unit tile), {p_.smem_bytes} B of "
                f"shared memory a CTA; T 1 call {one!r} ms, {per_step!r} us a step after it [{card}]")
        log(f"{cell} {name} backward, persistent route {bwd_ms!r} ms vs the step route ({t} launches) "
            f"{bwd_steps_ms!r} ms on the same inputs [{card}]")
        if cd == torch.bfloat16:
            def max_abs(names):
                return max((g.float() - r.float()).abs().max().item()
                           for k in names if k in plain for g, r in zip(got[k], plain[k]))

            rows = {
                "fwd": {"max_abs_err": max_abs(("ys", "acts", "cs", "hs", "h_cd", "gh_n")), "ms": fwd_ms,
                        "plain_ms": plain_fwd_ms, "library_ms": lib_fwd_ms, **fwd_b, "plan_route": plan.route},
                "bwd": {"max_abs_err": max_abs(("dgx", "dgh", "dW_h")), "ms": bwd_ms,
                        "plain_ms": plain_bwd_ms, "library_ms": lib_bwd_ms, **bwd_b, "plan_route": bplan.route,
                        "step_route_ms": bwd_steps_ms},
            }
        del got, plain, res, x
        torch.cuda.empty_cache()
    return rows


def reset_counts() -> None:
    """Every kernel's launch counts to 0 (per route too), and the CTC loss's
    routes, the beam searches' runs, the rescoring counts and the RNN-T
    loss's routes, just before a path is driven."""
    from tfkaldi_tpu_torch.decode import ctc as ctc_decode
    from tfkaldi_tpu_torch.decode import seq2seq as seq2seq_decode
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp, gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops import frame_preemph as fp
    from tfkaldi_tpu_torch.train import ctc
    from tfkaldi_tpu_torch.train import trainer as trainer_mod

    fused_mlp.launches = fp.launches = bn_fused_bwd.launches = 0
    for counts in (fused_mlp.launches_by_route, bn_fused_bwd.launches_by_route, fp.launches_by_route,
                   ctc.launches_by_route, ctc_decode.beam_runs, seq2seq_decode.rescored, trainer_mod.rnnt_routes):
        for route in counts:
            counts[route] = 0
    for c in (lstm_bidi.CELL, gru_bidi.CELL):
        c.reset_counts()


def check_dnn_routes(tag: str, steps: int) -> None:
    """A DNN training path's kernel-1 and kernel-3 launches by route: every
    kernel-1 launch (validation, decode) on the TMA route; kernel 3 once per
    hidden layer per step, layers 1-5 on the TMA route and layer 0 (whose
    input needs no gradient) on the dz pass alone; no SIMT edge launch."""
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp

    ffn, bn = dict(fused_mlp.launches_by_route), dict(bn_fused_bwd.launches_by_route)
    log(f"{tag} launches by route: fused_ffn {ffn}, bn_dgrad {bn} ({steps} train steps)")
    if not (ffn["tma"] > 0 and ffn["simt"] == 0):
        raise AssertionError(f"{tag}: fused_ffn routes {ffn}, want all on tma")
    if bn != {"tma": (HIDDEN_LAYERS - 1) * steps, "dz": steps, "simt": 0}:
        raise AssertionError(f"{tag}: bn_dgrad routes {bn}, want tma {(HIDDEN_LAYERS - 1) * steps}, dz {steps}")


@contextlib.contextmanager
def plain_versions():
    """Route the paths' kernel call sites to their plain versions."""
    from tfkaldi_tpu_torch.frontend import features
    from tfkaldi_tpu_torch.models import dnn
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops import frame_preemph as fp
    from tfkaldi_tpu_torch.ops import fused_mlp

    saved = (features.frame_preemph, dnn.fused_ffn_block, bn_fused_bwd.bn_dgrad)
    features.frame_preemph = fp.frame_preemph_ref
    dnn.fused_ffn_block = fused_mlp.fused_ffn_block_ref
    bn_fused_bwd.bn_dgrad = bn_fused_bwd.bn_dgrad_ref
    cells = (lstm_bidi.CELL, gru_bidi.CELL)
    for c in cells:  # instance attributes over the Cell's methods
        c.fwd, c.bwd = c.fwd_ref, c.bwd_ref
    try:
        yield
    finally:
        features.frame_preemph, dnn.fused_ffn_block, bn_fused_bwd.bn_dgrad = saved
        for c in cells:
            del c.fwd, c.bwd


def train_path(card: str) -> tuple[dict, dict, dict]:
    """The training path at full width through the CLI; returns the launch
    counts of its run, kernel 2's by route, and the workspace."""
    import torch

    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.cli import main as cli_main
    from tfkaldi_tpu_torch.io import native
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp
    from tfkaldi_tpu_torch.ops import frame_preemph as fp

    shutil.rmtree(TRAIN_WORK, ignore_errors=True)
    os.makedirs(TRAIN_WORK)
    t0 = time.perf_counter()
    ws = synthetic.make_train_workspace(
        TRAIN_WORK, num_pdfs=NUM_PDFS, hidden_units=HIDDEN_UNITS, hidden_layers=HIDDEN_LAYERS,
        num_train=TRAIN_UTTS, num_test=32, min_seconds=2.0, max_seconds=5.1, nnet=TRAIN_NNET,
    )
    log(f"training workspace: {TRAIN_UTTS} + 32 wavs of 2-5.1 s, 440 -> {HIDDEN_LAYERS}x{HIDDEN_UNITS} "
        f"-> {NUM_PDFS}, [nnet] overrides {TRAIN_NNET}: {time.perf_counter() - t0!r} s")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli_main.main(["--config", ws["cfg_path"], "--steps",
                        "dnn_train_features,dnn_test_features,train_nnet,test_nnet"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main training path: rc {rc}")
    launches = {"fused_ffn": fused_mlp.launches, "frame_preemph": fp.launches,
                "bn_dgrad": bn_fused_bwd.launches}
    savedir = ws["savedir"]
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    log(f"training-path launches: {launches}; {len(steps)} train steps run "
        f"(replays after a rollback included); whole run {run_s!r} s")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the training path")
    if launches["bn_dgrad"] != HIDDEN_LAYERS * len(steps):
        raise AssertionError(f"bn_dgrad launched {launches['bn_dgrad']} times, want "
                             f"{HIDDEN_LAYERS} x {len(steps)} steps")
    check_dnn_routes("training path", len(steps))
    frame_routes = check_frame_routes("training path")
    check_cli_run(card, "training path", ws, savedir, steps,
                  f"; native ark loader (decode stream) in use: {native.available()}")
    return launches, frame_routes, ws


def check_cli_run(card: str, tag: str, ws: dict, savedir: str, steps: list, note: str = "") -> None:
    """What a ``train_nnet,test_nnet`` run through the CLI must leave in
    ``savedir``: a step-0 loss of ln 2000 (the output layer starts at zero),
    the prior and the checkpoints, and a likelihood ark that covers the test
    set with finite values of the right shape. Logs the median step on the
    host clock, with ``note`` appended."""
    import numpy as np

    loss0 = steps[0]["loss"]
    log(f"{tag} step-0 loss {loss0!r} vs ln {NUM_PDFS} = {math.log(NUM_PDFS)!r} (tol 1e-4; exact for the "
        f"zero output layer); losses {[round(st['loss'], 6) for st in steps]}")
    if not abs(loss0 - math.log(NUM_PDFS)) <= 1e-4:
        raise AssertionError(f"{tag}: step-0 loss {loss0} is not ln {NUM_PDFS}")
    warm = steps[1:]
    step_s = sorted(st["step_time"] for st in warm)[len(warm) // 2]
    frames = sorted(st["num_frames"] for st in warm)[len(warm) // 2]
    log(f"{tag} train step (median of {len(warm)} after the first, host clock, data wait included): "
        f"{step_s!r} s, {frames / step_s!r} frames/s at ~{frames} real frames a batch{note} [{card}]")
    prior = np.load(os.path.join(savedir, "prior.npy"))
    if prior.shape != (NUM_PDFS,) or not abs(float(prior.sum()) - 1.0) <= 1e-5:
        raise AssertionError(f"{tag} prior.npy: shape {prior.shape}, sum {prior.sum()}")
    for name in ("final.pt", os.path.join("training", "step2.pt"), os.path.join("training", "validated.pt")):
        if not os.path.isfile(os.path.join(savedir, name)):
            raise AssertionError(f"{tag}: training wrote no {name}")
    feats = read_ark(os.path.join(ws["test_featdir"], "feats.scp"))
    likes = read_ark(os.path.join(savedir, "decode", "feats.scp"))
    if list(likes) != list(feats):
        raise AssertionError(f"{tag} test_nnet: the likelihood ark does not cover the test set")
    for utt, m in likes.items():
        if m.shape != (feats[utt].shape[0], NUM_PDFS) or not np.isfinite(m).all():
            raise AssertionError(f"{tag} test_nnet {utt}: likelihoods shape {m.shape} or non-finite")
    log(f"{tag} test_nnet decoded the trained final.pt: {len(likes)} utterances, "
        f"{sum(m.shape[0] for m in likes.values())} frames, all finite")
    check_wfst(tag, ws["config"], savedir)


def bf16_dnn_path(card: str, ws: dict) -> tuple[dict, object, str]:
    """bench.py's configuration at full width through the CLI: the
    workspace's 440 -> 6x2048 relu+BN -> 2000 ``[nnet]`` with
    ``compute_dtype = bfloat16`` (bench.py:48) and its own savedir, ``cli.main
    --steps train_nnet,test_nnet`` on the training workspace's features and
    alignments, the same three keys lowered (6 steps). Counts reset before,
    read after: kernel 3 launches 6 per train step (layers 1-5 on the TMA
    route, layer 0 on the dz pass alone), every kernel-1 launch (validation,
    decode) on the TMA route; the step-0 loss is ln 2000; the ark covers the
    test set and is finite. Returns the launches, the config and the
    savedir."""
    from configparser import ConfigParser

    import torch

    from tfkaldi_tpu_torch.cli import main as cli_main
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp

    config = ConfigParser()
    config.read(ws["cfg_path"])
    for key, value in BF16_DNN_NNET.items():
        config.set("nnet", key, value)
    cfg_path = os.path.join(TRAIN_WORK, "config_dnn_bf16.cfg")
    with open(cfg_path, "w") as f:
        config.write(f)
    savedir = os.path.join(config.get("directories", "expdir"), BF16_DNN_NNET["name"])

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli_main.main(["--config", cfg_path, "--steps", "train_nnet,test_nnet"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main bf16 DNN path: rc {rc}")
    launches = {"fused_ffn": fused_mlp.launches, "bn_dgrad": bn_fused_bwd.launches}
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    log(f"bf16 DNN path launches: {launches}; {len(steps)} train steps (replays after a rollback included); "
        f"whole run {run_s!r} s")
    check_dnn_routes("bf16 DNN path", len(steps))  # kernel 3: 6 launches a step
    check_cli_run(card, "bf16 DNN path", ws, savedir, steps)
    return launches, config, savedir


def check_train_step(card: str, ws: dict, bn_ms: float, bn_dz_only_ms: float, config=None,
                     savedir: str | None = None) -> None:
    """From the step-2 checkpoint of ``savedir`` (the training path's by
    default) with ``config``'s ``[nnet]`` (the workspace's by default), with
    the kernels and through ``plain_versions()``:

    - the validation pass (``Trainer.evaluate`` over the run's validation
      batches, whose loss decides a rollback) runs the eval forward, six
      fused FFN launches per 65,536-row batch against cuBLAS: the loss
      within 1e-5 relative (f32 sums in another order), and the eval
      logits of the first batch within LIKE_TOL absolute;
    - one full-width training step on the first training batch. The
      forward is the same code on both sides, so the loss agrees to f32
      rounding (1e-5 relative). The gradients differ by the summation order
      of dh = dz @ w^T (kernel vs cuBLAS) carried back through six layers
      and their wgrads: every gradient within 1e-4 of its max|ref|, and the
      BN layers' bias gradients (exactly 0 in exact arithmetic) below
      BN_BIAS_NOISE of the layer's beta gradient on both sides.

    In bf16 each layer's output is rounded to bf16 on both sides from f32
    sums taken in another order, so an output can land one bf16 step apart
    (2^-8 relative) and carry on through the six layers: the validation
    loss and the eval logits (max|diff| / max|ref|) within BF16_STEP_TOL,
    and every gradient within BF16_STEP_TOL of its max|ref| (the tolerance
    of tests/test_torch_cuda_kernels.py's bf16 kernel-vs-plain step). The
    bias gradients there are sums of 65,536 bf16-rounded dz values on both
    sides; their ratio to the beta gradient is printed, not bounded.

    Then the step is timed by parts (CUDA events)."""
    import torch

    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.models.dnn import DNNConfig
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp
    from tfkaldi_tpu_torch.train import checkpoint as ckpt
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

    config = ws["config"] if config is None else config
    savedir = ws["savedir"] if savedir is None else savedir
    featdir = ws["train_featdir"]
    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    reader = FeatureReader(os.path.join(featdir, "feats_shuffled.scp"), os.path.join(featdir, "cmvn.scp"),
                           os.path.join(featdir, "utt2spk"), ws["context"], max_length)
    ali = os.path.join(config.get("directories", "expdir"), config.get("nnet", "gmm_name"), "ali", "pdf.all.gz")
    dispenser = AlignmentBatchDispenser(reader, AlignmentCoder(identity_normalizer, NUM_PDFS),
                                        config.getint("nnet", "batch_size"), ali)
    # the validation carve, then the first training batch
    val_batches = [dispenser.get_padded_batch(DeviceBatcher()).to("cuda")
                   for _ in range(config.getint("nnet", "valid_batches"))]
    batch = dispenser.get_padded_batch(DeviceBatcher()).to("cuda")
    reader.close()
    dcfg = DNNConfig.from_config(dict(config.items("nnet")), 440, NUM_PDFS)
    bf16 = dcfg.compute_dtype == torch.bfloat16
    tag = "bf16 DNN" if bf16 else "DNN"
    loss_tol, grad_tol = (BF16_STEP_TOL, BF16_STEP_TOL) if bf16 else (STEP_LOSS_TOL, STEP_GRAD_TOL)
    trainer = Trainer(dcfg, TrainerConfig(num_steps=6), device="cuda")
    state = ckpt.restore_state(os.path.join(savedir, "training", "step2.pt"), trainer.init_state(0))

    before = fused_mlp.launches
    val_loss = trainer.evaluate(state, val_batches)
    with torch.inference_mode():
        logits = state.model(val_batches[0].inputs)
    with plain_versions():
        val_loss0 = trainer.evaluate(state, val_batches)
        with torch.inference_mode():
            logits0 = state.model(val_batches[0].inputs)
    torch.cuda.synchronize()
    if fused_mlp.launches != before + HIDDEN_LAYERS * (len(val_batches) + 1):
        raise AssertionError("the kernel side of the validation pass did not launch fused_ffn once per layer")
    val_rel = abs(val_loss - val_loss0) / abs(val_loss0)
    logit_err = (logits - logits0).abs().max().item()
    logit_tol = LIKE_TOL
    if bf16:  # relative to the logits' magnitude
        logit_err /= logits0.abs().max().item()
        logit_tol = BF16_STEP_TOL
    log(f"{tag} validation pass over {len(val_batches)} batches of [{val_batches[0].inputs.shape[0]}x"
        f"{val_batches[0].inputs.shape[1]}, 440] from the step-2 checkpoint, kernels vs plain: loss "
        f"{val_loss!r} vs {val_loss0!r} (rel {val_rel!r}, tol {loss_tol}); eval logits of the first "
        f"batch max|diff|{' / max|ref|' if bf16 else ''} {logit_err!r} (tol {logit_tol})")
    if not val_rel <= loss_tol:
        raise AssertionError(f"{tag} validation loss differs from the plain versions: rel {val_rel}")
    if not logit_err <= logit_tol:
        raise AssertionError(f"{tag} eval logits differ from the plain versions: {logit_err}")
    del logits, logits0

    before = bn_fused_bwd.launches
    grads, loss, frames = trainer.gradients(ckpt.device_snapshot(state), batch)
    with plain_versions():
        grads0, loss0, _ = trainer.gradients(ckpt.device_snapshot(state), batch)
    torch.cuda.synchronize()
    if bn_fused_bwd.launches != before + HIDDEN_LAYERS:
        raise AssertionError("the kernel side of the step did not launch bn_dgrad once per layer")
    loss_rel = abs(loss.item() - loss0.item()) / abs(loss0.item())
    # a batchnorm layer's bias b has a zero gradient in exact arithmetic (BN
    # removes the mean), so both sides hold rounding noise there: each must
    # stay below BN_BIAS_NOISE of the layer's beta gradient instead
    bias_noise = {}
    for l in range(HIDDEN_LAYERS):
        scale = grads0[f"hidden.{l}.beta"].abs().max()
        bias_noise[l] = max(grads[f"hidden.{l}.b"].abs().max(), grads0[f"hidden.{l}.b"].abs().max()).item() / scale.item()
    errs = {name: ((grads[name] - g0).abs().max() / g0.abs().max().clamp(min=1e-30)).item()
            for name, g0 in grads0.items() if not (name.startswith("hidden.") and name.endswith(".b"))}
    worst = max(errs, key=errs.get)
    log(f"{tag} one step at [{batch.inputs.shape[0]}x{batch.inputs.shape[1]}, 440] from the step-2 checkpoint, "
        f"kernels vs plain: loss {loss.item()!r} vs {loss0.item()!r} (rel {loss_rel!r}, tol "
        f"{STEP_LOSS_TOL}); gradients max|diff|/max|ref| worst {worst} {errs[worst]!r} (tol "
        f"{grad_tol}), all {errs!r}; BN-layer bias gradients / max|dbeta| {bias_noise!r} "
        f"({'printed' if bf16 else f'noise, tol {BN_BIAS_NOISE}'})")
    if not loss_rel <= STEP_LOSS_TOL:
        raise AssertionError(f"{tag} step loss differs from the plain versions: rel {loss_rel}")
    if not errs[worst] <= grad_tol:
        raise AssertionError(f"{tag} gradient {worst} differs from the plain versions: {errs[worst]}")
    if not bf16 and not max(bias_noise.values()) <= BN_BIAS_NOISE:
        raise AssertionError(f"a BN-layer bias gradient is not noise-level: {bias_noise}")

    # ---- where a step's time goes (CUDA events, 3 calls after 3 warm-ups) ----
    del grads, grads0
    s = ckpt.device_snapshot(state)
    fwd_ms = ms_per_call(lambda: trainer.loss_sum(s.model, batch, train=True), iters=3)
    grad_ms = ms_per_call(lambda: trainer.gradients(s, batch), iters=3)
    with plain_versions():
        grad_plain_ms = ms_per_call(lambda: trainer.gradients(s, batch), iters=3)
    step_ms = ms_per_call(lambda: trainer.update(s, batch), iters=3)
    n = batch.inputs.shape[0] * batch.inputs.shape[1]
    h = torch.randn(n, HIDDEN_UNITS, device="cuda")
    h0 = torch.randn(n, 440, device="cuda")
    dz = torch.randn(n, HIDDEN_UNITS, device="cuda")
    dlogits = torch.randn(n, NUM_PDFS, device="cuda")
    wgrad_ms = (
        (HIDDEN_LAYERS - 1) * ms_per_call(lambda: torch.matmul(h.t(), dz))
        + ms_per_call(lambda: torch.matmul(h0.t(), dz))
        + ms_per_call(lambda: torch.matmul(h.t(), dlogits))
    )
    bn_total = (HIDDEN_LAYERS - 1) * bn_ms + bn_dz_only_ms
    rest = grad_ms - fwd_ms - bn_total - wgrad_ms
    log(f"{tag} train step at {n} rows ({int(frames.item())} real frames): update {step_ms!r} ms "
        f"({frames.item() / step_ms * 1e3!r} frames/s), of which forward {fwd_ms!r} ms, kernel-3 "
        f"launches {bn_total!r} ms (5 x {bn_ms!r} + dz-only {bn_dz_only_ms!r}), wgrad GEMMs "
        f"{wgrad_ms!r} ms (cuBLAS f32{' on widened bf16 values' if bf16 else ''}), other backward (output-layer dgrad, BN pass 1, CE) "
        f"{rest!r} ms, Adam {step_ms - grad_ms!r} ms; forward+backward with the plain kernel-3 "
        f"version {grad_plain_ms!r} ms vs {grad_ms!r} ms with the kernel [{card}]")


def rnn_train_path(card: str, cell: str, ws: dict) -> tuple[dict, str, str]:
    """The BiLSTM (or BiGRU) hybrid path at full width through the CLI, on
    the training workspace's features and 2000-pdf alignments: ``cli.main
    --steps train_nnet,test_nnet`` with ``synthetic.recurrent_nnet(cell)``
    (the ``[nnet]`` of config_AURORA4_ctc.cfg under frame CE: 2 x 512
    bidirectional, context 2, bf16, batch 128, dropout 0.8, valid_batches
    4) and only num_epochs, valid_frequency and check_freq lowered. Counts
    reset before, read after: the backward kernel once per layer in each
    train step (replays included), the forward kernel once per layer call,
    both on the persistent route (never on the step route): the forward
    per layer in each train step and once more per layer of every
    validation and decode batch; no kernel of the DNN paths launches; the
    step-0 loss is
    ln 2000 (zero output layer); the ark covers the test set. Returns the
    launches, the config's path and the model dir."""
    from configparser import ConfigParser

    import torch

    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.cli import main as cli_main
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp, gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops import frame_preemph as fp

    config = ConfigParser()
    config.read(ws["cfg_path"])
    nnet = {**synthetic.recurrent_nnet(cell), **RNN_TRAIN_NNET}
    for key, value in nnet.items():
        config.set("nnet", key, str(value))
    cfg_path = os.path.join(TRAIN_WORK, f"config_bi{cell}.cfg")
    with open(cfg_path, "w") as f:
        config.write(f)
    savedir = os.path.join(config.get("directories", "expdir"), nnet["name"])

    cells = (lstm_bidi.CELL, gru_bidi.CELL)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli_main.main(["--config", cfg_path, "--steps", "train_nnet,test_nnet"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main bi{cell} path: rc {rc}")
    this = _rnn_cell(cell)
    routes = {"persistent": this.fwd_persistent_launches, "step": this.fwd_launches}
    bwd_routes = {"persistent": this.bwd_persistent_launches, "step": this.bwd_launches}
    launches = {f"{cell}_fwd": sum(routes.values()), f"{cell}_bwd": sum(bwd_routes.values())}
    other = {"fused_ffn": fused_mlp.launches, "frame_preemph": fp.launches, "bn_dgrad": bn_fused_bwd.launches}
    other.update({f"{c.name}_{k}": getattr(c, f"{k}_launches") for c in cells
                  if c is not this for k in ("fwd_persistent", "fwd", "bwd_persistent", "bwd")})
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    log(f"bi{cell} path launches: {launches}, the forward's by route {routes}, the backward's {bwd_routes} "
        f"(other kernels {other}); {len(steps)} train steps at T_pad {[st['padded_length'] for st in steps]} "
        f"(replays after a rollback included); whole run {run_s!r} s")
    # the backward: one persistent launch per layer in each train step, never the step route
    if bwd_routes != {"persistent": RNN_LAYERS * len(steps), "step": 0}:
        raise AssertionError(f"{cell}_bwd launches by route {bwd_routes}, want persistent "
                             f"{RNN_LAYERS} x {len(steps)} and step 0")
    # the forward: one persistent launch per layer call, in training, validation and decode alike
    if routes["step"] != 0:
        raise AssertionError(f"{cell}_fwd took the step route {routes['step']} times on the bi{cell} path")
    if not routes["persistent"] > RNN_LAYERS * len(steps):
        raise AssertionError(f"{cell}_fwd launched {routes['persistent']} times: want more than the "
                             f"{RNN_LAYERS * len(steps)} of training (validation and decode launch it too)")
    if any(other.values()):
        raise AssertionError(f"the bi{cell} path launched another path's kernels: {other}")
    check_cli_run(card, f"bi{cell} path", ws, savedir, steps)
    return launches, cfg_path, savedir


def check_rnn_step(card: str, cell: str, cfg_path: str, savedir: str, ws: dict) -> None:
    """The recurrent model's outputs with the kernels against the plain
    versions, on the card:

    - the likelihood ark ``test_nnet`` wrote (``final.pt``, kernel 4 or 6)
      against the plain versions' decode of the same weights; in bf16 the
      yardstick is the plain version run with an f32 compute dtype: the
      kernels' ark must lie within RNN_BF16_RATIO of the plain bf16 ark's
      distance from it (see check_rnn_kernels); in f32 within LIKE_TOL;
    - one full-width training step from the step-2 checkpoint on the first
      training batch, with the same dropout masks: every gradient by the
      same rule, and the loss within RNN_LOSS_TOL (relative) of the plain
      version's.

    Then the step is timed by parts (CUDA events)."""
    import dataclasses
    from configparser import ConfigParser

    import numpy as np
    import torch

    from tfkaldi_tpu_torch.convert import load_checkpoint
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.decode.decoder import Decoder
    from tfkaldi_tpu_torch.io import ArkWriter
    from tfkaldi_tpu_torch.models import RNNConfig, build_model
    from tfkaldi_tpu_torch.train.trainer import TrainerConfig

    c = _rnn_cell(cell)
    config = ConfigParser()
    config.read(cfg_path)
    conf = dict(config.items("nnet"))
    context = int(conf["context_width"])
    input_dim = 40 * (2 * context + 1)
    rcfg = RNNConfig.from_config(conf, input_dim, NUM_PDFS)
    rcfg32 = dataclasses.replace(rcfg, compute_dtype=torch.float32)
    bf16 = rcfg.compute_dtype == torch.bfloat16

    # ---- the likelihood ark of test_nnet against the plain versions ----
    prior = np.load(os.path.join(savedir, "prior.npy"))
    final = load_checkpoint(savedir)
    featdir = ws["test_featdir"]

    def decode(cfg, tag):
        model = build_model(cfg)
        model.load_state_dict(final)
        model.to("cuda")
        reader = FeatureReader(os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"),
                               os.path.join(featdir, "utt2spk"), context, 0)
        scp = os.path.join(TRAIN_WORK, f"plain_{cell}_{tag}", "feats.scp")
        with plain_versions(), ArkWriter(scp, os.path.join(os.path.dirname(scp), "likes.ark")) as w:
            Decoder(model, prior).decode_to_writer(reader, w, batch_size=int(conf.get("decode_batch_size", 16)))
        reader.close()
        return read_ark(scp)

    def dist(a, b):
        return max(float(np.abs(a[u] - b[u]).max()) for u in b)

    likes = read_ark(os.path.join(savedir, "decode", "feats.scp"))
    plain = decode(rcfg, "cd")
    d_kp = dist(likes, plain)
    if bf16:
        ref32 = decode(rcfg32, "f32")
        d_k, d_p = dist(likes, ref32), dist(plain, ref32)
        log(f"bi{cell} likelihoods ({len(likes)} utterances), max|diff| from the plain f32-compute decode: "
            f"kernels {d_k!r}, plain bf16 {d_p!r} (within {RNN_BF16_RATIO}x + {RNN_F32_TOL}); kernels vs plain bf16 {d_kp!r}")
        ok = bf16_close(d_k, d_p)
    else:
        log(f"bi{cell} likelihoods ({len(likes)} utterances), kernels vs plain max|diff| {d_kp!r} (tol {LIKE_TOL})")
        ok = d_kp <= LIKE_TOL
    if not ok:
        raise AssertionError(f"bi{cell} likelihoods differ from the plain versions beyond tolerance")

    # ---- one training step, kernels vs plain versions ----
    featdir = ws["train_featdir"]
    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    reader = FeatureReader(os.path.join(featdir, "feats_shuffled.scp"), os.path.join(featdir, "cmvn.scp"),
                           os.path.join(featdir, "utt2spk"), context, max_length)
    ali = os.path.join(config.get("directories", "expdir"), config.get("nnet", "gmm_name"), "ali", "pdf.all.gz")
    dispenser = AlignmentBatchDispenser(reader, AlignmentCoder(identity_normalizer, NUM_PDFS),
                                        int(conf["batch_size"]), ali)
    for _ in range(int(conf["valid_batches"])):  # past the validation carve
        dispenser.skip_batch()
    batch = dispenser.get_padded_batch(DeviceBatcher()).to("cuda")
    reader.close()
    trainer, state = compare_rnn_step(f"bi{cell}", c, rcfg, TrainerConfig(num_steps=6),
                                      os.path.join(savedir, "training", "step2.pt"), batch)
    time_rnn_step(card, f"bi{cell}", c, trainer, state, batch, NUM_PDFS)


def compare_rnn_step(tag: str, c, rcfg, tcfg, path: str, batch):
    """One full-width training step of a recurrent model from the checkpoint
    ``path`` on ``batch``, with the same dropout masks, with the kernels and
    with the plain versions (and, in bf16, the plain versions in f32
    compute): the backward kernel launched once per layer on the persistent
    route; every gradient by the bf16 rule of check_rnn_kernels (f32: within
    RNN_F32_TOL of max|ref|), the loss within RNN_LOSS_TOL (relative) of the
    plain version's. Returns the kernels' trainer and state."""
    import dataclasses

    import torch

    from tfkaldi_tpu_torch.train import checkpoint as ckpt
    from tfkaldi_tpu_torch.train.trainer import Trainer

    bf16 = rcfg.compute_dtype == torch.bfloat16
    rcfg32 = dataclasses.replace(rcfg, compute_dtype=torch.float32)
    b, t_pad, input_dim = batch.inputs.shape
    trainer = Trainer(rcfg, tcfg, device="cuda")
    trainer32 = Trainer(rcfg32, tcfg, device="cuda")
    state = ckpt.restore_state(path, trainer.init_state(0))
    state32 = ckpt.restore_state(path, trainer32.init_state(0))

    def gradients(tr, st, plain_path):
        s = ckpt.device_snapshot(st)
        with plain_versions() if plain_path else contextlib.nullcontext():
            grads, loss, _ = tr.gradients(s, batch, tr.dropout_generator(s))  # the same masks each time
        return grads, loss.item()

    before = (c.bwd_persistent_launches, c.bwd_launches)
    g_k, loss_k = gradients(trainer, state, False)
    if (c.bwd_persistent_launches, c.bwd_launches) != (before[0] + RNN_LAYERS, before[1]):
        raise AssertionError(f"the kernel side of the {tag} step did not launch {c.name}_bwd once per layer on "
                             f"the persistent route")
    g_p, loss_p = gradients(trainer, state, True)
    g_32, loss_32 = gradients(trainer32, state32, True) if bf16 else (g_p, loss_p)
    torch.cuda.synchronize()

    def rel(a, ref):
        return ((a - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()

    e_kp = {n: rel(g_k[n], g_p[n]) for n in g_p}
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    if bf16:
        e_k = {n: rel(g_k[n], g_32[n]) for n in g_32}
        e_p = {n: rel(g_p[n], g_32[n]) for n in g_32}
        bad = [n for n in e_k if not bf16_close(e_k[n], e_p[n])]
        log(f"{tag} one step at [{b}x{t_pad}, {input_dim}] from the step-2 checkpoint: loss kernels {loss_k!r}, "
            f"plain {loss_p!r} (rel {loss_rel!r}, tol {RNN_LOSS_TOL}), plain f32 compute {loss_32!r}; gradients "
            f"max|diff|/max|ref| from the plain f32-compute step: kernels {e_k!r}, plain bf16 {e_p!r} (within "
            f"{RNN_BF16_RATIO}x + {RNN_F32_TOL}); kernels vs plain bf16 {e_kp!r}")
    else:
        bad = [n for n in e_kp if not e_kp[n] <= RNN_F32_TOL]
        log(f"{tag} one step at [{b}x{t_pad}, {input_dim}]: loss rel {loss_rel!r}, gradients kernels vs plain "
            f"{e_kp!r} (tol {RNN_F32_TOL})")
    if bad or not loss_rel <= RNN_LOSS_TOL:
        raise AssertionError(f"{tag} step: loss rel {loss_rel}, gradients outside tolerance: {bad}")
    return trainer, state


def time_rnn_step(card: str, tag: str, c, trainer, state, batch, num_out: int, loss_parts: dict | None = None) -> None:
    """A recurrent model's training step timed by parts (CUDA events, 3 calls
    after 3 warm-ups): the whole update, the forward, then each part on its
    own at the step's shapes: the input projections, the kernels of both
    layers, the wgrads, the output layer (``num_out`` classes), and
    ``loss_parts`` (name -> ms, e.g. the CTC loss) where given; the rest
    (loss, dropout, casts, concat, bias sums) is what remains of the
    gradient pass."""
    import torch

    from tfkaldi_tpu_torch.layers import product
    from tfkaldi_tpu_torch.ops.lstm_scan import weight_grad
    from tfkaldi_tpu_torch.train import checkpoint as ckpt

    rcfg = trainer.model_config
    s = ckpt.device_snapshot(state)
    step_ms = ms_per_call(lambda: trainer.update(s, batch), iters=3)
    grad_ms = ms_per_call(lambda: trainer.gradients(s, batch, trainer.dropout_generator(s)), iters=3)
    fwd_ms = ms_per_call(lambda: trainer.loss_sum(s.model, batch, train=True, generator=trainer.dropout_generator(s),
                                                  loss_type=trainer.config.loss_type,
                                                  blank_id=trainer.config.ctc_blank_id), iters=3)
    frames = int(batch.input_lengths.sum().item())
    b, t_pad, input_dim = batch.inputs.shape
    cd, h, gates = rcfg.compute_dtype, rcfg.hidden_units, c.gates
    n = b * t_pad
    x0, x1 = torch.randn(n, input_dim, device="cuda"), torch.randn(n, 2 * h, device="cuda")
    wx0, wx1 = torch.randn(input_dim, gates * h, device="cuda"), torch.randn(2 * h, gates * h, device="cuda")
    dg = torch.randn(n, gates * h, device="cuda")
    wout, dlogits = torch.randn(2 * h, num_out, device="cuda"), torch.randn(n, num_out, device="cuda")
    # the input projections of both directions of both layers, forward (x @ wx)
    # and the backward's input gradient of layer 1 (dg @ wx^T)
    proj_ms = 2 * (ms_per_call(lambda: product(x0, wx0, cd), iters=5)
                   + ms_per_call(lambda: product(x1, wx1, cd), iters=5)
                   + ms_per_call(lambda: product(dg, wx1.t(), cd), iters=5))
    mask = (torch.arange(t_pad, device="cuda")[:, None] < batch.input_lengths.cuda()[None, :])[:, :, None].float()
    gxs = [dg.reshape(t_pad, b, gates * h).contiguous() for _ in range(2)]
    whs_cd = [torch.randn(h, gates * h, device="cuda").div(h ** 0.5).to(cd) for _ in range(2)]
    dys = [torch.randn(t_pad, b, h, device="cuda") for _ in range(2)]
    outs = c.fwd(gxs, whs_cd, mask, residuals=True)
    res = [r for _, r in outs]
    k_fwd_ms = RNN_LAYERS * ms_per_call(lambda: c.fwd(gxs, whs_cd, mask, residuals=True), iters=3)
    k_bwd_ms = RNN_LAYERS * ms_per_call(lambda: c.bwd(dys, res, mask, whs_cd), iters=3)
    dgx3 = dg.reshape(t_pad, b, gates * h)
    # dW_h, dW_x of both directions of both layers and the output layer's dW
    wgrad_ms = (2 * RNN_LAYERS * ms_per_call(lambda: weight_grad(res[0][2], dgx3, cd), iters=5)
                + 2 * ms_per_call(lambda: product(x0.t(), dg, cd), iters=5)
                + 2 * ms_per_call(lambda: product(x1.t(), dg, cd), iters=5)
                + ms_per_call(lambda: product(x1.t(), dlogits, cd), iters=5))
    # the output layer's forward and input gradient
    out_ms = (ms_per_call(lambda: product(x1, wout, cd), iters=5)
              + ms_per_call(lambda: product(dlogits, wout.t(), cd), iters=5))
    loss_parts = loss_parts or {}
    rest = grad_ms - proj_ms - k_fwd_ms - k_bwd_ms - wgrad_ms - out_ms - sum(loss_parts.values())
    loss_text = "".join(f"{name} {ms!r} ms, " for name, ms in loss_parts.items())
    log(f"{tag} train step at [{b}x{t_pad}] ({frames} real frames): update {step_ms!r} ms "
        f"({frames / step_ms * 1e3!r} frames/s), of which forward {fwd_ms!r} ms; by parts: input projections "
        f"{proj_ms!r} ms, kernel {c.name}_fwd {k_fwd_ms!r} ms ({RNN_LAYERS} layers), kernel {c.name}_bwd "
        f"{k_bwd_ms!r} ms, wgrads (dW_h, dW_x, output dW) {wgrad_ms!r} ms, output layer (forward, input "
        f"gradient) {out_ms!r} ms, {loss_text}rest (loss, dropout, casts, concat, bias sums) {rest!r} ms, Adam "
        f"{step_ms - grad_ms!r} ms [{card}]")


def log_num_alignments(labels, frames: int) -> float:
    """ln of the number of CTC alignments of ``labels`` in ``frames`` frames,
    counted on the host in f64 log space: the paths through the blank-
    interleaved labels (2L+1 states) that start in one of the first two and
    end in one of the last two, where a label may follow the one before it
    directly unless the two are equal."""
    import numpy as np

    labels = np.asarray(labels)
    n = 2 * len(labels) + 1
    skip = np.zeros(n, bool)  # s-2 -> s allowed: a label unlike the label before it
    skip[3::2] = labels[1:] != labels[:-1]
    alpha = np.full(n, -np.inf)
    alpha[: min(2, n)] = 0.0
    for _ in range(frames - 1):
        nxt = np.logaddexp(alpha, np.concatenate([[-np.inf], alpha[:-1]]))
        nxt[skip] = np.logaddexp(nxt[skip], alpha[np.flatnonzero(skip) - 2])
        alpha = nxt
    return float(np.logaddexp(alpha[-1], alpha[-2]) if n > 1 else alpha[-1])


def ctc_path(card: str, ws: dict) -> tuple[dict, str, str]:
    """The character-CTC recipe at full width through the CLI, on the
    training workspace's features and seeded transcripts:
    ``config_AURORA4_ctc.cfg``'s ``[nnet]`` exactly as written
    (``synthetic.ctc_nnet``: loss ctc, aurora4 normaliser, beam 16, 2 x 512
    BiLSTM, context 2, bf16, batch 128, dropout 0.8, valid_batches 4) with
    only num_epochs, valid_frequency and check_freq lowered, ``cli.main
    --steps train_nnet,test_nnet``. Counts reset before, read after: the
    backward kernel once per layer in each train step, the forward kernel on
    the persistent route more than layers x steps times (validation and
    decode launch it too), the step route never, no other kernel; the CTC
    loss on its F.ctc_loss route only (every transcript is feasible); the
    beam-16 decode on the native beam. The step-0 loss equals the
    uniform-posterior value ``sum_i (T_i ln 36 - ln N_i) / sum_i T_i`` (the
    output layer starts at zero; N_i counted on the host), and the ``text``
    decode has one line per test utterance. Returns the launches, the
    config's path and the model dir."""
    from configparser import ConfigParser

    import torch

    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.cli import main as cli_main
    from tfkaldi_tpu_torch.data.dispenser import TextBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode import ctc as ctc_decode
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp, gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops import frame_preemph as fp
    from tfkaldi_tpu_torch.train import ctc
    from tfkaldi_tpu_torch.utils.wer import char_tokens_to_words, score_text_files

    config = ConfigParser()
    config.read(ws["cfg_path"])
    nnet = {**synthetic.ctc_nnet(), **RNN_TRAIN_NNET}
    for key, value in nnet.items():
        config.set("nnet", key, str(value))
    cfg_path = os.path.join(TRAIN_WORK, "config_ctc.cfg")
    with open(cfg_path, "w") as f:
        config.write(f)
    savedir = os.path.join(config.get("directories", "expdir"), nnet["name"])

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli_main.main(["--config", cfg_path, "--steps", "train_nnet,test_nnet"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main CTC path: rc {rc}")
    c = lstm_bidi.CELL
    routes = {"persistent": c.fwd_persistent_launches, "step": c.fwd_launches}
    bwd_routes = {"persistent": c.bwd_persistent_launches, "step": c.bwd_launches}
    launches = {"lstm_fwd": sum(routes.values()), "lstm_bwd": sum(bwd_routes.values())}
    other = {"fused_ffn": fused_mlp.launches, "frame_preemph": fp.launches, "bn_dgrad": bn_fused_bwd.launches}
    other.update({f"gru_{k}": getattr(gru_bidi.CELL, f"{k}_launches")
                  for k in ("fwd_persistent", "fwd", "bwd_persistent", "bwd")})
    loss_routes, beams = dict(ctc.launches_by_route), dict(ctc_decode.beam_runs)
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    log(f"CTC path launches: {launches}, the forward's by route {routes}, the backward's {bwd_routes} (other "
        f"kernels {other}); CTC loss calls by route {loss_routes}; beam-search batches {beams}; {len(steps)} train "
        f"steps at T_pad {[st['padded_length'] for st in steps]} (replays after a rollback included); whole run "
        f"{run_s!r} s")
    if bwd_routes != {"persistent": RNN_LAYERS * len(steps), "step": 0}:
        raise AssertionError(f"lstm_bwd launches by route {bwd_routes} on the CTC path, want persistent "
                             f"{RNN_LAYERS} x {len(steps)} and step 0")
    if routes["step"] != 0 or not routes["persistent"] > RNN_LAYERS * len(steps):
        raise AssertionError(f"lstm_fwd launches by route {routes} on the CTC path: want step 0 and persistent "
                             f"more than {RNN_LAYERS * len(steps)}")
    if any(other.values()):
        raise AssertionError(f"the CTC path launched another path's kernels: {other}")
    if not (loss_routes["library"] >= len(steps) and loss_routes["plain"] == 0):
        raise AssertionError(f"CTC loss routes {loss_routes}: want F.ctc_loss on every batch, the plain "
                             f"recursion never (every transcript is feasible)")
    if not (beams["native"] > 0 and beams["python"] == 0):
        raise AssertionError(f"the beam-16 decode did not run on the native beam: {beams}")

    # ---- the step-0 loss: uniform posteriors over the 36 classes ----
    featdir = ws["train_featdir"]
    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    reader = FeatureReader(os.path.join(featdir, "feats_shuffled.scp"), os.path.join(featdir, "cmvn.scp"),
                           os.path.join(featdir, "utt2spk"), int(nnet["context_width"]), max_length)
    coder = TextCoder(aurora4_normalizer)
    dispenser = TextBatchDispenser(reader, coder, int(nnet["batch_size"]), os.path.join(featdir, "text"))
    for _ in range(int(nnet["valid_batches"])):  # past the validation carve
        dispenser.skip_batch()
    inputs, targets = dispenser.get_batch()
    reader.close()
    frames = [x.shape[0] for x in inputs]
    want = sum(t * math.log(CTC_CLASSES) - log_num_alignments(y, t) for t, y in zip(frames, targets)) / sum(frames)
    loss0 = steps[0]["loss"]
    rel0 = abs(loss0 - want) / want
    log(f"CTC path step-0 loss {loss0!r} vs the uniform-posterior value {want!r} over the first batch's "
        f"{sum(frames)} frames and {sum(len(y) for y in targets)} labels (rel {rel0!r}, tol {CTC_STEP0_TOL}); losses "
        f"{[round(st['loss'], 6) for st in steps]}")
    if not rel0 <= CTC_STEP0_TOL:
        raise AssertionError(f"CTC step-0 loss {loss0} is not the uniform-posterior value {want}")
    warm = steps[1:]
    step_s = sorted(st["step_time"] for st in warm)[len(warm) // 2]
    log(f"CTC path train step (median of {len(warm)} after the first, host clock, data wait included): {step_s!r} s "
        f"[{card}]")

    # ---- the text decode ----
    test_featdir = ws["test_featdir"]
    with open(os.path.join(test_featdir, "text")) as f:
        test_utts = [line.split()[0] for line in f if line.strip()]
    decode_dir = os.path.join(savedir, "decode")
    with open(os.path.join(decode_dir, "text")) as f:
        decoded = [line.split() for line in f]
    if [d[0] for d in decoded] != test_utts:
        raise AssertionError(f"the CTC decode text holds {len(decoded)} lines, not one per test utterance "
                             f"({len(test_utts)})")
    norm, out = os.path.join(decode_dir, "text.ref_normalized"), os.path.join(decode_dir, "text")
    log(f"CTC path beam-16 decode of {len(decoded)} test utterances ({sum(len(d) - 1 for d in decoded)} tokens): "
        f"CER {score_text_files(norm, out)}; WER {score_text_files(norm, out, transform=char_tokens_to_words)} "
        f"(noise data after {len(steps)} steps: printed, not gated)")
    return launches, cfg_path, savedir


def check_ctc_step(card: str, cfg_path: str, savedir: str, ws: dict) -> dict:
    """The CTC path's outputs with the kernels against the plain versions on
    the card, and its times:

    - the test set's log-posteriors from ``final.pt`` (the decode batches of
      16), kernels against the plain versions by the bf16 rule of
      check_rnn_kernels (against the plain version in f32 compute); greedy
      transcripts identical on every utterance whose frames all have a
      top-two log-posterior margin above twice the kernels' distance from the
      plain bf16 version (there no argmax can move);
    - greedy and beam-16 decode of the test set timed (frames/s, host clock:
      features, forward, D2H copy and search);
    - one full-width CTC training step from the step-2 checkpoint on the
      first training batch (compare_rnn_step: the bf16 rule);
    - the CTC loss on that step's logits [128, T_pad, 36]: the F.ctc_loss
      route against the plain recursion, per-row loss within CTC_LOSS_TOL
      relative and logit gradient within CTC_LOSS_TOL absolute, each route
      timed forward + backward; torch's CTC run in f32 timed and its
      gradient's distance printed beside them (the port runs it in f64);
    - the step timed by parts with the CTC loss as its own part.

    Returns the decode and loss timings."""
    import dataclasses
    from configparser import ConfigParser

    import numpy as np
    import torch
    import torch.nn.functional as F

    from tfkaldi_tpu_torch.convert import load_checkpoint
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.dispenser import TextBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode import ctc as ctc_decode
    from tfkaldi_tpu_torch.decode.streaming import stream_padded_batches
    from tfkaldi_tpu_torch.models import RNNConfig, build_model
    from tfkaldi_tpu_torch.ops import lstm_bidi
    from tfkaldi_tpu_torch.train import ctc
    from tfkaldi_tpu_torch.train.trainer import TrainerConfig

    c = lstm_bidi.CELL
    config = ConfigParser()
    config.read(cfg_path)
    conf = dict(config.items("nnet"))
    context = int(conf["context_width"])
    input_dim = 40 * (2 * context + 1)
    blank = CTC_CLASSES - 1
    rcfg = RNNConfig.from_config(conf, input_dim, CTC_CLASSES)
    rcfg32 = dataclasses.replace(rcfg, compute_dtype=torch.float32)
    coder = TextCoder(aurora4_normalizer)
    final = load_checkpoint(savedir)

    def decoder(cfg, beam=1):
        model = build_model(cfg)
        model.load_state_dict(final)
        return ctc_decode.CTCDecoder(model.to("cuda"), coder, blank, beam_width=beam)

    def test_reader():
        featdir = ws["test_featdir"]
        return FeatureReader(os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"),
                             os.path.join(featdir, "utt2spk"), context, 0)

    # ---- the test set's log-posteriors and greedy transcripts, kernels vs plain ----
    reader = test_reader()
    batches = list(stream_padded_batches(reader, batch_size=int(conf.get("decode_batch_size", 16))))
    reader.close()
    lengths = np.concatenate([l for _, _, l in batches])
    dec, dec32 = decoder(rcfg), decoder(rcfg32)

    def posteriors(d, plain):
        with plain_versions() if plain else contextlib.nullcontext():
            lps = [d.log_probs(x, l) for _, x, l in batches]
            paths = [p for _, x, l in batches for p in d.decode_batch(x, l)]
        return [lp[i, :n] for lp, (_, _, l) in zip(lps, batches) for i, n in enumerate(l)], paths

    before = c.fwd_persistent_launches
    lp_k, paths_k = posteriors(dec, False)
    if c.fwd_persistent_launches != before + 2 * RNN_LAYERS * len(batches):
        raise AssertionError("the kernel side of the decode did not launch lstm_fwd once per layer and batch")
    lp_p, paths_p = posteriors(dec, True)
    lp_32, _ = posteriors(dec32, True)

    def dist(a, b):
        return max(float(np.abs(x - y).max()) for x, y in zip(a, b))

    d_k, d_p, d_kp = dist(lp_k, lp_32), dist(lp_p, lp_32), dist(lp_k, lp_p)
    margins = [float(np.diff(np.sort(lp, axis=-1)[:, -2:], axis=-1).min()) for lp in lp_p]
    clear = [i for i, m in enumerate(margins) if m > 2 * d_kp]
    same = [i for i in clear if np.array_equal(paths_k[i], paths_p[i])]
    log(f"CTC log-posteriors of the test set ({len(lp_k)} utterances, {int(lengths.sum())} frames), max|diff| from "
        f"the plain f32-compute decode: kernels {d_k!r}, plain bf16 {d_p!r} (within {RNN_BF16_RATIO}x + "
        f"{RNN_F32_TOL}); kernels vs plain bf16 {d_kp!r}; greedy transcripts identical on {len(same)} of the "
        f"{len(clear)} utterances whose every frame's top-two margin exceeds {2 * d_kp!r} "
        f"(all {sum(np.array_equal(a, b) for a, b in zip(paths_k, paths_p))} of {len(paths_k)})")
    if not bf16_close(d_k, d_p):
        raise AssertionError("the CTC log-posteriors differ from the plain versions beyond the bf16 rule")
    if same != clear:
        raise AssertionError(f"greedy transcripts differ from the plain versions' on utterances {sorted(set(clear) - set(same))}")

    # ---- decode throughput, greedy and beam 16 ----
    rates = {}
    for beam in (1, int(conf["beam_width"])):
        d = decoder(rcfg, beam)
        out = os.path.join(TRAIN_WORK, f"ctc_decode_beam{beam}.txt")
        for _ in range(2):  # a warm-up, then the timed pass
            reader = test_reader()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            count = d.decode_to_file(reader, out)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            reader.close()
        rates[f"beam{beam}"] = int(lengths.sum()) / seconds
        log(f"CTC decode beam {beam} of the test set ({count} utterances, {int(lengths.sum())} frames, batches of "
            f"16, features read and decoded): {seconds!r} s, {rates[f'beam{beam}']!r} frames/s [{card}]")

    # ---- one training step, kernels vs plain versions ----
    featdir = ws["train_featdir"]
    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    reader = FeatureReader(os.path.join(featdir, "feats_shuffled.scp"), os.path.join(featdir, "cmvn.scp"),
                           os.path.join(featdir, "utt2spk"), context, max_length)
    dispenser = TextBatchDispenser(reader, coder, int(conf["batch_size"]), os.path.join(featdir, "text"))
    for _ in range(int(conf["valid_batches"])):  # past the validation carve
        dispenser.skip_batch()
    batch = dispenser.get_padded_batch(DeviceBatcher()).to("cuda")
    reader.close()
    tcfg = TrainerConfig(num_steps=6, loss_type="ctc", ctc_blank_id=blank)
    trainer, state = compare_rnn_step("CTC BiLSTM", c, rcfg, tcfg,
                                      os.path.join(savedir, "training", "step2.pt"), batch)

    # ---- the CTC loss at the step's shape: F.ctc_loss route vs plain recursion ----
    with torch.no_grad():
        logits = state.model(batch.inputs, batch.input_lengths, train=True,
                             generator=trainer.dropout_generator(state)).float()
    lengths_h = ctc.host(batch.input_lengths)
    targets_h, tgt_h = ctc.host(batch.targets), ctc.host(batch.target_lengths)

    def loss_and_grad(route):
        x = logits.clone().requires_grad_(True)
        loss = ctc.ctc_loss(x, lengths_h, targets_h, tgt_h, blank, route=route)
        loss.sum().backward()
        return loss.detach(), x.grad

    def torch_f32(x):  # torch's CTC on the f32 log-posteriors (the port widens them to f64)
        lp = torch.log_softmax(x, dim=-1).transpose(0, 1)
        return F.ctc_loss(lp, batch.targets.long(), tuple(lengths_h.tolist()), tuple(tgt_h.tolist()),
                          blank=blank, reduction="none")

    ctc.reset_counts()
    loss_l, grad_l = loss_and_grad(None)
    if ctc.launches_by_route != {"library": 1, "plain": 0}:
        raise AssertionError(f"the CTC loss took routes {ctc.launches_by_route} on the path's batch")
    loss_p, grad_p = loss_and_grad("plain")
    x32 = logits.clone().requires_grad_(True)
    loss_32 = torch_f32(x32)
    loss_32.sum().backward()
    loss_rel = ((loss_l - loss_p).abs() / loss_p.abs()).max().item()
    grad_err = (grad_l - grad_p).abs().max().item()
    f32_rel = ((loss_32.detach() - loss_p).abs() / loss_p.abs()).max().item()
    f32_err = (x32.grad - grad_p).abs().max().item()
    times = {
        "library_ms": ms_per_call(lambda: loss_and_grad(None), iters=5),
        "plain_ms": ms_per_call(lambda: loss_and_grad("plain"), iters=3),
        "f32_library_ms": ms_per_call(lambda: torch_f32(logits.clone().requires_grad_(True)).sum().backward(),
                                      iters=5),
    }
    b, t_pad = logits.shape[:2]
    log(f"CTC loss at [{b}x{t_pad}x{CTC_CLASSES}] (labels padded to {batch.targets.shape[1]}, {int(tgt_h.sum())} "
        f"labels): F.ctc_loss route (f64) vs plain recursion (f64): per-row loss rel {loss_rel!r}, logit gradient "
        f"max|diff| {grad_err!r} (tol {CTC_LOSS_TOL} each); forward+backward {times['library_ms']!r} ms vs "
        f"{times['plain_ms']!r} ms; torch's CTC in f32 {times['f32_library_ms']!r} ms, its distance from the plain "
        f"recursion: loss rel {f32_rel!r}, gradient {f32_err!r} [{card}]")
    if not (loss_rel <= CTC_LOSS_TOL and grad_err <= CTC_LOSS_TOL):
        raise AssertionError(f"the CTC loss routes disagree: loss rel {loss_rel}, gradient {grad_err}")
    del logits, grad_l, grad_p, x32

    time_rnn_step(card, "CTC BiLSTM", c, trainer, state, batch, CTC_CLASSES,
                  {"CTC loss (F.ctc_loss route, forward+backward)": times["library_ms"]})
    return {**times, "greedy_frames_per_s": rates["beam1"], "beam_frames_per_s": rates[f"beam{conf['beam_width']}"]}


def attention_flops(ecfg, cfg, b: int, t_pad: int, u1: int, num_classes: int) -> float:
    """Model FLOPs of one training step of the attention recipe on a padded
    batch ``[b, t_pad]`` with ``u1`` decoder positions, reckoned from the
    code (a multiply-add is 2): the forward's products, times 3 for forward
    and backward. Encoder rows ``n = b·T'`` (``T' = ceil(t_pad/s)``): the
    input projection, per conformer block two FFNs, the q/k/v/o projections,
    scores and context over ``T'`` keys, the conv module's two pointwise
    products and its depthwise taps; the memory projection. Decoder rows
    ``m = b·u1``: per block the self-attention projections, scores and
    context, the cross-attention's q/o on ``m`` rows and k/v on ``n``
    memory rows, scores and context over ``T'``, the FFN; the output layer;
    the CTC head on ``n`` rows."""
    d, f, k = ecfg.d_model, ecfg.ffn_dim, ecfg.conv_kernel
    t_out = -(-t_pad // ecfg.subsample)
    n, m = b * t_out, b * u1
    enc = 2 * n * ecfg.input_dim * ecfg.subsample * d + 2 * n * d * d
    enc += ecfg.num_blocks * (8 * n * d * f + 8 * n * d * d + 4 * b * t_out * t_out * d
                              + 6 * n * d * d + 2 * n * k * d)
    dec = cfg.dec_blocks * (8 * m * d * d + 4 * b * u1 * u1 * d + 4 * m * d * d + 4 * n * d * d
                            + 4 * b * u1 * t_out * d + 4 * m * d * cfg.ffn_dim)
    dec += 2 * m * d * num_classes + 2 * n * d * num_classes
    return 3.0 * (enc + dec)


def attention_featdirs(ws: dict) -> dict:
    """The attention phase's featdirs: the training workspace's features
    with transcripts of at most an eighth of each utterance's frames (its
    CTC head sees every fourth frame), written beside them; the existing
    featdirs and their ``text`` stay as they are."""
    from tfkaldi_tpu_torch import synthetic

    dirs = {}
    for kind, seed in (("train", 30), ("test", 31)):
        src = ws[f"{kind}_featdir"]
        root = os.path.join(TRAIN_WORK, "attention_features", kind)
        dirs[kind] = os.path.join(root, os.path.basename(src))
        shutil.rmtree(root, ignore_errors=True)
        synthetic.retext_featdir(src, dirs[kind], seed=seed, density=ATT_TEXT_DENSITY)
    return dirs


def attention_path(card: str, ws: dict) -> tuple[str, str, dict]:
    """The joint CTC-attention recipe at full width through the CLI:
    ``config_AURORA4_attention.cfg``'s ``[nnet]`` exactly as written
    (``synthetic.attention_nnet``: 12 x 256 conformer-s4, 4 heads, ffn 1024,
    kernel 15, 4 decoder blocks, ctc_weight 0.3, label smoothing 0.1, bf16,
    batch 128, dropout 0.9, average_last 5, rescoring decode with beam 10
    and rescore_weight 0.5) with only num_epochs, valid_frequency and
    check_freq lowered, on the training workspace's features with
    transcripts of at most T/8 labels (``attention_featdirs``); ``cli.main
    --steps train_nnet,test_nnet``. Counts reset before, read after: no
    hand kernel launched (the path runs none: every one of the seven
    counters stays at 0); the CTC loss on its F.ctc_loss route on every
    batch and the plain recursion never; pass 2 of the rescoring decode once
    per decode batch. The step-0 loss equals the uniform-posterior value
    ``[(1-w)·sum_i (U_i+1) ln 36 + w·sum_i (T'_i ln 36 - ln N_i)] / sum_i
    T_i`` (the decoder's output layer and the CTC head start at zero, and
    smoothing leaves a uniform CE as it is); the ``text`` decode has one
    line per test utterance. Returns the config's path, the model dir and
    the featdirs."""
    from configparser import ConfigParser

    import torch

    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.cli import main as cli_main
    from tfkaldi_tpu_torch.data.dispenser import TextBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode import seq2seq as seq2seq_decode
    from tfkaldi_tpu_torch.train import ctc
    from tfkaldi_tpu_torch.utils.wer import char_tokens_to_words, score_text_files

    t0 = time.perf_counter()
    dirs = attention_featdirs(ws)
    config = ConfigParser()
    config.read(ws["cfg_path"])
    for kind in ("train", "test"):
        config.set("directories", f"{kind}_features", os.path.dirname(dirs[kind]))
    nnet = {**synthetic.attention_nnet(), **RNN_TRAIN_NNET}
    for key, value in nnet.items():
        config.set("nnet", key, str(value))
    cfg_path = os.path.join(TRAIN_WORK, "config_attention.cfg")
    with open(cfg_path, "w") as f:
        config.write(f)
    savedir = os.path.join(config.get("directories", "expdir"), nnet["name"])
    log(f"attention workspace: the training features with transcripts of at most T/{ATT_TEXT_DENSITY} labels, "
        f"[nnet] of config_AURORA4_attention.cfg with {RNN_TRAIN_NNET}: {time.perf_counter() - t0!r} s")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli_main.main(["--config", cfg_path, "--steps", "train_nnet,test_nnet"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main attention path: rc {rc}")
    kernels = seven_counters()
    loss_routes, rescored = dict(ctc.launches_by_route), dict(seq2seq_decode.rescored)
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    log(f"attention path launches of the seven kernels {kernels}; CTC loss calls by route {loss_routes}; rescoring "
        f"{rescored}; {len(steps)} train steps at T_pad {[st['padded_length'] for st in steps]} (replays after a "
        f"rollback included); whole run {run_s!r} s")
    if any(kernels.values()):
        raise AssertionError(f"the attention path launched a hand kernel: {kernels}")
    if not (loss_routes["library"] >= len(steps) and loss_routes["plain"] == 0):
        raise AssertionError(f"CTC loss routes {loss_routes}: want F.ctc_loss on every batch, the plain recursion "
                             f"never (every transcript is feasible)")

    # ---- the step-0 loss: uniform posteriors over the 36 classes on both heads ----
    featdir = dirs["train"]
    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    reader = FeatureReader(os.path.join(featdir, "feats_shuffled.scp"), os.path.join(featdir, "cmvn.scp"),
                           os.path.join(featdir, "utt2spk"), int(nnet["context_width"]), max_length)
    dispenser = TextBatchDispenser(reader, TextCoder(aurora4_normalizer), int(nnet["batch_size"]),
                                   os.path.join(featdir, "text"))
    for _ in range(int(nnet["valid_batches"])):  # past the validation carve
        dispenser.skip_batch()
    inputs, targets = dispenser.get_batch()
    reader.close()
    w, s = float(nnet["ctc_weight"]), int(nnet["subsample"])
    frames = [x.shape[0] for x in inputs]
    ln_v = math.log(ATT_CLASSES)
    att = sum(len(y) + 1 for y in targets) * ln_v
    ctc_part = sum(-(-t // s) * ln_v - log_num_alignments(y, -(-t // s)) for t, y in zip(frames, targets))
    want = ((1 - w) * att + w * ctc_part) / sum(frames)
    loss0 = steps[0]["loss"]
    rel0 = abs(loss0 - want) / want
    log(f"attention path step-0 loss {loss0!r} vs the uniform-posterior value {want!r} over the first batch's "
        f"{sum(frames)} frames and {sum(len(y) for y in targets)} labels (rel {rel0!r}, tol {CTC_STEP0_TOL}); "
        f"losses {[round(st['loss'], 6) for st in steps]}")
    if not rel0 <= CTC_STEP0_TOL:
        raise AssertionError(f"attention step-0 loss {loss0} is not the uniform-posterior value {want}")
    warm = steps[1:]
    step_s = sorted(st["step_time"] for st in warm)[len(warm) // 2]
    log(f"attention path CLI train step (median of {len(warm)} after the first, host clock, data wait included): "
        f"{step_s!r} s [{card}]")

    # ---- the text decode ----
    with open(os.path.join(dirs["test"], "text")) as f:
        test_utts = [line.split()[0] for line in f if line.strip()]
    decode_dir = os.path.join(savedir, "decode")
    with open(os.path.join(decode_dir, "text")) as f:
        decoded = [line.split() for line in f]
    if [d[0] for d in decoded] != test_utts:
        raise AssertionError(f"the attention decode text holds {len(decoded)} lines, not one per test utterance "
                             f"({len(test_utts)})")
    want_batches = -(-len(test_utts) // int(nnet.get("decode_batch_size", 16)))
    if rescored["batches"] != want_batches or not rescored["hypotheses"] >= len(test_utts):
        raise AssertionError(f"rescoring {rescored}: want {want_batches} batches and at least one hypothesis per "
                             f"utterance")
    norm, out = os.path.join(decode_dir, "text.ref_normalized"), os.path.join(decode_dir, "text")
    log(f"attention path rescoring decode (beam {nnet['beam_width']}, rescore_weight {nnet['rescore_weight']}) of "
        f"{len(decoded)} test utterances ({sum(len(d) - 1 for d in decoded)} tokens): CER "
        f"{score_text_files(norm, out)}; WER {score_text_files(norm, out, transform=char_tokens_to_words)} (noise "
        f"data after {len(steps)} steps: printed, not gated)")
    return cfg_path, savedir, dirs


def check_attention(card: str, cfg_path: str, savedir: str, dirs: dict) -> dict:
    """The attention path's outputs on the card against the port on the CPU,
    and its times:

    - the test set through ``final.pt`` in decode batches of 16: the
      encoder memory, the CTC log-posteriors and pass 2's attention scores
      (of the CPU bf16 run's n-best lists) on the card (bf16) against the
      CPU in bf16 and in f32 compute, by the bf16 rule of check_rnn_kernels
      (``bf16_close`` and ``bf16_rounds``, against the f32-compute run);
      the transcripts identical on every utterance whose n-best lists agree
      and whose top-two final scores lie further apart than twice the two
      runs' largest score difference;
    - the rescoring decode of the test set timed (host clock, features
      read), split into pass 1, the host beam and pass 2;
    - one training step on the first training batch from the step-2
      checkpoint, timed by parts (CUDA events, median of 3 after 3
      warm-ups): encoder forward, decoder forward (with the attention CE),
      CTC head + loss forward, backward (the gradient pass less those), and
      Adam; beside the model FLOPs of the step and their f32 bound.

    Returns the timings."""
    import dataclasses
    from configparser import ConfigParser

    import numpy as np
    import torch

    from tfkaldi_tpu_torch.convert import load_checkpoint
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.dispenser import TextBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode.seq2seq import CTCRescoreDecoder
    from tfkaldi_tpu_torch.decode.streaming import stream_padded_batches
    from tfkaldi_tpu_torch.models import AttentionSeq2Seq, Seq2SeqConfig
    from tfkaldi_tpu_torch.train import checkpoint as ckpt
    from tfkaldi_tpu_torch.train import ctc
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

    config = ConfigParser()
    config.read(cfg_path)
    conf = dict(config.items("nnet"))
    coder = TextCoder(aurora4_normalizer)
    cfg = Seq2SeqConfig.from_config(conf, 40, coder.num_labels)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    final = load_checkpoint(savedir)
    beam, weight = int(conf["beam_width"]), float(conf["rescore_weight"])
    max_tokens = int(conf["max_decode_tokens"])

    def decoder(c, device):
        model = AttentionSeq2Seq(c)
        model.load_state_dict(final)
        return CTCRescoreDecoder(model.to(device), coder, beam_width=beam, rescore_weight=weight,
                                 max_tokens=max_tokens)

    def test_reader():
        featdir = dirs["test"]
        return FeatureReader(os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"),
                             os.path.join(featdir, "utt2spk"), 0, 0)

    # ---- the test set on the card and on the CPU ----
    reader = test_reader()
    batches = list(stream_padded_batches(reader, batch_size=int(conf.get("decode_batch_size", 16))))
    reader.close()
    runs = {"card": decoder(cfg, "cuda"), "cpu": decoder(cfg, "cpu"), "cpu_f32": decoder(cfg32, "cpu")}
    dist = {name: {"memory": 0.0, "ctc_logp": 0.0, "att": 0.0} for name in ("card", "cpu")}
    out = {"card": [], "cpu": []}
    clear, same = [], []
    t0 = time.perf_counter()
    for _, x, lengths in batches:
        got, memories = {}, {}
        for name, d in runs.items():
            memories[name], logp = d.first_pass(x, lengths)
            got[name] = {"memory": memories[name].float().cpu(), "ctc_logp": logp.cpu()}
        nbest = {}
        for name in ("card", "cpu"):  # the decode, with each side's own n-best
            d = runs[name]
            out[name] += d.decode_batch(x, lengths)
            nbest[name] = (d.last_tokens, d.last_hyp_lens, d.last_ctc_scores, d.last_att_scores)
        tokens, hyp_lens, ctc_p, att_p = nbest["cpu"]
        filled = np.isfinite(ctc_p)
        for name, d in runs.items():  # pass 2 on the CPU bf16 run's n-best, on every side
            got[name]["att"] = d.attention_scores(memories[name], lengths, tokens, hyp_lens)[filled]
        t_out = runs["cpu"].model.output_lengths(np.asarray(lengths))
        for name in ("card", "cpu"):
            for part in ("memory", "ctc_logp"):
                ref, mine = got["cpu_f32"][part], got[name][part]
                dist[name][part] = max(dist[name][part], max(float((mine[i, :n] - ref[i, :n]).abs().max())
                                                                for i, n in enumerate(t_out)))
            dist[name]["att"] = max(dist[name]["att"], float(np.abs(got[name]["att"] - got["cpu_f32"]["att"]).max()))
        tokens_k, _, ctc_k, att_k = nbest["card"]
        for i in range(len(lengths)):
            final_p = weight * ctc_p[i] + (1 - weight) * att_p[i]
            if tokens_k.shape != tokens.shape or not np.array_equal(tokens_k[i], tokens[i]):
                continue
            final_k = weight * ctc_k[i] + (1 - weight) * att_k[i]
            ok = filled[i]
            gap = 2 * float(np.abs(final_k[ok] - final_p[ok]).max())
            top = np.sort(final_p[ok])
            if len(top) < 2 or top[-1] - top[-2] > gap:
                index = len(out["cpu"]) - len(lengths) + i
                clear.append(index)
                if np.array_equal(out["card"][index], out["cpu"][index]):
                    same.append(index)
    cmp_s = time.perf_counter() - t0
    verdicts = {part: (bf16_close(dist["card"][part], dist["cpu"][part]),
                       bf16_rounds(dist["card"][part], dist["cpu"][part])) for part in dist["card"]}
    log(f"attention test set ({len(out['card'])} utterances) from final.pt, max|diff| from the CPU f32-compute run: "
        f"card bf16 {dist['card']!r}, CPU bf16 {dist['cpu']!r} (bf16 rule: within {RNN_BF16_RATIO}x + "
        f"{RNN_F32_TOL}, and at least 1/{RNN_BF16_RATIO} - {RNN_F32_TOL}: {verdicts}); transcripts identical on "
        f"{len(same)} of the {len(clear)} utterances whose n-best lists agree and whose final-score margin exceeds "
        f"twice the runs' score difference (all: {sum(np.array_equal(a, b) for a, b in zip(out['card'], out['cpu']))}"
        f" of {len(out['card'])}); comparison {cmp_s!r} s")
    if not all(close and rounds for close, rounds in verdicts.values()):
        raise AssertionError(f"the attention model on the card is outside the bf16 rule: {dist}")
    if same != clear:
        raise AssertionError(f"rescoring transcripts differ from the CPU's on utterances {sorted(set(clear) - set(same))}")
    del runs

    # ---- the rescoring decode, timed ----
    d = decoder(cfg, "cuda")
    frames = sum(int(n) for _, _, l in batches for n in l)
    for _ in range(2):  # a warm-up, then the timed pass
        d.seconds = dict.fromkeys(d.seconds, 0.0)
        reader = test_reader()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = d.decode_to_file(reader, os.path.join(TRAIN_WORK, "attention_decode.txt"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        reader.close()
    split = {part: s * 1e3 for part, s in d.seconds.items()}
    rate = {part: frames / ms * 1e3 for part, ms in split.items()}
    log(f"attention rescoring decode of the test set ({count} utterances, {frames} frames, batches of 16, beam "
        f"{beam}, features read): {seconds!r} s, {frames / seconds!r} frames/s; ms (frames/s) by part: pass 1 on "
        f"the device {split['pass1']!r} ({rate['pass1']!r}; encoder, CTC head, D2H copy), host prefix beam "
        f"{split['beam']!r} ({rate['beam']!r}), pass 2 {split['pass2']!r} ({rate['pass2']!r}; teacher-forced "
        f"decoder over every hypothesis); rest (features read, batching, text) "
        f"{seconds * 1e3 - sum(split.values())!r} [{card}]")
    timings = {"decode_frames_per_s": frames / seconds, **{f"decode_{p}_ms": v for p, v in split.items()}}
    del d

    # ---- one training step by parts ----
    featdir = dirs["train"]
    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    reader = FeatureReader(os.path.join(featdir, "feats_shuffled.scp"), os.path.join(featdir, "cmvn.scp"),
                           os.path.join(featdir, "utt2spk"), 0, max_length)
    dispenser = TextBatchDispenser(reader, coder, int(conf["batch_size"]), os.path.join(featdir, "text"))
    for _ in range(int(conf["valid_batches"])):  # past the validation carve
        dispenser.skip_batch()
    batch = dispenser.get_padded_batch(DeviceBatcher()).to("cuda")
    reader.close()
    trainer = Trainer(cfg, TrainerConfig(num_steps=6, loss_type="attention"), device="cuda")
    state = ckpt.restore_state(os.path.join(savedir, "training", "step2.pt"), trainer.init_state(0))
    model = state.model
    gen = trainer.dropout_generator(state)
    labels = [ctc.host(a) for a in (batch.input_lengths, batch.targets, batch.target_lengths)]
    labels[0] = model.output_lengths(labels[0])

    memory = model.encode(batch.inputs, batch.input_lengths, train=True, generator=gen).detach().requires_grad_()

    def decoder_forward():  # with the log-softmax of the attention CE
        logits = model.teacher_forced(memory, batch.input_lengths, batch.targets, batch.target_lengths, train=True,
                                      generator=gen)
        return torch.log_softmax(logits, dim=-1).sum()

    def ctc_forward():
        return ctc.ctc_loss(model.ctc_logits(memory), *labels, model.sos_eos_id).sum()

    parts = {
        "encoder forward": median3_ms(lambda: model.encode(batch.inputs, batch.input_lengths, train=True,
                                                          generator=gen)),
        "decoder forward": median3_ms(decoder_forward),
        "CTC head + loss forward": median3_ms(ctc_forward),
    }
    s = ckpt.device_snapshot(state)
    grad_ms = median3_ms(lambda: trainer.gradients(s, batch, trainer.dropout_generator(s)))
    step_ms = median3_ms(lambda: trainer.update(s, batch))
    parts["backward"] = grad_ms - sum(parts.values())
    parts["Adam"] = step_ms - grad_ms
    b, t_pad = batch.inputs.shape[:2]
    u1 = batch.targets.shape[1] + 1
    flops = attention_flops(cfg.encoder_config(), cfg, b, t_pad, u1, ATT_CLASSES)
    real = int(batch.input_lengths.sum().item())
    bound_ms = flops / PEAK_F32 * 1e3
    log(f"attention train step at [{b}x{t_pad}, 40] -> T' {-(-t_pad // cfg.encoder_config().subsample)}, decoder "
        f"{u1} positions ({real} real frames): update {step_ms!r} ms ({real / step_ms * 1e3!r} frames/s); by parts "
        f"{parts!r} ms; model FLOPs {flops!r} a step (forward x 3), f32 "
        f"bound {bound_ms!r} ms (products are f32 GEMMs of bf16 values at {PEAK_F32 / 1e12:.0f} TFLOP/s), "
        f"{bound_ms / step_ms!r} of it reached [{card}]")
    timings.update({"update_ms": step_ms, "flops_per_step": flops, "bound_ms": bound_ms,
                    **{f"{k.replace(' ', '_').replace('+', 'and')}_ms": v for k, v in parts.items()}})
    return timings


def transducer_flops(ecfg, cfg, b: int, t_pad: int, u1: int, s_range: int, num_classes: int) -> float:
    """Model FLOPs of one training step of the transducer recipe on a padded
    batch ``[b, t_pad]`` with ``u1 = U_pad + 1`` label positions and the
    banded loss of width ``s_range``, reckoned from the code (a multiply-add
    is 2): the forward's products, times 3 for forward and backward (the
    checkpointed joint's recomputation not counted). Encoder rows ``n =
    b·T'``: the input projection, per conformer block two FFNs, the q/k/v/o
    projections, scores and context over all ``T'`` keys (the band is a
    mask), the conv module's two pointwise products and its depthwise taps,
    the output projection to the joint width. Predictor rows ``m = b·u1``:
    the input projection, the recurrent product and the output projection.
    The band: the joint's product on ``n·S`` rows and the label columns'
    dot products."""
    d, f, k, j = ecfg.d_model, ecfg.ffn_dim, ecfg.conv_kernel, cfg.joint_units
    t_out = -(-t_pad // ecfg.subsample)
    n, m, h = b * t_out, b * u1, cfg.pred_units
    enc = 2 * n * ecfg.input_dim * ecfg.subsample * d + 2 * n * d * j
    enc += ecfg.num_blocks * (8 * n * d * f + 8 * n * d * d + 4 * b * t_out * t_out * d
                              + 6 * n * d * d + 2 * n * k * d)
    pred = 2 * m * cfg.embed_dim * 4 * h + 2 * m * h * 4 * h + 2 * m * h * j
    band = 2 * n * s_range * j * num_classes + 2 * n * s_range * j
    return 3.0 * (enc + pred + band)


def check_predictor_kernels(card: str) -> dict:
    """Kernels 4 and 5 at the transducer's prediction network (PRED_SHAPE:
    T = U_pad + 1 = 129, B 128, H 320, one direction; cuDNN's
    unidirectional LSTM on the 128-wide label embeddings as the library
    call), by the rules and the timing of ``check_rnn_kernels``. Returns
    the bf16 rows (the recipe's compute dtype)."""
    return check_rnn_kernels(card, "lstm", shape=PRED_SHAPE, dirs=1, width=PRED_WIDTH)


@contextlib.contextmanager
def counting_validations():
    """Count the controller's validation passes (its ``validation loss at
    step`` log lines) while a path runs; yields the list of their steps."""
    import logging

    seen = []
    handler = logging.Handler()
    handler.emit = lambda r: seen.append(r.args[0]) if r.getMessage().startswith("validation loss at step") else None
    logger = logging.getLogger("tfkaldi_tpu_torch.train.controller")
    logger.addHandler(handler)
    try:
        yield seen
    finally:
        logger.removeHandler(handler)


def transducer_path(card: str, ws: dict, dirs: dict) -> tuple[dict, str, str]:
    """The conformer-transducer recipe at full width through the CLI:
    ``config_AURORA4_transducer.cfg``'s ``[nnet]`` exactly as written
    (``synthetic.transducer_nnet``: 12 x 256 conformer-s4 with causal conv
    and attention context 64/0, a 1 x 320 LSTM predictor over 128-wide
    embeddings, joint 320, ``rnnt_prune_s 16`` diagonal, bf16, batch 128,
    dropout 0.9, average_last 5, beam 8 with 4 labels a frame) with only
    num_epochs, valid_frequency and check_freq lowered, on the attention
    phase's featdirs (transcripts of at most T/8 labels); ``cli.main --steps
    train_nnet,test_nnet`` (the beam-8 decode). Counts reset before, read
    after, against the controller's schedule written down before the run:
    6 train steps and validations at steps 0, 2, 4 and 6 over 4 batches, so
    the banded loss on 6 + 16 = 22 batches and the dense route never;
    kernel 4 once per loss call on the persistent route (the predictor's
    forward: 22), kernel 5 once per train step (6), no step-route launch,
    the other five counters 0. A rollback adds its replays and
    validations; the relations are asserted either way. The decode's
    ``text`` has one line per test utterance; CER and WER are printed.
    Returns the launches, the config's path and the model dir."""
    from configparser import ConfigParser

    import torch

    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.cli import main as cli_main
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp, gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops import frame_preemph as fp
    from tfkaldi_tpu_torch.train import trainer as trainer_mod
    from tfkaldi_tpu_torch.utils.wer import char_tokens_to_words, score_text_files

    config = ConfigParser()
    config.read(ws["cfg_path"])
    for kind in ("train", "test"):
        config.set("directories", f"{kind}_features", os.path.dirname(dirs[kind]))
    nnet = {**synthetic.transducer_nnet(), **RNN_TRAIN_NNET}
    for key, value in nnet.items():
        config.set("nnet", key, str(value))
    cfg_path = os.path.join(TRAIN_WORK, "config_transducer.cfg")
    with open(cfg_path, "w") as f:
        config.write(f)
    savedir = os.path.join(config.get("directories", "expdir"), nnet["name"])
    valid_batches, every = int(nnet["valid_batches"]), int(nnet["valid_frequency"])
    plan_steps = TRAIN_UTTS // int(nnet["batch_size"]) * int(nnet["num_epochs"])
    plan_valid = 1 + plan_steps // every
    plan = {"lstm_fwd": plan_steps + plan_valid * valid_batches, "lstm_bwd": plan_steps}
    log(f"transducer path schedule, before the run: {plan_steps} train steps, {plan_valid} validations of "
        f"{valid_batches} batches: the banded loss on {plan['lstm_fwd']} batches, kernel 4 {plan['lstm_fwd']} "
        f"persistent launches, kernel 5 {plan['lstm_bwd']}")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counting_validations() as validations:
        rc = cli_main.main(["--config", cfg_path, "--steps", "train_nnet,test_nnet"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main transducer path: rc {rc}")
    c = lstm_bidi.CELL
    routes = {"persistent": c.fwd_persistent_launches, "step": c.fwd_launches}
    bwd_routes = {"persistent": c.bwd_persistent_launches, "step": c.bwd_launches}
    launches = {"lstm_fwd": sum(routes.values()), "lstm_bwd": sum(bwd_routes.values())}
    other = {"fused_ffn": fused_mlp.launches, "frame_preemph": fp.launches, "bn_dgrad": bn_fused_bwd.launches}
    other.update({f"gru_{k}": getattr(gru_bidi.CELL, f"{k}_launches")
                  for k in ("fwd_persistent", "fwd", "bwd_persistent", "bwd")})
    loss_routes = dict(trainer_mod.rnnt_routes)
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    n, v = len(steps), len(validations)
    log(f"transducer path launches: kernel 4 by route {routes}, kernel 5 by route {bwd_routes} (other kernels "
        f"{other}); RNN-T loss calls by route {loss_routes}; {n} train steps at T_pad "
        f"{[st['padded_length'] for st in steps]}, validations at steps {validations} (replays after a rollback "
        f"included); whole run {run_s!r} s")
    want = {"banded": n + v * valid_batches, "dense": 0}
    if loss_routes != want:
        raise AssertionError(f"RNN-T loss routes {loss_routes}: want the banded route on every batch ({want})")
    if routes != {"persistent": want["banded"], "step": 0} or bwd_routes != {"persistent": n, "step": 0}:
        raise AssertionError(f"kernel 4 {routes} / kernel 5 {bwd_routes} on the transducer path: want persistent "
                             f"{want['banded']} / {n}, step 0")
    if (n, v) == (plan_steps, plan_valid) and launches != plan:
        raise AssertionError(f"the transducer path's launches {launches} are not the schedule's {plan}")
    if any(other.values()):
        raise AssertionError(f"the transducer path launched another path's kernels: {other}")
    losses = [st["loss"] for st in steps]
    if not all(math.isfinite(x) and x > 0 for x in losses):
        raise AssertionError(f"transducer losses {losses}")
    warm = steps[1:]
    step_s = sorted(st["step_time"] for st in warm)[len(warm) // 2]
    log(f"transducer path losses {[round(x, 6) for x in losses]}; CLI train step (median of {len(warm)} after the "
        f"first, host clock, data wait included): {step_s!r} s [{card}]")

    with open(os.path.join(dirs["test"], "text")) as f:
        test_utts = [line.split()[0] for line in f if line.strip()]
    decode_dir = os.path.join(savedir, "decode")
    with open(os.path.join(decode_dir, "text")) as f:
        decoded = [line.split() for line in f]
    if [d[0] for d in decoded] != test_utts:
        raise AssertionError(f"the transducer decode text holds {len(decoded)} lines, not one per test utterance "
                             f"({len(test_utts)})")
    norm, out = os.path.join(decode_dir, "text.ref_normalized"), os.path.join(decode_dir, "text")
    log(f"transducer path beam-{nnet['beam_width']} decode of {len(decoded)} test utterances "
        f"({sum(len(d) - 1 for d in decoded)} tokens): CER {score_text_files(norm, out)}; WER "
        f"{score_text_files(norm, out, transform=char_tokens_to_words)} (noise data after {n} steps: printed, not "
        f"gated)")
    return launches, cfg_path, savedir


def check_transducer(card: str, cfg_path: str, savedir: str, dirs: dict, ctc_greedy_fps: float) -> dict:
    """The transducer path's independent checks and times:

    - on the first training batch (past the validation carve) with the
      step-0 parameters (the CLI's seeded init), on the card in f32 compute:
      a full-width band (S = U_pad + 1) gives the dense fused loss, each row
      within RNNT_TOL relative; the recipe's S = 16 banded NLL is at least
      the dense NLL on every row (a band holds a subset of the paths; less
      RNNT_TOL relative); the bf16 values are printed beside them;
    - the first 16 test utterances through ``final.pt``: the encoder output,
      the banded scores and the per-row banded loss on the card (bf16)
      against the CPU port in bf16 and in f32 compute, by the bf16 rule
      (``bf16_close`` / ``bf16_rounds`` against the f32-compute run); the
      greedy and the beam-8 transcripts of the card against the CPU bf16
      run's, identical on every utterance the margins decide (greedy: the
      smallest top-two logit gap of the CPU search, over the steps that
      decide an emission, above 4x the largest joint-logit difference of
      the two runs at the start token; beam: the
      same n-best, and a top-two score gap above twice the runs' largest
      score difference);
    - greedy (``beam_width = 1``) and beam-8 decode of the test set from
      ``final.pt``, timed (host clock, features read before), split into
      the encoder and the search, beside the CTC recipe's greedy rate on the
      same frames;
    - one training step on the first training batch from the step-2
      checkpoint, by parts (CUDA events, median of 3 after 3 warm-ups):
      encoder forward, predictor forward (kernel 4), joint and band scores
      (the scores' forward less the two forwards in it), the banded alpha
      scan forward, the backward (the gradient pass less those) and
      TF-Adam; beside the model FLOPs of the step and their f32 bound.

    Returns the timings."""
    import dataclasses
    from configparser import ConfigParser

    import numpy as np
    import torch

    from tfkaldi_tpu_torch.convert import load_checkpoint
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.dispenser import TextBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode.streaming import stream_padded_batches
    from tfkaldi_tpu_torch.decode.transducer import TransducerDecoder
    from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
    from tfkaldi_tpu_torch.models import Transducer, TransducerConfig
    from tfkaldi_tpu_torch.ops import rnnt_loss
    from tfkaldi_tpu_torch.train import checkpoint as ckpt
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

    config = ConfigParser()
    config.read(cfg_path)
    conf = dict(config.items("nnet"))
    coder = TextCoder(aurora4_normalizer)
    cfg = TransducerConfig.from_config(conf, 40, coder.num_labels)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    final = load_checkpoint(savedir)
    beam, max_symbols = int(conf["beam_width"]), int(conf["max_symbols_per_frame"])

    def model_on(c, device, sd=final):
        m = Transducer(c)
        m.load_state_dict(sd)
        return m.to(device).eval()

    def text_batch(featdir, size, skip):
        with open(os.path.join(featdir, "maxlength")) as f:
            max_length = int(f.read())
        scp = "feats_shuffled.scp" if os.path.isfile(os.path.join(featdir, "feats_shuffled.scp")) else "feats.scp"
        reader = FeatureReader(os.path.join(featdir, scp), os.path.join(featdir, "cmvn.scp"),
                               os.path.join(featdir, "utt2spk"), 0, max_length)
        dispenser = TextBatchDispenser(reader, coder, size, os.path.join(featdir, "text"))
        for _ in range(skip):
            dispenser.skip_batch()
        batch = dispenser.get_padded_batch(DeviceBatcher())
        reader.close()
        return batch

    def band_losses(model, batch):
        """Per-row banded loss and its scores and starts, eval mode, on the CPU."""
        args = (batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths)
        with torch.no_grad():
            lpb, lpl, starts = model.lattice_scores_pruned(*args)
            loss = rnnt_loss.rnnt_alpha_loss_banded(lpb, lpl, starts, model.output_lengths(batch.input_lengths),
                                                    batch.target_lengths)
        return loss.float().cpu(), lpb.float().cpu(), lpl.float().cpu(), starts.cpu()

    def dense_losses(model, batch):
        args = (batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths)
        with torch.no_grad():
            lpb, lpl = model.lattice_scores(*args)
            return rnnt_loss.rnnt_alpha_loss(lpb, rnnt_loss.mask_label_scores(lpl, batch.target_lengths),
                                             model.output_lengths(batch.input_lengths),
                                             batch.target_lengths).float().cpu()

    # ---- the lattice at full width, step-0 parameters ----
    t0 = time.perf_counter()
    train_batch = text_batch(dirs["train"], int(conf["batch_size"]), int(conf["valid_batches"])).to("cuda")
    u_pad = train_batch.targets.shape[1]
    init = Trainer(cfg, TrainerConfig(loss_type="rnnt"), device="cpu").init_state(0).model.state_dict()
    got = {}
    for name, c in (("f32", cfg32), ("bf16", cfg)):
        dense = dense_losses(model_on(c, "cuda", init), train_batch)
        full = band_losses(model_on(dataclasses.replace(c, prune_s=u_pad + 1), "cuda", init), train_batch)
        band = band_losses(model_on(c, "cuda", init), train_batch)
        got[name] = (dense, full[0], band[0])
    dense, full, band = got["f32"]
    full_rel = float(((full - dense).abs() / dense.abs()).max())
    below = float(((dense - band) / dense.abs()).max())
    log(f"transducer lattice at [{train_batch.inputs.shape[0]}x{train_batch.inputs.shape[1]}], U_pad {u_pad}, "
        f"step-0 parameters, f32 compute: full-width band (S {u_pad + 1}) vs dense per-row loss max rel "
        f"{full_rel!r} (tol {RNNT_TOL}); S {cfg.prune_s} banded minus dense min {float((band - dense).min())!r}, "
        f"largest shortfall {below!r} relative (tol {RNNT_TOL}); dense loss sum {float(dense.sum())!r}, banded "
        f"{float(band.sum())!r}; bf16: dense {float(got['bf16'][0].sum())!r}, full band "
        f"{float(got['bf16'][1].sum())!r}, banded {float(got['bf16'][2].sum())!r} "
        f"({time.perf_counter() - t0!r} s)")
    if not full_rel <= RNNT_TOL:
        raise AssertionError(f"a full-width band differs from the dense loss: {full_rel}")
    if not below <= RNNT_TOL:
        raise AssertionError(f"the S = {cfg.prune_s} banded NLL is below the dense NLL on a row: {below}")

    # ---- the card against the CPU on final.pt ----
    t0 = time.perf_counter()
    test_batch = text_batch(dirs["test"], 16, 0)
    runs = {"card": (cfg, "cuda"), "cpu": (cfg, "cpu"), "cpu_f32": (cfg32, "cpu")}
    outs, models = {}, {}
    for name, (c, device) in runs.items():
        models[name] = model_on(c, device)
        b_ = test_batch.to(device)
        with torch.no_grad():
            enc = models[name].encode(b_.inputs, b_.input_lengths).float().cpu()
        outs[name] = (enc, *band_losses(models[name], b_))
    t_out = torch.as_tensor(models["cpu"].output_lengths(test_batch.input_lengths))
    dist = {}
    for name in ("card", "cpu"):
        enc, loss, lpb, lpl, starts = outs[name]
        ref = outs["cpu_f32"]
        if not torch.equal(starts, ref[4]):
            raise AssertionError(f"band starts differ between the {name} run and the CPU f32 run")
        ok = torch.arange(lpb.shape[1])[None, :] < t_out[:, None]
        dist[name] = {"encoder": max(float((enc[i, :n] - ref[0][i, :n]).abs().max()) for i, n in enumerate(t_out)),
                      "blank scores": float((lpb - ref[2])[ok].abs().max()),
                      "label scores": float(torch.where(ref[3] > -1e8, lpl - ref[3], 0.0)[ok].abs().max()),
                      "loss": float(((loss - ref[1]).abs() / ref[1].abs()).max())}
    verdicts = {part: (bf16_close(dist["card"][part], dist["cpu"][part]),
                       bf16_rounds(dist["card"][part], dist["cpu"][part])) for part in dist["card"]}

    # the searches on both sides, with the margins that decide them
    x, lengths = test_batch.inputs, test_batch.input_lengths  # numpy on the host
    calls = []
    joint_step = models["cpu"].joint_step

    def recording(enc_frames, pred_proj):
        logits = joint_step(enc_frames, pred_proj)
        calls.append(logits.float())
        return logits

    greedy = {"card": TransducerDecoder(models["card"], coder, max_symbols_per_frame=max_symbols).decode_batch(
        x, lengths)}
    models["cpu"].joint_step = recording
    greedy["cpu"] = TransducerDecoder(models["cpu"], coder, max_symbols_per_frame=max_symbols).decode_batch(
        x, lengths)
    del models["cpu"].joint_step
    # the search calls the joint max_symbols times a frame: the steps that
    # decide an emission are a valid frame's first, and each one after an
    # emission in that frame
    steps = torch.stack(calls).reshape(-1, max_symbols, len(lengths), calls[0].shape[-1])  # [T', S, B, V]
    top = torch.topk(steps, 2, dim=-1).values
    emits = steps.argmax(dim=-1) != models["cpu"].blank_id
    active = [torch.arange(steps.shape[0])[:, None] < t_out[None, :]]
    for k in range(1, max_symbols):
        active.append(active[-1] & emits[:, k - 1])
    gap = torch.where(torch.stack(active, dim=1), top[..., 0] - top[..., 1], torch.inf).amin(dim=(0, 1))
    with torch.no_grad():  # the joint's noise: every frame at the start token on both sides
        start_logits = {}
        for name in ("card", "cpu"):
            m = models[name]
            dev = m.embed.device
            proj, _ = m.predict_step(torch.full((x.shape[0],), m.blank_id, device=dev),
                                     torch.ones(x.shape[0], dtype=torch.bool, device=dev),
                                     m.init_pred_carry(x.shape[0]))
            enc = outs[name][0].to(dev)
            start_logits[name] = m.joint_step(enc, proj[:, None, :].expand_as(enc)).float().cpu()
    noise = max(float((start_logits["card"][i, :n] - start_logits["cpu"][i, :n]).abs().max())
                for i, n in enumerate(t_out))
    decided = [i for i in range(len(lengths)) if float(gap[i]) > 4 * noise]
    same = [i for i in decided if np.array_equal(greedy["card"][i], greedy["cpu"][i])]
    nbest = {name: TransducerBeamDecoder(models[name], coder, beam_width=beam, max_symbols_per_frame=max_symbols)
             .decode_batch_nbest(x, lengths) for name in ("card", "cpu")}
    beam_decided, beam_same = [], []
    for i, (hk, hc) in enumerate(zip(nbest["card"], nbest["cpu"])):
        if len(hk) != len(hc) or not all(np.array_equal(a[0], b_[0]) for a, b_ in zip(hk, hc)):
            continue
        diff = max(abs(a[1] - b_[1]) for a, b_ in zip(hk, hc))
        if len(hc) < 2 or hc[0][1] - hc[1][1] > 2 * diff:
            beam_decided.append(i)
            if np.array_equal(hk[0][0], hc[0][0]):
                beam_same.append(i)
    log(f"transducer card vs CPU on final.pt ({len(lengths)} test utterances, U_pad {test_batch.targets.shape[1]}), "
        f"max|diff| from the CPU f32-compute run: card bf16 {dist['card']!r}, CPU bf16 {dist['cpu']!r} (the loss "
        f"relative; bf16 rule: within {RNN_BF16_RATIO}x + {RNN_F32_TOL}, and at least 1/{RNN_BF16_RATIO} - "
        f"{RNN_F32_TOL}: {verdicts}); greedy transcripts identical on {len(same)} of the {len(decided)} utterances "
        f"whose smallest top-two logit gap at a deciding step exceeds 4x the joint's card-CPU difference {noise!r} "
        f"(gaps {[round(float(g), 4) for g in gap]}; all: "
        f"{sum(np.array_equal(a, b_) for a, b_ in zip(greedy['card'], greedy['cpu']))} of {len(lengths)}); "
        f"beam-{beam} transcripts identical on {len(beam_same)} of the {len(beam_decided)} utterances whose n-best "
        f"agree and whose top-two gap exceeds twice the score difference; {time.perf_counter() - t0!r} s")
    if not all(close and rounds for close, rounds in verdicts.values()):
        raise AssertionError(f"the transducer on the card is outside the bf16 rule: {dist}")
    if same != decided or beam_same != beam_decided:
        raise AssertionError(f"card transcripts differ from the CPU's: greedy {sorted(set(decided) - set(same))}, "
                             f"beam {sorted(set(beam_decided) - set(beam_same))}")
    del models, outs

    # ---- greedy and beam-8 decode of the test set, timed ----
    reader = FeatureReader(os.path.join(dirs["test"], "feats.scp"), os.path.join(dirs["test"], "cmvn.scp"),
                           os.path.join(dirs["test"], "utt2spk"), 0, 0)
    batches = list(stream_padded_batches(reader, batch_size=int(conf.get("decode_batch_size", 16))))
    reader.close()
    frames = sum(int(n) for _, _, l in batches for n in l)
    model = model_on(cfg, "cuda")
    timings = {}
    for name, d in (("greedy", TransducerDecoder(model, coder, max_symbols_per_frame=max_symbols)),
                    (f"beam{beam}", TransducerBeamDecoder(model, coder, beam_width=beam,
                                                          max_symbols_per_frame=max_symbols))):
        for _ in range(2):  # a warm-up, then the timed pass
            enc_s = search_s = 0.0
            for _, xb, lb in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                encoded = d.encode(xb, lb)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                [o.cpu() for o in d.search(*encoded)]
                t2 = time.perf_counter()
                enc_s, search_s = enc_s + t1 - t0, search_s + t2 - t1
        total = enc_s + search_s
        timings.update({f"{name}_frames_per_s": frames / total, f"{name}_encoder_ms": enc_s * 1e3,
                        f"{name}_search_ms": search_s * 1e3})
        enc_frames = sum(-(-xb.shape[1] // cfg.encoder_config().subsample) for _, xb, _ in batches)
        log(f"transducer {name} decode of the test set ({len(batches)} batches of 16, {frames} frames, at most "
            f"{max_symbols} labels a frame): {total!r} s, {frames / total!r} frames/s; encoder {enc_s * 1e3!r} ms "
            f"({frames / enc_s!r} frames/s), search {search_s * 1e3!r} ms ({frames / search_s!r} frames/s; a "
            f"Python loop over {enc_frames} encoder frames); the CTC recipe's greedy decode of the same frames "
            f"{ctc_greedy_fps!r} frames/s [{card}]")
    del model

    # ---- one training step by parts ----
    trainer = Trainer(cfg, TrainerConfig(num_steps=6, loss_type="rnnt"), device="cuda")
    state = ckpt.restore_state(os.path.join(savedir, "training", "step2.pt"), trainer.init_state(0))
    model = state.model
    gen = trainer.dropout_generator(state)
    batch = train_batch
    args = (batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths)
    enc_lengths = model.output_lengths(batch.input_lengths)

    lpb, lpl, starts = model.lattice_scores_pruned(*args, train=True, generator=gen)
    scores = (lpb.detach().requires_grad_(), lpl.detach().requires_grad_(), starts)
    parts = {
        "encoder forward": median3_ms(lambda: model.encode(batch.inputs, batch.input_lengths, train=True,
                                                          generator=gen)),
        "predictor forward (kernel 4)": median3_ms(lambda: model.predict(batch.targets, batch.target_lengths,
                                                                        train=True, generator=gen)),
    }
    scores_ms = median3_ms(lambda: model.lattice_scores_pruned(*args, train=True, generator=gen))
    parts["joint and band scores"] = scores_ms - sum(parts.values())
    parts["banded alpha scan forward"] = median3_ms(lambda: rnnt_loss.rnnt_alpha_loss_banded(
        *scores, enc_lengths, batch.target_lengths))
    s = ckpt.device_snapshot(state)
    grad_ms = median3_ms(lambda: trainer.gradients(s, batch, trainer.dropout_generator(s)))
    step_ms = median3_ms(lambda: trainer.update(s, batch))
    parts["backward"] = grad_ms - sum(parts.values())
    parts["Adam"] = step_ms - grad_ms
    b, t_pad = batch.inputs.shape[:2]
    ecfg = cfg.encoder_config()
    flops = transducer_flops(ecfg, cfg, b, t_pad, u_pad + 1, cfg.prune_s, RNNT_CLASSES)
    band_flops = 2 * b * -(-t_pad // ecfg.subsample) * cfg.prune_s * cfg.joint_units * RNNT_CLASSES
    real = int(batch.input_lengths.sum().item())
    bound_ms = flops / PEAK_F32 * 1e3
    log(f"transducer train step at [{b}x{t_pad}, 40] -> T' {-(-t_pad // ecfg.subsample)}, U_pad + 1 = "
        f"{u_pad + 1} label positions, band S {cfg.prune_s} ({real} real frames): update {step_ms!r} ms "
        f"({real / step_ms * 1e3!r} frames/s); by parts {parts!r} ms; model FLOPs {flops!r} a step (forward x 3; "
        f"the joint band's product alone {band_flops!r} a forward), f32 bound {bound_ms!r} ms (products are f32 "
        f"GEMMs of bf16 values at {PEAK_F32 / 1e12:.0f} TFLOP/s), {bound_ms / step_ms!r} of it reached [{card}]")
    timings.update({"update_ms": step_ms, "flops_per_step": flops, "bound_ms": bound_ms,
                    **{f"{k.split(' (')[0].replace(' ', '_')}_ms": v for k, v in parts.items()}})
    return timings


def seven_counters() -> dict:
    """Every launch counter of the seven kernels, the recurrences' by route."""
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp, gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops import frame_preemph as fp

    counts = {"fused_ffn": fused_mlp.launches, "frame_preemph": fp.launches, "bn_dgrad": bn_fused_bwd.launches}
    for name, c in (("lstm", lstm_bidi.CELL), ("gru", gru_bidi.CELL)):
        counts.update({f"{name}_{k}": getattr(c, f"{k}_launches") for k in ("fwd_persistent", "fwd",
                                                                              "bwd_persistent", "bwd")})
    return counts


def check_wfst(tag: str, config, savedir: str) -> None:
    """A hybrid ``test_nnet``'s WFST step reached the stub Kaldi egs
    (``synthetic.write_stub_kaldi``): each of the ``num_jobs`` stub
    ``latgen-faster-mapped`` runs got the decode dir's split ``feats.scp``
    (every test utterance: the stub splits by copying), the ``HCLG.fst``
    copied from the parent GMM and ``--acoustic-scale=0.1``, and ``best
    WER`` parsed the stub scorer's lowest ``wer_*``."""
    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.kaldi import best_wer

    decodedir = os.path.join(savedir, "decode")
    nj = config.getint("general", "num_jobs")
    with open(os.path.join(decodedir, "feats.scp")) as f:
        n = sum(1 for line in f if line.strip())
    for j in range(1, nj + 1):
        with open(os.path.join(decodedir, "kaldi_decode", "log", f"decode.{j}.log")) as f:
            text = f.read()
        for want in (f"{decodedir}/split{nj}/{j}/feats.scp ({n} utterances)", f"{decodedir}/graph/HCLG.fst",
                     "--acoustic-scale=0.1"):
            if want not in text:
                raise AssertionError(f"{tag} WFST step, job {j}: the stub latgen-faster-mapped log lacks {want!r}")
    wer = best_wer(os.path.join(decodedir, "kaldi_decode"))
    if wer != f"{synthetic.STUB_WERS['wer_10']} [wer_10]":
        raise AssertionError(f"{tag} WFST step: best WER {wer!r}")
    log(f"{tag} test_nnet WFST step: {nj} stub latgen-faster-mapped jobs on the decode dir's split scp ({n} "
        f"utterances), HCLG.fst and --acoustic-scale=0.1; best WER {wer}")


def hybrid_family_macs(model) -> float:
    """Multiply-adds a frame of the TDNN's or the CNN's forward, reckoned
    from its config: per TDNN layer the spliced product; per conv layer
    ``kt·kf·C_in·C_out`` at every frequency position of its input (SAME
    padding keeps the width; the pool after it narrows the next), then the
    dense stack; the output layer."""
    cfg = model.config
    macs = 0
    if hasattr(cfg, "offsets"):  # TDNN
        fan_in = cfg.input_dim
        for offs in cfg.offsets:
            macs += fan_in * len(offs) * cfg.num_hidden_units
            fan_in = cfg.num_hidden_units
    else:
        w, c_in = cfg.freq_dim, cfg.num_channels
        for c_out, (kt, kf), p in zip(cfg.conv_filters, cfg.conv_kernels, cfg.conv_pools):
            macs += kt * kf * c_in * c_out * w
            w, c_in = ((w - p) // p + 1 if p > 1 else w), c_out
        fan_in = cfg.conv_output_dim()
        for _ in range(cfg.num_hidden_layers):
            macs += fan_in * cfg.num_hidden_units
            fan_in = cfg.num_hidden_units
    return float(macs + fan_in * cfg.num_labels)


def median3_ms(fn) -> float:
    """ms a call on CUDA events: the median of 3 calls after 3 warm-ups."""
    import statistics

    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def hybrid_family_path(card: str, family: str, ws: dict) -> tuple[str, str]:
    """bench.py's TDNN (``family = "tdnn"``, bench.py:163-186) or CNN
    (``"cnn"``, bench.py:206-222) at full width through the CLI:
    ``config_AURORA4.cfg``'s ``[nnet]`` with ``synthetic.tdnn_nnet()`` /
    ``cnn_nnet()`` over it (5 x 1024 TDNN with Kaldi's sub-sampled context,
    or 64/128 9x3/3x3 convs with frequency pools 3/1 and 4 x 1024 dense;
    raw 40 fbanks, batchnorm, bf16, 2000 pdfs) and only num_epochs,
    valid_frequency and check_freq lowered, on the training workspace's
    features and alignments: ``cli.main --steps train_nnet,test_nnet``.
    Counts reset before, read after: all seven kernel counters 0 (no hand
    kernel lies on these paths). The step-0 loss is ln 2000; the controller
    validated at step 0 and after every train step that ends a
    ``valid_frequency`` period, and every rollback went back to a validated
    step; the likelihood ark covers the test set, finite and ``[T, 2000]``;
    the WFST step reached the stub egs (``check_wfst``). Returns the
    config's path and the model dir."""
    from configparser import ConfigParser

    import torch

    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.cli import main as cli_main

    config = ConfigParser()
    config.read(ws["cfg_path"])
    nnet = {**(synthetic.tdnn_nnet() if family == "tdnn" else synthetic.cnn_nnet()), **RNN_TRAIN_NNET}
    for key, value in nnet.items():
        config.set("nnet", key, str(value))
    cfg_path = os.path.join(TRAIN_WORK, f"config_{family}.cfg")
    with open(cfg_path, "w") as f:
        config.write(f)
    savedir = os.path.join(config.get("directories", "expdir"), nnet["name"])

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counting_validations() as validations:
        rc = cli_main.main(["--config", cfg_path, "--steps", "train_nnet,test_nnet"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main {family} path: rc {rc}")
    kernels = seven_counters()
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    every = int(nnet["valid_frequency"])
    order = [st["step"] for st in steps]
    want_valid = [0] + [s + 1 for s in order if (s + 1) % every == 0]
    rollbacks = [b for a, b in zip(order, order[1:]) if b != a + 1]
    log(f"{family} path launches of the seven kernels {kernels}; {len(steps)} train steps {order} at T_pad "
        f"{[st['padded_length'] for st in steps]}, validations at steps {validations}, rollbacks to {rollbacks}; "
        f"whole run {run_s!r} s")
    if any(kernels.values()):
        raise AssertionError(f"the {family} path launched a hand kernel: {kernels}")
    if list(validations) != want_valid or any(b % every for b in rollbacks):
        raise AssertionError(f"the {family} path's validations {validations} / rollbacks {rollbacks} do not follow "
                             f"the controller's schedule (validations {want_valid}, rollbacks to multiples of "
                             f"{every})")
    check_cli_run(card, f"{family} path", {**ws, "config": config}, savedir, steps)
    return cfg_path, savedir


def check_hybrid_family(card: str, family: str, cfg_path: str, savedir: str, ws: dict) -> dict:
    """The TDNN's or CNN's outputs on the card against the port on the CPU,
    and its times:

    - the eval logits of ``final.pt`` on the first 16 test utterances on
      the card (bf16) and on the CPU in bf16 and in f32 compute, by the bf16
      rule of check_rnn_kernels against the CPU f32 run (``bf16_close`` and
      ``bf16_rounds``);
    - the CNN only: TF32 pinned off (``resolve_device``), and the conv
      stack in f32 on the card against the CPU within CONV_F32_TOL (TF32
      would put it near 1e-3); the conv stack's forward timed in bf16 and in
      f32 as a yardstick;
    - ``test_nnet``'s likelihood emission of the whole test set timed
      (frames/s, host clock, features read);
    - one step on the first training batch from the step-2 checkpoint, by
      parts on CUDA events (median of 3 after 3 warm-ups): forward,
      backward (the gradient pass less the forward), TF-Adam; beside the
      model FLOPs of the step (``hybrid_family_macs``, forward x 3) and
      their f32 bound. Returns the timings."""
    import dataclasses
    from configparser import ConfigParser

    import numpy as np
    import torch

    from tfkaldi_tpu_torch.convert import load_checkpoint
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.decode.decoder import Decoder
    from tfkaldi_tpu_torch.decode.streaming import stream_padded_batches
    from tfkaldi_tpu_torch.io import ArkWriter
    from tfkaldi_tpu_torch.models import build_model
    from tfkaldi_tpu_torch.nnet import Nnet
    from tfkaldi_tpu_torch.train import checkpoint as ckpt
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

    config = ConfigParser()
    config.read(cfg_path)
    conf = dict(config.items("nnet"))
    cfg = Nnet(config, 40, NUM_PDFS, device="cpu").model.config
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    final = load_checkpoint(savedir)

    def model_on(c, device):
        model = build_model(c)
        model.load_state_dict(final)
        return model.to(device).eval()

    def test_reader():
        featdir = ws["test_featdir"]
        return FeatureReader(os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"),
                             os.path.join(featdir, "utt2spk"), 0, 0)

    # ---- the card against the CPU on final.pt ----
    reader = test_reader()
    _, x, lengths = next(iter(stream_padded_batches(reader, batch_size=16)))
    reader.close()
    x, lengths = torch.as_tensor(x), torch.as_tensor(lengths)
    real = (torch.arange(x.shape[1])[None, :] < lengths[:, None])
    logits = {}
    for name, c, device in (("card", cfg, "cuda"), ("cpu", cfg, "cpu"), ("cpu_f32", cfg32, "cpu")):
        with torch.inference_mode():
            logits[name] = model_on(c, device)(x.to(device), lengths).float().cpu()[real]
    ref = logits["cpu_f32"]
    dist = {name: float((logits[name] - ref).abs().max() / ref.abs().max()) for name in ("card", "cpu")}
    close, rounds = bf16_close(dist["card"], dist["cpu"]), bf16_rounds(dist["card"], dist["cpu"])
    log(f"{family} eval logits of final.pt on {len(lengths)} test utterances ({int(real.sum())} frames), "
        f"max|diff|/max|ref| from the CPU f32-compute run: card bf16 {dist['card']!r}, CPU bf16 {dist['cpu']!r} "
        f"(bf16 rule: within {RNN_BF16_RATIO}x + {RNN_F32_TOL}: {close}; at least 1/{RNN_BF16_RATIO} - "
        f"{RNN_F32_TOL}: {rounds})")
    if not (close and rounds):
        raise AssertionError(f"the {family} model on the card is outside the bf16 rule: {dist}")
    timings = {"logits_rel_card": dist["card"], "logits_rel_cpu": dist["cpu"]}

    if family == "cnn":
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on after the CNN path: resolve_device did not pin it off")
        stacks = {}
        for name, device in (("card", "cuda"), ("cpu", "cpu")):
            with torch.inference_mode():
                stacks[name] = model_on(cfg32, device).conv_stack(x.to(device), lengths).float().cpu()
        conv_rel = float((stacks["card"] - stacks["cpu"]).abs().max() / stacks["cpu"].abs().max())
        batch_x, batch_len = x.cuda(), lengths.cuda()
        conv_ms = {}
        for name, c in (("bfloat16", cfg), ("float32", cfg32)):
            m = model_on(c, "cuda")
            with torch.inference_mode():
                conv_ms[name] = median3_ms(lambda: m.conv_stack(batch_x, batch_len))
        log(f"CNN conv stack in f32, card vs CPU on [{x.shape[0]}x{x.shape[1]}, 40]: max|diff|/max|ref| "
            f"{conv_rel!r} (tol {CONV_F32_TOL}; cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}); its forward "
            f"{conv_ms['bfloat16']!r} ms in bf16 vs {conv_ms['float32']!r} ms in f32 [{card}]")
        if not conv_rel <= CONV_F32_TOL:
            raise AssertionError(f"the CNN's f32 convs on the card differ from the CPU's by {conv_rel}: TF32?")
        timings.update({"conv_f32_rel": conv_rel, "conv_stack_bf16_ms": conv_ms["bfloat16"],
                        "conv_stack_f32_ms": conv_ms["float32"]})

    # ---- test_nnet's likelihood emission, timed ----
    prior = np.load(os.path.join(savedir, "prior.npy"))
    decoder = Decoder(model_on(cfg, "cuda"), prior)
    scp = os.path.join(TRAIN_WORK, f"{family}_timed", "feats.scp")
    for _ in range(2):  # a warm-up, then the timed pass
        reader = test_reader()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ArkWriter(scp, os.path.join(os.path.dirname(scp), "likes.ark")) as w:
            count = decoder.decode_to_writer(reader, w, batch_size=int(conf.get("decode_batch_size", 16)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        reader.close()
    frames = sum(m.shape[0] for m in read_ark(scp).values())
    log(f"{family} likelihood emission of the test set ({count} utterances, {frames} frames, batches of 16, features "
        f"read): {seconds!r} s, {frames / seconds!r} frames/s [{card}]")
    timings["decode_frames_per_s"] = frames / seconds
    del decoder

    # ---- one training step by parts ----
    featdir = ws["train_featdir"]
    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    reader = FeatureReader(os.path.join(featdir, "feats_shuffled.scp"), os.path.join(featdir, "cmvn.scp"),
                           os.path.join(featdir, "utt2spk"), 0, max_length)
    ali = os.path.join(config.get("directories", "expdir"), config.get("nnet", "gmm_name"), "ali", "pdf.all.gz")
    dispenser = AlignmentBatchDispenser(reader, AlignmentCoder(identity_normalizer, NUM_PDFS),
                                        int(conf["batch_size"]), ali)
    for _ in range(int(conf["valid_batches"])):  # past the validation carve
        dispenser.skip_batch()
    batch = dispenser.get_padded_batch(DeviceBatcher()).to("cuda")
    reader.close()
    trainer = Trainer(cfg, TrainerConfig(num_steps=6), device="cuda")
    state = ckpt.restore_state(os.path.join(savedir, "training", "step2.pt"), trainer.init_state(0))
    s = ckpt.device_snapshot(state)
    fwd_ms = median3_ms(lambda: trainer.loss_sum(s.model, batch, train=True))
    grad_ms = median3_ms(lambda: trainer.gradients(s, batch))
    step_ms = median3_ms(lambda: trainer.update(s, batch))
    b, t_pad = batch.inputs.shape[:2]
    macs = hybrid_family_macs(s.model)
    flops = 3 * 2 * macs * b * t_pad
    bound_ms = flops / PEAK_F32 * 1e3
    real_frames = int(batch.input_lengths.sum().item())
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        warm = [json.loads(line) for line in f][1:]
    cli_s = sorted(st["step_time"] for st in warm)[len(warm) // 2]
    parts = {"forward": fwd_ms, "backward": grad_ms - fwd_ms, "TF-Adam": step_ms - grad_ms}
    log(f"{family} train step at [{b}x{t_pad}, 40] ({real_frames} real frames): update {step_ms!r} ms "
        f"({real_frames / step_ms * 1e3!r} frames/s); by parts {parts!r} ms; CLI step (median of {len(warm)} after "
        f"the first, host clock, data wait included) {cli_s!r} s; model {macs / 1e6!r} M MACs a frame, "
        f"{flops!r} FLOPs a step (forward x 3), f32 bound {bound_ms!r} ms (products are f32 GEMMs of bf16 values at "
        f"{PEAK_F32 / 1e12:.0f} TFLOP/s), {bound_ms / step_ms!r} of it reached [{card}]")
    timings.update({"update_ms": step_ms, "forward_ms": fwd_ms, "backward_ms": grad_ms - fwd_ms,
                    "adam_ms": step_ms - grad_ms, "cli_step_s": cli_s, "macs_per_frame": macs,
                    "flops_per_step": flops, "bound_ms": bound_ms})
    return timings


def read_ark(scp: str) -> dict:
    from tfkaldi_tpu_torch.io import ArkReader

    with ArkReader(scp) as reader:
        return {utt: mat for utt, mat in reader}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    sys.path.insert(0, ROOT)
    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.cli import main as cli_main
    from tfkaldi_tpu_torch.cli import serve as cli_serve
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.device import resolve_device
    from tfkaldi_tpu_torch.frontend.prepare_data import prepare_data
    from tfkaldi_tpu_torch.io import ArkWriter, read_wav, read_wavfiles
    from tfkaldi_tpu_torch.nnet import Nnet
    from tfkaldi_tpu_torch.ops import _build, fused_mlp
    from tfkaldi_tpu_torch.ops import frame_preemph as fp
    from tests import reference_port

    resolve_device("cuda")

    # ---- build ----
    t0 = time.perf_counter()
    _build.load()
    log(f"kernel build: {time.perf_counter() - t0!r} s (nvcc {_build.build_seconds!r} s) -> "
        f"{os.path.relpath(_build.library_path(), ROOT)}")

    # ---- kernels vs plain ----
    t0 = time.perf_counter()
    ffn = check_ffn(card)
    framing = check_framing(card)
    bn, bn_dz_only_ms = check_bn_dgrad(card)
    log(f"ptxas (-Xptxas -v) of the build: {os.path.relpath(_build.ptxas_report_path(_build.library_path()), ROOT)}")
    rnn_rows = {cell: check_rnn_kernels(card, cell) for cell in ("lstm", "gru")}
    pred_rows = check_predictor_kernels(card)
    log(f"phase kernels vs plain: {time.perf_counter() - t0!r} s")

    # ---- served path at full width ----
    t_serve = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    ws = synthetic.make_workspace(WORK, num_pdfs=NUM_PDFS, hidden_units=HIDDEN_UNITS,
                                  hidden_layers=HIDDEN_LAYERS)
    cfg_path, config, context, savedir = ws["cfg_path"], ws["config"], ws["context"], ws["savedir"]
    test_featdir, train_featdir = ws["test_featdir"], ws["train_featdir"]
    spool_in = os.path.join(WORK, "spool", "in")
    spool_out = os.path.join(WORK, "spool", "out")
    log(f"workspace: {cfg_path} (440 -> {HIDDEN_LAYERS}x{HIDDEN_UNITS} -> {NUM_PDFS}, batchnorm)")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli_main.main(["--config", cfg_path, "--steps", "dnn_train_features,dnn_test_features"])
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main features: rc {rc}")
    os.makedirs(spool_in)
    jobs = {"job0": test_featdir, "job1": train_featdir, "job2": test_featdir}
    for name, src in jobs.items():
        shutil.copytree(src, os.path.join(spool_in, name))
    t1 = time.perf_counter()
    rc = cli_main.main(["--config", cfg_path, "--steps", "test_nnet"])
    if rc != 0:
        raise RuntimeError(f"cli.main test_nnet: rc {rc}")
    t2 = time.perf_counter()
    rc = cli_serve.main(["--config", cfg_path, "--watch", spool_in, "--out", spool_out, "--once"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t2
    test_nnet_s = t2 - t1
    if rc != 0:
        raise RuntimeError(f"cli.serve: rc {rc}")
    launches = {"fused_ffn": fused_mlp.launches, "frame_preemph": fp.launches}
    log(f"main-path launches: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    frame_routes = check_frame_routes("served path")
    check_wfst("served path", config, savedir)

    # ---- outputs ----
    feats = {kind: read_ark(os.path.join(d, "feats.scp")) for kind, d in (("train", train_featdir), ("test", test_featdir))}
    feat_frames = sum(m.shape[0] for f in feats.values() for m in f.values())
    for kind, arks in feats.items():
        if len(arks) != 32:
            raise AssertionError(f"{kind} feats.ark holds {len(arks)} utterances, want 32")
        for utt, m in arks.items():
            if m.ndim != 2 or m.shape[1] != 40 or not np.isfinite(m).all():
                raise AssertionError(f"{kind} feats {utt}: shape {m.shape} or non-finite values")

    # features against the reference's own numpy code, and against the
    # plain framing on the card (the rest of the chain is the same code)
    feat_conf = dict(config.items("dnn-features"))
    wavs = read_wavfiles(os.path.join(config.get("directories", "test_data"), "wav.scp"))
    oracle_err = 0.0
    for utt in list(wavs)[:4]:
        rate, sig = read_wav(wavs[utt])
        golden = reference_port.compute(sig.astype(np.float64), rate, feat_conf)
        got = feats["test"][utt]
        if got.shape != golden.shape:
            raise AssertionError(f"feats {utt}: shape {got.shape} vs reference {golden.shape}")
        oracle_err = max(oracle_err, float(np.max(np.abs(got - golden) / np.maximum(np.abs(golden), 1))))
    log(f"features vs reference numpy oracle (4 utts): max err/max(|ref|,1) {oracle_err!r} (gate 1e-4)")
    if not oracle_err <= 1e-4:
        raise AssertionError(f"features differ from the reference oracle: {oracle_err}")
    plain_featdir = os.path.join(WORK, "plain", "features")
    with plain_versions():  # same batches as the cli run (batch 32)
        prepare_data(config.get("directories", "test_data"), plain_featdir, feat_conf,
                     batch_size=32, device="cuda")
    plain_feat_err = 0.0
    for utt, m in read_ark(os.path.join(plain_featdir, "feats.scp")).items():
        plain_feat_err = max(plain_feat_err, float(np.max(np.abs(m - feats["test"][utt]))))
    log(f"test features, kernel vs plain framing (32 utts): max|diff| {plain_feat_err!r}")
    if plain_feat_err != 0.0:
        raise AssertionError(f"features with the plain framing differ: {plain_feat_err}")

    # likelihoods: shapes, finiteness, and the plain versions on the same card
    decoder = Nnet(config, 40, NUM_PDFS, device="cuda").load_decoder()
    like_frames = 0
    like_err = 0.0
    outputs = {"test_nnet": os.path.join(savedir, "decode", "feats.scp")}
    outputs.update({name: os.path.join(spool_out, name, "feats.scp") for name in jobs})
    sources = {"test_nnet": test_featdir, **jobs}
    for name, scp in outputs.items():
        if name in jobs and not os.path.isfile(os.path.join(spool_out, name, "DONE")):
            raise AssertionError(f"spool job {name} has no DONE marker")
        likes = read_ark(scp)
        ref_feats = feats["test" if sources[name] == test_featdir else "train"]
        if list(likes) != list(ref_feats):
            raise AssertionError(f"{name}: utterance ids differ from the featdir")
        for utt, m in likes.items():
            if m.shape != (ref_feats[utt].shape[0], NUM_PDFS) or not np.isfinite(m).all():
                raise AssertionError(f"{name} {utt}: likelihoods shape {m.shape} or non-finite")
            like_frames += m.shape[0]
        reader = FeatureReader(
            os.path.join(sources[name], "feats.scp"), os.path.join(sources[name], "cmvn.scp"),
            os.path.join(sources[name], "utt2spk"), context, 0,
        )
        plain_scp = os.path.join(WORK, "plain", name, "feats.scp")
        with plain_versions(), ArkWriter(plain_scp, os.path.join(WORK, "plain", name, "likes.ark")) as w:
            decoder.decode_to_writer(reader, w, batch_size=16)
        reader.close()
        for utt, m in read_ark(plain_scp).items():
            like_err = max(like_err, float(np.abs(m - likes[utt]).max()))
    log(f"likelihoods, kernels vs plain versions (4 outputs, {like_frames} frames): "
        f"max|diff| {like_err!r} (tol {LIKE_TOL})")
    if not like_err <= LIKE_TOL:
        raise AssertionError(f"likelihoods differ from the plain versions: {like_err}")

    test_frames = sum(m.shape[0] for m in feats["test"].values())
    serve_frames = like_frames - test_frames  # the 3 spool jobs
    log(f"features (train+test, 64 wavs): {feat_s!r} s, {feat_frames / feat_s!r} frames/s [{card}]")
    log(f"test_nnet (32 utts, model load included): {test_nnet_s!r} s, {test_frames / test_nnet_s!r} frames/s [{card}]")
    log(f"serve --once (3 jobs, model load included): {serve_s!r} s, {serve_frames / serve_s!r} frames/s [{card}]")
    log(f"phase served path: {time.perf_counter() - t_serve!r} s")

    # ---- training path at full width ----
    t0 = time.perf_counter()
    train_launches, train_frame_routes, train_ws = train_path(card)
    check_train_step(card, train_ws, bn["float32"]["ms"], bn_dz_only_ms["float32"])
    log(f"phase training path: {time.perf_counter() - t0!r} s")

    # ---- bench.py's bf16 DNN at full width ----
    t0 = time.perf_counter()
    bf16_launches, bf16_config, bf16_savedir = bf16_dnn_path(card, train_ws)
    check_train_step(card, train_ws, bn["bfloat16"]["ms"], bn_dz_only_ms["bfloat16"], bf16_config, bf16_savedir)
    log(f"phase bf16 DNN path: {time.perf_counter() - t0!r} s")

    # ---- the BiLSTM and BiGRU hybrid paths at full width ----
    rnn_launches = {}
    for cell in ("lstm", "gru"):
        t0 = time.perf_counter()
        cell_launches, cell_cfg, cell_savedir = rnn_train_path(card, cell, train_ws)
        check_rnn_step(card, cell, cell_cfg, cell_savedir, train_ws)
        rnn_launches.update(cell_launches)
        log(f"phase bi{cell} path: {time.perf_counter() - t0!r} s")

    # ---- the character-CTC recipe at full width (kernels 4 and 5 again) ----
    t0 = time.perf_counter()
    ctc_launches, ctc_cfg, ctc_savedir = ctc_path(card, train_ws)
    ctc_times = check_ctc_step(card, ctc_cfg, ctc_savedir, train_ws)
    for name, count in ctc_launches.items():
        rnn_launches[name] += count
    log(f"CTC phase: {json.dumps(ctc_times)} [{card}]")
    log(f"phase CTC path: {time.perf_counter() - t0!r} s")

    # ---- the joint CTC-attention conformer recipe at full width (no hand kernel on its path) ----
    t0 = time.perf_counter()
    att_cfg, att_savedir, att_dirs = attention_path(card, train_ws)
    att_times = check_attention(card, att_cfg, att_savedir, att_dirs)
    log(f"attention phase: {json.dumps(att_times)} [{card}]")
    log(f"phase attention path: {time.perf_counter() - t0!r} s")

    # ---- the conformer-transducer recipe at full width (kernels 4 and 5 on its prediction network) ----
    t0 = time.perf_counter()
    rnnt_launches, rnnt_cfg, rnnt_savedir = transducer_path(card, train_ws, att_dirs)
    rnnt_times = check_transducer(card, rnnt_cfg, rnnt_savedir, att_dirs, ctc_times["greedy_frames_per_s"])
    for name, count in rnnt_launches.items():
        rnn_launches[name] += count
    log(f"kernels 4 and 5 at the prediction network's shape {list(PRED_SHAPE)}, one direction, bf16: "
        f"{json.dumps({part: {**row, 'launches': rnnt_launches[f'lstm_{part}']} for part, row in pred_rows.items()})} "
        f"[{card}]")
    log(f"transducer phase: {json.dumps(rnnt_times)} [{card}]")
    log(f"phase transducer path: {time.perf_counter() - t0!r} s")

    # ---- bench.py's TDNN and CNN on the hybrid recipe at full width (no hand kernel on their paths) ----
    for family in ("tdnn", "cnn"):
        t0 = time.perf_counter()
        family_cfg, family_savedir = hybrid_family_path(card, family, train_ws)
        family_times = check_hybrid_family(card, family, family_cfg, family_savedir, train_ws)
        log(f"{family} phase: {json.dumps(family_times)} [{card}]")
        log(f"phase {family} path: {time.perf_counter() - t0!r} s")

    # launches: f32, the served path's and the training path's runs
    # together; bf16, the bf16 DNN path's run; kernels 4 and 5, the BiLSTM
    # path's, the CTC path's and the transducer path's runs together
    total = {name: launches.get(name, 0) + train_launches[name] for name in train_launches}
    kernels = [
        dict(name="fused_ffn_f32", route="cuda", source="tfkaldi_tpu_torch/ops/csrc/fused_ffn.cu",
             replaces="tfkaldi_tpu/ops/fused_mlp.py:40", launches=total["fused_ffn"], **ffn["float32"]),
        dict(name="fused_ffn_bf16", route="cuda", source="tfkaldi_tpu_torch/ops/csrc/fused_ffn.cu",
             replaces="tfkaldi_tpu/ops/fused_mlp.py:40", launches=bf16_launches["fused_ffn"], **ffn["bfloat16"]),
        dict(name="frame_preemph", route="cuda", source="tfkaldi_tpu_torch/ops/csrc/frame_preemph.cu",
             replaces="tfkaldi_tpu/ops/pallas_frontend.py:69", launches=total["frame_preemph"],
             launches_by_route={r: frame_routes[r] + train_frame_routes[r] for r in frame_routes}, **framing),
        dict(name="bn_dgrad_f32", route="cuda", source="tfkaldi_tpu_torch/ops/csrc/bn_dgrad.cu",
             replaces="tfkaldi_tpu/ops/bn_fused_bwd.py:63", launches=total["bn_dgrad"], **bn["float32"]),
        dict(name="bn_dgrad_bf16", route="cuda", source="tfkaldi_tpu_torch/ops/csrc/bn_dgrad.cu",
             replaces="tfkaldi_tpu/ops/bn_fused_bwd.py:63", launches=bf16_launches["bn_dgrad"], **bn["bfloat16"]),
    ]
    for cell, kernel_file, lines in (("lstm", "pallas_lstm.py", (103, 255)), ("gru", "pallas_gru.py", (71, 212))):
        for part, line in zip(("fwd", "bwd"), lines):
            kernels.append(dict(
                name=f"{cell}_{part}", route="cuda", source=f"tfkaldi_tpu_torch/ops/csrc/{cell}_bidi.cu",
                replaces=f"tfkaldi_tpu/ops/{kernel_file}:{line}", launches=rnn_launches[f"{cell}_{part}"],
                **rnn_rows[cell][part]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

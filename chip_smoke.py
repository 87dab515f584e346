"""Smoke run of the PyTorch/CUDA port on one GPU: kernels, the served
path, the training path in f32 and in bf16, the BiLSTM and BiGRU paths,
the character-CTC recipe, the joint CTC-attention conformer recipe, the
conformer-transducer recipe, the text recipes' offline decode, then
bench.py's TDNN and CNN.

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
   Then the training knobs (``knobs_path``): the f32 DNN through ``cli.main
   --steps train_nnet,test_nnet`` with ``specaugment``, ``visualise`` and
   ``profile_steps = 2``: kernel 3 6 launches a step, kernel 1 in
   ``test_nnet``, the event file read back (a ``train/loss`` a step equal
   to metrics.jsonl's, ``valid/loss`` at each validation, a histogram a
   parameter), the trace naming kernel 3's CUDA kernel and giving the two
   profiled steps' device idle share and top ops, the likelihood ark
   through the port's ``kaldi_compat``; the first 8 batches of the bulk
   and the Python loaders byte-identical and timed; SpecAugment card vs
   CPU, its replay, its masked share against the analytic value and its
   ms a step. Every CLI training run of the script asserts that the
   native bulk loader served all its batches (``check_loader``).
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
11. Drives the text recipes' offline decode as the JAX package runs it on
   the three models those phases trained, with one character trigram ARPA
   estimated from the training transcripts (``text_decode_path``): the
   attention model's autoregressive beam (``decode_mode = beam``, beam 10,
   at most 200 tokens) unfused and LM-fused, its first batch's n-best on
   the card against the CPU's and beam 1 against a greedy walk of the
   cached step, both timed beside the rescoring decode; the transducer's
   beam 8 fused (a zero-weight table gives the unfused n-best exactly); the
   CTC beam 16 fused on the Python beam (the fused route on every batch,
   kernel 4 once per layer and batch); and ``cli.serve --once`` on one job
   per recipe, whose ``text`` equals ``Nnet.decode_text``'s.
12. Drives ``cli.serve --stream`` as users start it (``streaming_path``):
   the 32 test wavs in 100 ms chunks from 16 concurrent clients over the
   socket, on the transducer phase's ``final.pt`` with the recipe as
   written (beam 8, 16 slots), then 4 and 1 at a time for the chunk-reply
   latency, with ``--beam-width 1`` and with the text decode phase's
   trigram as ``lm_path``; then the CTC recipe unidirectional (seeded
   weights): greedy, beam 16 with the trigram, ``--endpoint`` and a run
   that reads back timestamps, confidences and words. Every final against
   the card's offline decode of the offline features (kernel 2; the CTC's
   offline forward kernel 4, one direction): identical or the first
   differing decision a near tie, its margin printed; the streamed encoder
   by the bf16 rule and the fused front-end's frames against the offline
   ones; latency p50 / p95, tick p50, real-time factor, ticks and rows.
13. Drives bench.py's TDNN and CNN on the hybrid recipe at full width
   (``hybrid_family_path``, ``check_hybrid_family``).
14. Drives the multi-process path (``multiprocess_path``), right after
   the training path: ``torchrun --standalone --nproc_per_node
   min(cards, 4)`` on a worker that brings up the NCCL process group on
   ``cuda:LOCAL_RANK`` and calls ``cli.main --steps train_nnet,test_nnet``
   on the training path's full-width f32 workspace (its own savedir), the
   grid's collectives on every step, world size 1 included. The children
   print their backend, world size, grid and kernel 1's and kernel 3's
   launches by route (the counters live in the child), a host barrier and
   an all-reduce of the step's gradient buffer timed on NCCL. The phase
   fails unless the backend is NCCL, kernels 3 and 1 launched in the
   child, every per-step loss equals the single-process CLI's within
   ``MP_LOSS_RTOL`` (equality expected at world size 1: 1e-6; 2e-4 with
   more ranks, whose global batch holds the rows in another order) and the
   merged likelihood ark equals the single-process ark within ``LIKE_TOL``
   (with more ranks, whose model is another rounding of the same
   training, one process's decode of the run's ``final.pt``).
15. Prints one JSON line of per-kernel results (all seven; kernel 2 counts
   the streaming path's offline features too, kernels 4 and 5 count the
   BiLSTM, the CTC, the transducer and, kernel 4, the text decode and
   streaming paths), then the final JSON line.

Any failure raises and exits non-zero; nothing is caught and passed over.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
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
# the multi-process path: the training path's [nnet] in its own savedir, at
# most 4 ranks; at world size 1 the losses are the single process's, bit for bit
MP_NNET = {"name": "dnn_mp"}
MP_MAX_RANKS = 4
# the losses against the single-process CLI: equal at one rank (every
# all-reduce returns its input); with more, a global batch holds the single
# process's rows in another order (strided shards), so the sums round
# otherwise: tests/test_distributed_cli.py's bound
MP_LOSS_RTOL = {1: 1e-6, "more": 2e-4}
MP_TIMEOUT_S = 600
# the training knobs on the f32 DNN, in its own savedir: the trace covers steps 2-3 (profile_start 2)
KNOBS_PROFILE_STEPS = 2
KNOBS_NNET = {"name": "dnn_knobs", "specaugment": "True", "visualise": "True",
              "profile_steps": str(KNOBS_PROFILE_STEPS)}
KNOBS_LOADER_BATCHES = 8  # batches of each loader compared byte for byte and timed
SPEC_DRAWS = 200  # SpecAugment draws whose masked share is held to its expectation

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
# utterances of the first attention decode batch whose beam the CPU replays (text_decode_path)
REPLAY_ROWS = 8
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
    routes, the beam searches' runs, the rescoring counts, the RNN-T loss's
    routes and the bulk loader's batches, just before a path is driven."""
    from tfkaldi_tpu_torch.data import bulk_loader
    from tfkaldi_tpu_torch.decode import ctc as ctc_decode
    from tfkaldi_tpu_torch.decode import seq2seq as seq2seq_decode
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp, gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops import frame_preemph as fp
    from tfkaldi_tpu_torch.train import ctc
    from tfkaldi_tpu_torch.train import trainer as trainer_mod

    fused_mlp.launches = fp.launches = bn_fused_bwd.launches = 0
    for counts in (fused_mlp.launches_by_route, bn_fused_bwd.launches_by_route, fp.launches_by_route,
                   ctc.launches_by_route, ctc_decode.beam_runs, seq2seq_decode.rescored, trainer_mod.rnnt_routes,
                   bulk_loader.batches):
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


def check_loader(tag: str, kind: str, cfg_path: str, steps: int) -> None:
    """A CLI training run's batches all came from the native bulk loader of
    ``kind`` (``alignment``: ``BulkAlignmentBatchSource``, ``text``:
    ``BulkTextBatchSource``): it served at least the validation batches and
    one batch a step (the prefetcher reads up to 2 ahead, a rollback reads
    again), the other source none. ``cli.main`` builds one source a run, so
    no batch came from the Python dispenser."""
    from configparser import ConfigParser

    from tfkaldi_tpu_torch.data import bulk_loader

    config = ConfigParser()
    config.read(cfg_path)
    want = config.getint("nnet", "valid_batches") + steps
    served = dict(bulk_loader.batches)
    log(f"{tag} batches from the native bulk loader: {served} (at least {want} {kind} batches: "
        f"{steps} steps + the validation set)")
    other = "text" if kind == "alignment" else "alignment"
    if served[kind] < want or served[other] != 0:
        raise AssertionError(f"{tag}: bulk loader batches {served}, want {kind} >= {want} and {other} 0")


def validate_arks(tag: str, scps: list) -> None:
    """Each ark of ``scps`` passes the port's strict Kaldi consumer: every
    record read sequentially and at its scp offset with the same bytes."""
    from tfkaldi_tpu_torch.io import kaldi_compat

    counts = {os.path.relpath(scp, ROOT): kaldi_compat.validate_archive(scp) for scp in scps}
    log(f"{tag}: arks through the port's strict Kaldi consumer (kaldi_compat.validate_archive), records {counts}")
    if not all(counts.values()):
        raise AssertionError(f"{tag}: an ark validated no record: {counts}")


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
    check_loader("training path", "alignment", ws["cfg_path"], len(steps))
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


# the multi-process path's rank: brings the NCCL group up itself (so that the
# CLI leaves it up for the readings after), runs the CLI, prints one JSON line
MP_WORKER = """import json, os, sys, time
sys.path.insert(0, {root!r})
import torch
import torch.distributed as dist
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp
from tfkaldi_tpu_torch.parallel import multihost

device, _ = multihost.initialize("cuda")
t0 = time.perf_counter()
rc = cli_main.main(["--config", {cfg!r}, "--steps", "train_nnet,test_nnet"])
run_s = time.perf_counter() - t0
grads = torch.zeros({grad_numel}, device=device)
times = {{"barrier_ms": [], "grad_allreduce_ms": []}}
for _ in range(5):
    t0 = time.perf_counter()
    multihost.barrier("timing")
    times["barrier_ms"].append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(grads)
    torch.cuda.synchronize()
    times["grad_allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
print("MP_RANK " + json.dumps({{
    "rank": dist.get_rank(), "rc": rc, "backend": dist.get_backend(), "world": dist.get_world_size(),
    "device": str(device), "fused_ffn": dict(fused_mlp.launches_by_route),
    "bn_dgrad": dict(bn_fused_bwd.launches_by_route), "run_s": run_s,
    **{{k: sorted(v)[len(v) // 2] for k, v in times.items()}}}}), flush=True)
multihost.shutdown()
sys.exit(rc)
"""


def dnn_grad_numel() -> int:
    """The f32 DNN's parameter count: the flat gradient buffer a step
    all-reduces (the summed loss and the frame count ride along)."""
    widths = [440] + [HIDDEN_UNITS] * HIDDEN_LAYERS
    hidden = sum(a * b + 3 * b for a, b in zip(widths[:-1], widths[1:]))  # w, b, beta
    return hidden + HIDDEN_UNITS * NUM_PDFS + NUM_PDFS + 2


def multiprocess_path(card: str, ws: dict) -> dict:
    """``torchrun`` over ``min(cards, MP_MAX_RANKS)`` ranks on the training
    path's workspace (phase 14 of the module docstring). Returns the
    children's launches of kernels 1 and 3."""
    from configparser import ConfigParser

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    nproc = min(torch.cuda.device_count(), MP_MAX_RANKS)
    config = ConfigParser()
    config.read(ws["cfg_path"])
    for key, value in MP_NNET.items():
        config.set("nnet", key, value)
    cfg_path = os.path.join(TRAIN_WORK, "config_dnn_mp.cfg")
    with open(cfg_path, "w") as f:
        config.write(f)
    savedir = os.path.join(config.get("directories", "expdir"), MP_NNET["name"])
    shutil.rmtree(savedir, ignore_errors=True)
    worker = os.path.join(TRAIN_WORK, "mp_worker.py")
    with open(worker, "w") as f:
        f.write(MP_WORKER.format(root=ROOT, cfg=cfg_path, grad_numel=dnn_grad_numel()))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           "--tee", "3", worker]
    log(f"multi-process path: {' '.join(cmd[1:])} ({torch.cuda.device_count()} card(s) visible)")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MP_TIMEOUT_S, cwd=ROOT)
    wall_s = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    with open(os.path.join(TRAIN_WORK, "mp_run.log"), "w") as f:
        f.write(out)
    if proc.returncode != 0:
        print(out[-6000:], flush=True)
        raise RuntimeError(f"torchrun multi-process path: rc {proc.returncode}")
    ranks = [json.loads(line.split("MP_RANK ", 1)[1]) for line in out.splitlines() if "MP_RANK " in line]
    log(f"multi-process path children: {json.dumps(ranks)}")
    if sorted(r["rank"] for r in ranks) != list(range(nproc)):
        raise AssertionError(f"multi-process path: reports of ranks {[r['rank'] for r in ranks]}, want {nproc}")
    for r in ranks:
        if r["backend"] != "nccl" or r["world"] != nproc or r["rc"] != 0:
            raise AssertionError(f"multi-process path rank {r['rank']}: backend {r['backend']}, world {r['world']}, "
                                 f"rc {r['rc']}; want nccl, {nproc}, 0")
        if not (sum(r["bn_dgrad"].values()) > 0 and sum(r["fused_ffn"].values()) > 0):
            raise AssertionError(f"multi-process path rank {r['rank']}: kernel 3 {r['bn_dgrad']}, kernel 1 "
                                 f"{r['fused_ffn']}; both must launch")
    grid = re.search(r"training on a (\d+)x(\d+) grid of ranks", out)
    if grid is None:
        raise AssertionError("multi-process path: the trainer logged no grid")
    with open(os.path.join(ws["savedir"], "metrics.jsonl")) as f:
        single = [json.loads(line) for line in f]
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        multi = [json.loads(line) for line in f]
    if len(multi) != len(single):
        raise AssertionError(f"multi-process path: {len(multi)} steps, the single process ran {len(single)}")
    loss_err = max(abs(m["loss"] - s["loss"]) / abs(s["loss"]) for m, s in zip(multi, single))
    loss_tol = MP_LOSS_RTOL[1] if nproc == 1 else MP_LOSS_RTOL["more"]
    log(f"multi-process per-step losses vs the single-process CLI ({len(multi)} steps): max rel diff "
        f"{loss_err!r} (tol {loss_tol}; {'bit-equal' if loss_err == 0 else 'not bit-equal'})")
    if not loss_err <= loss_tol:
        raise AssertionError(f"multi-process losses {[m['loss'] for m in multi]} vs {[s['loss'] for s in single]}")
    likes = read_ark(os.path.join(savedir, "decode", "feats.scp"))
    single_ark = read_ark(os.path.join(ws["savedir"], "decode", "feats.scp"))
    if nproc == 1:  # the same model: the single-process run's ark
        want, against = single_ark, "the single-process ark"
    else:  # another model (the sums rounded in another order): one process decodes the run's own final.pt
        from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
        from tfkaldi_tpu_torch.io import ArkWriter
        from tfkaldi_tpu_torch.nnet import Nnet

        test_featdir = ws["test_featdir"]
        reader = FeatureReader(*(os.path.join(test_featdir, n) for n in ("feats.scp", "cmvn.scp", "utt2spk")),
                               config.getint("nnet", "context_width"), 0)
        out = os.path.join(TRAIN_WORK, "mp_one_process")
        with ArkWriter(out + ".scp", out + ".ark") as writer:
            Nnet(config, 40, NUM_PDFS, device="cuda").load_decoder().decode_to_writer(reader, writer, batch_size=16)
        reader.close()
        want, against = read_ark(out + ".scp"), "one process's decode of the run's final.pt"
        trained = max(float(np.abs(likes[u] - m).max()) for u, m in single_ark.items())
        log(f"multi-process ark vs the single-process training run's ark: max|diff| {trained!r} (two models)")
    if sorted(likes) != sorted(want):
        raise AssertionError(f"multi-process path: the merged ark's utterances differ from {against}'s")
    like_err = max(float(np.abs(likes[u] - m).max()) for u, m in want.items())
    log(f"multi-process merged likelihood ark vs {against} ({len(likes)} utts): max|diff| {like_err!r} "
        f"(tol {LIKE_TOL})")
    if not like_err <= LIKE_TOL:
        raise AssertionError(f"multi-process likelihoods differ from {against}: {like_err}")
    step_mp = sorted(m["step_time"] for m in multi[1:])[len(multi[1:]) // 2]
    step_single = sorted(s["step_time"] for s in single[1:])[len(single[1:]) // 2]
    times = {
        "ranks": nproc, "grid": [int(grid.group(1)), int(grid.group(2))], "backend": ranks[0]["backend"],
        "step_s_multi": step_mp, "step_s_single": step_single,
        "barrier_ms": ranks[0]["barrier_ms"], "grad_allreduce_ms": ranks[0]["grad_allreduce_ms"],
        "grad_allreduce_numel": dnn_grad_numel(), "child_cli_s": ranks[0]["run_s"], "torchrun_wall_s": wall_s,
        "loss_max_rel_diff": loss_err, "like_max_abs_diff": like_err,
    }
    log(f"multi-process phase: {json.dumps(times)} [{card}]")
    log(f"phase multi-process path: {time.perf_counter() - t_phase!r} s [{card}]")
    launches = {"fused_ffn": sum(sum(r["fused_ffn"].values()) for r in ranks),
                "bn_dgrad": sum(sum(r["bn_dgrad"].values()) for r in ranks)}
    return launches


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
    check_loader("bf16 DNN path", "alignment", cfg_path, len(steps))
    log(f"bf16 DNN path launches: {launches}; {len(steps)} train steps (replays after a rollback included); "
        f"whole run {run_s!r} s")
    check_dnn_routes("bf16 DNN path", len(steps))  # kernel 3: 6 launches a step
    check_cli_run(card, "bf16 DNN path", ws, savedir, steps)
    return launches, config, savedir


@contextlib.contextmanager
def decode_launches():
    """Kernel 1's launches inside ``Nnet.decode`` (``test_nnet``'s
    likelihoods), counted apart from the validations' in the same run."""
    from tfkaldi_tpu_torch import nnet as nnet_mod
    from tfkaldi_tpu_torch.ops import fused_mlp

    counted = {"fused_ffn": 0}
    original = nnet_mod.Nnet.decode

    def decode(self, *args, **kw):
        before = fused_mlp.launches
        try:
            return original(self, *args, **kw)
        finally:
            counted["fused_ffn"] += fused_mlp.launches - before

    nnet_mod.Nnet.decode = decode
    try:
        yield counted
    finally:
        nnet_mod.Nnet.decode = original


def trace_steps(trace: dict, span: str = "train_step", top: int = 5) -> dict:
    """From a torch.profiler Chrome trace: the ``span`` ranges (the
    controller's ``record_function`` around each train step), the device's
    busy time inside them (the union of kernel, memcpy and memset events,
    clipped to the spans) and its idle share, and the ``top`` device ops by
    their summed time inside the spans."""
    events = trace["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == span and e.get("cat") == "user_annotation")
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    busy, by_name = 0.0, {}
    for lo, hi in spans:
        inside = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi), e["name"]) for e in device
                        if e["ts"] < hi and e["ts"] + e["dur"] > lo)
        end = lo
        for a, b, name in inside:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
            by_name[name] = by_name.get(name, 0.0) + (b - a)
    wall = sum(hi - lo for lo, hi in spans)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"steps": len(spans), "wall_ms": wall / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall if wall else None, "device_events": len(device),
            "top_ops": [{"name": name[:160], "ms": dur / 1e3, "share_of_wall": dur / wall} for name, dur in ranked]}


def spec_masked_fraction(lengths, raw: int, cfg) -> float:
    """The expected share of the real frames' inputs that SpecAugment
    zeroes, from the draw's distribution (``spec_augment_draw``: width
    uniform on [0, W], start uniform on [0, max(limit − w, 1)), the masks
    independent): an element is kept when no time band covers its frame and
    no frequency band its raw column, and P(index i covered by one band) =
    Σ_w P(w)·#{s: s ≤ i < s + w} / span_w."""
    import numpy as np

    def covered(n_masks, max_width, limit):
        idx = np.arange(limit)
        one = np.zeros(limit)
        for w in range(max_width + 1):
            span = max(limit - w, 1)
            lo, hi = np.maximum(idx - w + 1, 0), np.minimum(idx, span - 1)
            one += np.clip(hi - lo + 1, 0, None) / span / (max_width + 1)
        return 1.0 - (1.0 - one) ** n_masks

    kept_f = 1.0 - covered(cfg.spec_freq_masks, cfg.spec_freq_width, raw).mean()
    total = sum(int(n) for n in lengths)
    masked = sum(int(n) * (1.0 - (1.0 - covered(cfg.spec_time_masks, cfg.spec_time_width, int(n)).mean()) * kept_f)
                  for n in lengths)
    return masked / total


def compare_loaders(card: str, ws: dict, batches: int = KNOBS_LOADER_BATCHES):
    """The first ``batches`` batches of ``BulkAlignmentBatchSource`` and of
    the Python ``AlignmentBatchDispenser`` + ``DeviceBatcher`` on the
    training workspace (its shuffled scp, CMVN, the pdf alignments, batch
    128): byte-identical, each timed on the host clock. Returns the ms a
    batch of each and the bulk source's first batch."""
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.bulk_loader import BulkAlignmentBatchSource
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.io import read_alignments

    config, featdir = ws["config"], ws["train_featdir"]
    paths = (os.path.join(featdir, "feats_shuffled.scp"), os.path.join(featdir, "cmvn.scp"),
             os.path.join(featdir, "utt2spk"))
    alifile = os.path.join(config.get("directories", "expdir"), config.get("nnet", "gmm_name"), "ali", "pdf.all.gz")
    batch_size, context = config.getint("nnet", "batch_size"), ws["context"]
    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    bulk = BulkAlignmentBatchSource(*paths, context, read_alignments(alifile), batch_size, num_labels=NUM_PDFS,
                                    max_input_length=max_length)
    reader = FeatureReader(*paths, context, max_length)
    python = AlignmentBatchDispenser(reader, AlignmentCoder(identity_normalizer, NUM_PDFS), batch_size, alifile)
    batcher = DeviceBatcher()
    out, ms = {}, {}
    for name, source in (("bulk", bulk), ("python", python)):
        t0 = time.perf_counter()
        out[name] = [source.get_padded_batch(batcher) for _ in range(batches)]
        ms[name] = (time.perf_counter() - t0) * 1e3 / batches
    reader.close()
    for i, (a, b) in enumerate(zip(out["bulk"], out["python"])):
        for field, x, y in zip(("inputs", "targets", "input_lengths", "target_lengths"), a.fields(), b.fields()):
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                raise AssertionError(f"loaders: batch {i} {field} differs (bulk {x.dtype} {x.shape}, "
                                     f"python {y.dtype} {y.shape})")
    shape = list(out["bulk"][0].inputs.shape)
    log(f"loaders side by side: the first {batches} batches of BulkAlignmentBatchSource and of "
        f"AlignmentBatchDispenser + DeviceBatcher byte-identical (inputs {shape} f32, targets, lengths); "
        f"ms a batch (host clock): bulk {ms['bulk']!r}, python {ms['python']!r} ({ms['python'] / ms['bulk']!r}x) "
        f"[{card}]")
    return ms, out["bulk"][0]


def check_spec_augment(card: str, host_batch, step_ms: float) -> dict:
    """SpecAugment on the card at the recipe's defaults (2 time masks up to
    20 frames, 2 frequency masks up to 8 of the 40 raw columns, tiled over
    the 11 splice copies) on a full-width batch [128, 512, 440]: the same
    bands through ``spec_augment_apply`` on the card and on the CPU give
    identical outputs; two draws for one ``(seed, step)`` are identical;
    the masked share of the real frames' inputs over ``SPEC_DRAWS`` steps'
    draws lies within 4σ of ``spec_masked_fraction``; and the ms it adds to
    a step (CUDA events) beside its bound and ``step_ms``."""
    import types

    import numpy as np
    import torch

    from tfkaldi_tpu_torch.models import DNNConfig
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig, spec_augment_apply, spec_augment_draw

    raw = 40
    cfg = TrainerConfig(spec_augment=True, spec_raw_dim=raw)
    trainer = Trainer(DNNConfig(input_dim=host_batch.inputs.shape[2], num_labels=NUM_PDFS), cfg, device="cuda")
    batch = host_batch.to("cuda")
    b, t, d = batch.inputs.shape
    gen = torch.Generator(device="cuda").manual_seed(1234)
    time_bands = spec_augment_draw(gen, b, cfg.spec_time_masks, cfg.spec_time_width, batch.input_lengths)
    freq_bands = spec_augment_draw(gen, b, cfg.spec_freq_masks, cfg.spec_freq_width,
                                   torch.full((b,), raw, device="cuda"))
    card_out = spec_augment_apply(batch, time_bands, freq_bands, raw).inputs.cpu()
    cpu_out = spec_augment_apply(host_batch.to("cpu"), tuple(x.cpu() for x in time_bands),
                                 tuple(x.cpu() for x in freq_bands), raw).inputs
    if not torch.equal(card_out, cpu_out):
        raise AssertionError(f"SpecAugment apply, card vs CPU on the same bands: max|diff| "
                             f"{float((card_out - cpu_out).abs().max())}")
    state = types.SimpleNamespace(seed=0, step=5, mesh=None)
    first = trainer.spec_augment(state, batch).inputs
    if not torch.equal(first, trainer.spec_augment(state, batch).inputs):
        raise AssertionError("SpecAugment: two draws for one (seed, step) differ on the card")
    ones = dataclasses.replace(batch, inputs=torch.ones_like(batch.inputs))
    real = (torch.arange(t, device="cuda")[None, :] < batch.input_lengths[:, None].long())[:, :, None]
    denom = float(batch.input_lengths.sum()) * d
    fractions = []
    for step in range(SPEC_DRAWS):
        out = trainer.spec_augment(types.SimpleNamespace(seed=0, step=step, mesh=None), ones).inputs
        fractions.append(float(((out == 0) & real).sum()) / denom)
    mean = float(np.mean(fractions))
    want = float(spec_masked_fraction(batch.input_lengths.cpu().numpy(), raw, cfg))
    sigma = float(np.std(fractions, ddof=1)) / math.sqrt(SPEC_DRAWS)
    log(f"SpecAugment masked share of the real frames' inputs over {SPEC_DRAWS} draws: {mean!r} "
        f"(expected {want!r}, sigma of the mean {sigma!r}, gate 4 sigma)")
    if not abs(mean - want) <= 4 * sigma:
        raise AssertionError(f"SpecAugment masked share {mean} is not within 4 sigma of {want}")
    ms = ms_median(lambda: trainer.spec_augment(state, batch))
    row = {"spec_augment_ms": ms, **bound(0.0, 2 * nbytes(batch.inputs)), "step_ms": step_ms,
           "share_of_step": ms / step_ms, "masked_share": mean, "expected_share": want}
    log(f"SpecAugment card vs CPU on the same bands: identical ({b}x{t}x{d} f32); same (seed, step) twice: "
        f"identical; {ms!r} ms a step (draw + apply, median of 3 windows of 20 calls; bound {row['bound_ms']!r} ms "
        f"by {row['bound_by']}), {100 * ms / step_ms!r}% of the {step_ms!r} ms step [{card}]")
    return row


def knobs_path(card: str, ws: dict) -> tuple[dict, dict]:
    """The training knobs on the flagship DNN at full width (f32):
    ``cli.main --steps train_nnet,test_nnet`` on the training workspace's
    features and alignments with ``specaugment = True``, ``visualise =
    True`` and ``profile_steps = 2`` (steps 2-3) and a savedir of its own,
    the same three keys lowered as the training path. Counts reset before,
    read after: every batch from ``BulkAlignmentBatchSource``; kernel 3 6
    launches a step; kernel 1 launched in ``test_nnet``; the event file
    under ``<savedir>/logdir`` read back with the port's ``read_events``:
    one ``train/loss`` a step equal (as f32) to metrics.jsonl's, a
    ``valid/loss`` at each validation, one histogram per parameter under
    its JAX pytree path; the Chrome trace under ``<savedir>/profile`` names
    kernel 3's CUDA kernel, and its two ``train_step`` spans give the
    device's idle share and top ops; the likelihood ark passes the port's
    ``kaldi_compat.validate_archive``. Then the loaders side by side and
    SpecAugment on the card. Returns the launches and the phase's numbers."""
    import glob
    from configparser import ConfigParser

    import numpy as np
    import torch

    from tfkaldi_tpu_torch.cli import main as cli_main
    from tfkaldi_tpu_torch.convert import jax_param_path
    from tfkaldi_tpu_torch.nnet import Nnet
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp
    from tfkaldi_tpu_torch.utils.tb_events import read_events

    config = ConfigParser()
    config.read(ws["cfg_path"])
    for key, value in KNOBS_NNET.items():
        config.set("nnet", key, value)
    cfg_path = os.path.join(TRAIN_WORK, "config_dnn_knobs.cfg")
    with open(cfg_path, "w") as f:
        config.write(f)
    savedir = os.path.join(config.get("directories", "expdir"), KNOBS_NNET["name"])

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with decode_launches() as in_decode:
        rc = cli_main.main(["--config", cfg_path, "--steps", "train_nnet,test_nnet"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main training knobs: rc {rc}")
    launches = {"fused_ffn": fused_mlp.launches, "bn_dgrad": bn_fused_bwd.launches}
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    check_loader("training knobs", "alignment", cfg_path, len(steps))
    log(f"training knobs launches: {launches}, kernel 1 in test_nnet {in_decode['fused_ffn']}; {len(steps)} train "
        f"steps (replays after a rollback included); whole run {run_s!r} s")
    if launches["bn_dgrad"] != HIDDEN_LAYERS * len(steps):
        raise AssertionError(f"training knobs: bn_dgrad launched {launches['bn_dgrad']} times, want "
                             f"{HIDDEN_LAYERS} x {len(steps)} steps")
    if not in_decode["fused_ffn"] > 0:
        raise AssertionError("training knobs: kernel 1 was not launched in test_nnet")
    check_dnn_routes("training knobs", len(steps))
    check_cli_run(card, "training knobs", ws, savedir, steps)

    # the event file
    (events_path,) = glob.glob(os.path.join(savedir, "logdir", "events.out.tfevents.*"))
    events = read_events(events_path)
    losses = [(step, vals["train/loss"]) for step, vals in events if "train/loss" in vals]
    want_losses = [(m["step"], float(np.float32(m["loss"]))) for m in steps]
    every = config.getint("nnet", "valid_frequency")
    valid = [step for step, vals in events if "valid/loss" in vals]
    want_valid = [m["step"] + 1 for m in steps if (m["step"] + 1) % every == 0]
    hist = sorted(tag for _, vals in events for tag, v in vals.items() if v == "histogram")
    model = Nnet(config, 40, NUM_PDFS, device="cpu").model
    want_hist = sorted("params" + jax_param_path(name) for name, _ in model.named_parameters())
    log(f"training knobs event file {os.path.relpath(events_path, ROOT)}: {len(events)} records, train/loss at "
        f"steps {[s for s, _ in losses]}, valid/loss at steps {valid}, {len(hist)} histograms ({hist[:3]} ...)")
    if losses != want_losses:
        raise AssertionError(f"training knobs: train/loss events {losses} differ from metrics.jsonl {want_losses}")
    if valid != want_valid:
        raise AssertionError(f"training knobs: valid/loss at {valid}, want {want_valid}")
    if hist != want_hist:
        raise AssertionError(f"training knobs: histograms {hist}, want one per parameter {want_hist}")

    # the trace
    (trace_path,) = glob.glob(os.path.join(savedir, "profile", "*.pt.trace.json"))
    with open(trace_path) as f:
        trace = json.load(f)
    kernel_names = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"}
    dz = sorted(name for name in kernel_names if "bn_dz_kernel" in name)
    split = trace_steps(trace)
    log(f"training knobs trace {os.path.relpath(trace_path, ROOT)} ({os.path.getsize(trace_path)} B): "
        f"{len(kernel_names)} distinct kernels, kernel 3's {dz[:1]}; the {split['steps']} profiled full-width "
        f"train steps: {json.dumps(split)} [{card}]")
    if not dz:
        raise AssertionError("training knobs: the trace names no kernel-3 CUDA kernel (bn_dz_kernel)")
    if split["steps"] != KNOBS_PROFILE_STEPS or split["idle_share"] is None:
        raise AssertionError(f"training knobs: {split['steps']} train_step spans in the trace, want "
                             f"{KNOBS_PROFILE_STEPS}")

    validate_arks("training knobs test_nnet", [os.path.join(savedir, "decode", "feats.scp")])
    warm = sorted(st["step_time"] for st in steps[1:])
    step_ms = warm[len(warm) // 2] * 1e3
    loader_ms, first_batch = compare_loaders(card, ws)
    spec = check_spec_augment(card, first_batch, step_ms)
    times = {"run_s": run_s, "step_ms": step_ms, "idle_share": split["idle_share"],
             "profiled_wall_ms": split["wall_ms"], "profiled_device_busy_ms": split["device_busy_ms"],
             "top_ops": split["top_ops"], "bulk_ms_per_batch": loader_ms["bulk"],
             "python_ms_per_batch": loader_ms["python"], **spec}
    return launches, times


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
    check_loader(f"bi{cell} path", "alignment", cfg_path, len(steps))
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
    check_loader("CTC path", "text", cfg_path, len(steps))
    validate_arks("CTC path test_nnet", [os.path.join(ws["test_featdir"], name) for name in ("feats.scp", "cmvn.scp")])
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
    check_loader("attention path", "text", cfg_path, len(steps))
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
    check_loader("transducer path", "text", cfg_path, len(steps))
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


def greedy_walk(model, x, lengths, max_tokens: int) -> list:
    """Greedy decode of a padded batch by the cached step alone: each row
    takes the argmax of its running score plus the step's log-posteriors (the
    lower index on a tie, as the beam's stable sort) until EOS or
    ``max_tokens`` labels. Returns the label ids per row."""
    import torch

    dev = model.embed.device
    with torch.inference_mode():
        lengths = torch.as_tensor(lengths, dtype=torch.int32)
        memory = model.encode(torch.as_tensor(x).to(dev), lengths)
        valid = model.memory_valid(memory, lengths)
        cross_k, cross_v = model.cross_kv(memory)
        n = memory.shape[0]
        cache = model.init_decode_cache(n, max_tokens)
        tok = torch.full((n,), model.sos_eos_id, dtype=torch.long, device=dev)
        score = torch.zeros(n, device=dev)
        ids, done = [[] for _ in range(n)], [False] * n
        for step in range(max_tokens):
            logits, cache = model.decode_step_cached(tok, step, cache, cross_k, cross_v, valid)
            total = score[:, None] + torch.log_softmax(logits, dim=-1)
            tok = torch.argmax(total, dim=-1)
            score = total.gather(1, tok[:, None])[:, 0]
            for i, t in enumerate(tok.tolist()):
                done[i] = done[i] or t == model.sos_eos_id
                if not done[i]:
                    ids[i].append(t)
            if all(done):
                break
    return ids


def beam_step_profile(dec, x, lengths, steps: int = 10) -> dict:
    """``steps`` steps of the attention beam on a padded batch under
    torch.profiler (after 3 untraced ones): a step's top-level aten ops and
    device kernels, its device time (the kernels' self time summed) and its
    host time, and the device's idle share of the window."""
    import torch
    from torch.autograd import DeviceType

    from tfkaldi_tpu_torch import profile_frame as pf

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
    events = prof.events()
    ops = sum(1 for e in events if e.name.startswith("aten::") and
              (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in kernels)
    device_ms = sum(pf._self_device_us(e) for e in kernels) / 1e3 / steps
    if launches == 0:
        raise RuntimeError("torch.profiler saw no device event in the attention beam's steps")
    return {"aten_ops": ops / steps, "kernels": launches / steps, "device_ms": device_ms, "host_ms": host_ms,
            "idle": 1.0 - device_ms / host_ms}


def beam_replay(card_dec, cpu_dec, x, lengths) -> dict:
    """The card's attention beam step by step with the CPU replaying the
    card's choices: at each step both compute the candidate scores of the
    same hypotheses; wherever the CPU's top-K set differs from the card's,
    the card's choice must be a near tie on the CPU (the CPU's best
    candidate the card left out at most twice the row's largest card-CPU
    candidate difference above the card's worst pick). The replayed run
    must equal the card decoder's own n-best. Returns the counts."""
    import torch

    neg = -1e30 / 2
    steps = flips = 0
    noise_max = excess_max = 0.0
    with torch.inference_mode():
        card, cpu = card_dec.begin(x, lengths), cpu_dec.begin(x, lengths)
        while card_dec.live(card):
            ck, cc = card_dec.candidates(card), cpu_dec.candidates(cpu)
            flat = card_dec.select(ck)
            flat_cpu, ckc, fk = cpu_dec.select(cc), ck.cpu(), flat.cpu()
            noise = torch.where((ckc > neg) & (cc > neg), (ckc - cc).abs(), 0.0).amax(dim=1)
            noise_max = max(noise_max, float(noise.max()))
            for row, (mine, theirs) in enumerate(zip(fk.tolist(), flat_cpu.tolist())):
                picked, left = sorted(set(mine) - set(theirs)), sorted(set(theirs) - set(mine))
                if picked:
                    excess = float(cc[row, left].max() - cc[row, picked].min())
                    excess_max = max(excess_max, excess)
                    if excess > 2 * float(noise[row]):
                        raise AssertionError(f"attention beam step {card.step}, row {row}: the card kept candidates "
                                             f"{picked} that the CPU scores {excess} below its own (noise "
                                             f"{float(noise[row])})")
                    flips += 1
            card_dec.advance(card, ck, flat)
            cpu_dec.advance(cpu, cc, fk)
            steps += 1
        replayed = [t.cpu() for t in card_dec.close(card)]
    mine = card_dec.decode_batch_nbest(x, lengths)
    buf, counts, scores, ranked = (t.numpy() for t in replayed)
    for row, hyps in enumerate(mine):
        order = [k for k in sorted(range(buf.shape[1]), key=lambda k: -ranked[row, k]) if scores[row, k] > neg]
        want = [(buf[row, k, :counts[row, k]].tolist(), float(scores[row, k])) for k in order]
        if [(ids.tolist(), score) for ids, score in hyps] != want:
            raise AssertionError(f"the replayed beam differs from the card decoder's on row {row}")
    return {"steps": steps, "decisions": steps * len(lengths), "near_ties": flips, "noise_max": noise_max,
            "excess_max": excess_max, "labels": sum(len(h[0][0]) for h in mine)}


def text_decode_path(card: str, ws: dict, att_dirs: dict, recipes: dict, rates: dict, device: str = "cuda") -> dict:
    """The text recipes' offline decode as the JAX package runs it, on the
    models the CTC, attention and transducer phases trained (``recipes``:
    each one's config path and model dir; ``rates``: their decode rates).
    One character trigram ARPA (``synthetic.write_char_arpa``) is estimated
    from the seeded training transcripts; counts reset before, read after:

    - attention, ``decode_mode = beam`` (beam 10, at most 200 tokens, JAX's
      default mode) through ``Nnet.load_text_decoder``, unfused and fused
      (``lm_alpha 0.5``): the card's beam on the first decode batch's
      first REPLAY_ROWS utterances replayed on the CPU (bf16 both,
      ``beam_replay``: every top-10 choice the CPU's too, or a near tie
      within the candidates' card-CPU difference); 10 steps under
      torch.profiler (``beam_step_profile``: ops, kernels, device time and
      idle share a step); beam 1 equal to a greedy walk of the same cached
      step on the card; the test set timed
      (frames/s, the ``seconds`` split and the step count) beside the
      rescoring decode's rate;
    - transducer, beam 8 fused (``lm_path``): the test set timed, the
      unfused beam right after it on the same model; a zero-weight table (``lm_alpha 0``, ``lm_beta
      0``) gives the unfused n-best exactly on the first decode batch;
    - CTC, beam 16 fused: the fused route on every decode batch and the
      native beam never, kernel 4 once per layer and batch; frames/s;
    - ``cli.serve --once`` on one job (the test featdir) per recipe: its
      ``text`` equals ``Nnet.decode_text``'s for the same config (the CTC
      job's service reads no LM, as the JAX service) and ``DONE`` holds the
      utterance count.

    Returns the launches of the seven kernels and the timings."""
    from configparser import ConfigParser

    import numpy as np
    import torch

    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.cli import serve as cli_serve
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode import ctc as ctc_decode
    from tfkaldi_tpu_torch.decode.seq2seq import Seq2SeqBeamDecoder
    from tfkaldi_tpu_torch.decode.streaming import stream_padded_batches
    from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
    from tfkaldi_tpu_torch.nnet import Nnet
    from tfkaldi_tpu_torch.ops import lstm_bidi

    root = os.path.join(TRAIN_WORK, "text_decode")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    arpa = os.path.join(root, "char3.arpa")
    texts = [os.path.join(ws["train_featdir"], "text"), os.path.join(att_dirs["train"], "text")]
    n_grams = synthetic.write_char_arpa(arpa, texts)
    coder = TextCoder(aurora4_normalizer)
    log(f"text decode LM: a character trigram of {n_grams} n-grams over the {coder.num_labels} labels and </s>, "
        f"from the training transcripts of the CTC and attention featdirs: {time.perf_counter() - t0!r} s")

    def variant(kind: str, tag: str, **keys) -> str:
        config = ConfigParser()
        config.read(recipes[kind][0])
        for key, value in keys.items():
            config.set("nnet", key, str(value))
        path = os.path.join(root, f"config_{tag}.cfg")
        with open(path, "w") as f:
            config.write(f)
        return path

    def nnet(cfg_path: str, dev: str = device):
        config = ConfigParser()
        config.read(cfg_path)
        return Nnet(config, 40, coder.num_labels, device=dev)

    def reader(featdir: str, context: int):
        return FeatureReader(os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"),
                             os.path.join(featdir, "utt2spk"), context, 0)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    def timed(decoder, featdir: str, context: int, out: str, passes: int) -> tuple[float, int]:
        for _ in range(passes):  # warm-ups, then the timed pass
            if hasattr(decoder, "seconds"):
                decoder.seconds = dict.fromkeys(decoder.seconds, 0.0)
                decoder.steps = 0
            r = reader(featdir, context)
            sync()
            t = time.perf_counter()
            count = decoder.decode_to_file(r, out)
            sync()
            seconds = time.perf_counter() - t
            r.close()
        return seconds, count

    frames = sum(int(n) for _, _, l in stream_padded_batches(reader(att_dirs["test"], 0), batch_size=16) for n in l)
    timings = {}
    reset_counts()

    # ---- attention: the autoregressive beam, JAX's default decode mode ----
    t_att = time.perf_counter()
    beam_cfg = variant("attention", "attention_beam", decode_mode="beam")
    fused_cfg = variant("attention", "attention_beam_lm", decode_mode="beam", lm_path=arpa, lm_alpha=0.5)
    dec = nnet(beam_cfg).load_text_decoder(coder)
    if not (isinstance(dec, Seq2SeqBeamDecoder) and dec.beam == 10 and dec.max_tokens == 200 and dec.fusion is None):
        raise AssertionError(f"decode_mode = beam gave {type(dec).__name__} (beam {getattr(dec, 'beam', None)})")
    _, x, lengths = next(iter(stream_padded_batches(reader(att_dirs["test"], 0), batch_size=16)))
    t0 = time.perf_counter()
    cpu_dec = nnet(beam_cfg, "cpu").load_text_decoder(coder)
    rows = REPLAY_ROWS
    replay = beam_replay(dec, cpu_dec, x[:rows], lengths[:rows])
    log(f"attention beam 10 (bf16), card against CPU on the first decode batch's first {rows} utterances (the CPU "
        f"replays the card's choices; {rows} rows keep the CPU's share of the phase short): {replay['decisions']} "
        f"top-10 choices over {replay['steps']} steps, {replay['near_ties']} of them near ties where the CPU's top "
        f"10 differ (the left-out candidate at most {replay['excess_max']!r} above the card's pick, within twice "
        f"the step's card-CPU candidate difference, at most {replay['noise_max']!r}); the replay equals the card "
        f"decoder's n-best ({replay['labels']} labels in the best hypotheses); {time.perf_counter() - t0!r} s")
    del cpu_dec
    prof = beam_step_profile(dec, x, lengths)
    timings.update({f"attention_step_{k}": v for k, v in prof.items()})
    log(f"attention beam 10 step on the first decode batch (B·K = {dec.beam * len(lengths)}), 10 steps under "
        f"torch.profiler: {prof['aten_ops']!r} top-level aten ops and {prof['kernels']!r} device kernels a step, "
        f"device time {prof['device_ms']!r} ms against {prof['host_ms']!r} ms of host time a step: the device idle "
        f"{prof['idle']!r} of it [{card}]")
    beam1 = Seq2SeqBeamDecoder(dec.model, coder, beam_width=1, max_tokens=dec.max_tokens).decode_batch(x, lengths)
    walk = greedy_walk(dec.model, x, lengths, dec.max_tokens)
    differ = [i for i, (a, b) in enumerate(zip(beam1, walk)) if not np.array_equal(a, b)]
    log(f"attention beam 1 vs a greedy walk of the cached step on the card: {len(beam1) - len(differ)} of "
        f"{len(beam1)} rows identical ({sum(len(a) for a in beam1)} labels)")
    if differ:
        raise AssertionError(f"beam 1 differs from the greedy walk on rows {differ}")
    fused = nnet(fused_cfg).load_text_decoder(coder)
    if fused.fusion is None or fused.fusion.table.shape[1] != coder.num_labels + 1:
        raise AssertionError("the fused attention decoder has no table over the alphabet and </s>")
    outs = {}
    for tag, d in (("beam10", dec), ("beam10_lm", fused)):
        outs[tag] = os.path.join(root, f"attention_{tag}.txt")
        seconds, count = timed(d, att_dirs["test"], 0, outs[tag], passes=1)  # the card is warm
        split = {part: v * 1e3 for part, v in d.seconds.items()}
        timings[f"attention_{tag}_frames_per_s"] = frames / seconds
        timings.update({f"attention_{tag}_{part}_ms": v for part, v in split.items()})
        timings[f"attention_{tag}_steps"] = d.steps
        log(f"attention {tag} decode of the test set ({count} utterances, {frames} frames, batches of 16, at most "
            f"{d.max_tokens} tokens, features read): {seconds!r} s, {frames / seconds!r} frames/s; ms by part: "
            f"encoder + cross_kv {split['encoder']!r}, step loop {split['steps']!r} ({d.steps} steps, "
            f"{split['steps'] / max(d.steps, 1)!r} ms a step), forced close {split['close']!r}; rest (features "
            f"read, batching, text) {seconds * 1e3 - sum(split.values())!r}; the rescoring decode (the recipe's mode) "
            f"{rates['attention']!r} frames/s [{card}]")
    del dec, fused
    log(f"phase text decode, attention: {time.perf_counter() - t_att!r} s")

    # ---- transducer: beam 8 with the LM ----
    t_rnnt = time.perf_counter()
    rnnt_cfg = variant("rnnt", "transducer_lm", lm_path=arpa, lm_alpha=0.5)
    zero_cfg = variant("rnnt", "transducer_lm0", lm_path=arpa, lm_alpha=0, lm_beta=0)
    fused = nnet(rnnt_cfg).load_text_decoder(coder)
    if not (isinstance(fused, TransducerBeamDecoder) and fused.beam == 8 and fused.fusion is not None):
        raise AssertionError(f"the transducer config with lm_path gave {type(fused).__name__} without a table")
    zero = nnet(zero_cfg).load_text_decoder(coder)
    if zero.fusion.table.any():
        raise AssertionError("the zero-weight fusion table is not all zeros")
    plain = TransducerBeamDecoder(zero.model, coder, beam_width=zero.beam, max_symbols_per_frame=zero.max_symbols)
    outs["rnnt"] = os.path.join(root, "transducer_beam8_lm.txt")
    rate = {}
    for tag, d in (("beam8_lm", fused), ("beam8", plain)):  # back to back: the host's pace moves between calls
        seconds, count = timed(d, att_dirs["test"], 0, outs["rnnt"] if d is fused else os.devnull, passes=1)
        rate[tag] = frames / seconds
        timings[f"transducer_{tag}_frames_per_s"] = rate[tag]
    log(f"transducer beam 8 decode of the test set ({count} utterances, {frames} frames, features read), fused "
        f"{rate['beam8_lm']!r} frames/s, unfused {rate['beam8']!r} right after it; the transducer phase's unfused "
        f"beam 8 {rates['rnnt']!r} [{card}]")
    a, b = zero.decode_batch_nbest(x, lengths), plain.decode_batch_nbest(x, lengths)
    if [[(i.tolist(), s) for i, s in r] for r in a] != [[(i.tolist(), s) for i, s in r] for r in b]:
        raise AssertionError("the zero-weight fused transducer beam differs from the unfused beam")
    log(f"transducer zero-weight table (lm_alpha 0, lm_beta 0): n-best ids and scores equal to the unfused beam's on "
        f"the first decode batch's {len(a)} utterances")
    del fused, zero, plain
    log(f"phase text decode, transducer: {time.perf_counter() - t_rnnt!r} s")

    # ---- CTC: beam 16 with the FusionScorer (the Python beam) ----
    t_ctc = time.perf_counter()
    ctc_cfg = variant("ctc", "ctc_lm", lm_path=arpa, lm_alpha=0.5)
    ctc_nnet = nnet(ctc_cfg)
    dec = ctc_nnet.load_text_decoder(coder)
    if dec.fusion_scorer is None or dec.beam_width != 16:
        raise AssertionError("the CTC config with lm_path gave no fused beam 16")
    c = lstm_bidi.CELL
    runs0, fwd0, step0 = dict(ctc_decode.beam_runs), c.fwd_persistent_launches, c.fwd_launches
    outs["ctc"] = os.path.join(root, "ctc_beam16_lm.txt")
    seconds, count = timed(dec, ws["test_featdir"], ctc_nnet.context_width, outs["ctc"], passes=1)
    batches = -(-count // 16)
    runs = {k: ctc_decode.beam_runs[k] - runs0[k] for k in runs0}
    fwd = c.fwd_persistent_launches - fwd0
    timings["ctc_beam16_lm_frames_per_s"] = frames / seconds
    log(f"CTC beam 16 fused decode of the test set ({count} utterances, {frames} frames, {batches} batches, the "
        f"Python beam with the FusionScorer, features read): {seconds!r} s, {frames / seconds!r} frames/s; beam runs "
        f"{runs}; kernel 4 persistent launches {fwd}, step route {c.fwd_launches - step0}; the native unfused beam "
        f"16 {rates['ctc']!r} frames/s [{card}]")
    if runs != {"native": 0, "python": 0, "fused": batches}:
        raise AssertionError(f"the fused CTC decode ran beams {runs}, want fused on each of {batches} batches only")
    if fwd != RNN_LAYERS * batches or c.fwd_launches != step0:
        raise AssertionError(f"kernel 4 launched {fwd} times on the fused CTC decode, want {RNN_LAYERS} x {batches}")
    del dec
    log(f"phase text decode, CTC: {time.perf_counter() - t_ctc!r} s")

    # ---- the spool server for text models ----
    t_spool = time.perf_counter()
    ctc_text = os.path.join(recipes["ctc"][1], "decode", "text")  # the CTC phase's decode_text, no LM
    for kind, cfg_path, featdir, want in (("ctc", recipes["ctc"][0], ws["test_featdir"], ctc_text),
                                          ("attention", fused_cfg, att_dirs["test"], outs["beam10_lm"]),
                                          ("rnnt", rnnt_cfg, att_dirs["test"], outs["rnnt"])):
        spool_in, spool_out = os.path.join(root, f"spool_{kind}", "in"), os.path.join(root, f"spool_{kind}", "out")
        shutil.copytree(featdir, os.path.join(spool_in, "job0"))
        t0 = time.perf_counter()
        rc = cli_serve.main(["--config", cfg_path, "--watch", spool_in, "--out", spool_out, "--once",
                             "--device", device])
        serve_s = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli.serve {kind}: rc {rc}")
        with open(os.path.join(spool_out, "job0", "text")) as f:
            got = f.read()
        with open(want) as f:
            expected = f.read()
        with open(os.path.join(spool_out, "job0", "DONE")) as f:
            done = f.read()
        log(f"cli.serve --once, {kind} job of {len(got.splitlines())} utterances (model load included): "
            f"{serve_s!r} s; text equal to decode_text's: {got == expected}; DONE {done.strip()!r}")
        if got != expected or done != f"{len(expected.splitlines())}\n":
            raise AssertionError(f"the {kind} spool job's text or DONE marker differs from decode_text's")
    log(f"phase text decode, spool: {time.perf_counter() - t_spool!r} s")
    launches = seven_counters()
    log(f"text decode path launches of the seven kernels {launches}")
    want_fwd = RNN_LAYERS * 2 * batches  # the fused decode and the CTC spool job
    if launches["lstm_fwd_persistent"] != want_fwd or any(v for k, v in launches.items() if k != "lstm_fwd_persistent"):
        raise AssertionError(f"text decode path launches {launches}: want lstm_fwd_persistent {want_fwd}, all else 0")
    return {"lstm_fwd": launches["lstm_fwd_persistent"]}, timings


STREAM_CHUNK = 1600  # samples a client chunk: 100 ms at 16 kHz
STREAM_SLOTS = 16  # MultiStreamServer.DEFAULT_SLOTS: the rows of every server tick
STREAM_CEILING_SLOTS = (32, 64)  # --slots of the transducer runs that look for the slots' ceiling
STREAM_CLIENT_TIMEOUT = 300.0  # seconds a client socket waits for a reply before the run fails
# the fused front-end's frames (batch 1, 12 frames a call) against the offline extractor's (32 wavs a
# call), err/max(|ref|, 1): the f64 DFT products of other row counts may round otherwise, then f32
STREAM_FEAT_TOL = 1e-6
# the unidirectional CTC model's seeded output layer: N(0, 1)/sqrt(H) * gain, and a blank bias
CTC_OUT_GAIN = 8.0
CTC_BLANK_BIAS = 6.0


@contextlib.contextmanager
def stream_server(cfg_path: str, *flags: str):
    """``cli.serve.main([--config cfg, --stream, --port-file f, *flags],
    stop=...)`` in a thread; yields ``(host, port, server)`` once the port
    file is written (the ``MultiStreamServer`` caught as it is built). On
    exit the server is stopped and joined; an exception of ``main`` or a
    return code other than 0 raises."""
    import threading

    from tfkaldi_tpu_torch import serve as serve_mod
    from tfkaldi_tpu_torch.cli import serve as cli_serve

    root = os.path.join(TRAIN_WORK, "streaming")
    os.makedirs(root, exist_ok=True)
    port_file = os.path.join(root, f"port_{time.perf_counter_ns()}")
    servers, rc, errors = [], [], []
    build = serve_mod.MultiStreamServer.__init__

    def init(self, *args, **kwargs):
        build(self, *args, **kwargs)
        servers.append(self)

    stop = threading.Event()

    def run():
        try:
            rc.append(cli_serve.main(["--config", cfg_path, "--stream", "--port-file", port_file, *flags],
                                     stop=stop.is_set))
        except BaseException as exc:  # re-raised on the phase's thread
            errors.append(exc)

    serve_mod.MultiStreamServer.__init__ = init
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        deadline = time.time() + 300
        address = []
        while len(address) != 2:
            if errors or not thread.is_alive() or time.time() > deadline:
                raise RuntimeError(f"cli.serve --stream {' '.join(flags)} did not come up: {errors or rc}")
            time.sleep(0.05)
            if os.path.exists(port_file):
                with open(port_file) as f:
                    address = f.read().split()
        yield address[0], int(address[1]), servers[0]
    finally:
        serve_mod.MultiStreamServer.__init__ = build
        stop.set()
        thread.join(timeout=120)
    if thread.is_alive():
        raise RuntimeError("the streaming server did not stop within 120 s")
    if errors:
        raise errors[0]
    if rc != [0]:
        raise RuntimeError(f"cli.serve --stream returned {rc}")


def stream_clients(host: str, port: int, audios: list, concurrency: int, requests: bool = False) -> dict:
    """``stream_transcribe`` clients, ``concurrency`` at once, over
    ``audios``: each one's final, its partial count and (``requests``) its
    timestamps, confidences and words read back on the same connection; the
    client-side reply latency of every chunk (send to reply) and of every
    finish; the wall time. A client's error, an ``E`` reply or a missing
    reply (the socket timeout) raises."""
    import queue
    import socket
    import threading

    import numpy as np

    from tfkaldi_tpu_torch import serve as serve_mod

    todo = queue.Queue()
    for i in range(len(audios)):
        todo.put(i)
    out = [None] * len(audios)
    chunk_s, finish_s, errors = [], [], []

    def one(i: int):
        samples = np.ascontiguousarray(audios[i], dtype="<f4")
        mine, partials, final = [], 0, None
        with socket.create_connection((host, port), timeout=STREAM_CLIENT_TIMEOUT) as sock:
            gen = serve_mod._send_audio(sock, samples, STREAM_CHUNK)
            while True:
                t = time.perf_counter()
                try:
                    next(gen)
                except StopIteration as end:
                    final = end.value
                    (finish_s if partials == -(-len(samples) // STREAM_CHUNK) else mine).append(
                        time.perf_counter() - t)
                    break
                mine.append(time.perf_counter() - t)
                partials += 1
            extra = {}
            if requests:
                extra["times"] = np.frombuffer(serve_mod._request(sock, serve_mod.MSG_TIMES_REQ, serve_mod.MSG_TIMES),
                                               "<f8")
                extra["confs"] = np.frombuffer(serve_mod._request(sock, serve_mod.MSG_CONF_REQ, serve_mod.MSG_CONF),
                                               "<f8")
                extra["words"] = json.loads(serve_mod._request(sock, serve_mod.MSG_WORDS_REQ, serve_mod.MSG_WORDS))
        chunk_s.extend(mine)
        return {"final": final, "partials": partials, "early": partials < -(-len(samples) // STREAM_CHUNK), **extra}

    def worker():
        while True:
            try:
                i = todo.get_nowait()
            except queue.Empty:
                return
            try:
                out[i] = one(i)
            except Exception as exc:  # re-raised on the phase's thread
                errors.append((i, repr(exc)))

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads) or errors:
        raise RuntimeError(f"streaming clients failed: {errors or 'a client hung'}")
    return {"results": out, "chunk_s": chunk_s, "finish_s": finish_s, "wall_s": wall}


def _pct(values, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else float("nan")


def stream_replay(ext, wavs: list, encode, cmvn=None, slots: int = STREAM_SLOTS) -> list:
    """The wavs through the fused front-end and ``encode`` as the server's
    slots run them: ``slots`` rows a batch (a wav a row, empty rows to
    fill it), STREAM_CHUNK-sample pushes from each row's start, length 0
    once a row's audio ends, then the flush of every row. Each push's
    frames are CMVN'd by ``apply_cmvn`` (when given; frames past a row's
    count zero, as the fused call leaves them) and go to ``encode(feats,
    counts, carry) -> (per-row outputs, carry)``; the flush calls
    ``encode(None, None, carry)``. Every call has the shapes a server tick
    has, and every op of the path works row by row, so a row's numbers are
    its slot's. Returns per wav ``(frames before CMVN, outputs)``,
    concatenated."""
    import numpy as np
    import torch

    from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn
    from tfkaldi_tpu_torch.frontend.online import FusedOnlineFeatureExtractor

    out = []
    for g in range(0, len(wavs), slots):
        group = wavs[g: g + slots]
        online = FusedOnlineFeatureExtractor(ext)
        online.reset(slots)
        frames = [[] for _ in group]
        outs = [[] for _ in group]
        carry = None
        longest = max(len(w) for w in group)
        with torch.inference_mode():
            for p in [*range(0, longest, STREAM_CHUNK), None]:
                if p is not None:
                    chunk = np.zeros((slots, STREAM_CHUNK), np.float32)
                    lens = np.zeros((slots,), np.int64)
                    for r, w in enumerate(group):
                        part = w[p: p + STREAM_CHUNK]
                        chunk[r, : len(part)] = part
                        lens[r] = len(part)
                    f, k = online.step(chunk, lens)
                else:
                    f, k = online.flush()
                if not f.shape[1]:
                    continue
                for r in range(len(group)):
                    frames[r].append(f[r, : int(k[r])])
                if cmvn is not None:
                    f = apply_cmvn(f, cmvn)
                    past = torch.arange(f.shape[1], device=f.device)[None, :] >= torch.as_tensor(k, device=f.device)[:, None]
                    f[past] = 0.0
                ys, carry = encode(f, k, carry)
                for r in range(len(group)):
                    outs[r].append(ys[r])
            ys, carry = encode(None, None, carry)
            for r in range(len(group)):
                outs[r].append(ys[r])
        out += [(torch.cat(fr), torch.cat(o)) for fr, o in zip(frames, outs)]
    return out


def greedy_node(model, e_off, e32, ids_off, fr_off, ids_rep, fr_rep):
    """Where two greedy transducer searches part: the first emission
    ``(label, frame)`` that differs, at the node they share (the frame, and
    the labels emitted before it). Its decision is a near tie when the
    offline log-prob margin of its choice over the other's is within twice
    the bf16 noise there, the max|log-prob difference| between the offline
    encoder's output and the f32-compute encoder's under the same joint and
    prediction network (independent of the other search): ``(margin,
    noise)``, else None."""
    import torch

    blank = model.blank_id
    k = 0
    while k < min(len(ids_off), len(ids_rep)) and (ids_off[k], fr_off[k]) == (ids_rep[k], fr_rep[k]):
        k += 1
    frames = [f[k] for f in (fr_off, fr_rep) if k < len(f)]
    t = min(frames)
    choice_off = int(ids_off[k]) if k < len(ids_off) and fr_off[k] == t else blank
    choice_rep = int(ids_rep[k]) if k < len(ids_rep) and fr_rep[k] == t else blank
    dev = e_off.device
    with torch.inference_mode():
        proj, carry = model.predict_step(torch.full((1,), blank, device=dev),
                                         torch.ones(1, dtype=torch.bool, device=dev), model.init_pred_carry(1))
        for label in ids_off[:k]:
            proj, carry = model.predict_step(torch.full((1,), int(label), device=dev),
                                             torch.ones(1, dtype=torch.bool, device=dev), carry)
        lo = torch.log_softmax(model.joint_step(e_off[t: t + 1], proj).float(), -1)[0]
        l32 = torch.log_softmax(model.joint_step(e32[t: t + 1], proj).float(), -1)[0]
    margin, noise = float(lo[choice_off] - lo[choice_rep]), float((l32 - lo).abs().max())
    return (margin, noise) if margin <= 2 * noise else None


def nbest_tie(hyp: str, off: list, ref: list):
    """The beam rule: ``off`` / ``ref`` are ``[(text, score)]`` n-bests
    (best first) of the offline search and of the same search on the
    f32-compute model's numbers. A replayed best ``hyp`` that is not the
    offline best is a near tie when it is in the offline n-best and its
    offline score is within twice the bf16 noise, the largest score
    difference of the hypotheses both ``off`` and ``ref`` hold: ``(gap,
    noise)``, else None."""
    off_s, ref_s = dict(off), dict(ref)
    noise = max((abs(off_s[h] - ref_s[h]) for h in off_s if h in ref_s), default=0.0)
    if hyp not in off_s:
        return None
    gap = off[0][1] - off_s[hyp]
    return (gap, noise) if gap <= 2 * noise else None


def streaming_path(card: str, ws: dict, att_dirs: dict, recipes: dict, device: str = "cuda") -> tuple[dict, dict]:
    """``cli.serve --stream`` on the card as users start it, on the 32 test
    wavs of the training workspace, in STREAM_CHUNK chunks:

    - the transducer recipe as written on the transducer phase's ``final.pt``
      (beam 8, 16 slots, the pooled CMVN of its training featdir), 16
      concurrent clients; then 4 and 1 at a time (4 wavs, 1 wav) for the
      chunk-reply latency; ``--beam-width 1``; the text decode phase's
      character trigram as ``lm_path`` (the fused beam); and ``--slots``
      32 and 64 with as many streams (STREAM_CEILING_SLOTS), for the tick
      against the chunk period past the default 16 slots;
    - the CTC recipe with ``bidirectional = False`` (and ``context_width =
      0``: the streaming transcribers feed unspliced frames, as the JAX
      package's do) on a seeded ``final.pt``: greedy, beam 16 with the
      trigram (the Python beam and its ``FusionScorer``), greedy with
      ``--endpoint`` (an early final is the decode of the audio pushed
      until it), and greedy with every client reading back its timestamps,
      confidences and words.

    ``stream_replay`` runs the wavs through the same front-end and model
    calls in the slots' batch shapes, so each served final must equal the
    search on its replayed numbers exactly. Against the card's offline
    decoder on the offline extractor's features (kernel 2) with the same
    f32 CMVN (the CTC's offline forward runs kernel 4 with one direction),
    a final is identical, or the first decision where the replayed and the
    offline numbers part is a near tie: its offline margin within twice the
    offline model's own bf16 noise (its distance from the same model run
    in f32 compute, which does not depend on the stream), both printed.
    The replayed transducer encoder output and the replayed CTC
    log-posteriors are held to the bf16 rule against the f32-compute
    offline forward, the fused front-end's frames to the offline
    extractor's. Counts reset before, read after. Returns the seven
    kernels' launches and the timings."""
    import dataclasses
    from configparser import ConfigParser

    import numpy as np
    import torch

    from tfkaldi_tpu_torch.convert import save_checkpoint
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode.ctc_beam import beam_step, initial_beams, nbest_prefixes
    from tfkaldi_tpu_torch.decode.lm import ArpaLM, DenseFusionTable, FusionScorer
    from tfkaldi_tpu_torch.decode.transducer import TransducerDecoder
    from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
    from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn
    from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
    from tfkaldi_tpu_torch.io import read_wav, read_wavfiles
    from tfkaldi_tpu_torch.models import Transducer
    from tfkaldi_tpu_torch.nnet import Nnet
    from tfkaldi_tpu_torch.ops import rnn_bidi
    from tfkaldi_tpu_torch.serve import MultiStreamServer, global_cmvn

    t_phase = time.perf_counter()
    root = os.path.join(TRAIN_WORK, "streaming")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    arpa = os.path.join(TRAIN_WORK, "text_decode", "char3.arpa")  # the text decode phase's trigram
    if not os.path.isfile(arpa):
        raise FileNotFoundError(arpa)
    coder = TextCoder(aurora4_normalizer)
    blank = coder.num_labels
    base = ConfigParser()
    base.read(ws["cfg_path"])
    wav_scp = read_wavfiles(os.path.join(base.get("directories", "test_data"), "wav.scp"))
    rates, audio = set(), []
    for utt in wav_scp:
        rate, sig = read_wav(wav_scp[utt])
        rates.add(rate)
        audio.append(np.asarray(sig, np.float32))
    if rates != {16000} or len(audio) != 32:
        raise AssertionError(f"the test data: {len(audio)} wavs at {rates} Hz, want 32 at 16000")
    rate = 16000
    all32 = list(range(32))
    dev = torch.device(device)
    if MultiStreamServer.DEFAULT_SLOTS != STREAM_SLOTS:
        raise AssertionError(f"MultiStreamServer.DEFAULT_SLOTS {MultiStreamServer.DEFAULT_SLOTS}")

    def variant(src: str, tag: str, **keys) -> str:
        config = ConfigParser()
        config.read(src)
        for key, value in keys.items():
            config.set("nnet", key, str(value))
        path = os.path.join(root, f"config_{tag}.cfg")
        with open(path, "w") as f:
            config.write(f)
        return path

    def offline_feats(wavs):  # padded to whole seconds, as prepare_data pads (kernel 2's bulk route)
        batch = np.zeros((len(wavs), -(-max(len(w) for w in wavs) // rate) * rate), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : len(w)] = w
        with torch.inference_mode():
            return ext(batch, np.asarray([len(w) for w in wavs]))

    def padded(rows: list):
        """Per-row ``[T_i, J]`` tensors → ``([B, T_max, J], valid [B, T_max])``."""
        t_max = max(max(r.shape[0] for r in rows), 1)
        x = torch.zeros(len(rows), t_max, rows[0].shape[-1], device=dev)
        for i, r in enumerate(rows):
            x[i, : r.shape[0]] = r
        lens = torch.as_tensor([r.shape[0] for r in rows], device=dev)
        return x, torch.arange(t_max, device=dev)[None, :] < lens[:, None]

    reset_counts()
    frame_calls = 0
    timings = {"audio_s": sum(len(a) for a in audio) / rate}

    # ---- offline features (kernel 2) against the slots' front-end ----
    t0 = time.perf_counter()
    ext = FeatureExtractor(FeatureOpts.from_config(dict(base.items("dnn-features"))), rate, dev)
    raw, nframes = offline_feats(audio)
    frame_calls += 1
    empty = [torch.zeros(0, device=dev)] * STREAM_SLOTS
    feat_err, feat_exact = 0.0, 0
    for i, (f, _) in enumerate(stream_replay(ext, audio, lambda f, k, carry: (empty, carry))):
        ref = raw[i, : nframes[i]]
        if f.shape != ref.shape:
            raise AssertionError(f"wav {i}: the fused front-end emitted {tuple(f.shape)} frames, offline {ref.shape}")
        feat_err = max(feat_err, float(((f - ref).abs() / ref.abs().clamp(min=1.0)).max()))
        feat_exact += bool(torch.equal(f, ref))
    log(f"streaming: the fused front-end ({STREAM_SLOTS} rows, {STREAM_CHUNK}-sample pushes) against the offline "
        f"extractor (kernel 2, the 32 wavs in one batch): frames equal in count, bit-identical on {feat_exact} of 32 "
        f"wavs, max err/max(|ref|,1) {feat_err!r} (gate {STREAM_FEAT_TOL}: f64 products of other row counts) "
        f"{time.perf_counter() - t0!r} s [{card}]")
    if feat_err > STREAM_FEAT_TOL:
        raise AssertionError(f"the fused front-end's frames differ from the offline extractor's: {feat_err}")
    timings["feature_max_err"] = feat_err

    def served(cfg: str, flags: tuple, runs: list, slots: int = STREAM_SLOTS) -> list:
        """One server of ``slots`` slots; each run ``(tag, wav indices,
        concurrency, requests)`` a batch of clients; returns each run's
        results, with the server's ticks, rows and tick times over it."""
        out = []
        with stream_server(cfg, "--device", device, *flags) as (host, port, server):
            if server.num_slots != slots or server.chunk_size != STREAM_CHUNK:
                raise AssertionError(f"the server has {server.num_slots} slots of {server.chunk_size} samples")
            for tag, idx, conc, requests in runs:
                server.tick_durations.clear()
                ticks, rows = server.ticks, server.rows_pushed
                res = stream_clients(host, port, [audio[i] for i in idx], conc, requests)
                res.update(tag=tag, idx=idx, ticks=server.ticks - ticks, rows_pushed=server.rows_pushed - rows,
                           tick_s=list(server.tick_durations), audio_s=sum(len(audio[i]) for i in idx) / rate)
                log(f"streaming {tag}: {len(idx)} wavs ({res['audio_s']!r} s of audio), {conc} concurrent clients: "
                    f"chunk reply p50 {_pct(res['chunk_s'], 50) * 1e3!r} ms, p95 {_pct(res['chunk_s'], 95) * 1e3!r} "
                    f"ms ({len(res['chunk_s'])} replies), finish reply p50 {_pct(res['finish_s'], 50) * 1e3!r} ms; "
                    f"engine tick p50 {_pct(res['tick_s'], 50) * 1e3!r} ms against the {STREAM_CHUNK / rate * 1e3!r} "
                    f"ms chunk period; {res['ticks']} ticks, {res['rows_pushed']} rows pushed "
                    f"({res['rows_pushed'] / max(res['ticks'], 1)!r} a tick); wall {res['wall_s']!r} s, real-time "
                    f"factor {res['wall_s'] / res['audio_s']!r} [{card}]")
                for key, value in (("chunk_p50_ms", _pct(res["chunk_s"], 50) * 1e3),
                                   ("chunk_p95_ms", _pct(res["chunk_s"], 95) * 1e3),
                                   ("tick_p50_ms", _pct(res["tick_s"], 50) * 1e3),
                                   ("rtf", res["wall_s"] / res["audio_s"]), ("ticks", res["ticks"]),
                                   ("rows_pushed", res["rows_pushed"])):
                    timings[f"{tag}: {key}"] = value
                out.append(res)
        return out

    def judge(tag: str, res: dict, replay: list, offline: list, explain) -> dict:
        """Each served final: equal to the search on its slot's replayed
        numbers, else the run fails; against the offline decode identical,
        or ``explain(i)`` a near tie ``(margin, noise)`` (its margin within
        twice the offline model's own bf16 noise), else it fails."""
        same, ties = 0, []
        for j, i in enumerate(res["idx"]):
            got = res["results"][j]["final"]
            if got != replay[i]:
                raise AssertionError(f"streaming {tag}: wav {i}'s served final is not the decode of its slot's own "
                                     f"numbers:\n  served {got!r}\n  replay {replay[i]!r}")
            if got == offline[i]:
                same += 1
                continue
            tie = explain(i)
            if tie is None:
                raise AssertionError(f"streaming {tag}: wav {i} final differs from the offline decode and no near tie "
                                     f"explains it:\n  served  {got!r}\n  offline {offline[i]!r}")
            ties.append((i, *[float(v) for v in tie]))
        log(f"streaming {tag}: finals identical to the card's offline decode on {same} of {len(res['idx'])} wavs "
            f"(and each equal to its slot's replay); near ties {len(ties)} (wav, offline margin, offline bf16 noise "
            f"against the f32-compute model; a tie needs margin <= 2 x noise): {ties}")
        return {"identical": same, "near_ties": len(ties)}

    verdicts = {}

    # ---- the transducer recipe as written ----
    t0 = time.perf_counter()
    rnnt_cfg = recipes["rnnt"][0]
    rconf = ConfigParser()
    rconf.read(rnnt_cfg)
    model = Nnet(rconf, 40, coder.num_labels, device=dev)._load_model().eval()
    beam = int(rconf.get("nnet", "beam_width"))
    max_sym = int(rconf.get("nnet", "max_symbols_per_frame", fallback="4"))
    cmvn = global_cmvn(att_dirs["train"])
    x = apply_cmvn(raw, cmvn)
    n_t = torch.as_tensor(nframes, device=dev)
    m32 = Transducer(dataclasses.replace(model.config, compute_dtype=torch.float32)).to(dev).eval()
    m32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        enc_off, enc32 = model.encode(x, n_t), m32.encode(x, n_t)
    del m32
    t_out = model.output_lengths(n_t).tolist()
    valid_off = torch.arange(enc_off.shape[1], device=dev)[None, :] < torch.as_tensor(t_out, device=dev)[:, None]

    def rnnt_encode(f, k, carry):
        carry = model.enc.init_stream_carry(f.shape[0], dev) if carry is None else carry
        if f is None:
            y, m, carry = model.encode_stream_flush(carry)
        else:
            y, m, carry = model.encode_stream(f, torch.as_tensor(np.asarray(k), device=dev), carry)
        return [y[r, : int(c)] for r, c in enumerate(m.tolist())], carry

    def rnnt_replay(slots: int) -> list:
        """The 32 wavs' encoder outputs as ``slots`` server slots compute
        them, each held to the bf16 rule against the f32-compute encode."""
        t1 = time.perf_counter()
        enc_rep = [e for _, e in stream_replay(ext, audio, rnnt_encode, cmvn, slots)]
        d_rep = d_off = d_ro = 0.0
        bad = []
        for i, e in enumerate(enc_rep):
            if e.shape[0] != t_out[i]:
                raise AssertionError(f"wav {i}: {e.shape[0]} replayed encoder frames, offline {t_out[i]}")
            ref = enc32[i, : t_out[i]]
            a, b = float((e - ref).abs().max()), float((enc_off[i, : t_out[i]] - ref).abs().max())
            d_rep, d_off = max(d_rep, a), max(d_off, b)
            d_ro = max(d_ro, float((e - enc_off[i, : t_out[i]]).abs().max()))
            if not bf16_close(a, b):
                bad.append((i, a, b))
        log(f"streaming transducer encoder (bf16), replayed in the shapes of {slots} slots against the offline encode "
            f"of the batch: max|replay - offline| {d_ro!r}; from the f32-compute encode: replay {d_rep!r}, offline "
            f"{d_off!r} (bf16 rule per wav: within {RNN_BF16_RATIO}x + {RNN_F32_TOL}); "
            f"{time.perf_counter() - t1!r} s")
        if bad:
            raise AssertionError(f"the streamed encoder ({slots} slots) is outside the bf16 rule on wavs {bad}")
        timings.update({f"rnnt_encoder_replay_vs_offline_{slots}_slots": d_ro,
                        f"rnnt_encoder_replay_vs_f32_{slots}_slots": d_rep, "rnnt_encoder_offline_vs_f32": d_off})
        return enc_rep

    def searched(dec, rows: list, slots: int = STREAM_SLOTS) -> list:
        """``dec.search`` over per-row encoder outputs in batches of the
        slots' row count (each row on its own in a batch of the server's
        size); the host copies, row by row."""
        out = []
        for g in range(0, len(rows), slots):
            group = rows[g: g + slots]
            enc, valid = padded(group + [group[0][:0]] * (slots - len(group)))
            res = [t.cpu().numpy() for t in dec.search(enc, valid)]
            out += [[t[r] for t in res] for r in range(len(group))]
        return out

    def whole(dec, enc=None):  # the offline decode: the 32 rows of the offline batch together
        res = [t.cpu().numpy() for t in dec.search(enc_off if enc is None else enc, valid_off)]
        return [[t[r] for t in res] for r in range(32)]

    def nbest(rows):
        out = []
        for buf, _, _, counts, scores in rows:
            order = np.argsort(-scores, kind="stable")
            out.append([(coder.decode(buf[k, : counts[k]]), float(scores[k])) for k in order if scores[k] > -1e29])
        return out

    enc_rep = rnnt_replay(STREAM_SLOTS)
    greedy = TransducerDecoder(model, coder, max_symbols_per_frame=max_sym)
    g_off, g_rep = whole(greedy), searched(greedy, enc_rep)
    ali = {side: [(r[0][: r[3]].tolist(), r[1][: r[3]].tolist()) for r in rows]
           for side, rows in (("off", g_off), ("rep", g_rep))}
    table = DenseFusionTable(ArpaLM.load(arpa), list(coder.alphabet), list(coder.alphabet), alpha=0.5, beta=0.0)
    beams = {}
    for tag, fusion in (("beam", None), ("beam_lm", table)):
        dec = TransducerBeamDecoder(model, coder, beam_width=beam, max_symbols_per_frame=max_sym, fusion_table=fusion)
        beams[tag] = (dec, nbest(whole(dec)), nbest(whole(dec, enc32)), nbest(searched(dec, enc_rep)))

    def beam_verdict(tag: str, res: dict, key: str, rep=None) -> dict:
        _, off, ref, rep16 = beams[key]
        rep = rep16 if rep is None else rep
        return judge(tag, res, [rep[i][0][0] for i in range(32)], [h[0][0] for h in off],
                     lambda i: nbest_tie(rep[i][0][0], off[i], ref[i]))

    runs = served(rnnt_cfg, (), [("transducer beam 8, 16 streams", all32, 16, False),
                                 ("transducer beam 8, 4 streams", all32[:4], 4, False),
                                 ("transducer beam 8, 1 stream", all32[:1], 1, False)])
    for res in runs:
        verdicts[res["tag"]] = beam_verdict(res["tag"], res, "beam")
    (res,) = served(rnnt_cfg, ("--beam-width", "1"), [("transducer greedy, 16 streams", all32, 16, False)])
    verdicts[res["tag"]] = judge(
        res["tag"], res, [coder.decode(ids) for ids, _ in ali["rep"]], [coder.decode(ids) for ids, _ in ali["off"]],
        lambda i: greedy_node(model, enc_off[i, : t_out[i]], enc32[i, : t_out[i]], *ali["off"][i], *ali["rep"][i]))
    fused_cfg = variant(rnnt_cfg, "transducer_lm", lm_path=arpa, lm_alpha=0.5)
    (res,) = served(fused_cfg, (), [("transducer beam 8 + trigram, 16 streams", all32, 16, False)])
    verdicts[res["tag"]] = beam_verdict(res["tag"], res, "beam_lm")
    # the slots' ceiling: as many streams as slots (the 32 wavs twice for 64), every final still held
    for slots in STREAM_CEILING_SLOTS:
        rep = nbest(searched(beams["beam"][0], rnnt_replay(slots), slots))
        idx = (all32 * (slots // 32 + 1))[:slots]
        (res,) = served(rnnt_cfg, ("--slots", str(slots)),
                        [(f"transducer beam 8, {slots} slots, {slots} streams", idx, slots, False)], slots)
        verdicts[res["tag"]] = beam_verdict(res["tag"], res, "beam", rep)
    del model, enc_off, enc_rep, enc32, beams
    log(f"phase streaming, transducer: {time.perf_counter() - t0!r} s")

    # ---- the CTC recipe, unidirectional, seeded ----
    t0 = time.perf_counter()
    ctc_cfg = variant(recipes["ctc"][0], "ctc_uni", bidirectional="False", context_width=0, name="ctc_unilstm_512_2")
    cconf = ConfigParser()
    cconf.read(ctc_cfg)
    cnet = Nnet(cconf, 40, coder.num_labels, device=dev)
    gen = torch.Generator().manual_seed(13)
    cnet.model.reset_parameters(gen)
    with torch.no_grad():
        w = cnet.model.out.w
        w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w.shape[0]) * CTC_OUT_GAIN)
        cnet.model.out.b[blank] = CTC_BLANK_BIAS
    save_checkpoint(cnet.savedir, cnet.model.state_dict())
    cmodel = cnet._load_model().eval()
    c32 = type(cmodel)(dataclasses.replace(cmodel.config, compute_dtype=torch.float32)).to(dev).eval()
    c32.load_state_dict(cmodel.state_dict())
    ccmvn = global_cmvn(ws["train_featdir"])
    width = int(cconf.get("nnet", "beam_width"))
    lstm_want = {"lstm_fwd_persistent": 0, "lstm_fwd": 0}

    def offline_lp(raw_feats, counts):
        """Per wav the offline forward's log-posteriors (kernel 4, one
        direction), bf16 as configured and f32-compute on the same
        weights: ``(bf16 list, f32 list)``."""
        x = apply_cmvn(raw_feats, ccmvn)
        out = []
        for m in (cmodel, c32):
            with torch.inference_mode():
                lp = torch.log_softmax(m(x, torch.as_tensor(counts, device=dev)).float(), -1).cpu().numpy()
            cfg = m.config
            plan = rnn_bidi.fwd_plan(len(counts), cfg.hidden_units, m.GATES, cfg.compute_dtype, 1)
            persistent = plan.route == "persistent"
            lstm_want["lstm_fwd_persistent" if persistent else "lstm_fwd"] += cfg.num_layers * (
                1 if persistent else x.shape[1])
            out.append([lp[i, : counts[i]] for i in range(len(counts))])
        return tuple(out)

    def ctc_encode(f, k, carry):
        carry = cmodel.init_stream_carry(STREAM_SLOTS, dev) if carry is None else carry
        if f is None:
            return [torch.zeros(0, blank + 1, device=dev)] * STREAM_SLOTS, carry
        y, carry = cmodel.apply_stream(f, torch.as_tensor(np.asarray(k), device=dev), carry)
        lp = torch.log_softmax(y.float(), -1)
        return [lp[r, : int(c)] for r, c in enumerate(k)], carry

    def replay_lp(wavs):
        return [lp.cpu().numpy() for _, lp in stream_replay(ext, wavs, ctc_encode, ccmvn)]

    def held(lp_off, lp32, lp_rep, what: str) -> list:
        """The replayed log-posteriors held to the bf16 rule per wav against
        the f32-compute offline forward; returns each wav's bf16 noise, the
        offline forward's max|bf16 - f32| (the scale a near tie is judged
        by, independent of the stream)."""
        noise = [float(np.abs(o - r).max()) for o, r in zip(lp_off, lp32)]
        d_rep = [float(np.abs(p - r).max()) for p, r in zip(lp_rep, lp32)]
        d_ro = max(float(np.abs(p - o).max()) for p, o in zip(lp_rep, lp_off))
        bad = [(i, a, b) for i, (a, b) in enumerate(zip(d_rep, noise)) if not bf16_close(a, b)]
        log(f"streaming CTC (2 x 512 unidirectional LSTM, bf16, seeded), {what}: log-posteriors replayed in the "
            f"slots' shapes against the offline forward (kernel 4, one direction): max|diff| {d_ro!r}; from the "
            f"f32-compute offline forward: replay {max(d_rep)!r}, offline {max(noise)!r} (bf16 rule per wav: within "
            f"{RNN_BF16_RATIO}x + {RNN_F32_TOL})")
        if bad:
            raise AssertionError(f"the streamed CTC log-posteriors ({what}) are outside the bf16 rule on wavs {bad}")
        return noise

    (lp_off, lp32), lp_rep = offline_lp(raw, nframes), replay_lp(audio)
    noise = held(lp_off, lp32, lp_rep, "the 32 wavs")
    timings.update(ctc_logprob_replay_vs_offline=max(float(np.abs(r - o).max()) for r, o in zip(lp_rep, lp_off)),
                   ctc_logprob_replay_vs_f32=max(float(np.abs(r - o).max()) for r, o in zip(lp_rep, lp32)),
                   ctc_logprob_offline_vs_f32=max(noise))

    def greedy_text(lp):
        path = lp.argmax(-1)
        keep = np.ones(len(path), bool)
        keep[1:] = path[1:] != path[:-1]
        ids = path[keep]
        return coder.decode(ids[ids != blank])

    def frame_flip(a, b, noise_i):
        """The first frame whose argmax the offline ``a`` and replayed ``b``
        log-posteriors part on: a near tie ``(margin of a's pick over b's
        under a, the wav's bf16 noise)`` when the margin is within twice
        the noise, else None."""
        flips = np.flatnonzero(a.argmax(-1) != b.argmax(-1))
        if not len(flips):
            return None
        t = flips[0]
        margin = float(a[t].max() - a[t, b[t].argmax()])
        return (margin, noise_i) if margin <= 2 * noise_i else None

    scorer = FusionScorer(ArpaLM.load(arpa), list(coder.alphabet) + ["<blank>"], alpha=0.5, beta=0.0)

    def ctc_nbest(lp):
        beams_ = initial_beams()
        for t in range(lp.shape[0]):
            beams_ = beam_step(beams_, lp[t].astype(np.float64), blank, width, scorer)
        return [(coder.decode(np.asarray(p, np.int32)), s) for p, s in nbest_prefixes(beams_, width)]

    def beam_divergence(lp_a, lp_b, lp_c):
        """The prefix beams of the offline ``a``, the replay ``b`` and the
        f32-compute offline ``c`` log-posteriors, frame by frame: at the
        first frame the kept prefixes of ``a`` and ``b`` differ, ``a``'s
        margin for keeping its own over ``b``'s (the best score ``a`` kept
        that ``b`` dropped less the least ``a`` gives one ``b`` kept, scored
        by a 4x-wide step of the same beams), against the bf16 noise, the
        largest score difference of the prefixes both the wide steps of
        ``a`` and ``c`` hold; at the end, if the kept sets never parted, the
        offline gap between the two bests against the same noise of the
        final beams. ``(margin, noise)`` when the margin is within twice the
        noise, else None."""
        ba, bb, bc = initial_beams(), initial_beams(), initial_beams()

        def totals(beams_):
            return dict(nbest_prefixes(beams_, len(beams_)))

        def noise_of(sa, sc):
            return max((abs(sa[p] - sc[p]) for p in sa if p in sc), default=0.0)

        for t in range(lp_a.shape[0]):
            fa, fb, fc = (lp[t].astype(np.float64) for lp in (lp_a, lp_b, lp_c))
            na, nb = beam_step(ba, fa, blank, width, scorer), beam_step(bb, fb, blank, width, scorer)
            if set(na) != set(nb):
                wa = totals(beam_step(ba, fa, blank, 4 * width, scorer))
                noise_t = noise_of(wa, totals(beam_step(bc, fc, blank, 4 * width, scorer)))
                margin = (max(wa[p] for p in set(na) - set(nb))
                          - min(wa.get(q, -math.inf) for q in set(nb) - set(na)))
                return (margin, noise_t) if margin <= 2 * noise_t else None
            ba, bb, bc = na, nb, beam_step(bc, fc, blank, width, scorer)
        sa, sb = totals(ba), totals(bb)
        best_a, best_b = max(sa, key=sa.get), max(sb, key=sb.get)
        noise_t = noise_of(sa, totals(bc))
        margin = sa[best_a] - sa[best_b]
        return (margin, noise_t) if margin <= 2 * noise_t else None

    want_off = [greedy_text(lp) for lp in lp_off]
    want_rep = [greedy_text(lp) for lp in lp_rep]
    (cg,) = served(ctc_cfg, ("--beam-width", "1"), [("CTC greedy, 16 streams", all32, 16, False)])
    verdicts[cg["tag"]] = judge(cg["tag"], cg, want_rep, want_off,
                                lambda i: frame_flip(lp_off[i], lp_rep[i], noise[i]))
    ctc_lm_cfg = variant(ctc_cfg, "ctc_uni_lm", lm_path=arpa, lm_alpha=0.5)
    (cb,) = served(ctc_lm_cfg, (), [("CTC beam 16 + trigram, 16 streams", all32, 16, False)])
    t1 = time.perf_counter()
    nb_off, nb_rep = [ctc_nbest(lp) for lp in lp_off], [ctc_nbest(lp) for lp in lp_rep]
    timings["ctc_beam16_lm_host_s"] = time.perf_counter() - t1
    verdicts[cb["tag"]] = judge(cb["tag"], cb, [h[0][0] for h in nb_rep], [h[0][0] for h in nb_off],
                                lambda i: beam_divergence(lp_off[i], lp_rep[i], lp32[i]))
    (ce,) = served(ctc_cfg, ("--beam-width", "1", "--endpoint"), [("CTC greedy --endpoint, 16 streams", all32, 16,
                                                                   False)])
    early = [i for i, r in enumerate(ce["results"]) if r["early"]]
    ep_off, ep_rep, ep_noise = list(lp_off), list(lp_rep), list(noise)
    if early:  # an early final is the decode of the audio pushed until the endpoint
        cut = [audio[i][: (ce["results"][i]["partials"] + 1) * STREAM_CHUNK] for i in early]
        raw_cut, n_cut = offline_feats(cut)
        frame_calls += 1
        (off_cut, f32_cut), rep_cut = offline_lp(raw_cut, n_cut), replay_lp(cut)
        for i, off, rep, nz in zip(early, off_cut, rep_cut, held(off_cut, f32_cut, rep_cut, "the endpointed cuts")):
            ep_off[i], ep_rep[i], ep_noise[i] = off, rep, nz
    verdicts[ce["tag"]] = judge(ce["tag"], ce, [greedy_text(lp) for lp in ep_rep], [greedy_text(lp) for lp in ep_off],
                                lambda i: frame_flip(ep_off[i], ep_rep[i], ep_noise[i]))
    log(f"streaming CTC --endpoint (the default rules: no speech and 5 s of blanks, speech and 1 s of blanks, 20 s): "
        f"{len(early)} early finals of 32 (wavs {early}), each the decode of the audio pushed until it")
    timings["ctc_endpoint_early_finals"] = len(early)
    (ca,) = served(ctc_cfg, ("--beam-width", "1"), [("CTC greedy + alignment requests, 16 streams", all32, 16, True)])
    verdicts[ca["tag"]] = judge(ca["tag"], ca, want_rep, want_off,
                                lambda i: frame_flip(lp_off[i], lp_rep[i], noise[i]))
    frame_s = ext.frame_step / rate
    for i, r in enumerate(ca["results"]):
        n_labels = len(r["final"].split())
        path = lp_rep[i].argmax(-1)
        keep = np.ones(len(path), bool)
        keep[1:] = path[1:] != path[:-1]
        frames = np.flatnonzero(keep)[path[keep] != blank]
        if not (len(r["times"]) == len(r["confs"]) == n_labels == len(frames)
                and np.array_equal(r["times"], frames * frame_s) and np.all((r["confs"] >= 0) & (r["confs"] <= 1))
                and all(set(w) == {"word", "start", "end", "confidence"} and w["start"] <= w["end"]
                        for w in r["words"]) and len(r["words"]) <= n_labels):
            raise AssertionError(f"wav {i}: alignment answers {len(r['times'])} times, {len(r['confs'])} "
                                 f"confidences, {len(r['words'])} words for {n_labels} labels")
    log(f"streaming CTC alignment requests (S, C, W after each final): 32 of 32 answers of the right shapes: one "
        f"time and one confidence a label, the times those of the replay's emission frames, confidences in [0, 1], "
        f"{sum(len(r['words']) for r in ca['results'])} word spans")
    del cmodel, c32, cnet
    log(f"phase streaming, CTC: {time.perf_counter() - t0!r} s")

    launches = seven_counters()
    want = {"frame_preemph": frame_calls, **lstm_want}
    log(f"streaming path launches of the seven kernels {launches} (the offline references: kernel 2 {frame_calls} "
        f"feature calls, kernel 4 by route {lstm_want} from the bf16 and f32-compute CTC forwards of "
        f"{RNN_LAYERS} layers; the streaming path itself runs none)")
    if any(v != want.get(k, 0) for k, v in launches.items()):
        raise AssertionError(f"streaming path launches {launches}, want {want} and all else 0")
    timings["verdicts"] = verdicts
    frame_routes = check_frame_routes("streaming path")
    log(f"phase streaming: {time.perf_counter() - t_phase!r} s")
    return {"frame_preemph": frame_calls, "lstm_fwd": sum(lstm_want.values()), "frame_routes": frame_routes}, timings


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
    check_loader(f"{family} path", "alignment", cfg_path, len(steps))
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


# ---- the hybrid recipe's streaming (kernel 1 on the spliced DNN) ----

# kernel 1 at the streamed DNN's row counts: B x T_pad with T padded to the
# emitters' frame_bucket of 8 (chunks of 4, 16 and 64 frames at batch 1, 8
# ragged rows), below one 128-row TMA tile or with a ragged last one
STREAM_FFN_ROWS = (8, 16, 64, 72, 600)
HYBRID_STREAM_UTTS = 8  # test utterances a streamed check runs, at batch 1 and as 8 ragged rows
HYBRID_CHUNKS = (4, 16, 64)  # frames a feature chunk: 40, 160 and 640 ms at the 10 ms step (bench.py:1013)
HYBRID_TIMED_AUDIO_S = 10.0  # audio a timed sweep pushes (bench.py's sweep pushes 40 s)
HYBRID_WINDOWED_CHUNK = 16
# the delta front-end on the card against the offline extractor: derivative
# columns (rtol, atol), the f64 bar of tests/test_online_features.py; static
# columns bit for bit
DELTA_RTOL, DELTA_ATOL = 1e-7, 1e-10
HYBRID_WAVS = 8  # test wavs of the delta front-end's check, the delta server and speed-perturbed prepare_data
DELTA_SERVE_CLIENTS = 4
# a served delta final that differs from the offline greedy decode passes only
# as a near tie: a frame of the offline log-posteriors whose top two lie within
# this margin (f32 compute on both sides, sums in another order: about 1e-6)
DELTA_TIE_MARGIN = 1e-4
# speed-perturbed prepare_data on the card against --device cpu, err / max(|ref|, 1):
# the f64 DFT products of the card and the CPU round otherwise, then f32
PERTURB_FEAT_TOL = 1e-6


def check_ffn_streaming(card: str) -> dict:
    """Kernel 1 below one row tile: ``[n, K] @ [K, 2048]`` at n in
    STREAM_FFN_ROWS, K 440 and 2048, f32 and bf16, each on the TMA route
    its plan gives (TMA loads zeros past row n and the epilogue masks the
    stores), held to the plain version within FFN_TOL and timed beside
    ``torch.matmul`` and the bound. Returns ``{dtype: [rows]}``."""
    import torch

    from tfkaldi_tpu_torch.ops import fused_mlp
    from tfkaldi_tpu_torch.ops.gemm_plan import gemm_plan

    gen = torch.Generator().manual_seed(1)
    m = HIDDEN_UNITS
    rows = {"float32": [], "bfloat16": []}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for k in (440, 2048):
            w = (torch.randn(k, m, generator=gen) / k ** 0.5).to("cuda", dtype)
            b = (torch.randn(m, generator=gen) * 0.1).cuda()
            scale = (torch.rand(m, generator=gen) + 0.5).cuda()
            shift = (torch.randn(m, generator=gen) * 0.1).cuda()
            for n in STREAM_FFN_ROWS:
                x = torch.randn(n, k, generator=gen).to("cuda", dtype)
                plan = gemm_plan(n, k, m, dtype, "mn", (x.data_ptr(), w.data_ptr()))
                check_plan(plan, dtype)
                before = fused_mlp.launches_by_route["tma"]
                got = fused_mlp.fused_ffn_block(x, w, b, scale, shift, relu=True)
                want = fused_mlp.fused_ffn_block_ref(x, w, b, scale, shift, relu=True)
                torch.cuda.synchronize()
                if fused_mlp.launches_by_route["tma"] != before + 1:
                    raise AssertionError(f"fused_ffn [{n},{k}] did not launch on the TMA route")
                err = (got.float() - want.float()).abs().max().item()
                kernel_ms = ms_per_call(lambda: fused_mlp.fused_ffn_block(x, w, b, scale, shift))
                plain_ms = ms_per_call(lambda: fused_mlp.fused_ffn_block_ref(x, w, b, scale, shift))
                library_ms = ms_per_call(lambda: torch.matmul(x, w))
                b_ = bound(2 * n * k * m + 4 * n * m, nbytes(x, w, b, scale, shift, got),
                           PEAK_F32 if dtype == torch.float32 else PEAK_BF16)
                log(f"fused_ffn streaming rows [{n},{k}]x[{k},{m}] {name}: max|diff| {err!r} (tol {FFN_TOL[name]}), "
                    f"kernel {kernel_ms!r} ms, plain {plain_ms!r} ms, library (torch.matmul) {library_ms!r} ms "
                    f"({kernel_ms / library_ms!r}x), bound {b_['bound_ms']!r} ms by {b_['bound_by']}; "
                    f"{plan_text(plan)} [{card}]")
                if not (err <= FFN_TOL[name] and torch.isfinite(got.float()).all()):
                    raise AssertionError(f"fused_ffn {name} [{n},{k},{m}]: max|diff| {err} > {FFN_TOL[name]}")
                rows[name].append({"n": n, "k": k, "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                                   "library_ms": library_ms, **b_})
    return rows


def bench_sweep(push, chunk_s: float, warmup: int = 8) -> dict:
    """bench.py's streaming sweep (bench.py:1017-1038) over
    HYBRID_TIMED_AUDIO_S of audio: ``push()`` once per chunk after
    ``warmup`` pushes, each push's wall time (the likelihoods read back on
    the host, as serving reads them); p50 and p99 in ms, and bench's
    ``rtf``, audio seconds per wall second."""
    import numpy as np

    n = max(8, int(round(HYBRID_TIMED_AUDIO_S / chunk_s)))
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


def hybrid_streaming_path(card: str, ws: dict, train_ws: dict, bf16_conf, families: dict, ctc_cfg: str,
                          device: str = "cuda") -> tuple[dict, dict]:
    """The hybrid recipe's streaming, on the card:

    - the flagship DNN (the served path's f32 ``final.pt``, 440 -> 6 x 2048
      -> 2000, context 5) and bench.py's bf16 DNN (the bf16 DNN path's
      ``final.pt``) through ``OnlineSplicedDecoder`` on their test
      featdirs' first HYBRID_STREAM_UTTS utterances (CMVN'd fbanks), in
      chunks of HYBRID_CHUNKS frames, at batch 1 and as ragged rows of one
      batch; every emitted frame against the offline ``Decoder`` on
      offline-spliced features: f32 within LIKE_TOL, bf16 by the bf16 rule
      (each utterance's streamed frames no further from the f32-compute
      offline decode than RNN_BF16_RATIO times the bf16 offline decode's
      own distance, + RNN_F32_TOL: the stream's products have other row
      counts, which round otherwise). Kernel 1's counts reset before and
      read after: 6 launches per emitting call, all on the TMA route;
    - bench.py's ``lstm_hybrid`` (2 x LSTM-512, unidirectional, bf16, 2000
      pdfs, seeded) through ``OnlineRecurrentDecoder`` at chunk 16, and the
      TDNN and CNN ``final.pt`` of ``hybrid_family_path`` through
      ``OnlineWindowedDecoder`` at chunk HYBRID_WINDOWED_CHUNK, each by the
      bf16 rule against its offline decode;
    - ``OnlineDynamicExtractor`` at delta and ddelta on the card against
      the offline extractor (kernel 2) on the same wavs: static columns bit
      for bit, derivative columns within (DELTA_RTOL, DELTA_ATOL);
    - ``cli.serve --stream`` of a delta CTC config (the CTC recipe
      unidirectional, context 0, f32 compute, a seeded ``final.pt``, the
      CMVN of a delta featdir written by ``prepare_data``) with
      DELTA_SERVE_CLIENTS concurrent clients: each final equal to the
      offline greedy decode of the offline delta features, or a near tie
      (DELTA_TIE_MARGIN);
    - ``prepare_data`` with ``speed_perturb = 0.9,1.0,1.1`` on 8 test wavs
      on the card (kernel 2's launches counted) against ``--device cpu``
      within PERTURB_FEAT_TOL;
    - bench.py's streaming times: p50 / p99 per chunk and rtf for the f32
      and bf16 DNNs and the LSTM at 40, 160 and 640 ms chunks.

    Returns the main paths' launches (kernel 1 per dtype, kernel 2) and the
    timings."""
    import dataclasses
    from configparser import ConfigParser

    import numpy as np
    import torch

    from tfkaldi_tpu_torch.convert import save_checkpoint
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode.decoder import Decoder
    from tfkaldi_tpu_torch.decode.online import OnlineRecurrentDecoder, OnlineSplicedDecoder, OnlineWindowedDecoder
    from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn, splice
    from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
    from tfkaldi_tpu_torch.frontend.online import OnlineDynamicExtractor
    from tfkaldi_tpu_torch.frontend.prepare_data import compute_cmvn, prepare_data
    from tfkaldi_tpu_torch.io import read_wav, read_wavfiles
    from tfkaldi_tpu_torch.models import LSTM, RNNConfig, build_model
    from tfkaldi_tpu_torch.nnet import Nnet
    from tfkaldi_tpu_torch.ops import fused_mlp
    from tfkaldi_tpu_torch.ops import frame_preemph as fp
    from tfkaldi_tpu_torch.serve import global_cmvn

    t_phase = time.perf_counter()
    root = os.path.join(TRAIN_WORK, "hybrid_streaming")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    timings, launches = {}, {"fused_ffn_f32": 0, "fused_ffn_bf16": 0, "frame_preemph": 0}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def test_feats(featdir: str) -> list:
        """The featdir's first HYBRID_STREAM_UTTS utterances, CMVN'd, unspliced."""
        reader = FeatureReader(os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"),
                               os.path.join(featdir, "utt2spk"), 0, 0)
        out = [reader.get_utt()[1].astype(np.float32) for _ in range(HYBRID_STREAM_UTTS)]
        reader.close()
        return out

    def padded(feats: list) -> tuple:
        x = np.zeros((len(feats), max(f.shape[0] for f in feats), feats[0].shape[1]), np.float32)
        for i, f in enumerate(feats):
            x[i, : f.shape[0]] = f
        return x, np.asarray([f.shape[0] for f in feats], np.int64)

    def offline(model, prior, feats: list, c: int) -> list:
        """The offline ``Decoder`` on the utterances as one padded batch,
        spliced offline; per utterance its frames."""
        x, lengths = padded(feats)
        likes = Decoder(model, prior).compute_batch(splice(torch.from_numpy(x).to(dev), c), lengths).cpu().numpy()
        return [likes[i, :n] for i, n in enumerate(lengths)]

    def streamed(dec, feats: list, chunk: int) -> tuple[list, int]:
        """``feats`` as the rows of one batch through a windowed or spliced
        emitter in ``chunk``-frame pushes, then the flush; per row its
        frames, and the emitting calls (those that ran the model)."""
        b, longest = len(feats), max(f.shape[0] for f in feats)
        dec.reset(b)
        got, calls = [[] for _ in feats], 0
        for pos in [*range(0, longest, chunk), None]:
            if pos is None:
                likes, n = dec.flush()
            else:
                x = np.zeros((b, chunk, feats[0].shape[1]), np.float32)
                for i, f in enumerate(feats):
                    part = f[pos: pos + chunk]
                    x[i, : part.shape[0]] = part
                likes, n = dec.step(x, np.clip([f.shape[0] - pos for f in feats], 0, chunk))
            calls += int(n.max(initial=0) > 0)
            for i in range(b):
                got[i].append(likes[i, : n[i]])
        return [np.concatenate(g) for g in got], calls

    def f32_twin(model):
        twin = build_model(dataclasses.replace(model.config, compute_dtype=torch.float32)).to(dev).eval()
        twin.load_state_dict(model.state_dict())
        return twin

    def held(tag: str, got: list, off: list, off32: list | None) -> float:
        """Per utterance: f32 (``off32`` None) within LIKE_TOL of the
        offline frames; bf16 by the bf16 rule against the f32-compute
        offline ``off32``. Returns max|got - off|."""
        d = max(float(np.abs(g - o).max()) for g, o in zip(got, off))
        for i, (g, o) in enumerate(zip(got, off)):
            if g.shape != o.shape or not np.isfinite(g).all():
                raise AssertionError(f"{tag}, utterance {i}: streamed {g.shape} frames, offline {o.shape}")
        if off32 is None:
            ok, rule = d <= LIKE_TOL, f"tol {LIKE_TOL}"
        else:
            dist = [(float(np.abs(g - r).max()), float(np.abs(o - r).max())) for g, o, r in zip(got, off, off32)]
            ok = all(bf16_close(a, b) for a, b in dist)
            rule = (f"bf16 rule per utterance: from the f32-compute offline decode, streamed "
                    f"{max(a for a, _ in dist)!r}, offline {max(b for _, b in dist)!r}, within {RNN_BF16_RATIO}x + "
                    f"{RNN_F32_TOL}")
        log(f"hybrid streaming {tag}: {len(got)} utterances, {sum(g.shape[0] for g in got)} frames, max|streamed - "
            f"offline| {d!r} ({rule})")
        if not ok:
            raise AssertionError(f"hybrid streaming {tag}: the streamed likelihoods differ from the offline decode")
        return d

    # ---- the flagship DNN, f32 and bf16, through OnlineSplicedDecoder (kernel 1) ----
    t0 = time.perf_counter()
    dnn_runs = (("float32", ws["config"], ws["test_featdir"]), ("bfloat16", bf16_conf, train_ws["test_featdir"]))
    dnns = {}
    for name, config, featdir in dnn_runs:
        decoder = Nnet(config, 40, NUM_PDFS, device=dev).load_decoder()
        model, prior = decoder.model, decoder.prior.cpu().numpy()
        c = int(config.get("nnet", "context_width"))
        feats = test_feats(featdir)
        off = offline(model, prior, feats, c)
        off32 = None if name == "float32" else offline(f32_twin(model), prior, feats, c)
        sync()
        reset_counts()
        calls, errs = 0, {}
        for chunk in HYBRID_CHUNKS:
            rows = [streamed(OnlineSplicedDecoder(model, prior, c), [f], chunk) for f in feats]
            calls += sum(n for _, n in rows)
            errs[f"batch 1, chunk {chunk}"] = held(f"{name} DNN, batch 1, chunk {chunk}", [g for (g,), _ in rows],
                                                   off, off32)
            got, n = streamed(OnlineSplicedDecoder(model, prior, c), feats, chunk)
            calls += n
            errs[f"{len(feats)} rows, chunk {chunk}"] = held(f"{name} DNN, {len(feats)} ragged rows, chunk {chunk}",
                                                             got, off, off32)
        sync()
        routes = dict(fused_mlp.launches_by_route)
        log(f"hybrid streaming {name} DNN (context {c}): {calls} emitting calls, kernel 1 launches {fused_mlp.launches} "
            f"by route {routes} (want {HIDDEN_LAYERS} a call, all tma)")
        if not (fused_mlp.launches == HIDDEN_LAYERS * calls > 0 and routes["simt"] == 0):
            raise AssertionError(f"{name} DNN streaming: kernel 1 launches {fused_mlp.launches} by route {routes}, "
                                 f"want {HIDDEN_LAYERS} x {calls} on tma")
        launches[f"fused_ffn_{'f32' if name == 'float32' else 'bf16'}"] = fused_mlp.launches
        timings[f"dnn_{name}_max_abs_diff"] = errs
        dnns[name] = (model, prior, c)
    log(f"phase hybrid streaming, DNN: {time.perf_counter() - t0!r} s")

    # ---- bench.py's lstm_hybrid, and the TDNN and CNN ----
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(1)
    lstm = LSTM(RNNConfig(input_dim=40, num_labels=NUM_PDFS, num_layers=2, hidden_units=512, bidirectional=False,
                          compute_dtype=torch.bfloat16))
    lstm.reset_parameters(gen)
    with torch.no_grad():  # the init's output layer is zero: draw it, so that the likelihoods vary
        lstm.out.w.copy_(torch.randn(lstm.out.w.shape, generator=gen) / math.sqrt(lstm.out.w.shape[0]) * 4.0)
    lstm = lstm.to(dev).eval()
    uniform = np.full((NUM_PDFS,), 1.0 / NUM_PDFS, np.float32)
    feats = test_feats(train_ws["test_featdir"])
    x, lengths = padded(feats)
    off, off32 = (Decoder(m, uniform).compute_batch(x, lengths).cpu().numpy() for m in (lstm, f32_twin(lstm)))
    dec = OnlineRecurrentDecoder(lstm, uniform)
    got = []
    for f in feats:
        dec.reset(1)
        got.append(np.concatenate([dec.step(f[None, p: p + 16], [min(16, f.shape[0] - p)])[0]
                                   for p in range(0, f.shape[0], 16)]))
    timings["lstm_max_abs_diff"] = held("lstm_hybrid (2 x 512 unidirectional, bf16, seeded), batch 1, chunk 16", got,
                                        [off[i, :n] for i, n in enumerate(lengths)],
                                        [off32[i, :n] for i, n in enumerate(lengths)])
    for family, (cfg_path, _) in families.items():
        config = ConfigParser()
        config.read(cfg_path)
        model = Nnet(config, 40, NUM_PDFS, device=dev).load_decoder().model
        prior = np.load(os.path.join(families[family][1], "prior.npy"))
        c = int(config.get("nnet", "context_width"))
        o, o32 = offline(model, prior, feats, c), offline(f32_twin(model), prior, feats, c)
        got, _ = streamed(OnlineWindowedDecoder(model, prior, c), feats, HYBRID_WINDOWED_CHUNK)
        timings[f"{family}_max_abs_diff"] = held(
            f"{family} (receptive field {model.left_receptive} + {model.right_receptive}), {len(feats)} rows, chunk "
            f"{HYBRID_WINDOWED_CHUNK}", got, o, o32)
    log(f"phase hybrid streaming, LSTM, TDNN, CNN: {time.perf_counter() - t0!r} s")

    # ---- the delta front-end on the card ----
    t0 = time.perf_counter()
    base = ConfigParser()
    base.read(train_ws["cfg_path"])
    test_data = base.get("directories", "test_data")
    wav_scp = read_wavfiles(os.path.join(test_data, "wav.scp"))
    audio = [np.asarray(read_wav(p)[1], np.float32) for p in list(wav_scp.values())[:HYBRID_WAVS]]
    rate = 16000
    feat_conf = dict(base.items("dnn-features"))
    for dynamic in ("delta", "ddelta"):
        ext = FeatureExtractor(FeatureOpts.from_config({**feat_conf, "dynamic": dynamic}), rate, dev)
        batch = np.zeros((len(audio), -(-max(len(a) for a in audio) // rate) * rate), np.float32)
        for i, a in enumerate(audio):
            batch[i, : len(a)] = a
        with torch.inference_mode():
            ref, nf = ext(batch, np.asarray([len(a) for a in audio]))
        ref = ref.cpu().numpy()
        online = OnlineDynamicExtractor(ext)
        sdim, static_exact, worst = ext.opts.base_dim, 0, 0.0
        for i, a in enumerate(audio):
            online.reset(1)
            parts = [online.step(a[None, p: p + STREAM_CHUNK], [len(a[p: p + STREAM_CHUNK])])
                     for p in range(0, len(a), STREAM_CHUNK)] + [online.flush()]
            got = np.concatenate([f[0, : n[0]] for f, n in parts])
            want = ref[i, : nf[i]]
            if got.shape != want.shape or not np.array_equal(got[:, :sdim], want[:, :sdim]):
                raise AssertionError(f"{dynamic} stream, wav {i}: static columns differ from the offline extractor")
            static_exact += 1
            worst = max(worst, float(np.max(np.abs(got[:, sdim:] - want[:, sdim:])
                                            / (DELTA_ATOL + DELTA_RTOL * np.abs(want[:, sdim:])))))
        log(f"hybrid streaming: OnlineDynamicExtractor {dynamic} ({STREAM_CHUNK}-sample pushes) against the offline "
            f"extractor (kernel 2) on {len(audio)} wavs: static columns bit-identical on {static_exact}, derivative "
            f"columns at {worst!r} of the (rtol {DELTA_RTOL}, atol {DELTA_ATOL}) bar")
        if worst > 1.0:
            raise AssertionError(f"{dynamic} stream: derivative columns outside the bar ({worst})")
        timings[f"{dynamic}_bar_fraction"] = worst

    # ---- cli.serve --stream on a delta CTC config ----
    coder = TextCoder(aurora4_normalizer)
    blank = coder.num_labels
    config = ConfigParser()
    config.read(ctc_cfg)
    delta_name = f"{config.get('dnn-features', 'name')}_delta"
    config.set("dnn-features", "dynamic", "delta")
    config.set("dnn-features", "name", delta_name)
    config.set("directories", "train_features", os.path.join(root, "features"))
    for key, value in (("bidirectional", "False"), ("context_width", "0"), ("compute_dtype", "float32"),
                       ("name", "ctc_delta_unilstm")):
        config.set("nnet", key, value)
    delta_cfg = os.path.join(root, "config_ctc_delta.cfg")
    with open(delta_cfg, "w") as f:
        config.write(f)
    featdir = os.path.join(root, "features", delta_name)
    reset_counts()
    prepare_data(test_data, featdir, dict(config.items("dnn-features")), device=device)
    compute_cmvn(featdir)
    delta_frames, delta_routes = fp.launches, check_frame_routes("hybrid streaming, the delta featdir")
    cnet = Nnet(config, 80, coder.num_labels, device=dev)
    gen = torch.Generator().manual_seed(17)
    cnet.model.reset_parameters(gen)
    with torch.no_grad():
        w = cnet.model.out.w
        w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w.shape[0]) * CTC_OUT_GAIN)
        cnet.model.out.b[blank] = CTC_BLANK_BIAS
    save_checkpoint(cnet.savedir, cnet.model.state_dict())
    cmodel = cnet._load_model().eval()
    stats = global_cmvn(featdir)
    reader = FeatureReader(os.path.join(featdir, "feats.scp"), None, os.path.join(featdir, "utt2spk"), 0, 0)
    offline_feats = [reader.get_utt()[1] for _ in range(HYBRID_WAVS)]
    reader.close()
    x, lengths = padded(offline_feats)
    with torch.inference_mode():
        lp = torch.log_softmax(cmodel(apply_cmvn(torch.from_numpy(x).to(dev), stats),
                                      torch.as_tensor(lengths, device=dev)).float(), -1).cpu().numpy()

    def greedy(lp_i):
        path = lp_i.argmax(-1)
        keep = np.ones(len(path), bool)
        keep[1:] = path[1:] != path[:-1]
        ids = path[keep]
        return coder.decode(ids[ids != blank])

    want = [greedy(lp[i, :n]) for i, n in enumerate(lengths)]
    with stream_server(delta_cfg, "--device", device, "--beam-width", "1") as (host, port, server):
        res = stream_clients(host, port, audio, DELTA_SERVE_CLIENTS)
    ties = []
    for i, r in enumerate(res["results"]):
        if r["final"] != want[i]:
            top2 = np.sort(lp[i, : lengths[i]], axis=-1)[:, -2:]
            margin = float((top2[:, 1] - top2[:, 0]).min())
            if margin > DELTA_TIE_MARGIN:
                raise AssertionError(f"delta serve, wav {i}: final {r['final']!r}, offline {want[i]!r}, smallest "
                                     f"top-2 margin {margin} > {DELTA_TIE_MARGIN}")
            ties.append((i, margin))
    log(f"hybrid streaming: cli.serve --stream on a delta CTC config (2 x 512 unidirectional LSTM, f32, seeded, "
        f"80 inputs), {DELTA_SERVE_CLIENTS} concurrent clients on {len(audio)} wavs: {len(audio) - len(ties)} finals "
        f"identical to the offline greedy decode of the offline delta features, near ties {ties}; chunk reply p50 "
        f"{_pct(res['chunk_s'], 50) * 1e3!r} ms, wall {res['wall_s']!r} s [{card}]")
    timings["delta_serve_identical"] = len(audio) - len(ties)
    del cmodel, cnet
    log(f"phase hybrid streaming, delta front-end and serve: {time.perf_counter() - t0!r} s")

    # ---- prepare_data with speed_perturb (kernel 2) against --device cpu ----
    t0 = time.perf_counter()
    small = os.path.join(root, "sp_data")
    os.makedirs(small)
    keep = list(wav_scp)[:HYBRID_WAVS]
    for name in ("wav.scp", "utt2spk", "text"):
        src = os.path.join(test_data, name)
        if os.path.isfile(src):
            with open(src) as f, open(os.path.join(small, name), "w") as g:
                g.writelines(line for line in f if line.split(" ", 1)[0] in keep)
    spk = {}
    with open(os.path.join(small, "utt2spk")) as f:
        for line in f:
            utt, s = line.split()
            spk.setdefault(s, []).append(utt)
    with open(os.path.join(small, "spk2utt"), "w") as f:
        f.writelines(f"{s} {' '.join(u)}\n" for s, u in spk.items())
    sp_conf = {**feat_conf, "speed_perturb": "0.9,1.0,1.1"}
    dirs = {d: os.path.join(root, f"sp_{d}") for d in (device, "cpu")}
    reset_counts()
    sync()
    t1 = time.perf_counter()
    prepare_data(small, dirs[device], sp_conf, device=device)
    sync()
    sp_s = time.perf_counter() - t1
    sp_launches, sp_routes = fp.launches, check_frame_routes("hybrid streaming, speed_perturb")
    prepare_data(small, dirs["cpu"], sp_conf, device="cpu")
    card_feats, cpu_feats = read_ark(os.path.join(dirs[device], "feats.scp")), read_ark(
        os.path.join(dirs["cpu"], "feats.scp"))
    want_ids = [pre + u for u in keep for pre in ("sp0.9-", "", "sp1.1-")]
    if list(card_feats) != want_ids or list(cpu_feats) != want_ids:
        raise AssertionError(f"speed-perturbed featdir ids {list(card_feats)[:6]}..., want {want_ids[:6]}...")
    err = max(float(np.max(np.abs(card_feats[u] - cpu_feats[u]) / np.maximum(np.abs(cpu_feats[u]), 1.0)))
              for u in want_ids)
    log(f"hybrid streaming: prepare_data with speed_perturb 0.9,1.0,1.1 on {len(keep)} wavs -> {len(want_ids)} "
        f"utterances in {sp_s!r} s, kernel 2 launches {sp_launches}; card against --device cpu: max err/max(|ref|,1) "
        f"{err!r} (tol {PERTURB_FEAT_TOL}) [{card}]")
    if not (sp_launches > 0 and err <= PERTURB_FEAT_TOL):
        raise AssertionError(f"speed-perturbed prepare_data: kernel 2 launches {sp_launches}, card vs cpu {err}")
    launches["frame_preemph"] = delta_frames + sp_launches
    launches["frame_routes"] = {r: delta_routes[r] + sp_routes[r] for r in sp_routes}
    timings["speed_perturb_card_vs_cpu"] = err
    log(f"phase hybrid streaming, speed_perturb: {time.perf_counter() - t0!r} s")

    # ---- bench.py's streaming times ----
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    stacks = {"dnn_hybrid_f32": dnns["float32"], "dnn_hybrid_bf16": dnns["bfloat16"],
              "lstm_hybrid": (lstm, uniform, None)}
    for stack, (model, prior, c) in stacks.items():
        for frames in HYBRID_CHUNKS:
            chunk = rng.standard_normal((1, frames, 40)).astype(np.float32)
            dec = OnlineRecurrentDecoder(model, prior) if c is None else OnlineSplicedDecoder(model, prior, c)
            dec.reset(1)
            t = bench_sweep(lambda: dec.step(chunk, [frames]), frames / 100)
            log(f"hybrid streaming times, {stack} at {frames * 10} ms chunks: p50 {t['p50_ms']!r} ms, p99 "
                f"{t['p99_ms']!r} ms, rtf (audio s per wall s) {t['rtf']!r} over {t['chunks']} chunks [{card}]")
            timings[f"{stack}_{frames * 10}ms"] = t
    log(f"phase hybrid streaming, times: {time.perf_counter() - t0!r} s")
    log(f"phase hybrid streaming: {time.perf_counter() - t_phase!r} s")
    return launches, timings


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
    ffn_stream = check_ffn_streaming(card)
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

    # ---- the multi-process path: torchrun + NCCL on the same workspace ----
    mp_launches = multiprocess_path(card, train_ws)

    # ---- bench.py's bf16 DNN at full width ----
    t0 = time.perf_counter()
    bf16_launches, bf16_config, bf16_savedir = bf16_dnn_path(card, train_ws)
    check_train_step(card, train_ws, bn["bfloat16"]["ms"], bn_dz_only_ms["bfloat16"], bf16_config, bf16_savedir)
    log(f"phase bf16 DNN path: {time.perf_counter() - t0!r} s")

    # ---- the training knobs: SpecAugment, visualise, profile_steps on the bulk loader ----
    t0 = time.perf_counter()
    knobs_launches, knobs_times = knobs_path(card, train_ws)
    log(f"training knobs phase: {json.dumps(knobs_times)} [{card}]")
    log(f"phase training knobs: {time.perf_counter() - t0!r} s")

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

    # ---- the text recipes' offline decode as the JAX package runs it (kernel 4 on the fused CTC beam) ----
    t0 = time.perf_counter()
    text_launches, text_times = text_decode_path(
        card, train_ws, att_dirs,
        {"ctc": (ctc_cfg, ctc_savedir), "attention": (att_cfg, att_savedir), "rnnt": (rnnt_cfg, rnnt_savedir)},
        {"ctc": ctc_times["beam_frames_per_s"], "attention": att_times["decode_frames_per_s"],
         "rnnt": rnnt_times["beam8_frames_per_s"]})
    for name, count in text_launches.items():
        rnn_launches[name] += count
    log(f"text decode phase: {json.dumps(text_times)} [{card}]")
    log(f"phase text decode path: {time.perf_counter() - t0!r} s")

    # ---- cli.serve --stream: the transducer and CTC recipes over the socket (no hand kernel on the path) ----
    t0 = time.perf_counter()
    stream_launches, stream_times = streaming_path(
        card, train_ws, att_dirs, {"ctc": (ctc_cfg, ctc_savedir), "rnnt": (rnnt_cfg, rnnt_savedir)})
    rnn_launches["lstm_fwd"] += stream_launches["lstm_fwd"]
    log(f"streaming phase: {json.dumps(stream_times)} [{card}]")
    log(f"phase streaming path: {time.perf_counter() - t0!r} s")

    # ---- bench.py's TDNN and CNN on the hybrid recipe at full width (no hand kernel on their paths) ----
    families = {}
    for family in ("tdnn", "cnn"):
        t0 = time.perf_counter()
        families[family] = hybrid_family_path(card, family, train_ws)
        family_times = check_hybrid_family(card, family, *families[family], train_ws)
        log(f"{family} phase: {json.dumps(family_times)} [{card}]")
        log(f"phase {family} path: {time.perf_counter() - t0!r} s")

    # ---- the hybrid recipe's streaming: the spliced DNN on kernel 1, the other emitters, the delta
    # front-end and its server, speed-perturbed prepare_data ----
    t0 = time.perf_counter()
    hyb_launches, hyb_times = hybrid_streaming_path(card, ws, train_ws, bf16_config, families, ctc_cfg)
    log(f"hybrid streaming phase: {json.dumps(hyb_times)} [{card}]")
    log(f"kernel 1 at the streaming rows: {json.dumps(ffn_stream)} [{card}]")
    log(f"phase hybrid streaming path: {time.perf_counter() - t0!r} s")

    # launches: f32, the served path's, the training path's, the
    # multi-process path's children's, the training knobs' and the hybrid
    # streaming path's runs together; bf16, the bf16 DNN path's and the
    # hybrid streaming path's runs; kernels 4 and 5, the BiLSTM
    # path's, the CTC path's, the transducer path's and (kernel 4) the text
    # decode path's runs together
    total = {name: launches.get(name, 0) + train_launches[name] + knobs_launches.get(name, 0)
             + mp_launches.get(name, 0) for name in train_launches}
    total["frame_preemph"] += stream_launches["frame_preemph"] + hyb_launches["frame_preemph"]
    total["fused_ffn"] += hyb_launches["fused_ffn_f32"]
    kernels = [
        dict(name="fused_ffn_f32", route="cuda", source="tfkaldi_tpu_torch/ops/csrc/fused_ffn.cu",
             replaces="tfkaldi_tpu/ops/fused_mlp.py:40", launches=total["fused_ffn"], **ffn["float32"]),
        dict(name="fused_ffn_bf16", route="cuda", source="tfkaldi_tpu_torch/ops/csrc/fused_ffn.cu",
             replaces="tfkaldi_tpu/ops/fused_mlp.py:40",
             launches=bf16_launches["fused_ffn"] + hyb_launches["fused_ffn_bf16"], **ffn["bfloat16"]),
        dict(name="frame_preemph", route="cuda", source="tfkaldi_tpu_torch/ops/csrc/frame_preemph.cu",
             replaces="tfkaldi_tpu/ops/pallas_frontend.py:69", launches=total["frame_preemph"],
             launches_by_route={r: frame_routes[r] + train_frame_routes[r] + stream_launches["frame_routes"][r]
                                + hyb_launches["frame_routes"][r] for r in frame_routes}, **framing),
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

"""Preemphasis + end masking + overlapping framing in native f64 (kernel 2).

Port of :mod:`tfkaldi_tpu.ops.pallas_frontend`. The TPU kernel returned a
three-term f32 split of every frame because the TPU has no f64; here the
frames come out as f64 ``[B, t_max, frame_len]`` for the f64 DFT product.
On a CUDA tensor :func:`frame_preemph` launches ``csrc/frame_preemph.cu``
on the route :func:`frame_plan` picks; on a CPU tensor it runs
:func:`frame_preemph_ref`, the plain version. Both compute ``y[n] = x[n] -
c * x[n-1]`` with two f64 roundings (no FMA), so they agree bit for bit.

The launch plan is pure arithmetic, so the CPU tests reach it. A tile is
``frames`` consecutive frames of one utterance; a persistent grid walks the
tiles. Route ``"bulk"`` stages each tile's samples with one
``cp.async.bulk`` copy and writes the frames with 16-byte stores; it needs
a 16-byte aligned signal and output, a row pitch of whole 16 bytes (S a
multiple of 4) and an even frame length (so every tile's output starts on
16 bytes). Any other input takes route ``"edge"``: plain loads and 8-byte
stores. The route is decided here and nowhere else: a kernel that fails to
build or launch raises, and no call retries another route.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

from tfkaldi_tpu_torch.ops import _build

launches = 0  # kernel launches since the last reset (read by chip_smoke.py)
launches_by_route = {"bulk": 0, "edge": 0}  # the same launches by route

THREADS = 256  # a block (csrc/frame_preemph.cu)
ALIGN = 16  # bytes: the bulk copies' rule for addresses and sizes
SMEM_PER_CTA = 232_448  # the most shared memory a Hopper block may use
SMEM_PER_SM = 233_472  # an SM's shared memory; each block also reserves 1 KB
CTAS_PER_SM = 4  # the most blocks of the persistent grid an SM is given
TILE_BYTES = 51_200  # the f64 output a tile aims at: 16 frames of 400 samples
SMS = 132  # streaming multiprocessors of an H100 SXM, where no card is asked
_ROUTE_CODE = {"edge": 0, "bulk": 1}  # the C entries' `route` argument


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """``route`` ("bulk" or "edge"); ``frames`` a tile, ``tiles`` in
    all, a persistent ``grid`` of blocks of ``threads``, each with
    ``smem_bytes`` of dynamic shared memory."""

    route: str
    frames: int
    tiles: int
    grid: int
    threads: int
    smem_bytes: int

    @property
    def code(self) -> int:
        return _ROUTE_CODE[self.route]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def frame_smem(wl: int, ws: int, frames: int, route: str) -> int:
    """A block's shared memory (``Layout`` in csrc/frame_preemph.cu): the
    preemphasised span of a tile in f64 and, on route "bulk", two staged
    f32 spans (the span, the halo sample and 16-byte rounding at both
    ends) and two mbarriers."""
    span = (frames - 1) * ws + wl
    staged = 2 * _round_up(span + 8, 4) * 4 + 16 if route == "bulk" else 0
    return _round_up(span * 8, 16) + staged


def bulk_ok(s: int, wl: int, ptrs) -> bool:
    """Whether the bulk copies can serve a call: every row of the signal
    and every tile of the output start on 16 bytes."""
    return s % 4 == 0 and wl % 2 == 0 and all(p % ALIGN == 0 for p in ptrs)


def frame_plan(b: int, s: int, t_max: int, wl: int, ws: int, ptrs, sms: int = SMS, *,
               frames: int | None = None) -> FramePlan:
    """The plan of framing ``[b, s]`` f32 into ``[b, t_max, wl]`` f64 at
    step ``ws``; ``ptrs`` are the signal's and the output's data pointers
    (ints), ``sms`` the card's SM count. ``frames`` forces the tile depth
    (a harness that times it does)."""
    return _plan(b, s, t_max, wl, ws, bulk_ok(s, wl, ptrs), sms, frames)


@functools.lru_cache(maxsize=256)
def _plan(b, s, t_max, wl, ws, aligned, sms, frames) -> FramePlan:
    if min(b, s, t_max, wl, ws) < 1:
        raise ValueError(f"frame_plan: shape b {b}, s {s}, t_max {t_max}, wl {wl}, ws {ws}")
    if s >= 2 ** 31 or t_max * ws + wl >= 2 ** 31:
        raise ValueError("frame_plan: sample indices past 32 bits")
    route = "bulk" if aligned else "edge"
    if frames is None:
        frames = max(1, min(t_max, TILE_BYTES // (wl * 8)))
        while frames > 1 and frame_smem(wl, ws, frames, route) > SMEM_PER_CTA:
            frames //= 2
    smem = frame_smem(wl, ws, frames, route)
    tiles = b * -(-t_max // frames)
    per_sm = max(1, min(CTAS_PER_SM, SMEM_PER_SM // (smem + 1024)))
    return FramePlan(route, frames, tiles, min(tiles, sms * per_sm), THREADS, smem)


_sm_count: dict[int, int] = {}


def plan_for(signals, out, t_max: int, wl: int, ws: int, **force) -> FramePlan:
    """:func:`frame_plan` of a call on ``signals`` [B, S] writing ``out``,
    with the SM count of their card."""
    index = signals.device.index
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    b, s = signals.shape
    return frame_plan(b, s, t_max, wl, ws, (signals.data_ptr(), out.data_ptr()), _sm_count[index], **force)


def _check(signals, eff_len, frame_step, frame_len, t_max):
    if signals.ndim != 2 or signals.dtype != torch.float32:
        raise TypeError(f"frame_preemph: signals must be [B, S] float32, got {signals.dtype} {tuple(signals.shape)}")
    if eff_len.shape != (signals.shape[0],):
        raise ValueError(f"frame_preemph: eff_len must be [{signals.shape[0]}]")
    if frame_step <= 0 or frame_len <= 0 or t_max < 0:
        raise ValueError("frame_preemph: frame_step and frame_len must be positive")


def frame_preemph_ref(signals, eff_len, *, preemph: float, frame_step: int, frame_len: int, t_max: int):
    """Plain PyTorch version (the JAX package's f64 framing,
    frontend/features.py ``_compute_batch``)."""
    _check(signals, eff_len, frame_step, frame_len, t_max)
    x = signals.to(torch.float64)
    prev = torch.nn.functional.pad(x[:, :-1], (1, 0))
    y = x - float(preemph) * prev
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    y = y.masked_fill(idx >= eff_len.to(x.device)[:, None], 0.0)
    needed = (t_max - 1) * frame_step + frame_len
    if needed > y.shape[1]:
        y = torch.nn.functional.pad(y, (0, needed - y.shape[1]))
    fr = (
        torch.arange(t_max, device=x.device)[:, None] * frame_step
        + torch.arange(frame_len, device=x.device)[None, :]
    )
    return y[:, fr]


def frame_preemph(signals, eff_len, *, preemph: float, frame_step: int, frame_len: int, t_max: int,
                  plan: FramePlan | None = None):
    """``signals`` ``[B, S]`` float32 (samples exactly representable in
    f32, as wav data is), ``eff_len`` ``[B]`` real sample counts → the
    preemphasised frames ``[B, t_max, frame_len]`` float64, with samples at
    or past ``eff_len`` (or past ``S``) read as zeros. ``plan`` overrides
    :func:`plan_for`'s (its route must be the one the inputs allow)."""
    if signals.device.type == "cpu":
        return frame_preemph_ref(
            signals, eff_len, preemph=preemph, frame_step=frame_step,
            frame_len=frame_len, t_max=t_max,
        )
    if signals.device.type != "cuda":
        raise ValueError(f"frame_preemph: unsupported device {signals.device}")
    global launches
    _check(signals, eff_len, frame_step, frame_len, t_max)
    b, s = signals.shape
    if not signals.is_contiguous():
        signals = signals.contiguous()
    eff = eff_len
    if eff.dtype != torch.int32 or eff.device != signals.device or not eff.is_contiguous():
        eff = eff.to(device=signals.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, t_max, frame_len), dtype=torch.float64, device=signals.device)
    if out.numel() == 0:
        return out
    want = plan_for(signals, out, t_max, frame_len, frame_step)
    if plan is None:
        plan = want
    elif plan.route != want.route:
        raise ValueError(f"frame_preemph: {plan} on inputs whose route is {want.route!r}")
    lib = _build._lib or _build.load()
    ctx = (contextlib.nullcontext() if signals.device.index == torch.cuda.current_device()
           else torch.cuda.device(signals.device))
    with ctx:
        code = lib.tk_frame_preemph_f64(
            signals.data_ptr(), eff.data_ptr(), out.data_ptr(), b, s, t_max, frame_len, frame_step,
            float(preemph), plan.code, plan.frames, plan.grid,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "tk_frame_preemph_f64")
    launches += 1
    launches_by_route[plan.route] += 1
    return out

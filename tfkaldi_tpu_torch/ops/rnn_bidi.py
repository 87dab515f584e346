"""Both directions of a recurrence layer on the card: the parts kernels 4-7
share.

A :class:`Cell` names one recurrence (the LSTM in
:mod:`tfkaldi_tpu_torch.ops.lstm_bidi`, the GRU in
:mod:`tfkaldi_tpu_torch.ops.gru_bidi`) and carries its kernel wrappers,
their plain versions and their launch counts:

- :meth:`Cell.fwd` (kernel 4 / 6) runs :meth:`Cell.fwd_ref` on CPU tensors
  (one ``scan.forward`` per direction, the second reversed) and on CUDA
  tensors takes the route :func:`fwd_plan` picks from the shape and the
  dtype alone, before launch:

  - ``"persistent"``: ``tk_{name}_fwd_persistent_{f32,bf16}``
    (``csrc/rnn_step.cuh::persistent_fwd``), ONE cooperative launch per
    layer call carrying both directions and all T steps, each CTA's W_h
    slice resident in shared memory, h and c in registers, the bf16
    product on the tensor cores. Counted in ``fwd_persistent_launches``.
    Taken when a CTA's shared memory (W_h slice [H, 16·G] plus the h
    staging ring) fits in 232,448 bytes, the grid fits one CTA per SM
    (``dirs × ⌈H/16⌉ × row CTAs ≤ 132``) and no CTA loops over more than
    4 row tiles of 64 (B beyond the grid's row tiles loops inside a CTA).
    At the recipe's T 512, B 128, H 512 both dtypes take it (128 CTAs).
  - ``"step"``: ``tk_{name}_fwd_{f32,bf16}``, one launch per time step, on
    every other shape (e.g. H > 704 in f32 for the LSTM, or H > 1056
    bidirectional). Counted in ``fwd_launches`` (one per step).

  The route is never chosen after an error: a persistent launch that fails
  (the C side checks the occupancy calculator against the grid and
  launches with ``cudaLaunchCooperativeKernel``, which refuses a grid that
  cannot be co-resident) raises.
- :meth:`Cell.bwd` (kernel 5 / 7) runs :meth:`Cell.bwd_ref` on CPU tensors
  (one ``scan.backward_scan`` per direction, each shifting its own carry
  stream, as the JAX package's custom VJPs do) and on CUDA tensors takes
  the route :func:`bwd_plan` picks, the same way:

  - ``"persistent"``: ``tk_{name}_bwd_persistent_{f32,bf16}``
    (``csrc/rnn_step.cuh::persistent_bwd``), ONE cooperative launch per
    layer call, both directions and all T steps, each CTA's 16 rows of W_h
    resident in shared memory, dh (and dc) in registers, the dgates tile
    of the step before streamed by the TMA through a ring into the bf16
    tensor cores or exact f32 FMAs. Counted in ``bwd_persistent_launches``.
    Taken where a CTA's shared memory (W_h rows [16, G·H] plus the ring)
    fits in 232,448 bytes, the grid fits as for the forward and a dgates
    row fills whole 16-byte pieces. At the recipe's shape both dtypes and
    both cells take it (128 CTAs).
  - ``"step"``: ``tk_{name}_bwd_{f32,bf16}``, one launch per time step,
    elsewhere (e.g. H > 768 in bf16 or H > 576 in f32 for the LSTM, or an
    odd H in bf16).
    Counted in ``bwd_launches`` (one per step).

  A refused cooperative launch raises here too.

:class:`BidiScan` is the ``torch.autograd.Function`` around them, with
``dW_h = h_cdᵀ @ round_cd(dg)`` per direction as one ``torch.matmul``
(``lstm_scan.weight_grad``), outside the kernel as in the JAX package.
Without gradients (eval), :func:`run` takes the forward without residuals.
A unidirectional layer passes one direction to the same kernels. There is
no shape gate: the kernels mask their edges, so any T, B and H run.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from tfkaldi_tpu_torch.ops import _build
from tfkaldi_tpu_torch.ops.lstm_scan import weight_grad

_DT = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTRS = 9  # pointers per direction, in the order of csrc/rnn_step.cuh FwdDir / BwdDir

# The persistent kernels' tiling, as csrc/rnn_step.cuh sets it: P_ROWS,
# P_UNITS, P_MAXR, per compute dtype Pipe<T> (the forward: KC, NST, PADK,
# PADN) and BwdPipe<T> (the backward: KC, NST, PADN), and the backward's
# ring stage: two TMA boxes of 64 rows x 128 bytes.
P_ROWS, P_UNITS, P_MAXR = 64, 16, 4
_PIPE = {torch.bfloat16: (64, 8, 8, 8), torch.float32: (32, 4, 4, 4)}
_BWD_PIPE = {torch.bfloat16: (128, 8, 8), torch.float32: (64, 5, 4)}
_STAGE_BYTES = 2 * P_ROWS * 128
SMS = 132  # streaming multiprocessors of an H100 (SXM); one persistent CTA on each at most
SMEM_PER_CTA = 232_448  # the most shared memory a Hopper block may use


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """The forward's route and, on the persistent route, its grid:
    ``row_ctas`` CTAs along the batch per (direction, unit tile), each
    looping over ``tiles_per_cta`` row tiles of 64; ``ctas`` in all;
    ``smem_bytes`` of dynamic shared memory a CTA."""

    route: str
    ctas: int
    row_ctas: int
    tiles_per_cta: int
    smem_bytes: int


class BwdPlan(FwdPlan):
    """The backward's route and grid, with the fields of :class:`FwdPlan`."""


STEP_BWD = BwdPlan("step", 0, 0, 0, 0)  # the backward's step route, for a harness that times it


def _size(compute_dtype) -> int:
    return torch.empty((), dtype=compute_dtype).element_size()


def persistent_smem(gates: int, h: int, compute_dtype) -> int:
    """Shared memory of a persistent forward CTA: the W_h slice ``[KR, 16·G
    + PADN]`` and the h ring ``[NST, 64, KC + PADK]``, KR = H rounded up to
    KC (``csrc/rnn_step.cuh::persistent_smem``)."""
    kc, nst, padk, padn = _PIPE[compute_dtype]
    kr = -(-h // kc) * kc
    return (kr * (gates * P_UNITS + padn) + nst * P_ROWS * (kc + padk)) * _size(compute_dtype)


def persistent_bwd_smem(gates: int, h: int, compute_dtype) -> int:
    """Shared memory of a persistent backward CTA: W_h's 16 rows ``[16, KR +
    PADN]``, KR = G·H rounded up to KC, 1 KB to align the ring, the ring of
    NST stages of 16 KB (it also holds the warps' partial sums) and an
    8-byte mbarrier per stage (``csrc/rnn_step.cuh::persistent_bwd_smem``)."""
    kc, nst, padn = _BWD_PIPE[compute_dtype]
    kr = -(-(gates * h) // kc) * kc
    return P_UNITS * (kr + padn) * _size(compute_dtype) + 1024 + nst * (_STAGE_BYTES + 8)


def _plan(cls, smem: int, b: int, h: int, dirs: int):
    """The persistent route where ``smem`` fits a CTA, the grid fits one CTA
    per SM and no CTA loops over more than P_MAXR row tiles; else the step
    route."""
    tiles = -(-b // P_ROWS)
    row_ctas = min(tiles, SMS // (dirs * -(-h // P_UNITS)))
    if smem > SMEM_PER_CTA or row_ctas < 1 or -(-tiles // row_ctas) > P_MAXR:
        return cls("step", 0, 0, 0, 0)
    return cls("persistent", dirs * -(-h // P_UNITS) * row_ctas, row_ctas, -(-tiles // row_ctas), smem)


def fwd_plan(b: int, h: int, gates: int, compute_dtype, dirs: int) -> FwdPlan:
    """The forward's route for a layer call of batch ``b``, ``h`` units,
    ``gates`` gate blocks, ``dirs`` directions, from the shape and the
    compute dtype alone (T does not enter: the persistent kernel loops over
    it)."""
    return _plan(FwdPlan, persistent_smem(gates, h, compute_dtype), b, h, dirs)


def bwd_plan(b: int, h: int, gates: int, compute_dtype, dirs: int) -> BwdPlan:
    """The backward's route, as :func:`fwd_plan` decides the forward's; the
    persistent route also needs a dgates row of ``gates·h`` values to fill
    whole 16-byte pieces, as the TMA reads it."""
    if gates * h * _size(compute_dtype) % 16:
        return STEP_BWD
    return _plan(BwdPlan, persistent_bwd_smem(gates, h, compute_dtype), b, h, dirs)


def _check(name, gxs, whs_cd, mask, gates: int) -> tuple[int, int, int]:
    """Validate the operands a kernel takes; returns ``(T, B, H)``."""
    if len(gxs) not in (1, 2) or len(whs_cd) != len(gxs):
        raise ValueError(f"{name}: want 1 or 2 directions, got {len(gxs)} inputs and {len(whs_cd)} weights")
    t, b, gh = gxs[0].shape
    h = gh // gates
    cd = whs_cd[0].dtype
    if cd not in _DT:
        raise TypeError(f"{name}: compute dtype {cd}; want float32 or bfloat16")
    for gx, wh in zip(gxs, whs_cd):
        if gx.shape != (t, b, gates * h) or gx.dtype != torch.float32 or gx.device.type != "cuda":
            raise ValueError(f"{name}: inputs must be float32 [T, B, {gates}H] on one CUDA device")
        if wh.shape != (h, gates * h) or wh.dtype != cd or wh.device != gx.device:
            raise ValueError(f"{name}: weights must be [{h}, {gates * h}] {cd} on {gx.device}")
    if mask.shape != (t, b, 1) or mask.device != gxs[0].device:
        raise ValueError(f"{name}: mask must be [{t}, {b}, 1] on {gxs[0].device}")
    return t, b, h


def _launch(entry: str, blocks, mask, dirs: int, t: int, b: int, h: int, *extra: int) -> None:
    """Call a recurrence entry of the kernel library on the current stream:
    ``blocks`` holds ``_PTRS`` tensors (or None) per direction."""
    tensors = [x for block in blocks for x in block]
    assert len(tensors) == _PTRS * dirs
    ptrs = (ctypes.c_void_p * len(tensors))(*(None if x is None else x.data_ptr() for x in tensors))
    mask2d = mask[:, :, 0].to(torch.float32).contiguous()
    lib = _build.load()
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(ctypes.addressof(ptrs), mask2d.data_ptr(), dirs, t, b, h, *extra, stream)
    _build.check(code, entry)


class Cell:
    """One recurrence the kernels run.

    ``name`` picks the library entries ``tk_{name}_{fwd,bwd}_{f32,bf16}``;
    ``scan`` is the cell's plain module (``forward``, ``backward_scan``).
    ``gh_n`` marks the GRU: its forward keeps the recurrent n projection as
    a fourth residual and its backward emits ``dgh`` beside ``dgx``, where
    the LSTM carries a cell state ``c`` instead and its weight gradient
    contracts ``dgx`` itself. Residuals per direction: ``(acts, state,
    h_cds)`` plus ``gh_n`` for the GRU, ``state`` being ``cs`` (LSTM) or
    ``hs`` (GRU). The launch counts since the last reset, per route:
    ``fwd_persistent_launches`` and ``bwd_persistent_launches`` (one per
    call on the persistent route), ``fwd_launches`` and ``bwd_launches``
    (one per time step on the step route)."""

    def __init__(self, name: str, gates: int, scan, *, gh_n: bool):
        self.name, self.gates, self.scan, self.gh_n = name, gates, scan, gh_n
        self.reset_counts()

    def reset_counts(self) -> None:
        """Every launch count to 0."""
        self.fwd_persistent_launches = self.fwd_launches = 0
        self.bwd_persistent_launches = self.bwd_launches = 0

    def fwd_ref(self, gxs, whs_cd, mask, *, residuals: bool = True):
        """Plain version of the forward kernel: ``[(ys, residuals or None),
        ...]`` per direction (direction 1 runs reversed)."""
        outs = []
        for k, (gx, wh) in enumerate(zip(gxs, whs_cd)):
            ys, *res = self.scan.forward(gx, wh, mask, reverse=k == 1)
            outs.append((ys, tuple(res) if residuals else None))
        return outs

    def fwd(self, gxs, whs_cd, mask, *, residuals: bool = True):
        """The forward kernel on CUDA tensors, on the route :func:`fwd_plan`
        picks; :meth:`fwd_ref` on CPU tensors. ``gxs``: 1 or 2 ``[T, B,
        G·H]`` f32; ``whs_cd``: ``[H, G·H]`` in the compute dtype; ``mask
        [T, B, 1]`` f32 0/1."""
        if gxs[0].device.type == "cpu":
            return self.fwd_ref(gxs, whs_cd, mask, residuals=residuals)
        t, b, h = _check(f"{self.name}_fwd", gxs, whs_cd, mask, self.gates)
        cd = whs_cd[0].dtype
        dev = gxs[0].device
        plan = fwd_plan(b, h, self.gates, cd, len(gxs))
        persistent = plan.route == "persistent"
        outs, blocks = [], []
        for gx, wh in zip(gxs, whs_cd):
            ys = torch.empty(t, b, h, device=dev)
            res = None
            if residuals:
                res = (torch.empty(t, b, self.gates * h, device=dev), torch.empty(t, b, h, device=dev),
                       torch.empty(t, b, h, dtype=cd, device=dev))
                res += (torch.empty(t, b, h, device=dev),) if self.gh_n else ()
            acts, state, h_cds, ghns = (*res, None)[:4] if residuals else (None,) * 4
            if persistent:  # h_cds carries h between CTAs; without it two exchange slots do
                carry_h = None if residuals else torch.empty(2, b, h, dtype=cd, device=dev)
                carry_c = None
            else:
                carry_h = torch.zeros(2, b, h, device=dev)
                carry_c = None if self.gh_n else torch.zeros(b, h, device=dev)
            blocks.append((gx.contiguous(), wh.contiguous(), ys, acts, state, h_cds, ghns, carry_h, carry_c))
            outs.append((ys, res))
        if persistent:
            counters = torch.zeros(2, dtype=torch.int32, device=dev)  # one barrier counter per direction
            _launch(f"tk_{self.name}_fwd_persistent_{_DT[cd]}", blocks, mask, len(gxs), t, b, h,
                    int(residuals), plan.row_ctas, counters.data_ptr())
            self.fwd_persistent_launches += 1
        else:
            _launch(f"tk_{self.name}_fwd_{_DT[cd]}", blocks, mask, len(gxs), t, b, h, int(residuals))
            self.fwd_launches += t
        return outs

    def bwd_ref(self, dys, residuals, mask, whs_cd):
        """Plain version of the backward kernel: ``[(dgx, dg_w), ...]`` per
        direction, ``dg_w`` the operand of the weight gradient (``dgh`` for
        the GRU, ``dgx`` itself for the LSTM)."""
        out = []
        for k, (dy, (acts, state, _, *ghn), wh) in enumerate(zip(dys, residuals, whs_cd)):
            grads = self.scan.backward_scan(dy, acts, state, *ghn, mask, wh, reverse=k == 1)
            out.append(grads if self.gh_n else (grads, grads))
        return out

    def bwd(self, dys, residuals, mask, whs_cd, *, plan: BwdPlan | None = None):
        """The backward kernel on CUDA tensors, on the route :func:`bwd_plan`
        picks (``plan`` overrides it: a harness times the step route with
        :data:`STEP_BWD`); :meth:`bwd_ref` on CPU tensors."""
        if dys[0].device.type == "cpu":
            return self.bwd_ref(dys, residuals, mask, whs_cd)
        t, b, h = _check(f"{self.name}_bwd", [r[0] for r in residuals], whs_cd, mask, self.gates)
        cd = whs_cd[0].dtype
        dev = dys[0].device
        plan = plan or bwd_plan(b, h, self.gates, cd, len(dys))
        persistent = plan.route == "persistent"
        out, blocks = [], []
        for dy, (acts, state, _, *ghn), wh in zip(dys, residuals, whs_cd):
            for x in (dy, state, *ghn):
                if x.shape != (t, b, h) or x.dtype != torch.float32:
                    raise ValueError(f"{self.name}_bwd: dy and the [T, B, H] residuals must be float32 "
                                     f"[{t}, {b}, {h}]")
            dgx = torch.empty_like(acts)
            dgh = torch.empty_like(acts) if self.gh_n else None
            if persistent:  # two exchange slots of round_cd(dg); the carries stay in registers
                carry_dh, carry_dc = torch.empty(2, b, self.gates * h, dtype=cd, device=dev), None
            else:
                carry_dh = torch.zeros(b, h, device=dev)
                carry_dc = None if self.gh_n else torch.zeros(b, h, device=dev)
            blocks.append((dy.contiguous(), acts.contiguous(), state.contiguous(),
                           ghn[0].contiguous() if ghn else None, wh.contiguous(), dgx, dgh, carry_dh, carry_dc))
            out.append((dgx, dgx if dgh is None else dgh))
        if persistent:
            counters = torch.zeros(2, dtype=torch.int32, device=dev)  # one barrier counter per direction
            _launch(f"tk_{self.name}_bwd_persistent_{_DT[cd]}", blocks, mask, len(dys), t, b, h, plan.row_ctas,
                    counters.data_ptr())
            self.bwd_persistent_launches += 1
        else:
            _launch(f"tk_{self.name}_bwd_{_DT[cd]}", blocks, mask, len(dys), t, b, h)
            self.bwd_launches += t
        return out


class BidiScan(torch.autograd.Function):
    """``(cell, compute_dtype, mask, *gxs, *whs)`` → one ``ys [T, B, H]``
    per direction. ``whs`` are the f32 master weights, rounded to the
    compute dtype here; their gradients come back f32."""

    @staticmethod
    def forward(ctx, cell, compute_dtype, mask, *gx_wh):
        n = len(gx_wh) // 2
        gxs, whs = gx_wh[:n], gx_wh[n:]
        whs_cd = [w.to(compute_dtype) for w in whs]
        outs = cell.fwd(gxs, whs_cd, mask, residuals=True)
        ctx.cell, ctx.n, ctx.n_res = cell, n, len(outs[0][1])
        ctx.wh_dtypes = [w.dtype for w in whs]
        ctx.save_for_backward(mask, *whs_cd, *(x for _, res in outs for x in res))
        return tuple(ys for ys, _ in outs)

    @staticmethod
    def backward(ctx, *dys):
        mask, *saved = ctx.saved_tensors
        n, k = ctx.n, ctx.n_res
        whs_cd = saved[:n]
        residuals = [tuple(saved[n + i * k: n + (i + 1) * k]) for i in range(n)]
        grads = ctx.cell.bwd([dy.contiguous() for dy in dys], residuals, mask, whs_cd)
        cd = whs_cd[0].dtype
        # residuals[i][2] is h_cds for both cells
        dwhs = [weight_grad(res[2], dg_w, cd).to(dtype)
                for res, (_, dg_w), dtype in zip(residuals, grads, ctx.wh_dtypes)]
        return (None, None, None, *(dgx for dgx, _ in grads), *dwhs)


def run(cell: Cell, gxs, whs, mask, compute_dtype) -> list:
    """One or two directions of a recurrence layer; the autograd Function
    when a gradient is wanted, else the forward without residuals."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (*gxs, *whs)):
        return list(BidiScan.apply(cell, compute_dtype, mask, *gxs, *whs))
    whs_cd = [w.to(compute_dtype) for w in whs]
    return [ys for ys, _ in cell.fwd(gxs, whs_cd, mask, residuals=False)]

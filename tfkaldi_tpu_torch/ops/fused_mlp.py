"""Fused FFN block: ``act((x @ w + b) * scale + shift)`` with f32 accumulation.

Port of :mod:`tfkaldi_tpu.ops.fused_mlp`. The eval-mode forward of a DNN
hidden layer, with the batchnorm inference affine (``scale =
rsqrt(var + eps)``, ``shift = beta - mean * scale``) and the relu in the
epilogue. On a CUDA tensor :func:`fused_ffn_block` launches the hand-written
kernel ``csrc/fused_ffn.cu`` (the GEMM core of ``csrc/gemm_sm90.cuh`` with
the FFN epilogue, on the route :func:`~tfkaldi_tpu_torch.ops.gemm_plan.gemm_plan`
picks: ``tma``, ``splitk`` below one wave of tiles, or ``simt``; the first
two on 128-row tiles or the 64-row half tile); on a CPU
tensor it runs :func:`fused_ffn_block_ref`, the plain version that defines
the numerics.

The streamed DNN calls it six times a chunk on a few rows, where the
card's work is a few microseconds, so the wrapper keeps its host cost
low: the plan comes from a cache, casts and copies that would be no-ops
are not made, the device is switched only when it is not current, and the
split route's f32 workspace is one buffer a stream, kept and grown, not a
new allocation a call.
"""

from __future__ import annotations

import torch

from tfkaldi_tpu_torch.ops import _build
from tfkaldi_tpu_torch.ops.gemm_plan import GemmPlan, gemm_plan

launches = 0  # kernel launches since the last reset (read by chip_smoke.py)
launches_by_route = {"tma": 0, "splitk": 0, "simt": 0}  # the same launches by route
# the split route's workspace per (device, stream): launches on one stream
# run in order, so each reuses the buffer the one before it read
_workspaces: dict[tuple[int, int], torch.Tensor] = {}

_ENTRY = {torch.float32: "tk_fused_ffn_f32", torch.bfloat16: "tk_fused_ffn_bf16"}
# the current stream's handle without building a Stream object
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def fused_ffn_block_ref(x, w, b, scale=None, shift=None, *, relu: bool = True):
    """Plain PyTorch version: f32 accumulation (bf16 operands widen
    exactly), epilogue in f32, result in ``x.dtype``."""
    out = torch.matmul(x.float(), w.float()) + b.float()
    if scale is not None:
        out = out * scale.float()
    if shift is not None:
        out = out + shift.float()
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype)


def fused_ffn_block(x, w, b, scale=None, shift=None, *, relu: bool = True):
    """``[N, K] @ [K, M]`` + ``b`` → ``* scale + shift`` → relu, ``[N, M]``
    in ``x.dtype`` (float32 or bfloat16; f32 operands contract in full f32,
    never TF32). ``b``, ``scale``, ``shift`` are ``[M]``; ``scale``/``shift``
    default to the identity."""
    device = x.device
    if device.type == "cpu":
        return fused_ffn_block_ref(x, w, b, scale, shift, relu=relu)
    if device.type != "cuda":
        raise ValueError(f"fused_ffn_block: unsupported device {device}")
    if x.dtype not in _ENTRY or w.dtype != x.dtype:
        raise TypeError(f"fused_ffn_block: x {x.dtype} / w {w.dtype}; want both float32 or bfloat16")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_ffn_block: shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if b is None:
        raise ValueError("fused_ffn_block: b is required")
    n, k = x.shape
    m = w.shape[1]
    vecs = []
    for name, v in (("b", b), ("scale", scale), ("shift", shift)):
        if v is None:
            vecs.append(None)
            continue
        if v.shape != (m,) or v.device != device:
            raise ValueError(f"fused_ffn_block: {name} must be [{m}] on {device}")
        if v.dtype != torch.float32:
            v = v.to(torch.float32)
        vecs.append(v if v.is_contiguous() else v.contiguous())
    if not x.is_contiguous():
        x = x.contiguous()
    if not w.is_contiguous():
        w = w.contiguous()
    plan = gemm_plan(n, k, m, x.dtype, "mn", (x.data_ptr(), w.data_ptr()))
    return launch(plan, x, w, *vecs, relu=relu)


def launch(plan: GemmPlan, x, w, b, scale=None, shift=None, *, relu: bool = True):
    """One launch of kernel 1 on ``plan`` (as :func:`fused_ffn_block`
    checks and plans it: contiguous CUDA ``x``, ``w``; f32 contiguous
    vectors), counted on the plan's route; allocates the output and, on the
    split route, takes the ``[splits, N, M]`` f32 workspace from the
    stream's buffer (grown when too small)."""
    global launches
    device = x.device
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return launch(plan, x, w, b, scale, shift, relu=relu)
    n, k = x.shape
    m = w.shape[1]
    out = torch.empty((n, m), dtype=x.dtype, device=device)
    lib = _build.load()
    stream = _raw_stream(device.index) if _raw_stream is not None else torch.cuda.current_stream().cuda_stream
    ws = None
    if plan.route == "splitk":
        ws = _workspace(device, stream, plan.splits * n * m)
    code = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), out.data_ptr(), n, k, m, int(relu), plan.code, plan.bm,
        ws, plan.splits, plan.slabs, stream,
    )
    _build.check(code, _ENTRY[x.dtype])
    launches += 1
    launches_by_route[plan.route] += 1
    return out


def _workspace(device, stream: int, numel: int) -> int:
    """The address of at least ``numel`` f32 on ``device`` for launches on
    ``stream``: the buffer kept for the pair, replaced by a larger one when
    it is too small."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.numel() < numel:
        ws = _workspaces[key] = torch.empty(numel, dtype=torch.float32, device=device)
    return ws.data_ptr()

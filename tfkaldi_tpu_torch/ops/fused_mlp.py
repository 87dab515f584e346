"""Fused FFN block: ``act((x @ w + b) * scale + shift)`` with f32 accumulation.

Port of :mod:`tfkaldi_tpu.ops.fused_mlp`. The eval-mode forward of a DNN
hidden layer, with the batchnorm inference affine (``scale =
rsqrt(var + eps)``, ``shift = beta - mean * scale``) and the relu in the
epilogue. On a CUDA tensor :func:`fused_ffn_block` launches the hand-written
kernel ``csrc/fused_ffn.cu`` (the GEMM core of ``csrc/gemm_sm90.cuh`` with
the FFN epilogue, on the route :func:`~tfkaldi_tpu_torch.ops.gemm_plan.gemm_plan`
picks); on a CPU tensor it runs :func:`fused_ffn_block_ref`, the plain
version that defines the numerics.
"""

from __future__ import annotations

import torch

from tfkaldi_tpu_torch.ops import _build
from tfkaldi_tpu_torch.ops.gemm_plan import gemm_plan

launches = 0  # kernel launches since the last reset (read by chip_smoke.py)
launches_by_route = {"tma": 0, "simt": 0}  # the same launches by route

_ENTRY = {torch.float32: "tk_fused_ffn_f32", torch.bfloat16: "tk_fused_ffn_bf16"}


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
    if x.device.type == "cpu":
        return fused_ffn_block_ref(x, w, b, scale, shift, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn_block: unsupported device {x.device}")
    global launches
    if x.dtype not in _ENTRY or w.dtype != x.dtype:
        raise TypeError(f"fused_ffn_block: x {x.dtype} / w {w.dtype}; want both float32 or bfloat16")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_ffn_block: shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    n, k = x.shape
    m = w.shape[1]
    vecs = []
    for name, v in (("b", b), ("scale", scale), ("shift", shift)):
        if v is None:
            vecs.append(None)
            continue
        if v.shape != (m,) or v.device != x.device:
            raise ValueError(f"fused_ffn_block: {name} must be [{m}] on {x.device}")
        vecs.append(v.to(torch.float32).contiguous())
    if vecs[0] is None:
        raise ValueError("fused_ffn_block: b is required")
    x = x.contiguous()
    w = w.contiguous()
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    plan = gemm_plan(n, k, m, x.dtype, "mn", (x.data_ptr(), w.data_ptr()))
    lib = _build.load()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), w.data_ptr(), ptr(vecs[0]), ptr(vecs[1]), ptr(vecs[2]),
            out.data_ptr(), n, k, m, int(relu), plan.code, stream,
        )
    _build.check(code, _ENTRY[x.dtype])
    launches += 1
    launches_by_route[plan.route] += 1
    return out

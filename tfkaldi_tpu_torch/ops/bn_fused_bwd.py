"""Fused BN backward of the hybrid DNN's hidden layer: relu(maskedBN(h @ w + b)).

Port of :mod:`tfkaldi_tpu.ops.bn_fused_bwd`. :class:`BnReluLayer` is the
``torch.autograd.Function`` that replaces the JAX custom VJP
``bn_relu_layer``:

- forward: plain PyTorch, the ops of the JAX ``_forward`` in its order
  (matmul with f32 accumulation + f32 bias, stored in the compute dtype;
  masked f32 moments with ``count = max(Σmask, 1)`` and
  ``var = E[z²] − mean²``; center, ``rsqrt``, ``+beta``, cast, relu);
- backward pass 1: plain PyTorch, as the JAX ``_bwd`` (the relu gate
  recomputed from ``bn`` rounded to the compute dtype, ``S1``, ``S2``,
  ``c1 = r·S1/n``, ``c2 = r³·S2/n``, ``dbeta = S1``);
- backward pass 2: :func:`bn_dgrad`, which on a CUDA tensor launches the
  hand-written kernel ``csrc/bn_dgrad.cu`` (an elementwise ``dz`` pass, then
  ``dh = dz @ wᵀ`` on the GEMM core of ``csrc/gemm_sm90.cuh``) and on a CPU
  tensor runs :func:`bn_dgrad_ref`, the plain version that defines its
  numerics;
- then ``db = Σdz`` and ``dW = hᵀ @ dz`` (a ``torch.matmul``, as the JAX
  package leaves it to XLA).

Under a data split (:mod:`tfkaldi_tpu_torch.parallel.comm`) the forward's
moments are the global batch's, and the backward sums ``S1`` and ``S2``
over the data group before it forms ``c1`` and ``c2``, so the kernel runs
on the rank's rows with the global batch's feedback terms. Under the
column split the layer holds a block of ``H``: its moments stay per
column, and the ``dh`` it returns is a partial sum that the caller's
column gather (:func:`~tfkaldi_tpu_torch.parallel.comm.gather_columns`)
reduces over the model group.

The mask is a plain ``[N]`` float32 row mask: the TPU kernel's 128-lane
broadcast of it was a Mosaic block-alignment artefact.
"""

from __future__ import annotations

import torch

import torch.distributed as dist

from tfkaldi_tpu_torch.layers import affine, batchnorm, masked_moments
from tfkaldi_tpu_torch.ops import _build
from tfkaldi_tpu_torch.parallel import comm
from tfkaldi_tpu_torch.ops.gemm_plan import gemm_plan, tma_ok

launches = 0  # wrapper calls that launched the kernel since the last reset (read by chip_smoke.py)
# the same calls by route: "tma" (vector dz pass + the TMA product), "dz"
# (vector dz pass alone: need_dh=False), "simt" (scalar dz pass + the SIMT
# product, or alone): the edge route for rows TMA cannot describe
launches_by_route = {"tma": 0, "dz": 0, "simt": 0}

_ENTRY = {torch.float32: "tk_bn_dgrad_f32", torch.bfloat16: "tk_bn_dgrad_bf16"}


def bn_dgrad_ref(g, z, mask, w, mean, r, beta, c1, c2, compute_dtype=None, *, need_dh: bool = True):
    """Plain PyTorch version of the kernel (``_dgrad_kernel``).

    ``g``, ``z``: ``[N, H]``; ``mask``: ``[N]`` float32; ``w``: ``[K, H]``
    (the layer's ``[fan_in, fan_out]`` weight); ``mean``, ``r``, ``beta``,
    ``c1``, ``c2``: ``[H]`` float32. Returns ``(dh [N, K] in g.dtype or
    None, dz [N, H] in the compute dtype)``."""
    cd = compute_dtype or z.dtype
    zf = z.float()
    xhat = zf - mean
    bn = (xhat * r + beta).to(cd)
    dpre = torch.where(bn > 0, g.float(), 0.0)
    dz = (r * dpre - mask[:, None] * (c1 + xhat * c2)).to(cd)
    dh = None
    if need_dh:
        dh = torch.matmul(dz.float(), w.to(cd).float().t()).to(g.dtype)
    return dh, dz


def bn_dgrad(g, z, mask, w, mean, r, beta, c1, c2, *, need_dh: bool = True):
    """``dz`` and (with ``need_dh``) ``dh = dz @ wᵀ`` of a relu+BN layer;
    the compute dtype is ``z.dtype`` (float32 or bfloat16, f32
    accumulation, never TF32). Shapes as :func:`bn_dgrad_ref`. The route
    comes from :func:`~tfkaldi_tpu_torch.ops.gemm_plan.gemm_plan` of the
    product ``dz [N, H] @ wᵀ`` (B K-major) on the pointers of g, z and w
    (dz is a fresh, aligned allocation); without ``need_dh`` the same
    alignment rule picks the vector or the scalar dz pass."""
    if g.device.type == "cpu":
        return bn_dgrad_ref(g, z, mask, w, mean, r, beta, c1, c2, z.dtype, need_dh=need_dh)
    if g.device.type != "cuda":
        raise ValueError(f"bn_dgrad: unsupported device {g.device}")
    global launches
    cd = z.dtype
    if cd not in _ENTRY or g.dtype != cd:
        raise TypeError(f"bn_dgrad: g {g.dtype} / z {z.dtype}; want both float32 or bfloat16")
    if g.ndim != 2 or g.shape != z.shape or w.ndim != 2 or w.shape[1] != g.shape[1]:
        raise ValueError(f"bn_dgrad: shapes g {tuple(g.shape)} z {tuple(z.shape)} w {tuple(w.shape)}")
    n, h = g.shape
    k = w.shape[0]
    if mask.shape != (n,):
        raise ValueError(f"bn_dgrad: mask must be [{n}]")
    if n == 0:  # a rank's empty slice of a micro-batch: nothing to launch
        return (g.new_empty((0, k)) if need_dh else None), torch.empty_like(z)
    vecs = []
    for name, v in (("mean", mean), ("r", r), ("beta", beta), ("c1", c1), ("c2", c2)):
        if v.shape != (h,) or v.device != g.device:
            raise ValueError(f"bn_dgrad: {name} must be [{h}] on {g.device}")
        vecs.append(v.to(torch.float32).contiguous())
    g = g.contiguous()
    z = z.contiguous()
    w = w.to(cd).contiguous()  # read row by row as the transposed B operand
    mask = mask.to(device=g.device, dtype=torch.float32).contiguous()
    dz = torch.empty_like(z)
    dh = torch.empty((n, k), dtype=g.dtype, device=g.device) if need_dh else None
    ptrs = (g.data_ptr(), z.data_ptr(), w.data_ptr())
    if need_dh:
        route = gemm_plan(n, h, k, cd, "k", ptrs).route
    else:  # the dz pass alone: 16-byte loads wherever g and z could be a TMA operand
        route = "dz" if tma_ok(n, h, h, cd, "k", ptrs) else "simt"
    lib = _build.load()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, _ENTRY[cd])(
            g.data_ptr(), z.data_ptr(), mask.data_ptr(), w.data_ptr(),
            *(v.data_ptr() for v in vecs),
            None if dh is None else dh.data_ptr(), dz.data_ptr(), n, h, k, int(route != "simt"), stream,
        )
    _build.check(code, _ENTRY[cd])
    launches += 1
    launches_by_route[route] += 1
    return dh, dz


class BnReluLayer(torch.autograd.Function):
    """``(h, w, b, beta, mask, eps)`` → ``(act, batch_mean, batch_var)``.

    ``h`` ``[N, K]`` in the compute dtype; ``w`` ``[K, H]``, ``b``,
    ``beta`` ``[H]`` float32 master parameters; ``mask`` ``[N]`` float32.
    The moments feed non-differentiated state (the moving averages), so
    their cotangents are ignored, as in the JAX VJP."""

    @staticmethod
    def forward(ctx, h, w, b, beta, mask, eps: float):
        cd = h.dtype
        z = affine(h, w, b, cd)
        zf = z.float()
        mean, var, count = masked_moments(zf, mask)
        act = torch.relu(batchnorm(zf, mean, var, beta, eps, cd))
        ctx.eps = eps
        ctx.split = comm.row_split()  # the data group the backward sums S1 and S2 over
        ctx.save_for_backward(h, w, beta, mask, z, mean, var, count)
        ctx.mark_non_differentiable(mean, var)
        return act, mean, var

    @staticmethod
    def backward(ctx, g, _dmean, _dvar):
        h, w, beta, mask, z, mean, var, count = ctx.saved_tensors
        # pass 1: relu gate + moment-feedback reductions (bn_fused_bwd.py:185-195)
        zf = z.float()
        xhat = zf - mean
        r = torch.rsqrt(var + ctx.eps)
        bn = (xhat * r + beta).to(z.dtype)
        dpre = torch.where(bn > 0, g.float(), 0.0) * mask[:, None]
        s1 = dpre.sum(0)
        s2 = (dpre * xhat).sum(0)
        dbeta = s1  # this rank's rows: the trainer sums the gradients over the data group
        if ctx.split is not None:  # the global batch's feedback terms (one collective)
            s12 = torch.stack([s1, s2])
            dist.all_reduce(s12, group=ctx.split.group)
            s1, s2 = s12[0], s12[1]
        c1 = r * s1 / count
        c2 = r * r * r * s2 / count
        del zf, xhat, bn, dpre
        # pass 2: the kernel (the dz pass, then dh = dz @ wᵀ; dz feeds the wgrad)
        dh, dz = bn_dgrad(g, z, mask, w, mean, r, beta, c1, c2, need_dh=ctx.needs_input_grad[0])
        dzf = dz.float()
        db = dzf.sum(0)
        dw = torch.matmul(h.float().t(), dzf)
        return dh, dw, db, dbeta, None, None

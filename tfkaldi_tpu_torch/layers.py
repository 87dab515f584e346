"""The models' per-layer arithmetic.

Shared by :mod:`tfkaldi_tpu_torch.models.dnn` (its unfused chains and the
eval fallback) and :class:`tfkaldi_tpu_torch.ops.bn_fused_bwd.BnReluLayer`
(whose forward must be the same ops in the same order, so that the fused
and the unfused layer agree to the bit), and, for :func:`product`, by the
recurrent models and the plain scans. The ops are those of the JAX
package's ``models/dnn.py`` ``_affine``, ``ops/bn_fused_bwd.py``
``_forward`` and the ``preferred_element_type=float32`` products of
``models/rnn.py`` and ``ops/{lstm,gru}_scan.py``. Under a data split
(:func:`tfkaldi_tpu_torch.parallel.comm.data_split`) the batch moments are
the global batch's; a row-split weight's product is summed over the model
group before its bias (:func:`affine` with ``tp``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tfkaldi_tpu_torch.ops.bf16_split import ALIGN, padded, split3
from tfkaldi_tpu_torch.parallel import comm


# product calls by route since the last reset: bf16 on a card's tensor cores,
# or an f32 GEMM of the operands widened
product_routes = {"tensor_core": 0, "widened": 0}


def product(a, b, compute_dtype):
    """``a @ b`` (``torch.matmul``'s broadcasting) with operands rounded to
    ``compute_dtype``, f32 accumulation and an f32 result: the JAX package's
    ``preferred_element_type=float32`` product, where ``torch.matmul`` on
    bf16 would return bf16.

    bf16 operands on a card take the tensor cores (:class:`_Bf16Product`):
    a bf16 × bf16 product is exact in f32, so this is the widened product
    summed in another order. Everything else (f32 products, every CPU call)
    widens the rounded operands and runs an f32 GEMM, as the CPU twin of the
    JAX package does."""
    if compute_dtype == torch.bfloat16 and a.is_cuda and b.is_cuda:
        product_routes["tensor_core"] += 1
        a, b = a.to(compute_dtype), b.to(compute_dtype)
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _Bf16Product.apply(a, b)
        return _matmul_f32(a, b)
    product_routes["widened"] += 1
    return widened_product(a, b, compute_dtype)


def widened_product(a, b, compute_dtype):
    """:func:`product`'s widened route on any device: the operands rounded
    to ``compute_dtype``, widened to f32, one f32 GEMM. The plain
    recurrences that kernels 4-7 are held to (``ops/lstm_scan.py``,
    ``ops/gru_scan.py``) call it for their per-step products, so that on a
    card too they sum as the f32 GEMM does."""
    return torch.matmul(a.to(compute_dtype).float(), b.to(compute_dtype).float())


def _matmul_f32(x, y):
    """``torch.matmul(x, y)`` of bf16 operands as one tensor-core GEMM with
    f32 accumulation and an f32 result: a 2-D ``y`` takes every leading dim
    of ``x`` as rows, else the batch dims broadcast and flatten. cuBLAS
    takes its Hopper kernels only for an output width of whole 16 bytes, so
    a width that is not a multiple of 8 is padded with zero columns of
    ``y`` and cut off the result (a view)."""
    n = y.shape[-1]
    if n % ALIGN:
        y = _pad_cols(y, padded(n))
    if y.dim() == 2:
        out = torch.mm(x.reshape(-1, x.shape[-1]), y, out_dtype=torch.float32).reshape(*x.shape[:-1], y.shape[-1])
    else:
        batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
        x3 = x.expand(*batch, *x.shape[-2:]).reshape(-1, *x.shape[-2:])
        y3 = y.expand(*batch, *y.shape[-2:]).reshape(-1, *y.shape[-2:])
        out = torch.bmm(x3, y3, out_dtype=torch.float32).reshape(*batch, x.shape[-2], y.shape[-1])
    return out[..., :n] if n % ALIGN else out


def _pad_cols(y, cols: int):
    """``y [..., K, N]`` zero-padded to ``[..., K, cols]`` in its own
    layout (a column-major ``y``, such as a transposed view, is padded as
    its transpose), so that the copy reads memory in order."""
    if y.stride(-1) == 1:
        return F.pad(y, (0, cols - y.shape[-1]))
    return F.pad(y.mT, (0, 0, 0, cols - y.shape[-1])).mT


def split_term_grads(a, b, g, need_a: bool = True, need_b: bool = True):
    """The f32 gradients of bf16 ``a @ b`` for the f32 cotangent ``g``
    (None where not needed), by tensor-core GEMMs fed the cotangent whole,
    as :func:`split3`'s three bf16 terms (rows and columns zero-padded to
    multiples of 8): ``da = [g1|g2|g3] @ [bᵀ; bᵀ; bᵀ]`` (K tripled, one
    GEMM) and ``db = aᵀ @ [g1|g2|g3]`` (the rows of ``a`` zero-padded
    alike), its three column blocks summed in f32. Every product is exact in
    f32, so these are ``g @ bᵀ`` and ``aᵀ @ g`` summed in another order."""
    k, n = b.shape[-2:]
    fold = b.dim() == 2  # every leading dim of a and g is a row
    a2, g2 = (a.reshape(-1, k), g.reshape(-1, n)) if fold else (a, g)
    gs = split3(g2)  # [..., M8, 3·N8]
    m, (m8, n8) = g2.shape[-2], (gs.shape[-2], gs.shape[-1] // 3)
    da = db = None
    if need_a:  # [bᵀ; bᵀ; bᵀ], zero-padded, built in b's own layout
        if b.stride(-1) == 1:
            b3 = b.new_zeros(*b.shape[:-1], 3, n8)
            b3[..., :n] = b.unsqueeze(-2)
            b3t = b3.flatten(-2).mT
        else:
            b3t = b.new_zeros(*b.shape[:-2], 3, n8, k)
            b3t[..., :n, :] = b.mT.unsqueeze(-3)
            b3t = b3t.flatten(-3, -2)
        da = _matmul_f32(gs, b3t)[..., :m, :]
        da = da.reshape(a.shape) if fold else da.sum_to_size(a.shape)
    if need_b:
        a_rows = F.pad(a2, (0, 0, 0, m8 - m)) if m8 != m else a2
        db3 = _matmul_f32(a_rows.mT, gs).unflatten(-1, (3, n8))[..., :n]
        db = db3.sum(-2).sum_to_size(b.shape)
    return da, db


class _Bf16Product(torch.autograd.Function):
    """bf16 ``a @ b`` → f32 on the tensor cores, with the widened chain's
    gradients: :func:`split_term_grads`, each rounded once to bf16 (where
    the widened chain's cast rounds it)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _matmul_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da, db = split_term_grads(a, b, g, *ctx.needs_input_grad)
        return None if da is None else da.to(a.dtype), None if db is None else db.to(b.dtype)


def affine(h, w, b, compute_dtype, tp=None):
    """``h @ w + b``: :func:`product`, then an f32 bias add, stored in
    ``compute_dtype``. With ``tp`` (a grid whose model group splits ``w``
    by rows) the f32 partial products are summed over the model group
    before the bias."""
    z = product(h, w, compute_dtype)
    if tp is not None:
        z = comm.reduce_from_model(z, tp)
    return (z + b.float()).to(compute_dtype)


def masked_moments(zf, mask):
    """Batch mean and variance over the real rows, in f32:
    ``count = max(Σmask, 1)``, ``var = E[z²] − mean²``. Under a data split
    ``Σmask``, ``Σz·mask`` and ``Σz²·mask`` are summed over the data group
    in one collective first (layers.py:32-41 on the global batch). Returns
    ``(mean, var, count)``."""
    m = mask[:, None]
    n, s1, s2 = mask.sum(), (zf * m).sum(0), (torch.square(zf) * m).sum(0)
    n, s1, s2 = comm.sum_rows(n, s1, s2)
    count = torch.clamp(n, min=1.0)
    mean = s1 / count
    var = s2 / count - torch.square(mean)
    return mean, var, count


def batchnorm(zf, mean, var, beta, eps: float, compute_dtype, gamma=None):
    """Center-only batchnorm: ``((z − mean)·rsqrt(var + eps) + beta)`` in
    f32, cast to ``compute_dtype``; with ``gamma``, ``(z − mean)·rsqrt(var +
    eps)·gamma + beta``."""
    if gamma is None:
        return ((zf - mean) * torch.rsqrt(var + eps) + beta).to(compute_dtype)
    return ((zf - mean) * torch.rsqrt(var + eps) * gamma + beta).to(compute_dtype)

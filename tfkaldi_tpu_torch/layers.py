"""The models' per-layer arithmetic.

Shared by :mod:`tfkaldi_tpu_torch.models.dnn` (its unfused chains and the
eval fallback) and :class:`tfkaldi_tpu_torch.ops.bn_fused_bwd.BnReluLayer`
(whose forward must be the same ops in the same order, so that the fused
and the unfused layer agree to the bit), and, for :func:`product`, by the
recurrent models and the plain scans. The ops are those of the JAX
package's ``models/dnn.py`` ``_affine``, ``ops/bn_fused_bwd.py``
``_forward`` and the ``preferred_element_type=float32`` products of
``models/rnn.py`` and ``ops/{lstm,gru}_scan.py``.
"""

from __future__ import annotations

import torch


def product(a, b, compute_dtype):
    """``a @ b`` with operands rounded to ``compute_dtype``, f32 accumulation
    and an f32 result: bf16 operands widen exactly, so this is the JAX
    package's ``preferred_element_type=float32`` product, where
    ``torch.matmul`` on bf16 would return bf16."""
    return torch.matmul(a.to(compute_dtype).float(), b.to(compute_dtype).float())


def affine(h, w, b, compute_dtype):
    """``h @ w + b``: :func:`product`, then an f32 bias add, stored in
    ``compute_dtype``."""
    return (product(h, w, compute_dtype) + b.float()).to(compute_dtype)


def masked_moments(zf, mask):
    """Batch mean and variance over the real rows, in f32:
    ``count = max(Σmask, 1)``, ``var = E[z²] − mean²``. Returns
    ``(mean, var, count)``."""
    count = torch.clamp(mask.sum(), min=1.0)
    m = mask[:, None]
    mean = (zf * m).sum(0) / count
    var = (torch.square(zf) * m).sum(0) / count - torch.square(mean)
    return mean, var, count


def batchnorm(zf, mean, var, beta, eps: float, compute_dtype):
    """Center-only batchnorm: ``((z − mean)·rsqrt(var + eps) + beta)`` in
    f32, cast to ``compute_dtype``."""
    return ((zf - mean) * torch.rsqrt(var + eps) + beta).to(compute_dtype)

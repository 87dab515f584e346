"""The DNN's per-layer arithmetic in the training forward.

Shared by :mod:`tfkaldi_tpu_torch.models.dnn` (its unfused chains and the
eval fallback) and :class:`tfkaldi_tpu_torch.ops.bn_fused_bwd.BnReluLayer`
(whose forward must be the same ops in the same order, so that the fused
and the unfused layer agree to the bit). The ops are those of the JAX
package's ``models/dnn.py`` ``_affine`` and ``ops/bn_fused_bwd.py``
``_forward``.
"""

from __future__ import annotations

import torch


def affine(h, w, b, compute_dtype):
    """``h @ w + b``: operands in ``compute_dtype``, f32 accumulation and
    f32 bias add, stored in ``compute_dtype`` (bf16 operands widen exactly,
    so the product is the JAX package's ``preferred_element_type=float32``
    one)."""
    y = torch.matmul(h.to(compute_dtype).float(), w.to(compute_dtype).float())
    return (y + b.float()).to(compute_dtype)


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

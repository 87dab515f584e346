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

from tfkaldi_tpu_torch.parallel import comm


def product(a, b, compute_dtype):
    """``a @ b`` with operands rounded to ``compute_dtype``, f32 accumulation
    and an f32 result: bf16 operands widen exactly, so this is the JAX
    package's ``preferred_element_type=float32`` product, where
    ``torch.matmul`` on bf16 would return bf16."""
    return torch.matmul(a.to(compute_dtype).float(), b.to(compute_dtype).float())


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


def batchnorm(zf, mean, var, beta, eps: float, compute_dtype):
    """Center-only batchnorm: ``((z − mean)·rsqrt(var + eps) + beta)`` in
    f32, cast to ``compute_dtype``."""
    return ((zf - mean) * torch.rsqrt(var + eps) + beta).to(compute_dtype)

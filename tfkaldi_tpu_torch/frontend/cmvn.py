"""Per-speaker CMVN statistics, and the streaming path's f32 CMVN.

A numpy copy of ``cmvn_stats`` from :mod:`tfkaldi_tpu.frontend.cmvn` (that
module imports JAX), and :func:`apply_cmvn32`, a torch copy of its
``apply_cmvn`` as the streaming transcribers round it. The stats layout is Kaldi's: a ``[2, dim+1]`` matrix
per speaker with ``stats[0, :dim] = Σx``, ``stats[0, dim] = frame count``,
``stats[1, :dim] = Σx²``, ``stats[1, dim] = 0``.
"""

from __future__ import annotations

import numpy as np


def cmvn_stats(feats, num_frames=None) -> np.ndarray:
    """Accumulate CMVN stats over one speaker's frames.

    Args:
        feats: ``[T, D]`` matrix, or ``[B, T, D]`` padded batch (padding
            frames zeroed) with ``num_frames`` giving the real counts.

    Returns:
        ``[2, D+1]`` float64 stats matrix (prepare_data.py:113-118 layout).
    """
    feats = np.asarray(feats, dtype=np.float64)
    if feats.ndim == 2:
        total = feats.shape[0]
        s1 = feats.sum(0)
        s2 = np.square(feats).sum(0)
    else:
        total = int(np.sum(num_frames))
        s1 = feats.sum((0, 1))
        s2 = np.square(feats).sum((0, 1))
    dim = s1.shape[0]
    stats = np.zeros((2, dim + 1))
    stats[0, :dim] = s1
    stats[1, :dim] = s2
    stats[0, dim] = total
    return stats


def apply_cmvn32(feats, stats):
    """``(x - mean) / sqrt(E[x²] - mean²)`` in f32 on ``feats``'s device,
    the stats rounded to f32 first: the streaming transcribers' CMVN, which
    the JAX package computes in f32 whatever the stats' dtype
    (frontend/cmvn.py:46-53 outside an x64 scope). ``feats`` is a tensor
    ``[..., D]``; ``stats`` the Kaldi ``[2, D+1]`` matrix."""
    import torch

    s = torch.as_tensor(np.asarray(stats, np.float32), device=feats.device)
    count = s[0, -1]
    mean = s[0, :-1] / count
    variance = s[1, :-1] / count - torch.square(mean)
    return (feats.float() - mean) / torch.sqrt(variance)

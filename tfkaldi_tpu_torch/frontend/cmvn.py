"""Per-speaker CMVN statistics, normalisation and context splicing.

Copies of :mod:`tfkaldi_tpu.frontend.cmvn` (that module imports JAX):
``cmvn_stats`` in numpy, ``apply_cmvn`` and ``splice`` on torch tensors.
The stats layout is Kaldi's: a ``[2, dim+1]`` matrix
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


def apply_cmvn(utt, stats):
    """Mean/variance normalisation with precomputed speaker stats,
    ``(x - mean) / sqrt(E[x²] - mean²)``, in f32 on ``utt``'s device: a copy
    of the JAX ``apply_cmvn`` (frontend/cmvn.py:46-53) at JAX's default
    precision, which rounds the f64 stats to f32 first. ``utt`` is a tensor
    or array ``[..., D]`` (``[T, D]`` or ``[B, T, D]``); ``stats`` the Kaldi
    ``[2, D+1]`` matrix. The streaming transcribers' CMVN."""
    import torch

    utt = torch.as_tensor(utt)
    s = torch.as_tensor(np.asarray(stats, np.float32), device=utt.device)
    count = s[0, -1]
    mean = s[0, :-1] / count
    variance = s[1, :-1] / count - torch.square(mean)
    return (utt.float() - mean) / torch.sqrt(variance)


def splice(utt, context_width: int):
    """±``context_width`` neighbour frames concatenated onto each frame,
    zero-padded at the edges: ``[T, D] → [T, D·(2c+1)]``, or the same over
    the time axis of ``[B, T, D]`` (a copy of the JAX ``splice``,
    frontend/cmvn.py:56-84; column block ``o`` holds the frames shifted by
    ``o - c``). Batch padding frames take context from real neighbours, so
    callers mask frames past each row's length downstream."""
    import torch

    c = int(context_width)
    utt = torch.as_tensor(utt)
    if c == 0:
        return utt
    t = utt.shape[-2]
    pad = [0, 0, c, c]  # the time axis, second to last
    padded = torch.nn.functional.pad(utt, pad)
    return torch.cat([padded[..., o: o + t, :] for o in range(2 * c + 1)], dim=-1)

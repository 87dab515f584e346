"""Standalone signal-processing functions (API parity with the reference's
vendored python_speech_features module, processing/sigproc.py:33-191).

A copy of :mod:`tfkaldi_tpu.frontend.sigproc` (numpy only). These are
host-side float64 conveniences for scripting and tests; the production
path is the batched device pipeline of
:mod:`tfkaldi_tpu_torch.frontend.features`. Semantics pinned to the
reference:

- framing pads the signal with zeros to a whole number of frames and the
  default window is rectangular (sigproc.py:33-68)
- ``deframesig`` divides the overlap-add by the summed window + 1e-15
  (sigproc.py:70-117)
- ``logpowspec`` floors at 1e-30 and optionally normalizes to max 0 dB
  (sigproc.py:155-178)
- ``preemphasis`` keeps the first sample (sigproc.py:180-191)
"""

from __future__ import annotations

import numpy as np


def preemphasis(signal: np.ndarray, coeff: float = 0.95) -> np.ndarray:
    """``y[n] = x[n] - coeff·x[n-1]``, ``y[0] = x[0]``."""
    signal = np.asarray(signal, dtype=np.float64)
    return np.concatenate([signal[:1], signal[1:] - coeff * signal[:-1]])


def _num_frames(slen: int, frame_len: int, frame_step: int) -> int:
    if slen <= frame_len:
        return 1
    return 1 + int(np.ceil((slen - frame_len) / frame_step))


def framesig(
    sig: np.ndarray,
    frame_len: float,
    frame_step: float,
    winfunc=lambda x: np.ones((x,)),
) -> np.ndarray:
    """Overlapping frames with zero padding to a whole frame count."""
    sig = np.asarray(sig, dtype=np.float64)
    frame_len_i, frame_step_i = int(round(frame_len)), int(round(frame_step))
    numframes = _num_frames(len(sig), frame_len_i, frame_step_i)
    padlen = (numframes - 1) * frame_step_i + frame_len_i
    padded = np.concatenate([sig, np.zeros(padlen - len(sig))])
    idx = (
        np.arange(numframes)[:, None] * frame_step_i + np.arange(frame_len_i)[None, :]
    )
    return padded[idx] * winfunc(frame_len_i)[None, :]


def deframesig(
    frames: np.ndarray,
    siglen: int,
    frame_len: float,
    frame_step: float,
    winfunc=lambda x: np.ones((x,)),
) -> np.ndarray:
    """Overlap-add inverse of :func:`framesig` with window-sum correction."""
    frames = np.asarray(frames, dtype=np.float64)
    frame_len_i, frame_step_i = int(round(frame_len)), int(round(frame_step))
    numframes = frames.shape[0]
    padlen = (numframes - 1) * frame_step_i + frame_len_i
    idx = (
        np.arange(numframes)[:, None] * frame_step_i + np.arange(frame_len_i)[None, :]
    ).ravel()
    win = winfunc(frame_len_i)
    rec = np.zeros(padlen)
    correction = np.zeros(padlen)
    np.add.at(rec, idx, frames.ravel())
    np.add.at(correction, idx, np.broadcast_to(win, frames.shape).ravel() + 1e-15)
    rec = rec / correction
    if siglen <= 0:
        siglen = padlen
    return rec[:siglen]


def magspec(frames: np.ndarray, nfft: int) -> np.ndarray:
    """``|rfft(frame, nfft)|`` per frame."""
    return np.abs(np.fft.rfft(np.asarray(frames, dtype=np.float64), nfft, axis=-1))


def powspec(frames: np.ndarray, nfft: int) -> np.ndarray:
    """``|rfft|² / nfft`` per frame."""
    return np.square(magspec(frames, nfft)) / nfft


def logpowspec(frames: np.ndarray, nfft: int, norm: bool = True) -> np.ndarray:
    """``10·log10(powspec)`` floored at 1e-30; ``norm`` shifts max to 0 dB."""
    ps = powspec(frames, nfft)
    ps = np.where(ps <= 1e-30, 1e-30, ps)
    lps = 10.0 * np.log10(ps)
    if norm:
        lps = lps - np.max(lps)
    return lps

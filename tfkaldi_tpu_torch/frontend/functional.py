"""Standalone feature functions (API parity with the reference's
processing/base.py:37-284): fbank / logfbank / mfcc / ssc and the
derivative helpers, one signal at a time in float64 on the host.

A copy of :mod:`tfkaldi_tpu.frontend.functional` (numpy and scipy only;
``FeatureOpts`` and the mel helpers come from the port). The production
path is :class:`tfkaldi_tpu_torch.frontend.features.FeatureExtractor` (the
same math batched on the device); these exist so scripts written against
the reference's function-level API keep working. ``conf`` is the same
string-valued ``[gmm-features]``/``[dnn-features]`` dict the reference
passes around.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage

from tfkaldi_tpu_torch.frontend import sigproc
from tfkaldi_tpu_torch.frontend.features import FeatureOpts
from tfkaldi_tpu_torch.frontend.mel import dct_ortho_matrix, lifter_vector, mel_filterbank

_EPS = float(np.finfo(np.float64).eps)


def _power_and_energy(signal, samplerate, opts: FeatureOpts):
    winlen = opts.winlen * samplerate
    winstep = opts.winstep * samplerate
    sig = sigproc.preemphasis(signal, opts.preemph)
    frames = sigproc.framesig(sig, winlen, winstep)
    pspec = sigproc.powspec(frames, opts.nfft)
    energy = np.sum(pspec, axis=1)
    energy = np.where(energy == 0, _EPS, energy)  # base.py:87
    return pspec, energy


def fbank(signal, samplerate, conf) -> tuple[np.ndarray, np.ndarray]:
    """Mel filterbank energies + per-frame total energy (base.py:59-98).

    Returns ``(feat [T, nfilt], energy [T])``; feat is eps-floored, not
    logged.
    """
    opts = FeatureOpts.from_config(dict(conf))
    pspec, energy = _power_and_energy(signal, samplerate, opts)
    highfreq = opts.highfreq if opts.highfreq >= 0 else samplerate / 2
    fb = mel_filterbank(opts.nfilt, opts.nfft, samplerate, opts.lowfreq, highfreq)
    feat = pspec @ fb.T
    feat = np.where(feat == 0, _EPS, feat)  # base.py:96
    return feat, energy


def logfbank(signal, samplerate, conf) -> np.ndarray:
    """``log(fbank)`` (base.py:100-115)."""
    feat, _ = fbank(signal, samplerate, conf)
    return np.log(feat)


def mfcc(signal, samplerate, conf) -> tuple[np.ndarray, np.ndarray]:
    """Log-fbank → ortho DCT-II keep ``numcep`` → ceplifter (base.py:37-57).

    Returns ``(feat [T, numcep], energy [T])``.
    """
    opts = FeatureOpts.from_config(dict(conf))
    feat, energy = fbank(signal, samplerate, conf)
    feat = np.log(feat) @ dct_ortho_matrix(opts.nfilt, opts.numcep)
    feat = feat * lifter_vector(opts.numcep, opts.ceplifter)[None, :]
    return feat, energy


def ssc(signal, samplerate, conf) -> tuple[np.ndarray, np.ndarray]:
    """Spectral subband centroids (base.py:117-154)."""
    opts = FeatureOpts.from_config(dict(conf))
    pspec, energy = _power_and_energy(signal, samplerate, opts)
    highfreq = opts.highfreq if opts.highfreq >= 0 else samplerate / 2
    fb = mel_filterbank(opts.nfilt, opts.nfft, samplerate, opts.lowfreq, highfreq)
    feat = pspec @ fb.T  # unfloored divisor (base.py:150-154)
    nbins = opts.nfft // 2 + 1
    tiles = np.linspace(1, samplerate / 2, nbins)
    return (pspec * tiles) @ fb.T / feat, energy


def deriv(features: np.ndarray) -> np.ndarray:
    """First-order derivative filter ``[2,1,0,-1,-2]`` with reflect
    boundaries (base.py:249-259)."""
    return scipy.ndimage.convolve1d(
        np.asarray(features, dtype=np.float64), [2, 1, 0, -1, -2], axis=0
    )


def delta(features: np.ndarray) -> np.ndarray:
    """``concat(features, deriv(features))`` (base.py:261-271)."""
    features = np.asarray(features, dtype=np.float64)
    return np.concatenate([features, deriv(features)], axis=1)


def ddelta(features: np.ndarray) -> np.ndarray:
    """``concat(features, d1, d2)`` (base.py:273-284)."""
    features = np.asarray(features, dtype=np.float64)
    d1 = deriv(features)
    return np.concatenate([features, d1, deriv(d1)], axis=1)

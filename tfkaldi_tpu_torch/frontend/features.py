"""Batched acoustic feature extraction in native f64 on the device.

Port of :mod:`tfkaldi_tpu.frontend.features`. One call turns a padded batch
``signals[B, S]`` + ``lengths[B]`` into ``feats[B, T_max, D]`` float32 +
``num_frames[B]``:

1. ``snip_edges`` frame geometry on the host in f64 (:meth:`frame_geometry`)
2. preemphasis, end masking and framing in one kernel
   (:func:`tfkaldi_tpu_torch.ops.frame_preemph`, f64 frames)
3. real DFT as f64 products against cos/sin bases, ``|X|²/nfft``
4. frame energy with the ε floor; mel filterbank product with the ε floor
5. fbank → log / mfcc → log → DCT → lifter / ssc centroids
6. optional log-energy column, delta/ddelta with reflect boundaries
7. padding frames zeroed, cast to f32

Hopper has native f64, so the TPU package's double-float emulation of the
DFT and mel products is not carried over: every stage is plain f64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tfkaldi_tpu_torch.device import resolve_device
from tfkaldi_tpu_torch.frontend import mel
from tfkaldi_tpu_torch.ops.frame_preemph import frame_preemph

# np.finfo(float).eps — the reference's flooring constant (base.py:87,96)
_EPS = float(np.finfo(np.float64).eps)
# out[t] = 2f[t+2] + f[t+1] - f[t-1] - 2f[t-2]: weight for offset d = -2..2
_DERIV_TAPS = (-2.0, -1.0, 0.0, 1.0, 2.0)


@dataclasses.dataclass(frozen=True)
class FeatureOpts:
    """Feature configuration; field names/defaults mirror the reference
    ``[gmm-features]``/``[dnn-features]`` config sections
    (config/config_AURORA4.cfg:26-80)."""

    feature_type: str = "fbank"  # fbank | mfcc | ssc
    dynamic: str = "nodelta"  # nodelta | delta | ddelta
    winlen: float = 0.025
    winstep: float = 0.01
    nfilt: int = 23
    nfft: int = 512
    lowfreq: float = 0.0
    highfreq: float = -1.0
    preemph: float = 0.97
    include_energy: bool = False
    snip_edges: bool = True
    numcep: int = 13
    ceplifter: float = 22.0

    @classmethod
    def from_config(cls, conf: dict) -> "FeatureOpts":
        """Build from a reference-style string-valued config dict."""
        return cls(
            feature_type=conf.get("type", conf.get("feature_type", "fbank")),
            dynamic=conf.get("dynamic", "nodelta"),
            winlen=float(conf.get("winlen", 0.025)),
            winstep=float(conf.get("winstep", 0.01)),
            nfilt=int(conf.get("nfilt", 23)),
            nfft=int(conf.get("nfft", 512)),
            lowfreq=float(conf.get("lowfreq", 0)),
            highfreq=float(conf.get("highfreq", -1)),
            preemph=float(conf.get("preemph", 0.97)),
            include_energy=str(conf.get("include_energy", "False")) == "True",
            snip_edges=str(conf.get("snip_edges", "True")) == "True",
            numcep=int(conf.get("numcep", 13)),
            ceplifter=float(conf.get("ceplifter", 22)),
        )

    @property
    def base_dim(self) -> int:
        dim = self.numcep if self.feature_type == "mfcc" else self.nfilt
        return dim + (1 if self.include_energy else 0)

    @property
    def dim(self) -> int:
        """Final feature dimension including dynamics."""
        mult = {"nodelta": 1, "delta": 2, "ddelta": 3}[self.dynamic]
        return self.base_dim * mult


class FeatureExtractor:
    """Batched feature computer for a fixed sample rate on one device."""

    def __init__(self, opts: FeatureOpts, samplerate: int, device: str | torch.device = "cuda"):
        if opts.feature_type not in ("fbank", "mfcc", "ssc"):
            raise ValueError(f"unknown feature type {opts.feature_type!r}")
        if opts.dynamic not in ("nodelta", "delta", "ddelta"):
            raise ValueError(f"unknown dynamic type {opts.dynamic!r}")
        self.opts = opts
        self.rate = int(samplerate)
        self.device = resolve_device(device)
        self.frame_len = int(round(opts.winlen * self.rate))
        self.frame_step = int(round(opts.winstep * self.rate))
        highfreq = opts.highfreq if opts.highfreq >= 0 else self.rate / 2

        def f64(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=self.device)

        self._fbank_t = f64(mel.mel_filterbank(opts.nfilt, opts.nfft, self.rate, opts.lowfreq, highfreq).T)
        if opts.feature_type == "mfcc":
            self._dct = f64(mel.dct_ortho_matrix(opts.nfilt, opts.numcep))
            self._lift = f64(mel.lifter_vector(opts.numcep, opts.ceplifter))
        if opts.feature_type == "ssc":
            self._tiles = f64(np.linspace(1, self.rate / 2, opts.nfft // 2 + 1))
        # real-DFT bases over the un-padded window: zero-padding to nfft is
        # implicit in truncating the bases to wl rows, and (like numpy's
        # rfft(frame, n=nfft), sigproc.py:136) frames longer than nfft are
        # truncated to their first nfft samples, hence min() rows
        nbins = opts.nfft // 2 + 1
        self._dft_rows = min(self.frame_len, opts.nfft)
        n = np.arange(self._dft_rows, dtype=np.float64)[:, None]
        k = np.arange(nbins, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * n * k / opts.nfft
        self._dft_cos = f64(np.cos(ang))
        self._dft_sin = f64(-np.sin(ang))

    # frame geometry: host-side float64, replicating the reference's float
    # arithmetic exactly (``winlen*rate`` is a float in feat.py:86 and
    # sigproc.py:50-55; truncations and ceils must see the same values)

    def frame_geometry(self, lengths) -> tuple[np.ndarray, np.ndarray]:
        """Per-utterance ``(num_frames, effective_len)``: the snipped length
        (feat.py:86-88) when ``snip_edges``, else the full length, and the
        frame count framesig produces from it (sigproc.py:52-55)."""
        lengths = np.asarray(lengths, dtype=np.int64)
        wl_f = self.opts.winlen * self.rate
        ws_f = self.opts.winstep * self.rate
        if self.opts.snip_edges:
            nfull = ((lengths - wl_f) / ws_f).astype(np.int64)  # trunc toward 0
            eff = np.minimum(lengths, (nfull * ws_f + wl_f).astype(np.int64))
        else:
            eff = lengths
        num_frames = np.where(
            eff <= self.frame_len,
            1,
            1 + np.ceil((eff.astype(np.float64) - self.frame_len) / self.frame_step),
        ).astype(np.int32)
        return num_frames, eff.astype(np.int32)

    def max_frames(self, padded_len: int) -> int:
        """Frame capacity for signals padded to ``padded_len``."""
        return int(self.frame_geometry(np.asarray([padded_len]))[0][0])

    def __call__(self, signals, lengths) -> tuple[torch.Tensor, np.ndarray]:
        """``signals`` ``[B, S]`` (numpy or tensor; samples must be exactly
        representable in float32, as wav data is), ``lengths`` ``[B]`` →
        ``(feats [B, T_max, dim] float32 on the device, num_frames [B] int32
        numpy)``; padding frames are zero."""
        signals = torch.as_tensor(signals)
        if signals.ndim != 2:
            raise ValueError("signals must be [batch, samples]")
        num_frames, eff_len = self.frame_geometry(np.asarray(lengths))
        signals = signals.to(device=self.device, dtype=torch.float32, non_blocking=True)
        frames = frame_preemph(
            signals,
            torch.as_tensor(eff_len, device=self.device),
            preemph=self.opts.preemph,
            frame_step=self.frame_step,
            frame_len=self.frame_len,
            t_max=self.max_frames(signals.shape[1]),
        )
        nf = torch.as_tensor(num_frames, dtype=torch.int64, device=self.device)
        return self._frames_to_feats(frames, nf), num_frames

    def compute(self, signal) -> np.ndarray:
        """Single utterance → the trimmed ``[num_frames, dim]`` matrix."""
        signal = np.asarray(signal)
        feats, nframes = self(signal[None, :], np.asarray([signal.shape[0]]))
        return feats[0, : int(nframes[0])].cpu().numpy()

    def _frames_to_feats(self, frames, num_frames):
        """f64 frames ``[B, T, wl]`` → masked f32 features ``[B, T, dim]``."""
        return self._apply_dynamics(self._frames_to_static(frames, num_frames), num_frames)

    def _frames_to_static(self, frames, num_frames):
        """The per-frame part of :meth:`_frames_to_feats`: f64 frames → f64
        static features ``[B, T, base_dim]``, not yet masked or cast (what
        the streaming delta extractor buffers)."""
        opts = self.opts
        dft_in = frames[:, :, : self._dft_rows]  # rfft truncation semantics
        xr = torch.matmul(dft_in, self._dft_cos)
        xi = torch.matmul(dft_in, self._dft_sin)
        pspec = (xr * xr + xi * xi) * (1.0 / opts.nfft)

        energy = pspec.sum(-1)
        energy = torch.where(energy == 0, _EPS, energy)  # base.py:87
        log_energy = torch.log(energy)

        feat_raw = torch.matmul(pspec, self._fbank_t)
        if opts.feature_type == "fbank":
            feat = torch.log(torch.where(feat_raw == 0, _EPS, feat_raw))  # base.py:96,115
        elif opts.feature_type == "mfcc":
            logfeat = torch.log(torch.where(feat_raw == 0, _EPS, feat_raw))
            feat = torch.matmul(logfeat, self._dct) * self._lift
        else:  # ssc: divides by the unfloored filterbank energies (base.py:150-154)
            feat = torch.matmul(pspec * self._tiles, self._fbank_t) / feat_raw
        if opts.include_energy:
            feat = torch.cat([feat, log_energy[..., None]], dim=-1)
        return feat

    def _apply_dynamics(self, feat, num_frames):
        """The tail of :meth:`_frames_to_feats` on f64 static features: the
        reflected deltas over each row's ``num_frames``, then the mask and
        the f32 cast."""
        opts = self.opts
        if opts.dynamic != "nodelta":
            d1 = _reflect_deriv(feat, num_frames)
            if opts.dynamic == "delta":
                feat = torch.cat([feat, d1], dim=-1)
            else:
                feat = torch.cat([feat, d1, _reflect_deriv(d1, num_frames)], dim=-1)

        frame_ok = torch.arange(feat.shape[1], device=feat.device)[None, :] < num_frames[:, None]
        return feat.to(torch.float32).masked_fill(~frame_ok[..., None], 0.0)


def _reflect_deriv(feat, num_frames):
    """``scipy.ndimage.convolve1d(x, [2,1,0,-1,-2], axis=0)`` (mode 'reflect')
    per utterance over its valid frames (base.py:249-259):
    ``out[t] = 2x[t+2] + x[t+1] - x[t-1] - 2x[t-2]`` with indices mirrored at
    0 and ``n-1``."""
    b, t_max, d = feat.shape
    t = torch.arange(t_max, device=feat.device)[None, :]
    n = torch.clamp(num_frames, min=1)[:, None]
    out = torch.zeros_like(feat)
    for off, w in zip(range(-2, 3), _DERIV_TAPS):
        if w == 0.0:
            continue
        i = t + off
        i = torch.where(i < 0, -i - 1, i)
        i = torch.where(i >= n, 2 * n - 1 - i, i)
        # second pass for pathologically short utterances (n <= 2)
        i = torch.where(i < 0, -i - 1, i)
        i = torch.clamp(i, 0, t_max - 1)
        out = out + w * torch.gather(feat, 1, i[:, :, None].expand(b, t_max, d))
    return out

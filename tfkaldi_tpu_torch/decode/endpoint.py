"""Endpoint detection for the streaming decoders.

A copy of :mod:`tfkaldi_tpu.decode.endpoint` (host numpy; the port
imports nothing of the JAX package).

Kaldi's online2 endpointing semantics (``OnlineEndpointConfig``: a bank
of OR-ed rules, each "fire when the utterance has/hasn't produced speech,
trailing silence exceeds S seconds, and the utterance exceeds L seconds")
re-based on CTC streaming evidence: the reference pipeline has no online
story at all, and Kaldi's own rules read silence off the decoder
traceback — in a CTC system the *blank* plays exactly that role, so
silence here is "frames whose best label is blank" as reported by the
streaming decoders' per-frame argmax.

The rules that condition on lattice relative-cost in Kaldi are shipped
without that condition (we have no lattice); the default bank is the
cost-free subset:

- rule 1: no speech decoded yet and >= 5 s of trailing silence
- rule 2: speech was decoded and >= 1 s of trailing silence
- rule 3: the utterance is >= 20 s long regardless

``EndpointConfig.frame_shift`` is the duration of one *decoder output*
frame: the feature ``winstep`` (0.01 s) times the model's subsample
factor for subsampling front-ends.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class EndpointRule:
    """One endpointing rule; fires when ALL conditions hold."""

    must_contain_nonsilence: bool = True
    min_trailing_silence: float = 1.0  # seconds
    min_utterance_length: float = 0.0  # seconds


DEFAULT_RULES: tuple[EndpointRule, ...] = (
    EndpointRule(False, 5.0, 0.0),
    EndpointRule(True, 1.0, 0.0),
    EndpointRule(False, 0.0, 20.0),
)


@dataclasses.dataclass(frozen=True)
class EndpointConfig:
    rules: tuple[EndpointRule, ...] = DEFAULT_RULES
    frame_shift: float = 0.01  # seconds per decoder output frame


class Endpointer:
    """Tracks per-row blank/speech frame streams and latches endpoints.

    ``update`` consumes the per-frame best-label matrix a streaming CTC
    decoder produced for one chunk (``[B, T]`` with ``n_valid`` valid
    frames per row) and returns the latched per-row detection flags.
    Chunking-invariant: the state depends only on the concatenated label
    stream. A detected row stays detected until ``reset``.
    """

    def __init__(self, config: EndpointConfig, blank_id: int):
        self.config = config
        self.blank_id = int(blank_id)
        self._total = None  # frames seen per row
        self._trailing = None  # trailing blank frames per row
        self._seen_speech = None
        self._detected = None

    def reset(self, batch_size: int) -> None:
        self._total = np.zeros(batch_size, np.int64)
        self._trailing = np.zeros(batch_size, np.int64)
        self._seen_speech = np.zeros(batch_size, bool)
        self._detected = np.zeros(batch_size, bool)

    def update(self, frame_labels, n_valid) -> np.ndarray:
        """Advance with one chunk's per-frame labels; returns detections."""
        if self._total is None:
            raise RuntimeError("call reset(batch_size) before update()")
        labels = np.asarray(frame_labels)
        n_valid = np.asarray(n_valid, np.int64)
        for row in range(labels.shape[0]):
            n = int(n_valid[row])
            if n > 0:
                p = labels[row, :n]
                nonblank = np.flatnonzero(p != self.blank_id)
                if nonblank.size:
                    self._seen_speech[row] = True
                    self._trailing[row] = n - 1 - int(nonblank[-1])
                else:
                    self._trailing[row] += n
                self._total[row] += n
        shift = self.config.frame_shift
        for rule in self.config.rules:
            ok = np.ones_like(self._detected)
            if rule.must_contain_nonsilence:
                ok &= self._seen_speech
            ok &= self._trailing * shift >= rule.min_trailing_silence
            ok &= self._total * shift >= rule.min_utterance_length
            # a rule with no silence requirement must still see >0 frames
            ok &= self._total > 0
            self._detected |= ok
        return self.detected()

    def reset_rows(self, rows) -> None:
        """Re-arm a subset of rows for new utterances (the per-slot analog
        of ``reset``); other rows' counters are untouched."""
        if self._detected is None:
            raise RuntimeError("call reset(batch_size) before reset_rows()")
        idx = np.asarray(list(rows), np.int64)
        self._total[idx] = 0
        self._trailing[idx] = 0
        self._seen_speech[idx] = False
        self._detected[idx] = False

    def detected(self) -> np.ndarray:
        """Latched per-row endpoint flags (copy)."""
        if self._detected is None:
            raise RuntimeError("call reset(batch_size) before detected()")
        return self._detected.copy()

    def trailing_silence_seconds(self) -> np.ndarray:
        """Current trailing-silence duration per row, in seconds."""
        if self._trailing is None:
            raise RuntimeError("call reset(batch_size) before querying")
        return self._trailing * self.config.frame_shift

"""Word-level alignments from committed label streams.

A copy of :mod:`tfkaldi_tpu.decode.words` (host numpy; the port imports
nothing of the JAX package).

The character-level recipes (CTC / transducer / attention over the
TextCoder alphabet, data/target_coder.py) emit label streams whose
``<space>`` tokens delimit words. Given the per-label emission times and
confidences the greedy decoders commit (decode/online.py,
decode/transducer.py), this module groups them into word spans — the
word-timing surface Kaldi's online2 decoders expose, and one the
reference has no analog of (its decoder emits likelihood matrices only,
neuralNetworks/decoder.py:50-77).

Semantics:

- a word's ``start`` is its first label's emission time; ``end`` is its
  last label's emission time plus one decoder frame (CTC/transducer
  alignments are peaky — labels fire AT or slightly AFTER the sound, so
  these are emission-time spans, not tight acoustic segmentations);
- a word's ``confidence`` is the MINIMUM of its labels' confidences
  (the weakest link: one uncertain character makes the word uncertain —
  a product would conflate length with uncertainty);
- ``<sos>``/``<eos>`` markers are dropped; consecutive spaces or
  leading/trailing spaces produce no empty words.

Pure host-side list processing: runs per committed stream (a few labels
per chunk), never on the device path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: tokens that never contribute to a word (utterance markers)
_MARKERS = frozenset({"<sos>", "<eos>"})


@dataclass(frozen=True)
class WordAlignment:
    """One aligned word: text, emission-time span (seconds), confidence."""

    word: str
    start: float
    end: float
    confidence: float


def group_words(
    tokens: list[str],
    times: np.ndarray,
    confs: np.ndarray,
    frame_seconds: float,
    *,
    space_token: str = "<space>",
) -> list[WordAlignment]:
    """Group an aligned label stream into word spans.

    ``tokens``/``times``/``confs`` are parallel (one entry per committed
    label, as the streaming transcribers accumulate them); ``<space>``
    closes the current word, ``<sos>``/``<eos>`` are ignored, every
    other token (letters, punctuation, ``<unk>``) is part of a word.
    """
    if not len(tokens) == len(times) == len(confs):
        raise ValueError(
            f"misaligned streams: {len(tokens)} tokens, {len(times)} times, "
            f"{len(confs)} confidences"
        )
    words: list[WordAlignment] = []
    parts: list[str] = []
    start = 0.0
    end = 0.0
    conf = np.inf

    def close() -> None:
        nonlocal parts, conf
        if parts:
            words.append(
                WordAlignment("".join(parts), start, end, float(conf))
            )
        parts, conf = [], np.inf

    for token, t, c in zip(tokens, times, confs):
        if token == space_token:
            close()
        elif token not in _MARKERS:
            if not parts:
                start = float(t)
            end = float(t) + float(frame_seconds)
            conf = min(conf, float(c))
            parts.append(token)
    close()
    return words

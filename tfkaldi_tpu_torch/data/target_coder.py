"""Target coders: map target strings ↔ integer id sequences.

A copy of ``TargetCoder``, ``TextCoder`` and ``AlignmentCoder`` from
:mod:`tfkaldi_tpu.data.target_coder` (reference target_coder.py:8-142). A
coder owns a normalizer function and a fixed alphabet; ``encode``
normalizes then maps space-separated tokens to ids, ``decode`` reverses.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

Normalizer = Callable[[str, Sequence[str]], str]


class TargetCoder:
    """Base coder over an explicit alphabet (reference target_coder.py:8-77)."""

    def __init__(self, target_normalizer: Normalizer, alphabet: Sequence[str] | None = None):
        self.target_normalizer = target_normalizer
        self.alphabet = list(alphabet if alphabet is not None else self.create_alphabet())
        self.lookup = {token: index for index, token in enumerate(self.alphabet)}

    def create_alphabet(self) -> list[str]:
        raise NotImplementedError

    def encode(self, targets: str) -> np.ndarray:
        normalized = self.target_normalizer(targets, self.alphabet)
        return np.asarray(
            [self.lookup[token] for token in normalized.split(" ")], dtype=np.int32
        )

    def decode(self, encoded_targets) -> str:
        return " ".join(self.alphabet[int(i)] for i in encoded_targets)

    @property
    def num_labels(self) -> int:
        return len(self.lookup)


class TextCoder(TargetCoder):
    """Character coder with the reference's fixed alphabet
    (target_coder.py:79-118): ``<eos> <sos> <space> , . ' - ? <unk> a..z``."""

    def create_alphabet(self) -> list[str]:
        return ["<eos>", "<sos>", "<space>", ",", ".", "'", "-", "?", "<unk>"] + [
            chr(c) for c in range(ord("a"), ord("z") + 1)
        ]


class AlignmentCoder(TargetCoder):
    """Coder for pdf-id state alignments: alphabet is the stringified ids
    ``0..num_targets-1`` (target_coder.py:120-142)."""

    def __init__(self, target_normalizer: Normalizer, num_targets: int):
        self.num_targets = int(num_targets)
        super().__init__(target_normalizer)

    def create_alphabet(self) -> list[str]:
        return [str(t) for t in range(self.num_targets)]

    def encode(self, targets: str) -> np.ndarray:
        # fast path: alignment "tokens" are already the integer ids
        normalized = self.target_normalizer(targets, self.alphabet)
        ids = np.asarray([int(t) for t in normalized.split(" ")], dtype=np.int32)
        # the base class would KeyError on out-of-alphabet tokens; keep that
        # safety (a mismatched GMM's pdf-ids would otherwise silently train
        # against clamped labels)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_targets):
            raise ValueError(
                f"pdf-id outside [0, {self.num_targets}): "
                f"{int(ids.min())}..{int(ids.max())}"
            )
        return ids

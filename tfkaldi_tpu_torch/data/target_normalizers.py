"""Target normalizers of the hybrid recipe.

A copy of ``identity_normalizer`` from
:mod:`tfkaldi_tpu.data.target_normalizers` (reference
target_normalizers.py); the character normalizers of the text-target
recipes come with their slices (ROADMAP.md, queue 1, slices 4-6).
"""

from __future__ import annotations

from typing import Sequence


def identity_normalizer(transcription: str, alphabet: Sequence[str]) -> str:
    """Pass-through, used for pdf-id alignment targets (main.py:151)."""
    return transcription

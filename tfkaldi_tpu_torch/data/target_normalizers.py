"""Corpus-specific target normalizers (reference target_normalizers.py:5-58).

A copy of :mod:`tfkaldi_tpu.data.target_normalizers`: the identity
normalizer of the hybrid recipe and the Aurora-4 character normalizer of
the CTC recipe.
"""

from __future__ import annotations

from typing import Sequence

_AURORA4_REPLACEMENTS = {
    ",COMMA": "COMMA",
    '"DOUBLE-QUOTE': "DOUBLE-QUOTE",
    "!EXCLAMATION-POINT": "EXCLAMATION-POINT",
    "&AMPERSAND": "AMPERSAND",
    "'SINGLE-QUOTE": "SINGLE-QUOTE",
    "(LEFT-PAREN": "LEFT-PAREN",
    ")RIGHT-PAREN": "RIGHT-PAREN",
    "-DASH": "DASH",
    "-HYPHEN": "HYPHEN",
    "...ELLIPSIS": "ELLIPSIS",
    ".PERIOD": "PERIOD",
    "/SLASH": "SLASH",
    ":COLON": "COLON",
    ";SEMI-COLON": "SEMI-COLON",
    "<NOISE>": "",
    "?QUESTION-MARK": "QUESTION-MARK",
    "{LEFT-BRACE": "LEFT-BRACE",
    "}RIGHT-BRACE": "RIGHT-BRACE",
}


def identity_normalizer(transcription: str, alphabet: Sequence[str]) -> str:
    """Pass-through, used for pdf-id alignment targets (main.py:151)."""
    return transcription


def aurora4_normalizer(transcription: str, alphabet: Sequence[str]) -> str:
    """Aurora-4 character-level normalization (target_normalizers.py:5-58):
    punctuation-word replacements → lowercase → char split → <sos>/<eos>
    wrap → spaces→<space> → OOV→<unk>."""
    replaced = " ".join(
        _AURORA4_REPLACEMENTS.get(word, word) for word in transcription.split(" ")
    )
    normalized = ["<sos>"] + list(replaced.lower()) + ["<eos>"]
    normalized = [c if c != " " else "<space>" for c in normalized]
    alphabet_set = set(alphabet)
    normalized = [c if c in alphabet_set else "<unk>" for c in normalized]
    return " ".join(normalized)

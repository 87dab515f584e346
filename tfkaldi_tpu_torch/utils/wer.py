"""Word/character error rate scoring.

A copy of :mod:`tfkaldi_tpu.utils.wer`. The hybrid path's scoring is
Kaldi's (``local/score.sh``); this in-process scorer serves the CTC text
path: edit-distance error rates between a decoded Kaldi ``text`` file and
the reference transcriptions, over character tokens (CER) or, through
:func:`char_tokens_to_words`, over words (WER).
"""

from __future__ import annotations

import dataclasses


def edit_distance(ref: list[str], hyp: list[str]) -> tuple[int, int, int, int]:
    """Levenshtein alignment counts ``(substitutions, insertions,
    deletions, correct)`` between token sequences."""
    m, n = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, ins, dels) best alignment of ref[:i], hyp[:j]
    prev = [(j, 0, j, 0) for j in range(n + 1)]
    for i in range(1, m + 1):
        cur = [(i, 0, 0, i)]
        for j in range(1, n + 1):
            if ref[i - 1] == hyp[j - 1]:
                cand = [(prev[j - 1][0], *prev[j - 1][1:])]
            else:
                cand = [
                    (prev[j - 1][0] + 1, prev[j - 1][1] + 1, prev[j - 1][2], prev[j - 1][3])
                ]
            cand.append((cur[j - 1][0] + 1, cur[j - 1][1], cur[j - 1][2] + 1, cur[j - 1][3]))
            cand.append((prev[j][0] + 1, prev[j][1], prev[j][2], prev[j][3] + 1))
            cur.append(min(cand))
        prev = cur
    cost, subs, ins, dels = prev[n]
    return subs, ins, dels, m - subs - dels


@dataclasses.dataclass
class WerResult:
    substitutions: int = 0
    insertions: int = 0
    deletions: int = 0
    correct: int = 0
    ref_tokens: int = 0
    scored_utts: int = 0
    missing_utts: int = 0

    @property
    def errors(self) -> int:
        return self.substitutions + self.insertions + self.deletions

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.ref_tokens, 1)

    def __str__(self) -> str:  # Kaldi-style summary line
        return (
            f"%WER {self.wer:.2f} [ {self.errors} / {self.ref_tokens}, "
            f"{self.insertions} ins, {self.deletions} del, {self.substitutions} sub ]"
        )


def _read_text(path: str) -> dict[str, list[str]]:
    out: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def score_text_files(ref_path: str, hyp_path: str, transform=None) -> WerResult:
    """Token error rate between two Kaldi ``text`` files (any tokenization —
    words, or the TextCoder's character tokens for CER).

    ``transform``: optional per-utterance token-list mapper applied to both
    sides before alignment (e.g. :func:`char_tokens_to_words` to score
    word-level WER on character-CTC output)."""
    refs = _read_text(ref_path)
    hyps = _read_text(hyp_path)
    result = WerResult()
    for utt, ref in refs.items():
        hyp = hyps.get(utt)
        if transform is not None:
            ref = transform(ref)
        result.ref_tokens += len(ref)
        if hyp is None:
            result.missing_utts += 1
            result.deletions += len(ref)  # unscored utterance = all deleted
            continue
        if transform is not None:
            hyp = transform(hyp)
        s, i, d, c = edit_distance(ref, hyp)
        result.substitutions += s
        result.insertions += i
        result.deletions += d
        result.correct += c
        result.scored_utts += 1
    return result


def char_tokens_to_words(tokens: list[str]) -> list[str]:
    """Reassemble TextCoder character tokens (``<space>`` separated words,
    ``<sos>``/``<eos>`` markers, target_coder.py:79-118) into words so
    character-CTC output can be scored as word-level WER."""
    words: list[str] = []
    current: list[str] = []
    for tok in tokens:
        if tok in ("<sos>", "<eos>"):
            continue
        if tok == "<space>":
            if current:
                words.append("".join(current))
                current = []
        else:
            current.append(tok)
    if current:
        words.append("".join(current))
    return words

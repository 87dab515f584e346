"""CTC prefix beam search (Hannun et al. 2014-style) over log posteriors.

A copy of :mod:`tfkaldi_tpu.decode.ctc_beam`, with its LM-fusion ``scorer``
(:class:`tfkaldi_tpu_torch.decode.lm.FusionScorer`); :func:`nbest_prefixes`
is the first pass of attention rescoring
(:class:`tfkaldi_tpu_torch.decode.seq2seq.CTCRescoreDecoder`). The device
computes the frame log-posteriors of a whole batch in one call
(:mod:`tfkaldi_tpu_torch.decode.ctc`); the sequential prefix search runs on
the host, where its dynamic prefix set is cheap (V≈36 characters). The C++ copy (``csrc/ctc_beam.cpp`` via
:mod:`tfkaldi_tpu_torch.decode.native_beam`) is used when it builds; this
module is its Python twin and the fallback, and the only one that keeps the
label-time backtrace.
"""

from __future__ import annotations

import math

import numpy as np

_NEG_INF = -math.inf


def _logsumexp2(a: float, b: float) -> float:
    if a == _NEG_INF:
        return b
    if b == _NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log1p(math.exp(-abs(a - b)))


def initial_beams() -> dict[tuple, list[float]]:
    """The beam state before any frame: the empty prefix, blank-ended
    with probability 1."""
    return {(): [0.0, _NEG_INF]}


def initial_alignments() -> dict[tuple, tuple]:
    """The label-time backtrace companion of ``initial_beams``: prefix →
    per-label ``(frame_index, posterior)`` pairs. The empty prefix has an
    empty alignment."""
    return {(): ()}


def beam_step(
    beams: dict[tuple, list[float]],
    frame: np.ndarray,
    blank_id: int,
    beam_width: int,
    scorer=None,
    align: dict[tuple, tuple] | None = None,
    frame_index: int = 0,
) -> dict[tuple, list[float]]:
    """Advance the prefix-beam state by ONE frame of log-posteriors.

    ``beams`` maps prefix tuples to ``[log P(ends in blank), log P(ends in
    non-blank)]``; this is the search's only state.

    ``scorer`` enables shallow fusion: ``scorer(prefix, new_id)`` returns
    the additive log-score (``alpha·ln P_lm + beta``) paid each time a new
    label extends a prefix (repeat-collapses and blanks emit nothing, so
    they pay nothing: the fusion points of Hannun et al. 2014).

    ``align`` (with the current global ``frame_index``) maintains the
    label-time backtrace: a dict (from ``initial_alignments``) mapping
    each live prefix to one ``(frame_index, posterior)`` pair per label —
    the frame at which the surviving hypothesis appended that label, and
    the label's softmax posterior at that frame (the same emission-frame
    semantics the greedy decoder commits). It is updated IN PLACE to
    cover exactly the returned beam set: a prefix carried over keeps its
    alignment; a prefix newly created this frame extends its parent's by
    this frame.
    """
    # prune the vocabulary to labels that could matter this frame
    order = np.argsort(frame)[::-1]
    cand = order[: max(beam_width, 8)]
    nxt: dict[tuple, list[float]] = {}

    def acc(prefix, idx, val):
        slot = nxt.get(prefix)
        if slot is None:
            slot = [_NEG_INF, _NEG_INF]
            nxt[prefix] = slot
        slot[idx] = _logsumexp2(slot[idx], val)

    for prefix, (p_b, p_nb) in beams.items():
        p_tot = _logsumexp2(p_b, p_nb)
        last = prefix[-1] if prefix else None
        for v in cand:
            p = float(frame[v])
            if v == blank_id:
                acc(prefix, 0, p_tot + p)
            elif v == last:
                # repeat without separator extends the SAME prefix...
                acc(prefix, 1, p_nb + p)
                # ...and extends it only from the blank-ended mass
                bonus = scorer(prefix, int(v)) if scorer is not None else 0.0
                acc(prefix + (v,), 1, p_b + p + bonus)
            else:
                bonus = scorer(prefix, int(v)) if scorer is not None else 0.0
                acc(prefix + (v,), 1, p_tot + p + bonus)
    pruned = dict(
        sorted(
            nxt.items(),
            key=lambda kv: _logsumexp2(kv[1][0], kv[1][1]),
            reverse=True,
        )[:beam_width]
    )
    if align is not None:
        new_align = {}
        for prefix in pruned:
            got = align.get(prefix)
            if got is None:
                # created this frame from its (unique) parent, which was
                # in the previous beam set and therefore in ``align``
                got = align[prefix[:-1]] + (
                    (frame_index, math.exp(float(frame[prefix[-1]]))),
                )
            new_align[prefix] = got
        align.clear()
        align.update(new_align)
    return pruned


def best_prefix(beams: dict[tuple, list[float]]) -> np.ndarray:
    """Highest-marginal prefix in a beam state, as int32 label ids."""
    best = max(beams.items(), key=lambda kv: _logsumexp2(kv[1][0], kv[1][1]))[0]
    return np.asarray(best, dtype=np.int32)


def nbest_prefixes(beams: dict[tuple, list[float]], n: int) -> list[tuple[tuple, float]]:
    """Top-``n`` prefixes of a beam state with their total (blank +
    non-blank) log-probabilities, best first."""
    ranked = sorted(((p, _logsumexp2(v[0], v[1])) for p, v in beams.items()), key=lambda kv: -kv[1])
    return ranked[:n]


def alignment_of(
    align: dict[tuple, tuple], prefix: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Look up a prefix's label-time backtrace in an alignment dict:
    ``(frames int64, posteriors float64)``, one entry per label."""
    pairs = align[tuple(int(i) for i in prefix)]
    return (
        np.asarray([p[0] for p in pairs], np.int64),
        np.asarray([p[1] for p in pairs], np.float64),
    )


def ctc_beam_search_py(
    log_probs: np.ndarray, blank_id: int, beam_width: int = 16, scorer=None, return_alignment: bool = False,
):
    """Most probable label sequence under the CTC marginal, shallow-fused
    with a language model when ``scorer`` is given (see :func:`beam_step`).

    Args:
        log_probs: ``[T, V]`` frame log-posteriors (already length-trimmed).
        blank_id: blank class index.
        beam_width: number of prefixes kept per frame.
        scorer: optional ``(prefix, new_id) -> additive log-score``.
        return_alignment: also return the best hypothesis' label-time
            backtrace (see ``beam_step``'s ``align``).

    Returns:
        1-D int32 array of label ids (collapsed; no blanks); with
        ``return_alignment``, the triple ``(ids, frames, posteriors)``.
    """
    log_probs = np.asarray(log_probs, dtype=np.float64)
    beams = initial_beams()
    align = initial_alignments() if return_alignment else None
    for t in range(log_probs.shape[0]):
        beams = beam_step(beams, log_probs[t], blank_id, beam_width, scorer, align=align, frame_index=t)
    best = best_prefix(beams)
    if return_alignment:
        frames, confs = alignment_of(align, best)
        return best, frames, confs
    return best

"""Backoff n-gram language models for shallow fusion in the text beams.

A copy of :mod:`tfkaldi_tpu.decode.lm` (``ArpaLM``, ``FusionScorer``,
``DenseFusionTable``, ``fusion_from_config``; host code, numpy and the
standard library), with ``lm_extension_scores`` on torch tensors. An ARPA
backoff n-gram (use the highest-order hit, else back off with the recorded
penalty) over the target coder's tokens is fused into a beam with the
shallow-fusion score ``log P_am + alpha·log P_lm + beta`` per emitted label
(Hannun et al. 2014):

- the CTC prefix beam (:mod:`~tfkaldi_tpu_torch.decode.ctc_beam`, on the
  host) asks :class:`FusionScorer` for each prefix extension;
- the transducer and attention beams run on the device, where the whole LM
  is the function ``(last n-1 labels) → V scores``: :class:`DenseFusionTable`
  resolves it into a ``[(V+1)^(n-1), C]`` f32 table on the host (the same
  loops as the JAX package, so the same bits), a decoder places it on its
  device once, and :func:`lm_extension_scores` reads an extension's LM term
  with ``n-1`` gathers and one row gather.
"""

from __future__ import annotations

import gzip
import math
import re

import numpy as np
import torch


class ArpaLM:
    """Backoff n-gram LM read from an ARPA file (plain or ``.gz``).

    Tokens are looked up as strings (the words of the ARPA file);
    ``score(context, word)`` returns the natural-log conditional probability
    with standard backoff::

        P(w | h) = P*(w | h)                       if (h, w) listed
                 = backoff(h) · P(w | h[1:])       otherwise

    ARPA files store log10; converted to natural log on load.
    """

    _LN10 = math.log(10.0)

    def __init__(self, order: int, ngrams: dict, backoffs: dict):
        self.order = order
        self._ngrams = ngrams  # tuple(words) -> ln P*
        self._backoffs = backoffs  # tuple(words) -> ln backoff weight

    @classmethod
    def load(cls, path: str) -> "ArpaLM":
        opener = gzip.open if path.endswith(".gz") else open
        ngrams: dict[tuple, float] = {}
        backoffs: dict[tuple, float] = {}
        order = 0
        section = 0  # the n-gram order being read; 0 = header
        with opener(path, "rt", encoding="utf-8", errors="replace") as fid:
            for line in fid:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\"):
                    m = re.match(r"\\(\d+)-grams:", line)
                    section = int(m.group(1)) if m else 0
                    continue
                if section == 0:
                    continue  # header (ngram N=...), \data\, \end\
                parts = line.split()  # logp word1..wordN [backoff]
                if len(parts) < section + 1:
                    raise ValueError(f"malformed {section}-gram line: {line!r}")
                words = tuple(parts[1:1 + section])
                ngrams[words] = float(parts[0]) * cls._LN10
                if len(parts) > section + 1:
                    backoffs[words] = float(parts[1 + section]) * cls._LN10
                order = max(order, section)
        if order == 0:
            raise ValueError(f"no n-gram sections found in {path!r}")
        return cls(order, ngrams, backoffs)

    def score(self, context: tuple, word: str) -> float:
        """ln P(word | context); ``context`` is a tuple of preceding words
        (of any length: only the last ``order-1`` are used)."""
        context = tuple(context)[-(self.order - 1):] if self.order > 1 else ()
        while True:
            p = self._ngrams.get(context + (word,))
            if p is not None:
                return p
            if not context:
                # an unknown word takes the <unk> entry, else a hard floor
                unk = self._ngrams.get(("<unk>",))
                return unk if unk is not None else -20.0 * self._LN10
            # back off: drop the oldest context word, paying its penalty if
            # the context itself is listed (0 otherwise, per ARPA)
            penalty = self._backoffs.get(context, 0.0)
            context = context[1:]
            if penalty:
                return penalty + self.score(context, word)


class FusionScorer:
    """Shallow-fusion scorer over label ids for the CTC prefix beam.

    Maps label ids to LM tokens through ``id_to_token`` once, then scores a
    prefix extension as ``alpha · ln P_lm(token | prefix tokens) + beta``
    (``beta`` is the insertion bonus per emitted label). A label the LM has
    never seen takes the backoff / ``<unk>`` path: the LM vetoes none.
    """

    def __init__(self, lm: ArpaLM, id_to_token: list, alpha: float = 0.5, beta: float = 0.0,
                 bos: str | None = "<s>"):
        self.lm = lm
        self.id_to_token = list(id_to_token)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.bos = bos
        self._cache: dict[tuple, float] = {}

    def __call__(self, prefix: tuple, new_id: int) -> float:
        # only the last order-1 labels matter: cache on that suffix
        key = tuple(prefix[-(self.lm.order - 1):]) + (new_id,)
        # a short prefix's true context includes BOS: key it apart
        if self.bos is not None and len(prefix) < self.lm.order - 1:
            key = ("<BOS>",) + key
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        context = tuple(self.id_to_token[i] for i in prefix)
        if self.bos is not None:
            context = (self.bos,) + context
        val = self.alpha * self.lm.score(context, self.id_to_token[new_id]) + self.beta
        if len(self._cache) > 1 << 20:
            self._cache.clear()
        self._cache[key] = val
        return val


class DenseFusionTable:
    """The backoff LM resolved into a dense table for the device beams
    (transducer, attention).

    For a label-level n-gram over V labels the whole LM is the function
    ``(last n-1 labels) → scores``: ``table[ctx, c] = alpha · ln P(column_c |
    ctx) + beta`` for every context, ``(V+1)^(n-1)`` rows of ``C`` f32 (about
    231 KB for a character trigram). Context slots hold label ids ``0..V-1``
    or ``V`` (= BOS, which also fills the positions before a short prefix,
    as :class:`FusionScorer`'s ``(<s>,) + prefix``). ``column_tokens`` names
    the columns: usually the coder's alphabet; the attention decoder appends
    ``"</s>"`` so its EOS column carries the LM's end-of-sentence term.
    """

    def __init__(self, lm: ArpaLM, context_tokens: list, column_tokens: list, alpha: float = 0.5,
                 beta: float = 0.0, bos: str = "<s>"):
        self.order = lm.order
        self.num_context_ids = len(context_tokens) + 1  # + BOS
        self.bos_id = len(context_tokens)
        n_ctx = max(lm.order - 1, 0)
        rows = self.num_context_ids ** n_ctx
        if rows * len(column_tokens) > 1 << 27:
            raise ValueError(f"dense fusion table would hold {rows * len(column_tokens)} entries; lower the LM "
                             "order or vocabulary")
        table = np.zeros((rows, len(column_tokens)), np.float32)
        for row in range(rows):
            # the row's context ids, base num_context_ids, oldest first
            ids, r = [], row
            for _ in range(n_ctx):
                ids.append(r % self.num_context_ids)
                r //= self.num_context_ids
            ids = ids[::-1]
            # BOS fills leading slots; a BOS after a real label never arises
            # in a prefix, but it is scored consistently all the same
            context = tuple(bos if i == self.bos_id else context_tokens[i] for i in ids)
            # a leading run of BOS collapses to the single <s> of the host scorer
            while len(context) > 1 and context[0] == bos and context[1] == bos:
                context = context[1:]
            for col, tok in enumerate(column_tokens):
                table[row, col] = alpha * lm.score(context, tok) + beta
        self.table = table  # np [rows, C]; a decoder copies it to its device once

    def flat_context(self, last_ids):
        """``last_ids [..., n-1]`` (oldest first, BOS = ``bos_id``) → the
        flat row index into ``table`` (numpy arrays or tensors)."""
        idx = 0
        for i in range(max(self.order - 1, 0)):
            idx = idx * self.num_context_ids + last_ids[..., i]
        return idx


def _lm_from_config(conf, beam_width):
    """``(ArpaLM, alpha, beta)`` from the ``[nnet]`` keys ``lm_path``,
    ``lm_alpha`` and ``lm_beta``; ``None`` without ``lm_path``. Raises
    ``ValueError`` when ``lm_path`` comes with a beam of width <= 1
    (``beam_width``, default ``[nnet] beam_width``)."""
    lm_path = conf.get("lm_path", "")
    if not lm_path:
        return None
    if beam_width is None:
        beam_width = int(conf.get("beam_width", 1))
    if beam_width <= 1:
        raise ValueError("lm_path needs beam_width > 1 in [nnet]")
    return ArpaLM.load(lm_path), float(conf.get("lm_alpha", 0.5)), float(conf.get("lm_beta", 0.0))


def fusion_from_config(conf, coder, column_tokens, beam_width=None):
    """A :class:`DenseFusionTable` from the ``[nnet]`` keys ``lm_path``,
    ``lm_alpha`` and ``lm_beta``; ``None`` without ``lm_path``. Raises
    ``ValueError`` when ``lm_path`` comes with a beam of width <= 1
    (``beam_width``, default ``[nnet] beam_width``)."""
    lm = _lm_from_config(conf, beam_width)
    if lm is None:
        return None
    arpa, alpha, beta = lm
    return DenseFusionTable(arpa, list(coder.alphabet), column_tokens, alpha=alpha, beta=beta)


def ctc_scorer_from_config(conf, coder, beam_width=None):
    """The CTC prefix beam's :class:`FusionScorer` from the same keys, over
    ``alphabet + ["<blank>"]`` (the blank is an extra non-text class past
    the alphabet); ``None`` without ``lm_path``; raises as
    :func:`fusion_from_config` does."""
    lm = _lm_from_config(conf, beam_width)
    if lm is None:
        return None
    arpa, alpha, beta = lm
    return FusionScorer(arpa, list(coder.alphabet) + ["<blank>"], alpha=alpha, beta=beta)


def lm_extension_scores(fusion: DenseFusionTable, table_dev: torch.Tensor, buf: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
    """The LM term of extending each hypothesis: ``buf [..., L]`` emitted
    label ids (int64), ``counts [...]`` → ``[..., C]``, one fused score per
    table column. The context is the last ``order-1`` emitted labels,
    BOS-filled for short prefixes: ``n-1`` gathers and one row gather."""
    n_ctx = max(fusion.order - 1, 0)
    if n_ctx == 0:
        return table_dev[0].expand(*counts.shape, table_dev.shape[1])
    flat = None
    for back in range(n_ctx, 0, -1):  # the oldest context slot first
        pos = counts - back
        tok = torch.gather(buf, -1, pos.clamp(min=0)[..., None])[..., 0]
        tok = torch.where(pos >= 0, tok, fusion.bos_id)
        flat = tok if flat is None else flat * fusion.num_context_ids + tok
    return table_dev[flat]

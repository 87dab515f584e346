"""Attention seq2seq text decode: the autoregressive beam and attention
rescoring.

Port of :mod:`tfkaldi_tpu.decode.seq2seq` (``Seq2SeqBeamDecoder``,
decode/seq2seq.py:43-268, and ``CTCRescoreDecoder``, :270-435).

:class:`Seq2SeqBeamDecoder` (``decode_mode = beam``) is a step-synchronous
batched beam: at step s every live hypothesis has emitted s labels, so the
``[B, K]`` beam advances in lockstep through the model's KV-cached step
(:meth:`~tfkaldi_tpu_torch.models.seq2seq.AttentionSeq2Seq.
decode_step_cached`) and scores a ``[B, K, V+1]`` candidate matrix (column 0
a finished hypothesis holding, 1..V extending by a label; emitting EOS
finishes a hypothesis without storing a token). The top ``K`` of the
``K·(V+1)`` candidates come from a stable descending sort, so equal scores
keep the lower index first, as ``lax.top_k`` breaks ties (every dead beam's
``_NEG + logp`` rounds to ``_NEG``). The caches are regathered by parent
beam on every step; label buffers are written with the JAX package's
masked compares. JAX's ``while_loop`` is a Python loop on the device
(``begin``, then ``candidates``, ``select`` and ``advance`` while ``live``,
then ``close``; a caller may drive the steps itself, e.g. to replay one
device's choices on another) whose exit test (any hypothesis alive and
unfinished, and fewer than ``max_tokens`` steps) is one host read a step;
hypotheses still open after it take a forced EOS close, which pays the
fused ``</s>`` term. Ranking applies the GNMT ``((5+len)/6)^α`` length
penalty when ``length_penalty > 0``. An optional
:class:`~tfkaldi_tpu_torch.decode.lm.DenseFusionTable` over ``alphabet +
["</s>"]`` adds the LM term to every extension, EOS included.
:attr:`Seq2SeqBeamDecoder.seconds` accumulates the host-clock time of the
encoder and ``cross_kv``, of the step loop and of the forced close;
:attr:`Seq2SeqBeamDecoder.steps` counts the loop's steps.

:class:`CTCRescoreDecoder` (``decode_mode = rescoring``), per padded batch
of the test set (:func:`~tfkaldi_tpu_torch.decode.streaming.pick_stream`):

- pass 1: the encoder and the CTC head's ``log_softmax`` on the device,
  one D2H copy of the log-posteriors, then the Python prefix beam
  (:mod:`~tfkaldi_tpu_torch.decode.ctc_beam`) on the host keeps each
  utterance's ``beam_width`` best prefixes and their CTC log-probabilities
  (:func:`~tfkaldi_tpu_torch.decode.ctc_beam.nbest_prefixes`);
- pass 2: one teacher-forced decoder forward over all ``B·N`` hypotheses
  (the token axis padded to a multiple of 8), each scored by the sum of its
  labels' and its EOS's log-probabilities;
- the rerank: ``w·logP_ctc + (1−w)·logP_att``, unfilled slots left at
  ``-inf`` whatever the weights.

:attr:`CTCRescoreDecoder.seconds` accumulates the host-clock time of pass 1
(to the log-posteriors on the host), the beam and pass 2 (to the scores on
the host); :data:`rescored` counts the batches and the hypotheses pass 2
scored since the last reset.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.decode.ctc_beam import beam_step, initial_beams, nbest_prefixes
from tfkaldi_tpu_torch.decode.lm import lm_extension_scores
from tfkaldi_tpu_torch.decode.streaming import pick_stream

_NEG = -1e30  # score of dead hypotheses and illegal candidates

# batches and hypotheses scored by pass 2 since the last reset
rescored = {"batches": 0, "hypotheses": 0}


@dataclasses.dataclass
class _Beam:
    """A batch's beam between steps (tensors on the decoder's device):
    the memory's cross-attention K/V and valid frames per hypothesis, the
    self-attention caches, the token fed next, the label buffers, their
    counts, the scores and the finished flags, and the steps taken."""

    cross_k: torch.Tensor  # [blocks, B·K, T', D]
    cross_v: torch.Tensor
    mem_valid: torch.Tensor  # [B·K, T']
    cache: dict  # k, v: [blocks, B·K, L+1, D] f32
    tok: torch.Tensor  # [B·K]
    buf: torch.Tensor  # [B, K, L]
    counts: torch.Tensor  # [B, K]
    scores: torch.Tensor  # [B, K]
    finished: torch.Tensor  # [B, K]
    step: int = 0


def _write_text(decoder, reader: FeatureReader, outfile: str, batch_size: int, bucket_multiple: int) -> int:
    """Stream the test set through ``decoder.decode_batch`` and write a Kaldi
    ``text`` file (``utt_id transcription`` per line). Returns #utterances."""
    count = 0
    with open(outfile, "w") as fid:
        for utt_ids, inputs, lengths in pick_stream(reader)(reader, batch_size=batch_size,
                                                            bucket_multiple=bucket_multiple):
            for utt_id, ids in zip(utt_ids, decoder.decode_batch(inputs, lengths)):
                fid.write(f"{utt_id} {decoder.coder.decode(ids)}\n")
                count += 1
    return count


class Seq2SeqBeamDecoder:
    """Batched autoregressive beam of an :class:`~tfkaldi_tpu_torch.models.
    seq2seq.AttentionSeq2Seq` on its device: ``beam_width`` hypotheses per
    utterance, at most ``max_tokens`` labels each; ``length_penalty`` α > 0
    ranks by ``score / ((5 + len) / 6)^α`` (GNMT), 0 by the raw scores (so
    beam 1 is greedy); ``fusion_table`` (a
    :class:`~tfkaldi_tpu_torch.decode.lm.DenseFusionTable` with one column
    per emittable id, EOS included) adds shallow fusion."""

    def __init__(self, model, coder, *, beam_width: int = 4, max_tokens: int = 100, length_penalty: float = 0.0,
                 fusion_table=None):
        if beam_width < 1:
            raise ValueError("beam_width must be >= 1")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.coder = coder
        self.beam = int(beam_width)
        self.max_tokens = int(max_tokens)
        self.length_penalty = float(length_penalty)
        if fusion_table is not None and fusion_table.table.shape[1] != model.vocab_size:
            raise ValueError(f"attention fusion table needs one column per emittable id incl. EOS: got "
                             f"{fusion_table.table.shape[1]}, want {model.vocab_size} (build with column_tokens = "
                             "alphabet + ['</s>'])")
        self.fusion = fusion_table
        self._lm_table = None if fusion_table is None else torch.as_tensor(fusion_table.table).to(self.device)
        self.seconds = {"encoder": 0.0, "steps": 0.0, "close": 0.0}
        self.steps = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _lm(self, logp, buf, counts):
        return logp if self.fusion is None else logp + lm_extension_scores(self.fusion, self._lm_table, buf, counts)

    def begin(self, inputs, lengths) -> _Beam:
        """Encode a padded batch and set up its beam: every hypothesis empty,
        only beam 0 alive, SOS fed at position 0."""
        model, k, L, dev = self.model, self.beam, self.max_tokens, self.device
        inputs = torch.as_tensor(inputs, dtype=torch.float32).to(dev, non_blocking=True)
        lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int32)
        memory = model.encode(inputs, lengths)  # [B, T', D]
        b, t, d = memory.shape
        # cross-attention K/V once from the memory, beams on the batch axis: [blocks, B·K, T', D]
        cross_k, cross_v = model.cross_kv(memory)
        nb = cross_k.shape[0]
        scores = torch.full((b, k), _NEG, device=dev)
        scores[:, 0] = 0.0
        return _Beam(
            cross_k=cross_k[:, :, None].expand(nb, b, k, t, d).reshape(nb, b * k, t, d),
            cross_v=cross_v[:, :, None].expand(nb, b, k, t, d).reshape(nb, b * k, t, d),
            mem_valid=model.memory_valid(memory, lengths)[:, None].expand(b, k, t).reshape(b * k, t),
            cache=model.init_decode_cache(b * k, L, dev),
            tok=torch.full((b * k,), model.sos_eos_id, dtype=torch.long, device=dev),
            buf=torch.zeros(b, k, L, dtype=torch.long, device=dev),
            counts=torch.zeros(b, k, dtype=torch.long, device=dev),
            scores=scores,
            finished=torch.zeros(b, k, dtype=torch.bool, device=dev),
        )

    def live(self, st: _Beam) -> bool:
        """JAX's ``while_loop`` cond, one host read: a step is taken while
        some hypothesis is alive (not pruned to ``_NEG``) and unfinished, and
        fewer than ``max_tokens`` steps were taken."""
        return st.step < self.max_tokens and bool(((st.scores > _NEG / 2) & ~st.finished).any())

    def candidates(self, st: _Beam) -> torch.Tensor:
        """One cached decoder step: the ``[B, K·(V+1)]`` candidate scores
        (per beam, column 0 a finished hypothesis holding, 1+v extending by v,
        with the LM term when fused; at the buffer cap only EOS). Writes the
        fed token's K/V into the cache."""
        b, k = st.scores.shape
        v_total, eos = self.model.vocab_size, self.model.sos_eos_id
        logits, st.cache = self.model.decode_step_cached(st.tok, st.step, st.cache, st.cross_k, st.cross_v,
                                                         st.mem_valid)
        logp = self._lm(torch.log_softmax(logits, dim=-1).reshape(b, k, v_total), st.buf, st.counts)
        hold = torch.where(st.finished, st.scores, _NEG)
        extend = torch.where(st.finished[:, :, None], _NEG, st.scores[:, :, None] + logp)
        is_eos = torch.arange(v_total, device=logp.device)[None, None, :] == eos
        extend = torch.where(is_eos | (st.counts < self.max_tokens)[:, :, None], extend, _NEG)
        return torch.cat([hold[:, :, None], extend], dim=2).reshape(b, k * (v_total + 1))

    def select(self, cand: torch.Tensor) -> torch.Tensor:
        """The flat indices ``[B, K]`` of the top ``K`` candidates: a stable
        descending sort, so equal scores keep the lower index first, as
        ``lax.top_k``."""
        return torch.sort(cand, dim=1, descending=True, stable=True)[1][:, :self.beam]

    def advance(self, st: _Beam, cand: torch.Tensor, flat: torch.Tensor) -> None:
        """Commit the chosen candidates ``flat [B, K]``: regather the beams
        by parent, append the emitted labels, mark EOS finished, and feed the
        labels at the next position."""
        b, k = flat.shape
        L, v1 = self.max_tokens, self.model.vocab_size + 1
        parent = torch.div(flat, v1, rounding_mode="floor")
        choice = flat % v1  # 0 = hold, 1+v = emit v
        label = (choice - 1).clamp(min=0)
        emits_eos = choice == 1 + self.model.sos_eos_id
        extends = (choice > 0) & ~emits_eos
        buf = torch.gather(st.buf, 1, parent[:, :, None].expand(b, k, L))
        counts = torch.gather(st.counts, 1, parent)
        st.finished = torch.gather(st.finished, 1, parent) | emits_eos
        # the masked compare write; rows that do not extend point past the buffer
        slot = torch.arange(L, device=flat.device)[None, None, :] == torch.where(extends, counts, L)[:, :, None]
        st.buf = torch.where(slot, label[:, :, None], buf)
        st.counts = counts + extends.long()
        # beams reorder: regather the caches by parent ([blocks, B, K, L+1, D] on the B·K axis)
        order = (torch.arange(b, device=flat.device)[:, None] * k + parent).reshape(-1)
        st.cache = {key: val.index_select(1, order) for key, val in st.cache.items()}
        st.tok = label.reshape(b * k)  # the token fed at the next position
        st.scores = torch.gather(cand, 1, flat)
        st.step += 1

    def close(self, st: _Beam):
        """Close the open hypotheses with their EOS log-probability (and the
        fused ``</s>`` term), so every score is a whole sequence's: ``(buf
        [B, K, L], counts, scores, ranked [B, K])``, ``ranked`` with the
        length penalty."""
        b, k = st.scores.shape
        logits, _ = self.model.decode_step_cached(st.tok, st.step, st.cache, st.cross_k, st.cross_v, st.mem_valid)
        logp = self._lm(torch.log_softmax(logits, dim=-1).reshape(b, k, -1), st.buf, st.counts)
        scores = torch.where(st.finished, st.scores, st.scores + logp[:, :, self.model.sos_eos_id])
        ranked = scores
        if self.length_penalty > 0.0:
            ranked = scores / ((5.0 + st.counts.float()) / 6.0) ** self.length_penalty
        return st.buf, st.counts, scores, ranked

    def search(self, inputs, lengths):
        """The beam over a padded batch: ``(buf [B, K, L], counts, scores,
        ranked [B, K])`` on the device (raw and length-penalised scores)."""
        with torch.inference_mode():
            t0 = time.perf_counter()
            st = self.begin(inputs, lengths)
            self._sync()
            t1 = time.perf_counter()
            while self.live(st):
                cand = self.candidates(st)
                self.advance(st, cand, self.select(cand))
            t2 = time.perf_counter()
            out = self.close(st)
            self._sync()
            t3 = time.perf_counter()
        for part, seconds in (("encoder", t1 - t0), ("steps", t2 - t1), ("close", t3 - t2)):
            self.seconds[part] += seconds
        self.steps += st.step
        return out

    def decode_batch_nbest(self, inputs, lengths) -> list[list[tuple[np.ndarray, float]]]:
        """Per row, the surviving hypotheses as ``(label_ids, log_score)``,
        best first by the length-penalised rank (raw scores reported)."""
        buf, counts, scores, ranked = (x.cpu().numpy() for x in self.search(inputs, lengths))
        out = []
        for bi in range(buf.shape[0]):
            order = np.argsort(-ranked[bi], kind="stable")
            out.append([(buf[bi, kk, :counts[bi, kk]].astype(np.int32), float(scores[bi, kk]))
                        for kk in order if scores[bi, kk] > _NEG / 2])
        return out

    def decode_batch(self, inputs, lengths) -> list[np.ndarray]:
        """``[B, T, F]`` padded features → best-hypothesis label ids."""
        return [h[0][0] for h in self.decode_batch_nbest(inputs, lengths)]

    def decode_to_file(self, reader: FeatureReader, outfile: str, *, batch_size: int = 16,
                       bucket_multiple: int = 128) -> int:
        """Stream the test set and write a Kaldi ``text`` file
        (``utt_id transcription`` per line). Returns #utterances."""
        return _write_text(self, reader, outfile, batch_size, bucket_multiple)


class CTCRescoreDecoder:
    """Two-pass decode of an :class:`~tfkaldi_tpu_torch.models.seq2seq.
    AttentionSeq2Seq` trained with ``ctc_weight > 0``, on its device.

    After each :meth:`decode_batch`, ``last_tokens [B, N, L+1]`` (SOS, the
    hypothesis, zero padding), ``last_hyp_lens [B, N]``,
    ``last_ctc_scores`` and ``last_att_scores [B, N]`` hold pass 2's
    inputs and both scores."""

    def __init__(self, model, coder, *, beam_width: int = 10, rescore_weight: float = 0.5,
                 max_tokens: int = 100):
        if model.config.ctc_weight <= 0.0:
            raise ValueError("attention rescoring needs a joint model (ctc_weight > 0)")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.coder = coder
        self.beam = int(beam_width)
        self.w = float(rescore_weight)
        self.max_tokens = int(max_tokens)
        self.seconds = {"pass1": 0.0, "beam": 0.0, "pass2": 0.0}
        self.last_tokens = self.last_hyp_lens = self.last_ctc_scores = self.last_att_scores = None

    def first_pass(self, inputs, lengths) -> tuple[torch.Tensor, torch.Tensor]:
        """``(memory [B, T', D], CTC log-posteriors [B, T', V])`` on the
        device."""
        inputs = torch.as_tensor(inputs, dtype=torch.float32).to(self.device, non_blocking=True)
        with torch.inference_mode():
            memory = self.model.encode(inputs, torch.as_tensor(lengths, dtype=torch.int32))
            return memory, torch.log_softmax(self.model.ctc_logits(memory), dim=-1)

    def attention_scores(self, memory, lengths, tokens: np.ndarray, hyp_lens: np.ndarray) -> np.ndarray:
        """Teacher-forced scores ``[B, N]`` (f32) of ``tokens [B, N, L+1]``
        (SOS first) with ``hyp_lens [B, N]`` labels each: the sum over
        positions ``0..len`` of the log-probability of the next label, and of
        EOS at ``len``, against each row's own ``memory``."""
        model = self.model
        b, n, l1 = tokens.shape
        device = memory.device
        tok = torch.as_tensor(tokens.reshape(b * n, l1)).to(device)
        lens = torch.as_tensor(hyp_lens.reshape(b * n)).to(device)
        pos = torch.arange(l1, device=device)[None, :]
        valid = pos <= lens[:, None]
        with torch.inference_mode():
            mem_valid = model.memory_valid(memory, lengths).repeat_interleave(n, dim=0)
            logits = model.decode_step_logits(tok, valid, memory.repeat_interleave(n, dim=0), mem_valid)
            logp = torch.log_softmax(logits, dim=-1)
            # the targets: the tokens shifted left, EOS at each hypothesis' length
            tgt = torch.cat([tok[:, 1:], torch.zeros_like(tok[:, :1])], dim=1)
            tgt = torch.where(pos == lens[:, None], model.sos_eos_id, tgt)
            lp = torch.gather(logp, 2, tgt[:, :, None].long())[..., 0]
            return torch.sum(lp * valid, dim=1).cpu().numpy().reshape(b, n)

    def decode_batch(self, inputs, lengths) -> list[np.ndarray]:
        """``[B, T, F]`` padded features → list of label-id arrays."""
        model, n_best = self.model, self.beam
        t0 = time.perf_counter()
        memory, logp = self.first_pass(inputs, lengths)
        ctc_logp = logp.cpu().numpy().astype(np.float64)
        enc_lens = np.asarray(model.output_lengths(np.asarray(lengths)))
        t1 = time.perf_counter()
        hyps = []
        for row in range(memory.shape[0]):
            beams = initial_beams()
            for t in range(int(enc_lens[row])):
                beams = beam_step(beams, ctc_logp[row, t], model.sos_eos_id, n_best)
            hyps.append(nbest_prefixes(beams, n_best))
        t2 = time.perf_counter()

        # every hypothesis in one batch; the token axis padded to a multiple of 8
        b = len(hyps)
        l_raw = max(1, min(self.max_tokens, max(len(h[0]) for row in hyps for h in row)))
        l_max = -(-l_raw // 8) * 8
        tokens = np.full((b, n_best, l_max + 1), model.sos_eos_id, np.int32)
        hyp_lens = np.zeros((b, n_best), np.int32)
        ctc_scores = np.full((b, n_best), -np.inf, np.float64)
        for row, row_hyps in enumerate(hyps):
            for k, (prefix, score) in enumerate(row_hyps):
                ids = list(prefix)[:l_max]
                tokens[row, k, 1:1 + len(ids)] = ids
                tokens[row, k, 1 + len(ids):] = 0
                hyp_lens[row, k] = len(ids)
                ctc_scores[row, k] = score
        att = self.attention_scores(memory, lengths, tokens, hyp_lens)
        t3 = time.perf_counter()
        rescored["batches"] += 1
        rescored["hypotheses"] += int(np.isfinite(ctc_scores).sum())
        for part, seconds in (("pass1", t1 - t0), ("beam", t2 - t1), ("pass2", t3 - t2)):
            self.seconds[part] += seconds

        # unfilled slots (rows with fewer than N prefixes) stay -inf
        final = np.where(np.isfinite(ctc_scores), self.w * ctc_scores + (1.0 - self.w) * att, -np.inf)
        self.last_tokens, self.last_hyp_lens = tokens, hyp_lens
        self.last_ctc_scores, self.last_att_scores = ctc_scores, att
        out = []
        for row in range(b):
            k = int(np.argmax(final[row]))
            out.append(tokens[row, k, 1:1 + int(hyp_lens[row, k])].astype(np.int32))
        return out

    def decode_to_file(self, reader: FeatureReader, outfile: str, *, batch_size: int = 16,
                       bucket_multiple: int = 128) -> int:
        """Stream the test set and write a Kaldi ``text`` file
        (``utt_id transcription`` per line). Returns #utterances."""
        return _write_text(self, reader, outfile, batch_size, bucket_multiple)

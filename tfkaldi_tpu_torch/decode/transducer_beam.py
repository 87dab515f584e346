"""Transducer (RNN-T) beam search, batched and offline.

Port of :mod:`tfkaldi_tpu.decode.transducer_beam` (``_merge_equal_prefixes``,
``_beam_scan``, ``TransducerBeamDecoder``): a
frame-synchronous beam of ``K`` hypotheses per utterance with bounded
per-frame expansions and exact prefix merging. Per encoder frame each beam
either finishes the frame (takes the blank) or extends by one label and
keeps expanding; after ``max_symbols_per_frame`` expansions every active
beam takes the blank. Beams that reach the same label prefix by different
paths merge their scores by ``logaddexp`` into the lowest-index copy.

The search is vectorized over ``[B, K]`` on the device and walks frames
and expansions in a Python loop (the JAX package jits it as one
``lax.scan``). The top ``K`` of the ``K·(V+1)`` candidates come from a
stable descending sort, so equal scores keep the lower index first, as
``lax.top_k`` breaks ties; exact ties are common (a retired beam's
``_NEG + logp`` rounds to ``_NEG``). Label buffers are written with the
JAX package's masked compares.

LM shallow fusion (``fusion_table``, a
:class:`~tfkaldi_tpu_torch.decode.lm.DenseFusionTable` over the coder's
alphabet, placed on the device once): every label extension gains the LM
term of its prefix, padded with 0 on the blank column (the blank is a
lattice move, not a label), and the recorded confidences stay the acoustic,
pre-fusion posteriors.

:class:`OnlineTransducerBeamDecoder` (decode/transducer_beam.py:380-585)
carries the whole beam state (encoder carry, projections, prediction
carries, label buffers and backtraces, counts, scores, frame counter)
between chunks: the search is causal, so the chunked beam equals
:class:`TransducerBeamDecoder` on the whole utterance at any chunking.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tfkaldi_tpu_torch.decode.lm import lm_extension_scores
from tfkaldi_tpu_torch.decode.online import host_arrays, row_mask
from tfkaldi_tpu_torch.decode.transducer import TransducerDecoder

_NEG = -1e30  # score of retired beams and illegal candidates


def _merge_equal_prefixes(scores, buf, counts, active=None):
    """Merge beams with identical label prefixes: the lowest-index copy
    absorbs the others' mass (logsumexp), the others drop to ``_NEG``.
    ``scores [B, K]``, ``buf [B, K, L]`` (zero past each count), ``counts
    [B, K]``; mid-frame, ``active`` status must match too."""
    k = buf.shape[1]
    ar = torch.arange(k, device=buf.device)
    alive = scores > _NEG / 2
    eq = ((buf[:, :, None, :] == buf[:, None, :, :]).all(dim=-1) & (counts[:, :, None] == counts[:, None, :])
          & alive[:, :, None] & alive[:, None, :])
    if active is not None:
        eq &= active[:, :, None] == active[:, None, :]
    canon = torch.argmax(eq.to(torch.int32), dim=1)  # the first True of each column
    owns = canon[:, None, :] == ar[None, :, None]  # [B, c, j]
    merged = torch.logsumexp(torch.where(owns, scores[:, None, :], _NEG), dim=2)
    is_canon = canon == ar[None, :]
    return torch.where(is_canon & alive, merged, torch.where(alive, _NEG, scores))


def _beam_scan(model, beam: int, max_symbols: int, enc, frame_valid, proj, carry, buf, counts, scores, buf_len,
               frame_buf, conf_buf, fcount, fusion=None, lm_table=None):
    """The frame-synchronous beam over ``enc [B, T, J]``: ``proj [B, K,
    J]``, carry leaves ``[B·K, H]``, ``buf``/``frame_buf``/``conf_buf [B, K,
    L]`` (labels, the global frame that emitted each and its posterior),
    ``counts``/``scores [B, K]``, ``fcount [B]`` valid frames so far;
    ``fusion`` / ``lm_table``: an optional dense fusion LM and its table on
    the device. Returns the advanced ``(proj, carry, buf, frame_buf, conf_buf, counts,
    scores, fcount)``."""
    b, t, j = enc.shape
    k, v_total, blank = beam, model.vocab_size, model.blank_id
    device = enc.device
    slots = torch.arange(buf_len, device=device)[None, None, :]
    label_ok = torch.arange(v_total, device=device)[None, None, :] != blank

    def take(x, parent):  # re-gather [B, K, ...] by parent beam
        return torch.gather(x, 1, parent.reshape(b, k, *([1] * (x.ndim - 2))).expand(b, k, *x.shape[2:]))

    def expand(st, enc_t, valid_t, forced):
        proj, carry, buf, frame_buf, conf_buf, counts, scores, active = st
        logits = model.joint_step(enc_t[:, None, :].expand(b, k, j).reshape(b * k, j), proj.reshape(b * k, j))
        logp = torch.log_softmax(logits.reshape(b, k, v_total), dim=-1)
        stay = torch.where(active, scores + logp[:, :, blank], scores)  # finished beams keep their score
        if forced:  # after max_symbols expansions every active beam takes the blank
            return proj, carry, buf, frame_buf, conf_buf, counts, stay, torch.zeros_like(active)
        can_extend = (active & (counts < buf_len))[:, :, None] & label_ok
        extend = scores[:, :, None] + logp
        if fusion is not None:  # the LM term of each label, 0 on the blank column
            extend = extend + F.pad(lm_extension_scores(fusion, lm_table, buf, counts), (0, 1))
        extend = torch.where(can_extend, extend, _NEG)
        cand = torch.cat([stay[:, :, None], extend], dim=2).reshape(b, k * (v_total + 1))
        top_scores, flat_idx = torch.sort(cand, dim=1, descending=True, stable=True)
        top_scores, flat_idx = top_scores[:, :k], flat_idx[:, :k]
        parent = torch.div(flat_idx, v_total + 1, rounding_mode="floor")
        choice = flat_idx % (v_total + 1)  # 0 = stay, 1+v = extend by v
        is_ext = choice > 0
        label = (choice - 1).clamp(min=0)
        new_buf, new_frames, new_confs = take(buf, parent), take(frame_buf, parent), take(conf_buf, parent)
        new_counts, new_proj = take(counts, parent), take(proj, parent)
        carry = [tuple(take(x.reshape(b, k, -1), parent).reshape(b * k, -1) for x in layer) for layer in carry]
        label_conf = torch.exp(torch.gather(take(logp, parent).float(), 2, label[:, :, None])[..., 0])
        slot = slots == torch.where(is_ext, new_counts, buf_len)[:, :, None]
        new_buf = torch.where(slot, label[:, :, None], new_buf)
        new_frames = torch.where(slot, fcount[:, None, None], new_frames)
        new_confs = torch.where(slot, label_conf[:, :, None], new_confs)
        new_counts = new_counts + is_ext.long()
        # the prediction network advances for extended beams only
        adv = (is_ext & valid_t[:, None]).reshape(b * k)
        stepped, carry = model.predict_step(label.reshape(b * k), adv, carry)
        new_proj = torch.where(is_ext[:, :, None], stepped.reshape(b, k, j), new_proj)
        merged = _merge_equal_prefixes(top_scores, new_buf, new_counts, is_ext)
        return new_proj, carry, new_buf, new_frames, new_confs, new_counts, merged, is_ext

    for ti in range(t):
        enc_t, valid_t = enc[:, ti], frame_valid[:, ti]
        st = (proj, carry, buf, frame_buf, conf_buf, counts, scores, torch.ones(b, k, dtype=torch.bool, device=device))
        for _ in range(max_symbols):
            st = expand(st, enc_t, valid_t, False)
        proj2, carry2, buf2, frames2, confs2, counts2, scores2, _ = expand(st, enc_t, valid_t, True)
        scores2 = _merge_equal_prefixes(scores2, buf2, counts2)

        def keep(new, old):  # rows past their length keep everything
            return torch.where(valid_t.reshape(b, *([1] * (new.ndim - 1))), new, old)

        proj, buf, frame_buf = keep(proj2, proj), keep(buf2, buf), keep(frames2, frame_buf)
        conf_buf, counts, scores = keep(confs2, conf_buf), keep(counts2, counts), keep(scores2, scores)
        valid_bk = valid_t.repeat_interleave(k)[:, None]
        carry = [tuple(torch.where(valid_bk, n, o) for n, o in zip(ln, lo)) for ln, lo in zip(carry2, carry)]
        fcount = fcount + valid_t.long()
    return proj, carry, buf, frame_buf, conf_buf, counts, scores, fcount


class TransducerBeamDecoder(TransducerDecoder):
    """Batched transducer beam search emitting text transcriptions:
    ``beam_width`` hypotheses per utterance, ``max_symbols_per_frame``
    emissions a frame at most, ``max_tokens`` labels a hypothesis (default
    ``T' · max_symbols_per_frame``); ``fusion_table`` adds shallow fusion."""

    def __init__(self, model, coder, *, beam_width: int = 4, max_symbols_per_frame: int = 4,
                 max_tokens: int | None = None, fusion_table=None):
        if beam_width < 1:
            raise ValueError("beam_width must be >= 1")
        super().__init__(model, coder, max_symbols_per_frame=max_symbols_per_frame)
        self.beam = int(beam_width)
        self.max_tokens = max_tokens
        self.fusion = fusion_table
        self._lm_table = None if fusion_table is None else torch.as_tensor(fusion_table.table).to(self.device)

    def search(self, enc, frame_valid):
        """The beam over an encoded batch: ``(tokens, frames, confs [B, K,
        L], counts, scores [B, K])`` on the device."""
        model, k = self.model, self.beam
        b, t, j = enc.shape
        buf_len = self.max_tokens or t * self.max_symbols
        dev = self.device
        with torch.inference_mode():
            # every beam primed with the start token; only beam 0 is live
            proj, carry = model.predict_step(torch.full((b * k,), model.blank_id, dtype=torch.long, device=dev),
                                             torch.ones(b * k, dtype=torch.bool, device=dev),
                                             model.init_pred_carry(b * k))
            scores = torch.full((b, k), _NEG, device=dev)
            scores[:, 0] = 0.0
            zeros = torch.zeros(b, k, buf_len, dtype=torch.long, device=dev)
            out = _beam_scan(model, k, self.max_symbols, enc, frame_valid, proj.reshape(b, k, j), carry, zeros,
                             torch.zeros(b, k, dtype=torch.long, device=dev), scores, buf_len, zeros,
                             torch.zeros(b, k, buf_len, device=dev), torch.zeros(b, dtype=torch.long, device=dev),
                             self.fusion, self._lm_table)
        _, _, buf, frame_buf, conf_buf, counts, scores, _ = out
        return buf, frame_buf, conf_buf, counts, scores

    def _host(self, inputs, lengths):
        return [x.cpu().numpy() for x in self.search(*self.encode(inputs, lengths))]

    def decode_batch_nbest(self, inputs, lengths) -> list[list[tuple[np.ndarray, float]]]:
        """``[B, T, F]`` padded features → per row, the surviving hypotheses
        as ``(label_ids, log_score)``, best first."""
        buf, _, _, counts, scores = self._host(inputs, lengths)
        out = []
        for bi in range(buf.shape[0]):
            order = np.argsort(-scores[bi], kind="stable")
            out.append([(buf[bi, kk, : counts[bi, kk]].astype(np.int32), float(scores[bi, kk]))
                        for kk in order if scores[bi, kk] > _NEG / 2])
        return out

    def decode_batch(self, inputs, lengths) -> list[np.ndarray]:
        """``[B, T, F]`` padded features → best-hypothesis label ids."""
        return [h[0][0] for h in self.decode_batch_nbest(inputs, lengths)]

    def decode_batch_aligned(self, inputs, lengths) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Per row the best hypothesis' ``(ids, frames, posteriors)``: the
        encoder frame whose joint step emitted each label and the label's
        softmax posterior there."""
        buf, frame_buf, conf_buf, counts, scores = self._host(inputs, lengths)
        out = []
        for bi in range(buf.shape[0]):
            kk = int(np.argmax(scores[bi]))
            n = int(counts[bi, kk])
            out.append((buf[bi, kk, :n].astype(np.int32), frame_buf[bi, kk, :n].astype(np.int64),
                        conf_buf[bi, kk, :n].astype(np.float64)))
        return out


class OnlineTransducerBeamDecoder:
    """Streaming transducer beam search for a unidirectional or causal
    encoder. Already emitted labels are not final: ``best()`` is each row's
    current best prefix, which later frames may rewrite. ``max_tokens``
    bounds a hypothesis' labels; ``fusion_table`` adds shallow fusion."""

    def __init__(self, model, *, beam_width: int = 4, max_symbols_per_frame: int = 4, max_tokens: int = 1024,
                 fusion_table=None):
        model.validate_streamable()
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.beam = int(beam_width)
        self.max_symbols = int(max_symbols_per_frame)
        self.max_tokens = int(max_tokens)
        self.fusion = fusion_table
        self._lm_table = None if fusion_table is None else torch.as_tensor(fusion_table.table).to(self.device)
        self._state = None

    def _fresh_state(self, b: int):
        """``(enc_carry, proj [B, K, J], pred_carry, buf, frame_buf,
        conf_buf [B, K, L], counts, scores [B, K], fcount [B])``: every beam
        primed with the start token, only beam 0 live."""
        model, k, dev, L = self.model, self.beam, self.device, self.max_tokens
        proj, pred = model.predict_step(torch.full((b * k,), model.blank_id, dtype=torch.long, device=dev),
                                        torch.ones(b * k, dtype=torch.bool, device=dev), model.init_pred_carry(b * k))
        scores = torch.full((b, k), _NEG, device=dev)
        scores[:, 0] = 0.0
        return (model.enc.init_stream_carry(b, dev), proj.reshape(b, k, -1), pred,
                torch.zeros(b, k, L, dtype=torch.long, device=dev), torch.zeros(b, k, L, dtype=torch.long, device=dev),
                torch.zeros(b, k, L, device=dev), torch.zeros(b, k, dtype=torch.long, device=dev), scores,
                torch.zeros(b, dtype=torch.long, device=dev))

    @torch.inference_mode()
    def reset(self, batch_size: int) -> None:
        self._state = self._fresh_state(batch_size)

    def _scan(self, enc, n_out, enc_carry, state):
        """The beam over one chunk's encoder frames from ``state``."""
        _, proj, pred, buf, frame_buf, conf_buf, counts, scores, fcount = state
        valid = torch.arange(enc.shape[1], device=self.device)[None, :] < n_out[:, None]
        (proj, pred, buf, frame_buf, conf_buf, counts, scores,
         fcount) = _beam_scan(self.model, self.beam, self.max_symbols, enc, valid, proj, pred, buf, counts, scores,
                              self.max_tokens, frame_buf, conf_buf, fcount, self.fusion, self._lm_table)
        return enc_carry, proj, pred, buf, frame_buf, conf_buf, counts, scores, fcount

    @torch.inference_mode()
    def step(self, chunk, lengths) -> list[np.ndarray]:
        """Consume a ``[B, Tc, F]`` feature chunk; each row's current best
        hypothesis (its whole prefix)."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before step()")
        if chunk.shape[1] > 0:
            chunk = torch.as_tensor(chunk, dtype=torch.float32).to(self.device, non_blocking=True)
            lengths = torch.as_tensor(np.asarray(lengths, np.int64)).to(self.device)
            enc, n_out, enc_carry = self.model.encode_stream(chunk, lengths, self._state[0])
            self._state = self._scan(enc, n_out, enc_carry, self._state)
        return self.best()

    @torch.inference_mode()
    def finish(self) -> list[np.ndarray]:
        """End the utterances (the front-end's last partial group); each
        row's final best hypothesis."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before finish()")
        self._state = self._scan(*self.model.encode_stream_flush(self._state[0]), self._state)
        return self.best()

    def _merge_state(self, sel, new, old):
        """Row-wise select over the whole beam state."""
        model, k = self.model, self.beam
        enc = model.enc.merge_stream_carry(sel, new[0], old[0])
        pred = model.pred.merge_stream_carry(sel.repeat_interleave(k), new[2], old[2])

        def rows(n, o):
            return torch.where(sel.reshape(-1, *([1] * (n.ndim - 1))), n, o)

        return (enc, rows(new[1], old[1]), pred, *(rows(n, o) for n, o in zip(new[3:], old[3:])))

    @torch.inference_mode()
    def finish_rows(self, rows) -> list[np.ndarray]:
        """``finish`` for some rows; the others' state stays as it was.
        Entries at ``rows`` are final."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before finish_rows()")
        old = self._state
        new = self._scan(*self.model.encode_stream_flush(old[0]), old)
        self._state = self._merge_state(torch.from_numpy(row_mask(old[1].shape[0], rows)).to(self.device), new, old)
        return self.best()

    @torch.inference_mode()
    def reset_rows(self, rows) -> None:
        """Re-arm some rows for new utterances; the others keep streaming."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before reset_rows()")
        b = self._state[1].shape[0]
        sel = torch.from_numpy(row_mask(b, rows)).to(self.device)
        self._state = self._merge_state(sel, self._fresh_state(b), self._state)

    def _best_rows(self):
        """The best beam of each row on the host: ``(ids, frames, confs,
        count)`` rows, the first of equal scores as ``np.argmax`` takes."""
        _, _, _, buf, frame_buf, conf_buf, counts, scores, _ = self._state
        with torch.inference_mode():
            kk = torch.argmax(scores, dim=1)[:, None]
            pick = (torch.gather(buf, 1, kk[:, :, None].expand(-1, -1, buf.shape[2]))[:, 0],
                    torch.gather(frame_buf, 1, kk[:, :, None].expand(-1, -1, buf.shape[2]))[:, 0],
                    torch.gather(conf_buf, 1, kk[:, :, None].expand(-1, -1, buf.shape[2]))[:, 0],
                    torch.gather(counts, 1, kk)[:, 0])
            return host_arrays(*pick)

    def best(self) -> list[np.ndarray]:
        """The current best hypothesis of each row."""
        buf, _, _, n = self._best_rows()
        return [buf[i, : int(n[i])].astype(np.int32) for i in range(len(n))]

    def best_alignment(self) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Per row ``(ids, frames, posteriors)`` of the current best
        hypothesis: the global encoder frame whose joint step emitted each
        label and its acoustic posterior there. After ``finish`` it equals
        ``TransducerBeamDecoder.decode_batch_aligned`` on the whole
        features."""
        buf, frames, confs, n = self._best_rows()
        return [(buf[i, : int(n[i])].astype(np.int32), frames[i, : int(n[i])].astype(np.int64),
                 confs[i, : int(n[i])]) for i in range(len(n))]

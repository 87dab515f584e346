"""Streaming (online) CTC transcription.

Port of :mod:`tfkaldi_tpu.decode.online`'s CTC half
(``_validate_streamable``, ``OnlineCTCDecoder``, ``OnlineCTCBeamDecoder``,
``StreamingTranscriber``; decode/online.py:26-37, 102-777). A
unidirectional LSTM / GRU or a causal time-restricted transformer /
conformer is stepped chunk by chunk through its ``apply_stream``, its carry
kept between calls, and the decode equals the offline one on the whole
utterance at any chunking:

- greedy: the device takes each frame's argmax and its posterior; the host
  collapses repeats across chunk boundaries (the last frame label of each
  row is carried) and drops blanks, and keeps each emitted label's frame
  and posterior;
- beam: the device computes ``log_softmax``; the host advances the prefix
  beam frame by frame with :func:`~tfkaldi_tpu_torch.decode.ctc_beam.beam_step`
  in f64 (the offline Python beam's own step, optionally LM-fused), keeping
  the label-time backtrace, so ``best_alignment`` equals the offline
  ``ctc_beam_search_py(..., return_alignment=True)``.

A subsampling front-end emits ``(fill + v) // s`` positions a chunk and its
last partial group at ``finish`` (``apply_stream_flush``).
``finish_rows`` / ``reset_rows`` end or re-arm some rows of the batch and
leave the others' carries as they were (``merge_stream_carry``): the
multi-stream server's per-slot lifecycle. Every device call runs under
``torch.inference_mode``.

The hybrid recipe's streaming likelihood emitters (decode/online.py:40-99,
779-1068) emit log pseudo-likelihoods chunk by chunk, equal to the offline
:class:`~tfkaldi_tpu_torch.decode.decoder.Decoder` on the whole utterance:
``OnlineRecurrentDecoder`` carries a unidirectional LSTM / GRU's state
through its ``apply_stream``; ``OnlineSplicedDecoder`` (the DNN, kernel 1 on
each hidden layer on the card) holds back the splice's ``context_width``
frames of lookahead; ``OnlineWindowedDecoder`` (TDNN, CNN) recomputes each
chunk over a window that reaches the model's receptive field. All three
run on the model's device and return host numpy f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tfkaldi_tpu_torch.decode.ctc_beam import alignment_of, beam_step, best_prefix, initial_alignments, initial_beams
from tfkaldi_tpu_torch.decode.decoder import log_likelihoods
from tfkaldi_tpu_torch.decode.endpoint import EndpointConfig, Endpointer
from tfkaldi_tpu_torch.decode.words import group_words
from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn


def _validate_streamable(model) -> None:
    """Streaming needs a strictly causal model: a unidirectional RNN, or a
    transformer that declares itself streamable."""
    if getattr(model.config, "bidirectional", False):
        raise ValueError("online decoding requires a unidirectional model (bidirectional = False)")
    check = getattr(model, "validate_streamable", None)
    if check is not None:
        check()


def row_mask(b: int, rows) -> np.ndarray:
    sel = np.zeros((b,), bool)
    sel[np.asarray(list(rows), np.int64)] = True
    return sel


def host_arrays(*tensors) -> list[np.ndarray]:
    """Several same-batch device tensors back to the host in one copy (as
    f64; label ids and counts are exact there)."""
    flat = [t.reshape(t.shape[0], -1).double() for t in tensors]
    both = torch.cat(flat, dim=1).cpu().numpy()
    out, at = [], 0
    for t, f in zip(tensors, flat):
        out.append(both[:, at: at + f.shape[1]].reshape(t.shape))
        at += f.shape[1]
    return out


class _HybridEmitter:
    """What the hybrid emitters share: the model in eval on its device and
    the prior there."""

    def __init__(self, model, prior: np.ndarray):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.prior = torch.as_tensor(np.asarray(prior, np.float32), device=self.device)

    def _empty(self, b: int) -> np.ndarray:
        return np.zeros((b, 0, self.prior.shape[0]), np.float32)


class OnlineRecurrentDecoder(_HybridEmitter):
    """Streaming log pseudo-likelihoods of a unidirectional LSTM / GRU: its
    ``apply_stream`` carry kept between calls, so any chunking gives the
    offline decode's frames.

    Usage::

        dec = OnlineRecurrentDecoder(model, prior)
        dec.reset(batch_size)
        for chunk, lengths in feature_chunks:     # [B, Tc, F], [B]
            log_likes = dec.step(chunk, lengths)  # [B, Tc, O]
    """

    def __init__(self, model, prior: np.ndarray):
        _validate_streamable(model)
        if getattr(model, "subsample_factor", 1) != 1:
            raise ValueError("hybrid likelihood emission is per input frame; a subsampling front-end has no 1:1 "
                             "alignment (it is a ctc/rnnt/attention-only recipe)")
        super().__init__(model, prior)
        self._carry = None

    @torch.inference_mode()
    def reset(self, batch_size: int) -> None:
        """Start new utterances: zero the recurrent state."""
        self._carry = self.model.init_stream_carry(batch_size, self.device)

    @torch.inference_mode()
    def step(self, chunk, lengths) -> np.ndarray:
        """``[B, Tc, F]`` chunk (``lengths`` valid frames a row) → ``[B, Tc,
        O]`` log pseudo-likelihoods; advances the carry."""
        if self._carry is None:
            raise RuntimeError("call reset(batch_size) before step()")
        if chunk.shape[1] == 0:  # e.g. a feature flush that added no frames
            return self._empty(chunk.shape[0])
        x = torch.as_tensor(chunk, dtype=torch.float32).to(self.device, non_blocking=True)
        n = torch.as_tensor(np.asarray(lengths, np.int64)).to(self.device)
        logits, self._carry = self.model.apply_stream(x, n, self._carry)
        return log_likelihoods(logits, self.prior).cpu().numpy()


class OnlineWindowedDecoder(_HybridEmitter):
    """Streaming log pseudo-likelihoods of the sequence-local hybrid
    families (TDNN, CNN): output frame ``t`` depends on the input frames
    ``[t - left_receptive, t + right_receptive]`` (the models' shifts or
    time kernels) of features spliced with ±``context_width`` neighbours.

    Frame ``t`` is emitted once frame ``t + c + right_receptive`` has
    arrived; each call runs the model over the spliced window ``[e -
    left_receptive, e + n - 1 + right_receptive]`` of the ``n`` frames it
    emits from ``e`` on, and keeps their rows. The models' zero fill makes
    the window's edges exact: at the start it reaches only frames already
    emitted, or is the utterance's own start; the end lies
    ``right_receptive`` real frames past the emitted span, or at ``flush``
    is the utterance's end. The splice's zero padding is applied at the
    edges: the left one at once, the right one at ``flush``. Emitted frames
    equal the offline ``Decoder`` on offline-spliced features.

    Usage::

        dec = OnlineWindowedDecoder(model, prior, context_width)
        dec.reset(batch_size)
        for feats, lengths in feature_chunks:       # [B, Tc, F] unspliced
            likes, n_new = dec.step(feats, lengths)  # [B, max(n_new), O]
        likes, n_new = dec.flush()                  # the rest of each row

    The model's calls are padded to a multiple of ``frame_bucket`` frames.
    """

    def __init__(self, model, prior: np.ndarray, context_width: int, frame_bucket: int = 8):
        super().__init__(model, prior)
        self.c = int(context_width)
        self.lrf, self.rrf = self._receptive(model)
        self.frame_bucket = int(frame_bucket)
        self._buf = None

    @staticmethod
    def _receptive(model) -> tuple[int, int]:
        return int(model.left_receptive), int(model.right_receptive)

    def reset(self, batch_size: int) -> None:
        self._buf = [None] * batch_size
        self._start = np.zeros((batch_size,), np.int64)  # the global index of each buffer's first frame
        self._total = np.zeros((batch_size,), np.int64)
        self._emitted = np.zeros((batch_size,), np.int64)

    def _emit(self, navail: np.ndarray, final: bool):
        c, lrf, rrf = self.c, self.lrf, self.rrf
        b = len(self._buf)
        counts = navail.astype(np.int32)
        offs = np.zeros((b,), np.int64)  # the emitted span's offset in each window
        w_len = np.zeros((b,), np.int64)
        for row, n in enumerate(navail):
            if int(n) == 0:
                continue
            e = int(self._emitted[row])
            ws = max(0, e - lrf)  # the window's start (the utterance start clamps it)
            we = e + int(n) - 1 + (0 if final else rrf)
            offs[row], w_len[row] = e - ws, we - ws + 1
        if int(w_len.max(initial=0)) == 0:
            return self._empty(b), counts
        w_pad = -(-int(w_len.max()) // self.frame_bucket) * self.frame_bucket
        dim = next(f.shape[1] for f in self._buf if f is not None)
        spliced = np.zeros((b, w_pad, dim * (2 * c + 1)), np.float32)
        for row, n in enumerate(navail):
            n = int(n)
            if n == 0:
                continue
            e = int(self._emitted[row])
            ws, wl = e - int(offs[row]), int(w_len[row])
            # the raw span [ws - c, ws + wl - 1 + c], zeros before global frame 0
            lead = max(0, c - ws)
            first = int(ws - c + lead - self._start[row])
            span = self._buf[row][first: first + (wl + 2 * c - lead)]
            if lead:
                span = np.concatenate([np.zeros((lead, span.shape[1]), span.dtype), span])
            win = np.lib.stride_tricks.sliding_window_view(span, 2 * c + 1, axis=0)
            spliced[row, :wl] = win.transpose(0, 2, 1).reshape(wl, -1)
            self._emitted[row] = e + n
            keep_from = int(max(0, self._emitted[row] - c - lrf) - self._start[row])
            if keep_from > 0:
                self._buf[row] = self._buf[row][keep_from:]
                self._start[row] += keep_from
        with torch.inference_mode():
            x = torch.from_numpy(spliced).to(self.device, non_blocking=True)
            likes = log_likelihoods(self.model(x, torch.from_numpy(w_len).to(self.device)), self.prior)
            likes = likes.cpu().numpy()
        out = np.zeros((b, int(counts.max()), self.prior.shape[0]), np.float32)
        for row, n in enumerate(counts):
            if n:
                out[row, :n] = likes[row, int(offs[row]): int(offs[row]) + n]
        return out, counts

    def step(self, feats, lengths) -> tuple[np.ndarray, np.ndarray]:
        """``[B, Tc, F]`` unspliced CMVN'd features (``lengths`` valid frames
        a row) → ``(log pseudo-likelihoods [B, T, O], counts [B])`` of every
        frame whose splice and receptive field are now complete."""
        if self._buf is None:
            raise RuntimeError("call reset(batch_size) before step()")
        feats = np.asarray(feats, np.float32)
        lengths = np.asarray(lengths, np.int64)
        navail = np.zeros((len(self._buf),), np.int64)
        for row, n in enumerate(lengths):
            n = int(n)
            if n > 0:
                new = feats[row, :n]
                self._buf[row] = new.copy() if self._buf[row] is None else np.concatenate([self._buf[row], new])
                self._total[row] += n
            navail[row] = max(0, self._total[row] - self.c - self.rrf - self._emitted[row])
        return self._emit(navail, final=False)

    def flush(self) -> tuple[np.ndarray, np.ndarray]:
        """Emit the rest of each row: the window's end is the utterance's,
        and the splice's ``c`` zero frames are appended; then ``reset`` is
        required."""
        if self._buf is None:
            raise RuntimeError("call reset(batch_size) before flush()")
        rem = self._total - self._emitted
        if self.c > 0:
            for row, r in enumerate(rem):
                if r > 0:
                    pad = np.zeros((self.c, self._buf[row].shape[1]), np.float32)
                    self._buf[row] = np.concatenate([self._buf[row], pad])
        out = self._emit(rem.astype(np.int64), final=True)
        self._buf = None
        return out


class OnlineSplicedDecoder(OnlineWindowedDecoder):
    """Streaming log pseudo-likelihoods of the DNN: frame-independent in
    eval (stored batchnorm statistics), so it needs only the splice's
    ``context_width`` frames of lookahead: the windowed emitter with no
    receptive field. On the card each emitting call is the eval forward's
    fused FFN kernel (kernel 1) on every hidden layer, at ``B × T_pad``
    rows (``T_pad`` the emitted count padded to ``frame_bucket``).

    Usage::

        dec = OnlineSplicedDecoder(model, prior, context_width)
        dec.reset(batch_size)
        for feats, lengths in feature_chunks:       # [B, Tc, F] unspliced
            likes, n_new = dec.step(feats, lengths)
        likes, n_new = dec.flush()                  # the last c frames a row
    """

    @staticmethod
    def _receptive(model) -> tuple[int, int]:
        return 0, 0


class _StreamCTC:
    """What the greedy and the beam decoder share: the model, its carry,
    the chunk step and the flush."""

    def __init__(self, model, blank_id: int):
        _validate_streamable(model)
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.blank_id = int(blank_id)
        self._carry = None
        # the last chunk's per-frame argmax labels [B, T] and valid counts
        # [B], read by decode/endpoint.py's Endpointer
        self.last_frame_labels = None
        self.last_n_out = None

    def _forward(self, chunk, lengths):
        """``(logits [B, Tc', V], n_out [B])`` of one chunk; advances the
        carry."""
        chunk = torch.as_tensor(chunk, dtype=torch.float32).to(self.device, non_blocking=True)
        lengths = torch.as_tensor(np.asarray(lengths, np.int64)).to(self.device)
        out_fn = getattr(self.model, "stream_output_lengths", None)
        n_out = lengths if out_fn is None else out_fn(self._carry, lengths)
        logits, self._carry = self.model.apply_stream(chunk, lengths, self._carry)
        return logits, n_out

    def _flush(self, rows=None):
        """The front-end's last group ``(logits, n)``, or None for a 1:1
        model; with ``rows`` only those rows take the flushed carry."""
        flush = getattr(self.model, "apply_stream_flush", None)
        if flush is None:
            return None
        old = self._carry
        logits, n, flushed = flush(old)
        if rows is None:
            self._carry = flushed
            return logits, n
        sel = torch.from_numpy(row_mask(n.shape[0], rows)).to(self.device)
        self._carry = self.model.merge_stream_carry(sel, flushed, old)
        return logits, torch.where(sel, n, 0)

    def _reset_carry(self, batch_size: int) -> None:
        self._carry = self.model.init_stream_carry(batch_size, self.device)

    def _rearm_carry(self, b: int, rows) -> None:
        sel = torch.from_numpy(row_mask(b, rows)).to(self.device)
        self._carry = self.model.merge_stream_carry(sel, self.model.init_stream_carry(b, self.device), self._carry)


class OnlineCTCDecoder(_StreamCTC):
    """Streaming greedy (best-path) CTC: each ``step`` returns the label ids
    that chunk newly emitted, repeats merged across chunk boundaries. The
    accumulated stream equals the offline best path of the whole utterance.

    ``last_label_frames`` / ``last_label_confs`` hold, after each call, every
    newly emitted label's decoder-output frame (since the row's reset) and
    its softmax posterior there (the first frame of its argmax run)."""

    def __init__(self, model, blank_id: int):
        super().__init__(model, blank_id)
        self._prev = None  # the last raw frame label of each row
        self._frame_base = None
        self.last_label_frames = None
        self.last_label_confs = None

    @torch.inference_mode()
    def reset(self, batch_size: int) -> None:
        self._reset_carry(batch_size)
        self._prev = np.full((batch_size,), -1, np.int64)
        self._frame_base = np.zeros((batch_size,), np.int64)

    def _paths(self, logits, n_out) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        conf = torch.exp(torch.log_softmax(logits.float(), dim=-1).amax(dim=-1))
        paths, conf, n = host_arrays(torch.argmax(logits, dim=-1), conf, n_out)
        return paths.astype(np.int32), conf.astype(np.float32), n.astype(np.int32)

    def _collapse(self, paths, n_out, confs) -> list[np.ndarray]:
        out, frames, label_confs = [], [], []
        for row in range(paths.shape[0]):
            p = paths[row, : int(n_out[row])]
            if p.size == 0:
                out.append(np.zeros((0,), np.int32))
                frames.append(np.zeros((0,), np.int64))
                label_confs.append(np.zeros((0,), np.float64))
                continue
            keep = np.ones(p.shape[0], dtype=bool)
            keep[0] = p[0] != self._prev[row]
            keep[1:] = p[1:] != p[:-1]
            idx = np.flatnonzero(keep)
            nonblank = p[idx] != self.blank_id
            out.append(p[idx][nonblank].astype(np.int32))
            # a label's frame is the first of its run and its confidence the
            # posterior there: chunking-invariant (a run may straddle chunks)
            frames.append(idx[nonblank] + self._frame_base[row])
            label_confs.append(confs[row, idx[nonblank]].astype(np.float64))
            self._prev[row] = p[-1]
            self._frame_base[row] += p.shape[0]
        self.last_label_frames, self.last_label_confs = frames, label_confs
        return out

    def _decode(self, logits, n_out) -> list[np.ndarray]:
        paths, conf, n = self._paths(logits, n_out)
        self.last_frame_labels, self.last_n_out = paths, n
        return self._collapse(paths, n, conf)

    def _empty_step(self, b: int) -> list[np.ndarray]:
        self.last_frame_labels = np.zeros((b, 0), np.int32)
        self.last_n_out = np.zeros((b,), np.int32)
        self.last_label_frames = [np.zeros((0,), np.int64) for _ in range(b)]
        self.last_label_confs = [np.zeros((0,), np.float64) for _ in range(b)]
        return [np.zeros((0,), np.int32) for _ in range(b)]

    @torch.inference_mode()
    def step(self, chunk, lengths) -> list[np.ndarray]:
        """``[B, Tc, F]`` chunk (numpy or a device tensor) → per-row arrays
        of the newly emitted label ids."""
        if self._carry is None:
            raise RuntimeError("call reset(batch_size) before step()")
        if chunk.shape[1] == 0:  # e.g. a feature flush that added no frames
            return self._empty_step(chunk.shape[0])
        return self._decode(*self._forward(chunk, lengths))

    @torch.inference_mode()
    def finish(self) -> list[np.ndarray]:
        """End the utterances: decode the front-end's last partial group (a
        no-op for 1:1 models); returns the newly emitted ids."""
        if self._carry is None:
            raise RuntimeError("call reset(batch_size) before finish()")
        flushed = self._flush()
        return self._empty_step(self._prev.shape[0]) if flushed is None else self._decode(*flushed)

    @torch.inference_mode()
    def finish_rows(self, rows) -> list[np.ndarray]:
        """``finish`` for some rows; the others' carry and collapse state
        stay as they were. Entries outside ``rows`` are empty."""
        if self._carry is None:
            raise RuntimeError("call reset(batch_size) before finish_rows()")
        flushed = self._flush(rows)
        return self._empty_step(self._prev.shape[0]) if flushed is None else self._decode(*flushed)

    @torch.inference_mode()
    def reset_rows(self, rows) -> None:
        """Re-arm some rows for new utterances; the others keep streaming."""
        if self._carry is None:
            raise RuntimeError("call reset(batch_size) before reset_rows()")
        idx = np.asarray(list(rows), np.int64)
        self._rearm_carry(self._prev.shape[0], idx)
        self._prev[idx] = -1
        self._frame_base[idx] = 0


class OnlineCTCBeamDecoder(_StreamCTC):
    """Streaming CTC prefix beam search: the device emits each chunk's
    frame log-posteriors through the carried state, the host advances the
    prefix beam over them with the offline search's own ``beam_step``, so
    the chunked decode equals ``ctc_beam_search_py`` on the whole utterance.
    ``step`` returns the current best hypothesis of each row;
    ``stable_prefixes`` the part every live beam shares, which only grows.
    ``fusion_scorer``: an optional
    :class:`~tfkaldi_tpu_torch.decode.lm.FusionScorer`."""

    def __init__(self, model, blank_id: int, beam_width: int = 16, fusion_scorer=None):
        super().__init__(model, blank_id)
        self.beam_width = int(beam_width)
        self.fusion_scorer = fusion_scorer
        self._beams = None

    @torch.inference_mode()
    def reset(self, batch_size: int) -> None:
        self._reset_carry(batch_size)
        self._beams = [initial_beams() for _ in range(batch_size)]
        self._aligns = [initial_alignments() for _ in range(batch_size)]
        self._frame_base = np.zeros((batch_size,), np.int64)

    def _advance(self, logits, n_out) -> None:
        log_probs, n = host_arrays(torch.log_softmax(logits.float(), dim=-1), n_out)
        n = n.astype(np.int32)  # log_probs: the f32 values in f64, as the offline search takes them
        self.last_frame_labels = np.argmax(log_probs, axis=-1).astype(np.int32)
        self.last_n_out = n
        for row in range(log_probs.shape[0]):
            for t in range(int(n[row])):
                self._beams[row] = beam_step(self._beams[row], log_probs[row, t], self.blank_id, self.beam_width,
                                             self.fusion_scorer, align=self._aligns[row],
                                             frame_index=int(self._frame_base[row]) + t)
            self._frame_base[row] += int(n[row])

    def _no_frames(self) -> None:
        b = len(self._beams)
        self.last_frame_labels = np.zeros((b, 0), np.int32)
        self.last_n_out = np.zeros((b,), np.int32)

    @torch.inference_mode()
    def step(self, chunk, lengths) -> list[np.ndarray]:
        """``[B, Tc, F]`` chunk → each row's current best label ids (the
        whole hypothesis so far, which later frames may still change)."""
        if self._carry is None:
            raise RuntimeError("call reset(batch_size) before step()")
        self._no_frames()
        if chunk.shape[1] > 0:
            self._advance(*self._forward(chunk, lengths))
        return self.best()

    @torch.inference_mode()
    def finish(self) -> list[np.ndarray]:
        """End the utterances (the front-end's last partial group); returns
        the final best hypotheses."""
        if self._carry is None:
            raise RuntimeError("call reset(batch_size) before finish()")
        flushed = self._flush()
        if flushed is not None:
            self._advance(*flushed)
        return self.best()

    @torch.inference_mode()
    def finish_rows(self, rows) -> list[np.ndarray]:
        """``finish`` for some rows; the others' carry and beams stay as
        they were. Entries at ``rows`` are final."""
        if self._carry is None:
            raise RuntimeError("call reset(batch_size) before finish_rows()")
        flushed = self._flush(rows)
        if flushed is None:
            self._no_frames()
        else:
            self._advance(*flushed)
        return self.best()

    @torch.inference_mode()
    def reset_rows(self, rows) -> None:
        """Re-arm some rows for new utterances; the others keep streaming."""
        if self._carry is None:
            raise RuntimeError("call reset(batch_size) before reset_rows()")
        idx = np.asarray(list(rows), np.int64)
        self._rearm_carry(len(self._beams), idx)
        for row in idx:
            self._beams[int(row)] = initial_beams()
            self._aligns[int(row)] = initial_alignments()
            self._frame_base[int(row)] = 0

    def best(self) -> list[np.ndarray]:
        """Each row's highest-marginal hypothesis over the frames seen."""
        if self._beams is None:
            raise RuntimeError("call reset(batch_size) before best()")
        return [best_prefix(b) for b in self._beams]

    def best_alignment(self) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Per row ``(ids, frames, posteriors)`` of the current best
        hypothesis: the frame at which its surviving path appended each
        label and the label's posterior there. Rewritten as frames arrive;
        final after ``finish``."""
        if self._beams is None:
            raise RuntimeError("call reset(batch_size) before best_alignment()")
        out = []
        for row, beams in enumerate(self._beams):
            ids = best_prefix(beams)
            frames, confs = alignment_of(self._aligns[row], ids)
            out.append((ids, frames, confs))
        return out

    def stable_prefixes(self) -> list[np.ndarray]:
        """Each row's committed ids: the longest prefix common to every live
        beam entry, which can only grow."""
        if self._beams is None:
            raise RuntimeError("call reset(batch_size) before stable_prefixes()")
        out = []
        for beams in self._beams:
            prefixes = list(beams.keys())
            common = prefixes[0]
            for p in prefixes[1:]:
                n = 0
                for a, b in zip(common, p):
                    if a != b:
                        break
                    n += 1
                common = common[:n]
                if not common:
                    break
            out.append(np.asarray(common, dtype=np.int32))
        return out


class StreamingTranscriber:
    """Raw audio chunks → incremental CTC transcripts.

    The chain: an online feature extractor
    (:mod:`tfkaldi_tpu_torch.frontend.online`; the fused one takes the CMVN
    into its call) → optional f32 CMVN with precomputed stats → the
    streaming CTC decoder (greedy for ``beam_width <= 1``, else the prefix
    beam, optionally LM-fused). The finals equal the offline pipeline's
    (``FeatureExtractor`` → CMVN → ``CTCDecoder``) on the whole audio; the
    partials are usable mid-stream.

    ``timestamps`` / ``confidences`` / ``words`` read each label's emission
    time (seconds since the row's reset), its posterior and the ``<space>``
    -delimited word spans; greedy commitments only grow, the beam's are the
    current best hypothesis' backtrace. ``endpoint_config`` adds the
    blank-silence endpoint rules (``endpointed``); its default
    ``frame_shift`` is scaled by the model's subsample factor.
    """

    def __init__(self, online_extractor, model, coder, blank_id: int, *, cmvn: np.ndarray | None = None,
                 beam_width: int = 1, fusion_scorer=None, endpoint_config=None):
        if fusion_scorer is not None and int(beam_width) <= 1:
            raise ValueError("LM shallow fusion needs beam_width > 1 (greedy decoding has no hypothesis set to "
                             "rescore)")
        if int(beam_width) > 1:
            dec = OnlineCTCBeamDecoder(model, blank_id, beam_width=int(beam_width), fusion_scorer=fusion_scorer)
        else:
            dec = OnlineCTCDecoder(model, blank_id)
        self._setup(online_extractor, model, coder, cmvn, beam_width, dec)
        if endpoint_config is not None:
            # EndpointConfig.frame_shift is per decoder output frame; left at
            # its default on a subsampled model, derive it from the model
            sub = int(getattr(model, "subsample_factor", 1) or 1)
            default_shift = EndpointConfig.frame_shift
            if sub != 1 and endpoint_config.frame_shift == default_shift:
                endpoint_config = dataclasses.replace(endpoint_config, frame_shift=default_shift * sub)
            self._endpointer = Endpointer(endpoint_config, blank_id)

    def _setup(self, online_extractor, model, coder, cmvn, beam_width: int, dec) -> None:
        """What every transcriber holds: the front-end (a fused one takes
        the CMVN into its call), the decoder, and seconds a decoder output
        frame (the feature step times the subsample factor)."""
        self.extractor = online_extractor
        self.coder = coder
        if cmvn is not None and hasattr(online_extractor, "fuse_cmvn"):
            online_extractor.fuse_cmvn(np.asarray(cmvn))  # CMVN rides the fused call
            cmvn = None
        self.cmvn = None if cmvn is None else np.asarray(cmvn)
        self.beam_width = int(beam_width)
        self._dec = dec
        ext = online_extractor.extractor
        self.frame_seconds = ext.frame_step / ext.rate * int(getattr(model, "subsample_factor", 1) or 1)
        self._endpointer = None
        self._ids = None
        self._frames = None
        self._confs = None
        self._committed = None  # the ids again, kept past finish() for words()

    def reset(self, batch_size: int) -> None:
        self.extractor.reset(batch_size)
        self._dec.reset(batch_size)
        if self._endpointer is not None:
            self._endpointer.reset(batch_size)
        self._ids = [[] for _ in range(batch_size)]
        self._frames = [[] for _ in range(batch_size)]
        self._confs = [[] for _ in range(batch_size)]
        self._committed = [[] for _ in range(batch_size)]

    def _commit(self, per_row_ids) -> list[str]:
        """Fold newly emitted greedy labels and their alignment into the
        running streams; render the partial transcripts."""
        for row, new_ids in enumerate(per_row_ids):
            self._ids[row].extend(new_ids.tolist())
            self._committed[row].extend(new_ids.tolist())
            self._frames[row].extend(self._dec.last_label_frames[row].tolist())
            self._confs[row].extend(self._dec.last_label_confs[row].tolist())
        return [self.coder.decode(np.asarray(row, np.int32)) for row in self._ids]

    def _sync_beam_alignment(self) -> None:
        """Beam: replace the streams with the current best hypothesis'
        backtrace (re-ranked in hindsight, so rewritten, not appended)."""
        for row, (ids, frames, confs) in enumerate(self._dec.best_alignment()):
            self._committed[row] = ids.tolist()
            self._frames[row] = frames.tolist()
            self._confs[row] = confs.tolist()

    def _feed(self, feats, n_new) -> list[str]:
        if self.cmvn is not None:
            with torch.inference_mode():
                feats = apply_cmvn(torch.as_tensor(feats).to(self._dec.device), self.cmvn)
        if self.beam_width > 1:
            ids = self._dec.step(feats, n_new)
            self._sync_beam_alignment()
            out = [self.coder.decode(row) for row in ids]
        else:
            out = self._commit(self._dec.step(feats, n_new))
        if self._endpointer is not None:
            self._endpointer.update(self._dec.last_frame_labels, self._dec.last_n_out)
        return out

    def push(self, audio_chunk, lengths) -> list[str]:
        """``[B, S]`` audio samples (``lengths`` valid a row) → the current
        partial transcripts."""
        if self._ids is None:
            raise RuntimeError("call reset(batch_size) before push()")
        return self._feed(*self.extractor.step(audio_chunk, lengths))

    def finish(self) -> list[str]:
        """Flush the feature tail and the front-end's last group; the final
        transcripts. The alignment stays readable."""
        if self._ids is None:
            raise RuntimeError("call reset(batch_size) before finish()")
        self._feed(*self.extractor.flush())
        if self.beam_width > 1:
            out = [self.coder.decode(row) for row in self._dec.finish()]
            self._sync_beam_alignment()
        else:
            out = self._commit(self._dec.finish())
        self._ids = None
        return out

    def finish_rows(self, rows) -> list[str]:
        """Finish some rows through the shared batched step; the others keep
        streaming. Entries at ``rows`` are final; the rows keep their
        transcript until ``reset_rows`` re-arms them."""
        if self._ids is None:
            raise RuntimeError("call reset(batch_size) before finish_rows()")
        self._feed(*self.extractor.flush_rows(rows))
        if self.beam_width > 1:
            out = [self.coder.decode(r) for r in self._dec.finish_rows(rows)]
            self._sync_beam_alignment()
            return out
        return self._commit(self._dec.finish_rows(rows))

    def reset_rows(self, rows) -> None:
        """Re-arm some rows for new streams; the others keep streaming."""
        if self._ids is None:
            raise RuntimeError("call reset(batch_size) before reset_rows()")
        self.extractor.reset_rows(rows)
        self._dec.reset_rows(rows)
        if self._endpointer is not None:
            self._endpointer.reset_rows(rows)
        for row in rows:
            self._ids[int(row)] = []
            self._frames[int(row)] = []
            self._confs[int(row)] = []
            self._committed[int(row)] = []

    def timestamps(self) -> list[np.ndarray]:
        """Each row's label emission times in seconds since its reset,
        aligned with the transcript's labels; readable after ``finish``."""
        if self._frames is None:
            raise RuntimeError("call reset(batch_size) before timestamps()")
        return [np.asarray(row, np.float64) * self.frame_seconds for row in self._frames]

    def confidences(self) -> list[np.ndarray]:
        """Each row's label posteriors at their emission frames, in [0, 1]."""
        if self._confs is None:
            raise RuntimeError("call reset(batch_size) before confidences()")
        return [np.asarray(row, np.float64) for row in self._confs]

    def words(self) -> list[list]:
        """Each row's ``WordAlignment(word, start, end, confidence)`` spans
        (decode/words.py)."""
        times, confs = self.timestamps(), self.confidences()
        return [group_words([self.coder.alphabet[i] for i in ids], times[r], confs[r], self.frame_seconds)
                for r, ids in enumerate(self._committed)]

    def endpointed(self) -> np.ndarray:
        """The latched per-row endpoint flags (needs ``endpoint_config``)."""
        if self._endpointer is None:
            raise RuntimeError("StreamingTranscriber was built without endpoint_config")
        return self._endpointer.detected()

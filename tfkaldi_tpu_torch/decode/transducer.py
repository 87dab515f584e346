"""Transducer (RNN-T) greedy decoding, batched and offline.

Port of :mod:`tfkaldi_tpu.decode.transducer` (``_scan_frames``,
``TransducerDecoder``). Per padded batch of the test set
(:func:`~tfkaldi_tpu_torch.decode.streaming.pick_stream`) the encoder runs
once on the device, then the search walks the encoder frames in a Python
loop, each frame a bounded ``max_symbols_per_frame`` emission loop: the
joint for the whole batch, the argmax, the emitted label written into a
per-row buffer, and the prediction network advanced (``predict_step``)
only for the rows that emitted. Everything stays on the device; the host
reads one ``(tokens, frames, confidences, counts)`` set per batch. The
JAX package runs the same loops as one jitted ``lax.scan`` /
``fori_loop``; here each step is a few small launches, so the search is
paced by the host.

Streaming (decode/transducer.py:188-603): :class:`OnlineTransducerDecoder`
runs the same ``_scan_frames`` on each chunk's encoder frames
(``Transducer.encode_stream``), carrying the encoder carry, the last
projection and the prediction carry between calls; greedy transducer search
is strictly causal, so the chunked decode equals :class:`TransducerDecoder`
on the whole utterance at any chunking. ``finish_rows`` / ``reset_rows``
end or re-arm some rows and leave the others' state as it was.
:class:`StreamingTransducerTranscriber` is the audio-to-text chain over it,
or over :class:`~tfkaldi_tpu_torch.decode.transducer_beam.OnlineTransducerBeamDecoder`
when ``beam_width > 1``: the CTC ``StreamingTranscriber``'s lifecycle with
a transducer decoder. The streaming calls run under
``torch.inference_mode``.
"""

from __future__ import annotations

import numpy as np
import torch

from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.decode.online import StreamingTranscriber, host_arrays, row_mask
from tfkaldi_tpu_torch.decode.streaming import pick_stream


def _scan_frames(model, max_symbols: int, enc, frame_valid, proj, carry):
    """Greedy emission over ``enc [B, T, J]`` (``frame_valid [B, T]``) from
    the projection ``proj [B, J]`` and prediction carry. Returns
    ``(tokens, frames, confs [B, T·max_symbols], counts [B], proj,
    carry)``: ``frames[i, k]`` is the encoder frame that emitted token
    ``k``, ``confs[i, k]`` its softmax posterior at that joint step."""
    b, t, _ = enc.shape
    device = enc.device
    buf_len = t * max_symbols
    slots = torch.arange(buf_len, device=device)[None, :]
    buf = torch.zeros(b, buf_len, dtype=torch.long, device=device)
    frame_buf = torch.zeros(b, buf_len, dtype=torch.long, device=device)
    conf_buf = torch.zeros(b, buf_len, device=device)
    counts = torch.zeros(b, dtype=torch.long, device=device)
    for ti in range(t):
        enc_t, valid_t = enc[:, ti], frame_valid[:, ti]
        active = torch.ones(b, dtype=torch.bool, device=device)
        for _ in range(max_symbols):
            logits = model.joint_step(enc_t, proj)
            tok = torch.argmax(logits, dim=-1)
            tok_conf = torch.exp(torch.log_softmax(logits.float(), dim=-1).amax(dim=-1))
            emit = active & (tok != model.blank_id) & valid_t
            # the row's next slot; rows that do not emit point past the buffer
            slot = slots == torch.where(emit, counts, buf_len)[:, None]
            buf = torch.where(slot, tok[:, None], buf)
            frame_buf = torch.where(slot, ti, frame_buf)
            conf_buf = torch.where(slot, tok_conf[:, None], conf_buf)
            counts = counts + emit.long()
            new_proj, carry = model.predict_step(tok, emit, carry)
            proj = torch.where(emit[:, None], new_proj, proj)
            active = emit
    return buf, frame_buf, conf_buf, counts, proj, carry


class TransducerDecoder:
    """Batched greedy decoder of a
    :class:`~tfkaldi_tpu_torch.models.transducer.Transducer` on its device,
    emitting text transcriptions. ``max_symbols_per_frame`` bounds the
    labels a frame may emit.

    After each :meth:`decode_batch`, ``last_label_frames`` holds every
    row's encoder-frame index of each emitted label (multiply by the
    feature step and ``model.subsample_factor`` for seconds) and
    ``last_label_confs`` each label's softmax posterior at its joint step."""

    def __init__(self, model, coder, *, max_symbols_per_frame: int = 4):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.coder = coder
        self.max_symbols = int(max_symbols_per_frame)
        self.last_label_frames = None
        self.last_label_confs = None

    def encode(self, inputs, lengths) -> tuple[torch.Tensor, torch.Tensor]:
        """``(enc [B, T', J], frame_valid [B, T'])`` on the device."""
        inputs = torch.as_tensor(inputs, dtype=torch.float32).to(self.device, non_blocking=True)
        lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int32).to(self.device)
        with torch.inference_mode():
            enc = self.model.encode(inputs, lengths)
        enc_lengths = self.model.output_lengths(lengths)
        return enc, torch.arange(enc.shape[1], device=self.device)[None, :] < enc_lengths[:, None]

    def search(self, enc, frame_valid):
        """The greedy search over an encoded batch: ``(tokens, frames,
        confs, counts)`` on the device."""
        model = self.model
        b = enc.shape[0]
        with torch.inference_mode():
            sos = torch.full((b,), model.blank_id, dtype=torch.long, device=self.device)
            proj, carry = model.predict_step(sos, torch.ones(b, dtype=torch.bool, device=self.device),
                                             model.init_pred_carry(b))
            return _scan_frames(model, self.max_symbols, enc, frame_valid, proj, carry)[:4]

    def decode_batch(self, inputs, lengths) -> list[np.ndarray]:
        """``[B, T, F]`` padded features → list of label-id arrays."""
        buf, frame_buf, conf_buf, counts = (x.cpu().numpy() for x in self.search(*self.encode(inputs, lengths)))
        n = [int(c) for c in counts]
        self.last_label_frames = [frame_buf[i, : n[i]].astype(np.int64) for i in range(len(n))]
        self.last_label_confs = [conf_buf[i, : n[i]].astype(np.float64) for i in range(len(n))]
        return [buf[i, : n[i]].astype(np.int32) for i in range(len(n))]

    def decode_to_file(self, reader: FeatureReader, outfile: str, *, batch_size: int = 16,
                       bucket_multiple: int = 128) -> int:
        """Stream the test set and write a Kaldi ``text`` file
        (``utt_id transcription`` per line). Returns #utterances."""
        count = 0
        with open(outfile, "w") as fid:
            for utt_ids, inputs, lengths in pick_stream(reader)(
                reader, batch_size=batch_size, bucket_multiple=bucket_multiple
            ):
                for utt_id, ids in zip(utt_ids, self.decode_batch(inputs, lengths)):
                    fid.write(f"{utt_id} {self.coder.decode(ids)}\n")
                    count += 1
        return count


class OnlineTransducerDecoder:
    """Streaming greedy transducer decoding for a unidirectional or causal
    encoder: each ``step`` consumes a feature chunk and returns the label ids
    it newly emitted (the lattice emits each label once, so there is no
    cross-chunk merging). ``last_label_frames`` / ``last_label_confs`` hold
    each new label's encoder frame since the row's reset and its posterior
    at its joint step."""

    def __init__(self, model, *, max_symbols_per_frame: int = 4):
        model.validate_streamable()
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.max_symbols = int(max_symbols_per_frame)
        self._state = None
        self.last_label_frames = None
        self.last_label_confs = None

    def _fresh(self, b: int):
        """Zero encoder carry, the prediction network primed with the start
        token: ``(enc_carry, proj [B, J], pred_carry)``."""
        model, dev = self.model, self.device
        proj, pred = model.predict_step(torch.full((b,), model.blank_id, dtype=torch.long, device=dev),
                                        torch.ones(b, dtype=torch.bool, device=dev), model.init_pred_carry(b))
        return model.enc.init_stream_carry(b, dev), proj, pred

    @torch.inference_mode()
    def reset(self, batch_size: int) -> None:
        self._state = self._fresh(batch_size)
        self._frame_base = np.zeros((batch_size,), np.int64)
        self.last_label_frames = None
        self.last_label_confs = None

    def _search(self, enc, n_out, enc_carry, rows=None):
        """``_scan_frames`` over one chunk's encoder frames; with ``rows``
        only those rows take the new state. Returns the host results."""
        old = self._state
        _, proj, pred = old
        valid = torch.arange(enc.shape[1], device=self.device)[None, :] < n_out[:, None]
        buf, frames, confs, counts, proj, pred = _scan_frames(self.model, self.max_symbols, enc, valid, proj, pred)
        new = (enc_carry, proj, pred)
        if rows is None:
            self._state = new
        else:
            sel = torch.from_numpy(row_mask(proj.shape[0], rows)).to(self.device)
            self._state = self._merge(sel, new, old)
            counts, n_out = torch.where(sel, counts, 0), torch.where(sel, n_out, 0)
        return self._unpack(*host_arrays(buf, frames, confs, counts, n_out))

    def _unpack(self, buf, frames, confs, counts, n_out) -> list[np.ndarray]:
        """Host side: each row's new labels, their frames made global, and
        the frame base advanced by the chunk's valid frames."""
        n = counts.astype(np.int64)
        self.last_label_frames = [frames[i, : n[i]].astype(np.int64) + self._frame_base[i] for i in range(len(n))]
        self.last_label_confs = [confs[i, : n[i]] for i in range(len(n))]
        self._frame_base += n_out.astype(np.int64)
        return [buf[i, : n[i]].astype(np.int32) for i in range(len(n))]

    @torch.inference_mode()
    def step(self, chunk, lengths) -> list[np.ndarray]:
        """``[B, Tc, F]`` feature chunk (numpy or a device tensor) → each
        row's newly emitted label ids."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before step()")
        b = chunk.shape[0]
        if chunk.shape[1] == 0:
            self.last_label_frames = [np.zeros((0,), np.int64) for _ in range(b)]
            self.last_label_confs = [np.zeros((0,), np.float64) for _ in range(b)]
            return [np.zeros((0,), np.int32) for _ in range(b)]
        chunk = torch.as_tensor(chunk, dtype=torch.float32).to(self.device, non_blocking=True)
        lengths = torch.as_tensor(np.asarray(lengths, np.int64)).to(self.device)
        enc, n_out, enc_carry = self.model.encode_stream(chunk, lengths, self._state[0])
        return self._search(enc, n_out, enc_carry)

    @torch.inference_mode()
    def finish(self) -> list[np.ndarray]:
        """End the utterances: the front-end's last partial group (a no-op
        for RNN encoders); returns the newly emitted ids."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before finish()")
        return self._search(*self.model.encode_stream_flush(self._state[0]))

    def _merge(self, sel, new, old):
        """Row-wise select over ``(enc_carry, proj, pred_carry)``."""
        model = self.model
        return (model.enc.merge_stream_carry(sel, new[0], old[0]), torch.where(sel[:, None], new[1], old[1]),
                model.pred.merge_stream_carry(sel, new[2], old[2]))

    @torch.inference_mode()
    def finish_rows(self, rows) -> list[np.ndarray]:
        """``finish`` for some rows; the others' state stays as it was and
        they emit nothing."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before finish_rows()")
        return self._search(*self.model.encode_stream_flush(self._state[0]), rows=rows)

    @torch.inference_mode()
    def reset_rows(self, rows) -> None:
        """Re-arm some rows for new utterances; the others keep streaming."""
        if self._state is None:
            raise RuntimeError("call reset(batch_size) before reset_rows()")
        b = self._state[1].shape[0]
        sel = row_mask(b, rows)
        self._state = self._merge(torch.from_numpy(sel).to(self.device), self._fresh(b), self._state)
        self._frame_base[sel] = 0


class StreamingTransducerTranscriber(StreamingTranscriber):
    """Raw audio chunks → incremental transducer transcripts: an online
    feature extractor → optional f32 CMVN → the streaming transducer search
    (greedy for ``beam_width <= 1``, else the frame-synchronous beam,
    optionally LM-fused by ``fusion_table``). Both searches are causal, so
    the finals equal the offline pipeline's on the whole audio. Greedy
    partials are final as emitted; beam partials are the current best
    hypothesis. The lifecycle, ``timestamps`` (the start of the encoder
    frame whose joint step emitted each label), ``confidences`` and
    ``words`` are :class:`~tfkaldi_tpu_torch.decode.online.StreamingTranscriber`'s;
    there are no endpoint rules (they read the CTC blank stream)."""

    def __init__(self, online_extractor, model, coder, *, cmvn: np.ndarray | None = None,
                 max_symbols_per_frame: int = 4, beam_width: int = 1, fusion_table=None, max_tokens: int = 1024):
        from tfkaldi_tpu_torch.decode.transducer_beam import OnlineTransducerBeamDecoder

        if fusion_table is not None and int(beam_width) <= 1:
            raise ValueError("LM shallow fusion needs beam_width > 1 (greedy decoding has no hypothesis set to "
                             "rescore)")
        if int(beam_width) > 1:
            dec = OnlineTransducerBeamDecoder(model, beam_width=int(beam_width),
                                              max_symbols_per_frame=max_symbols_per_frame, max_tokens=max_tokens,
                                              fusion_table=fusion_table)
        else:
            dec = OnlineTransducerDecoder(model, max_symbols_per_frame=max_symbols_per_frame)
        self._setup(online_extractor, model, coder, cmvn, beam_width, dec)

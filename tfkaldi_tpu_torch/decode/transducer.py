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

The online and streaming decoders (``OnlineTransducerDecoder``,
``StreamingTransducerTranscriber``) are not ported (ROADMAP.md, item 16).
"""

from __future__ import annotations

import numpy as np
import torch

from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
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

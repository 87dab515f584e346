"""CTC text decoding: best path or prefix beam, written as a Kaldi ``text``.

Port of :mod:`tfkaldi_tpu.decode.ctc`. Per padded batch of the test set
(:func:`~tfkaldi_tpu_torch.decode.streaming.pick_stream`) the model's eval
forward runs on the device, then:

- greedy (``beam_width = 1``): the device takes the argmax of the logits
  and ``exp(max log_softmax)`` of every frame, both come back in one D2H
  copy, and the host collapses each path (merge repeats, drop blanks),
  keeping each emitted label's frame and posterior;
- beam (``beam_width > 1``): the device computes ``log_softmax``, which
  comes back in one D2H copy, and the host runs the prefix beam search: the
  native C++ one (:mod:`~tfkaldi_tpu_torch.decode.native_beam`, the
  utterances over the host's threads) when it is built, else the Python
  twin (:mod:`~tfkaldi_tpu_torch.decode.ctc_beam`);
- fused beam (``fusion_scorer``, an ARPA LM's
  :class:`~tfkaldi_tpu_torch.decode.lm.FusionScorer`): the Python beam
  with the scorer and the label-time backtrace, as the JAX package does
  (the native beam scores acoustics only). The constructor's arguments
  choose this route.

:data:`beam_runs` counts the batches each beam decoded: ``native``,
``python`` (the unfused beam where the native one did not build) and
``fused``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.data.target_coder import TargetCoder
from tfkaldi_tpu_torch.decode import native_beam
from tfkaldi_tpu_torch.decode.ctc_beam import ctc_beam_search_py
from tfkaldi_tpu_torch.decode.streaming import pick_stream

# batches decoded by each beam search since the last reset
beam_runs = {"native": 0, "python": 0, "fused": 0}


def collapse_ctc_path(path: np.ndarray, blank_id: int) -> np.ndarray:
    """Collapse a frame-level CTC path: merge consecutive repeats, then
    drop blanks. ``path`` is a 1-D int array of per-frame label ids."""
    return collapse_ctc_path_aligned(path, blank_id)[0]


def collapse_ctc_path_aligned(path: np.ndarray, blank_id: int) -> tuple[np.ndarray, np.ndarray]:
    """``collapse_ctc_path`` plus the alignment: also returns each emitted
    label's frame index (the first frame of its argmax run)."""
    path = np.asarray(path)
    if path.size == 0:
        return path.astype(np.int32), np.zeros((0,), np.int64)
    keep = np.ones(path.shape[0], dtype=bool)
    keep[1:] = path[1:] != path[:-1]
    idx = np.flatnonzero(keep)
    collapsed = path[idx]
    nonblank = collapsed != blank_id
    return collapsed[nonblank].astype(np.int32), idx[nonblank].astype(np.int64)


class CTCDecoder:
    """Batched CTC decoder of a model (DNN, LSTM, GRU or Transformer
    emitting the labels plus the blank) on its device, emitting text
    transcriptions.

    ``last_label_frames`` / ``last_label_confs`` hold, after each
    :meth:`decode_batch`, every row's emitted labels' frame index and
    softmax posterior there (greedy: the first frame of the label's argmax
    run; Python beam: the best prefix's backtrace); None after the native
    beam, which returns transcripts only."""

    def __init__(self, model: nn.Module, coder: TargetCoder, blank_id: int, beam_width: int = 1,
                 fusion_scorer=None):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.coder = coder
        self.blank_id = int(blank_id)
        self.beam_width = int(beam_width)
        self.fusion_scorer = fusion_scorer
        self.last_label_frames = None
        self.last_label_confs = None

    def _logits(self, inputs, lengths) -> torch.Tensor:
        inputs = torch.as_tensor(inputs, dtype=torch.float32).to(self.device, non_blocking=True)
        return self.model(inputs, torch.as_tensor(lengths, dtype=torch.int32))

    def log_probs(self, inputs, lengths) -> np.ndarray:
        """``[B, T, V]`` frame log-posteriors (f32) of a padded batch."""
        with torch.inference_mode():
            return torch.log_softmax(self._logits(inputs, lengths).float(), dim=-1).cpu().numpy()

    def best_paths(self, inputs, lengths) -> tuple[np.ndarray, np.ndarray]:
        """Each frame's argmax label ``[B, T]`` int32 and its posterior
        ``[B, T]`` f32, computed on the device and copied back together."""
        with torch.inference_mode():
            logits = self._logits(inputs, lengths)
            conf = torch.exp(torch.log_softmax(logits.float(), dim=-1).amax(dim=-1))
            # label ids < 2^24 are exact in f32: one tensor, one copy
            both = torch.stack([torch.argmax(logits, dim=-1).float(), conf]).cpu().numpy()
        return both[0].astype(np.int32), both[1]

    def decode_batch(self, inputs, lengths) -> list[np.ndarray]:
        """``[B, T, F]`` padded features → list of collapsed label-id arrays."""
        lengths = np.asarray(lengths)
        # a subsampling front-end emits ceil(n/s) frames per row: the model
        # reads the input lengths, the search the output ones
        out_fn = getattr(self.model, "output_lengths", None)
        out_lengths = lengths if out_fn is None else np.asarray(out_fn(lengths))
        if self.beam_width <= 1:
            paths, conf = self.best_paths(inputs, lengths)
            out, frames, confs = [], [], []
            for i in range(paths.shape[0]):
                ids, idx = collapse_ctc_path_aligned(paths[i, : int(out_lengths[i])], self.blank_id)
                out.append(ids)
                frames.append(idx)
                confs.append(conf[i, idx].astype(np.float64))
            self.last_label_frames, self.last_label_confs = frames, confs
            return out
        log_probs = self.log_probs(inputs, lengths)
        if self.fusion_scorer is not None:
            beam_runs["fused"] += 1
        elif native_beam.available():
            beam_runs["native"] += 1
            self.last_label_frames = self.last_label_confs = None
            return native_beam.ctc_beam_search_batch_native(log_probs, out_lengths, self.blank_id, self.beam_width)
        else:
            beam_runs["python"] += 1
        out, frames, confs = [], [], []
        for i in range(log_probs.shape[0]):
            ids, fr, cf = ctc_beam_search_py(log_probs[i, : int(out_lengths[i])], self.blank_id, self.beam_width,
                                             scorer=self.fusion_scorer, return_alignment=True)
            out.append(ids)
            frames.append(fr)
            confs.append(cf)
        self.last_label_frames, self.last_label_confs = frames, confs
        return out

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

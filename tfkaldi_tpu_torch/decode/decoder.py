"""Prior-normalized pseudo-likelihood emission.

Port of :class:`tfkaldi_tpu.decode.decoder.Decoder`. Utterances are packed
into padded batches; per batch the model's eval forward (DNN, LSTM or
GRU; the lengths freeze a recurrent model's carry past each utterance),
softmax, ÷prior, ε-floor and log run on the device, and the real rows are
written to a Kaldi ark for ``latgen-faster-mapped``.

The reference's ε floor is a no-op bug (``np.where(...)`` result discarded,
nnet.py:283), so its log can emit -inf; the floor is applied for real, as
in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.decode.streaming import pick_stream
from tfkaldi_tpu_torch.io import ArkWriter

_EPS = float(np.finfo(np.float64).eps)


def log_likelihoods(logits: torch.Tensor, prior: torch.Tensor) -> torch.Tensor:
    """Logits → f32 log pseudo-likelihoods: softmax, ÷prior, the ε floor,
    log (the offline ``Decoder`` and the streaming emitters alike)."""
    likes = torch.softmax(logits.float(), dim=-1) / prior
    likes = torch.where(likes == 0, _EPS, likes)  # nnet.py:283, fixed
    return torch.log(likes)


class Decoder:
    """Batched posterior → log pseudo-likelihood computer on the model's
    device."""

    def __init__(self, model: nn.Module, prior: np.ndarray):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.prior = torch.as_tensor(np.asarray(prior, np.float32), device=self.device)

    def compute_batch(self, inputs, lengths) -> torch.Tensor:
        """``[B, T, F]`` padded features → ``[B, T, O]`` float32 log
        pseudo-likelihoods, on the device."""
        inputs = torch.as_tensor(inputs, dtype=torch.float32).to(self.device, non_blocking=True)
        lengths = torch.as_tensor(lengths, dtype=torch.int32)
        with torch.inference_mode():
            return log_likelihoods(self.model(inputs, lengths), self.prior)

    def decode_to_writer(
        self,
        reader: FeatureReader,
        writer: ArkWriter,
        *,
        batch_size: int = 16,
        bucket_multiple: int = 128,
    ) -> int:
        """Stream the whole test set (read + CMVN + splice, batch, compute,
        write; nnet.py:270-286). Returns the number of utterances.

        Each batch runs under four ``torch.profiler`` spans on the calling
        thread, one after the other: ``decode.read`` (the reader's next
        batch: read, CMVN, splice, pad; one more ends the stream),
        ``decode.compute`` (the copy in and the forward's launches),
        ``decode.fetch`` (the wait for the device and the copy out) and
        ``decode.write`` (the batch's ark records)."""
        batches = pick_stream(reader)(reader, batch_size=batch_size, bucket_multiple=bucket_multiple)
        count = 0
        while True:
            with record_function("decode.read"):
                batch = next(batches, None)
            if batch is None:
                return count
            utt_ids, inputs, lengths = batch
            with record_function("decode.compute"):
                out = self.compute_batch(inputs, lengths)
            with record_function("decode.fetch"):
                out = out.cpu().numpy()
            with record_function("decode.write"):
                for i, utt_id in enumerate(utt_ids):
                    writer.write_next_utt(utt_id, out[i, : lengths[i]])
                    count += 1

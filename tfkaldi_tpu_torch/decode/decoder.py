"""Prior-normalized pseudo-likelihood emission.

Port of :class:`tfkaldi_tpu.decode.decoder.Decoder`. Utterances are packed
into padded batches; per batch the model's eval forward (DNN, LSTM or
GRU; the lengths freeze a recurrent model's carry past each utterance),
softmax, ÷prior, ε-floor and log run on the device, and the real rows are
written to a Kaldi ark for ``latgen-faster-mapped``. On a CUDA device only
those real rows travel to the host, into page-locked memory (``copy_out``
counts them).

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

# rows of the batches fetched in this process: padded rows computed,
# real rows handed to the writer, and the batches copied into pinned memory
copy_out = {"batches": 0, "rows_computed": 0, "rows_copied": 0, "pinned_batches": 0}


def fetch_real_rows(out: torch.Tensor, lengths) -> list[np.ndarray]:
    """``[B, T, O]`` padded likelihoods → one ``[lengths[i], O]`` host matrix
    an utterance, in batch order.

    On a CUDA device each utterance's real rows are copied, non-blocking,
    into one page-locked block from torch's caching host allocator, and the
    stream is waited on once. A block goes back to that allocator only when
    the last view of it is gone, so a matrix never changes after it is
    returned, even if its holder keeps it. On any other device the matrices
    are views of ``out`` on the host, as ``.cpu()`` gives them."""
    lengths = [int(n) for n in lengths]
    copy_out["batches"] += 1
    copy_out["rows_computed"] += out.shape[0] * out.shape[1]
    copy_out["rows_copied"] += sum(lengths)
    if out.device.type != "cuda":
        host = out.cpu().numpy()
        return [host[i, :n] for i, n in enumerate(lengths)]
    host = torch.empty((sum(lengths), out.shape[2]), dtype=out.dtype, pin_memory=True).split(lengths)
    for i, part in enumerate(host):
        part.copy_(out[i, : lengths[i]], non_blocking=True)
    torch.cuda.current_stream(out.device).synchronize()
    copy_out["pinned_batches"] += 1
    return [part.numpy() for part in host]


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
        ``decode.fetch`` (:func:`fetch_real_rows`: on a CUDA device the
        copy of the real rows alone into pinned host memory and the one
        wait for the device) and ``decode.write`` (the batch's ark records).
        ``writer.write_next_utt`` gets each utterance's float32 matrix, which
        stays as it is for as long as the writer holds it."""
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
                out = fetch_real_rows(out, lengths)
            with record_function("decode.write"):
                for utt_id, mat in zip(utt_ids, out):
                    writer.write_next_utt(utt_id, mat)
                    count += 1

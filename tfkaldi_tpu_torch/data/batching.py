"""Bucket-padded batches.

Port of :mod:`tfkaldi_tpu.data.batching`. Each batch is padded to the next
multiple of ``bucket_multiple`` frames over its longest utterance (or to a
fixed length), and losses mask the padding frames. A :class:`PaddedBatch`
holds numpy arrays on the host; :meth:`PaddedBatch.to` gives the torch
tensors on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PaddedBatch:
    """One padded batch, numpy on the host or torch tensors after
    :meth:`to`.

    Attributes:
        inputs: ``[B, T_pad, F]`` float32, zero-padded.
        targets: ``[B, L_pad]`` int32, zero-padded.
        input_lengths: ``[B]`` int32 true frame counts.
        target_lengths: ``[B]`` int32 true target lengths.
    """

    inputs: np.ndarray | torch.Tensor
    targets: np.ndarray | torch.Tensor
    input_lengths: np.ndarray | torch.Tensor
    target_lengths: np.ndarray | torch.Tensor

    @property
    def num_frames(self) -> int:
        """Total real input frames (throughput accounting; for frame-level
        targets also the loss divisor, trainer.py:130-133)."""
        return int(self.input_lengths.sum())

    def fields(self) -> tuple:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def to(self, device, non_blocking: bool = False) -> "PaddedBatch":
        """The batch as torch tensors on ``device`` (from numpy or from
        host tensors, pinned ones copied asynchronously with
        ``non_blocking``)."""
        return PaddedBatch(*(
            torch.as_tensor(a).to(device, non_blocking=non_blocking) for a in self.fields()
        ))


def round_up(value: int, multiple: int) -> int:
    return -(-int(value) // int(multiple)) * int(multiple)


class DeviceBatcher:
    """Pads ragged utterance lists into bucketed static-shape arrays."""

    def __init__(
        self,
        bucket_multiple: int = 128,
        fixed_input_length: int | None = None,
        fixed_target_length: int | None = None,
    ):
        """Args:
            bucket_multiple: pad batch time dims up to a multiple of this.
            fixed_input_length / fixed_target_length: pin the padded lengths
                (reference-style corpus-max padding).
        """
        self.bucket_multiple = int(bucket_multiple)
        self.fixed_input_length = fixed_input_length
        self.fixed_target_length = fixed_target_length

    def __call__(self, inputs, targets) -> PaddedBatch:
        input_lengths = np.asarray([x.shape[0] for x in inputs], dtype=np.int32)
        target_lengths = np.asarray([t.shape[0] for t in targets], dtype=np.int32)

        t_pad = self.fixed_input_length or round_up(
            input_lengths.max(initial=1), self.bucket_multiple
        )
        l_pad = self.fixed_target_length or round_up(
            target_lengths.max(initial=1), self.bucket_multiple
        )
        if input_lengths.max(initial=0) > t_pad or target_lengths.max(initial=0) > l_pad:
            raise ValueError("utterance longer than fixed padded length")

        feat_dim = inputs[0].shape[1]
        batch_in = np.zeros((len(inputs), t_pad, feat_dim), dtype=np.float32)
        batch_tgt = np.zeros((len(targets), l_pad), dtype=np.int32)
        for i, (x, t) in enumerate(zip(inputs, targets)):
            batch_in[i, : x.shape[0]] = x
            batch_tgt[i, : t.shape[0]] = t
        return PaddedBatch(batch_in, batch_tgt, input_lengths, target_lengths)

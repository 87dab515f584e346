"""Batch dispensers: pair features with encoded targets.

A copy of ``BatchDispenser``, ``TextBatchDispenser`` and
``AlignmentBatchDispenser`` from
:mod:`tfkaldi_tpu.data.dispenser` (reference processing/batchdispenser.py),
reading through the port's :class:`~tfkaldi_tpu_torch.data.feature_reader.FeatureReader`,
with the same cursor semantics: ``get_batch`` skips target-less or
too-short utterances with warnings, ``skip_batch``/``return_batch``
fast-forward and rewind for resume and validation rollback, ``split``
carves off what has been read. Output stays host-side ragged;
:class:`~tfkaldi_tpu_torch.data.batching.DeviceBatcher` pads it.
"""

from __future__ import annotations

import gzip
import logging

import numpy as np

from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.data.target_coder import TargetCoder
from tfkaldi_tpu_torch.io import scan_scp_shapes

log = logging.getLogger(__name__)


class BatchDispenser:
    """Base dispenser; subclasses define how the target file is read."""

    def read_target_file(self, target_path: str) -> dict[str, str]:
        raise NotImplementedError

    def __init__(
        self,
        feature_reader: FeatureReader,
        target_coder: TargetCoder,
        size: int,
        target_path: str,
    ):
        self.feature_reader = feature_reader
        self.target_coder = target_coder
        self.size = int(size)
        self.target_dict = self.read_target_file(target_path)
        # count only targets whose features this reader can serve
        in_scp = set(feature_reader.reader.utt_ids)
        self.target_dict = {u: t for u, t in self.target_dict.items() if u in in_scp}
        # encode every target once: reused by max_target_length and prior
        # counting (the reference re-encodes each time, batchdispenser.py:51)
        self._encoded = {
            utt: target_coder.encode(targets) for utt, targets in self.target_dict.items()
        }
        self.max_target_length = max((t.size for t in self._encoded.values()), default=0)
        # the cursor predicate: has targets AND is long enough to splice, so
        # get_batch, skip_batch and return_batch agree on batch boundaries
        # (the reference's cursor ops checked only the former)
        self._usable = self._find_usable()

    def _find_usable(self) -> set[str]:
        reader = self.feature_reader.reader
        min_frames = 2 * self.feature_reader.context_width + 1
        with_targets = [
            (utt, entry)
            for utt, entry in zip(reader.utt_ids, reader.scp_data)
            if utt in self.target_dict
        ]
        shapes = scan_scp_shapes([entry for _, entry in with_targets])
        return {
            utt
            for (utt, _), (rows, _cols) in zip(with_targets, shapes)
            if rows >= min_frames
        }

    def get_batch(self):
        """Collect ``size`` usable utterances (batchdispenser.py:60-91).

        Returns (inputs, targets): lists of [T_i, F] float32 matrices and
        [L_i] int32 vectors.
        """
        # the reference loops forever in this situation; raise instead
        if not self._usable:
            raise RuntimeError(
                "no usable utterances: every scp entry lacks targets "
                "or is too short to splice"
            )
        batch_inputs: list[np.ndarray] = []
        batch_targets: list[np.ndarray] = []
        while len(batch_inputs) < self.size:
            utt_id, utt_mat, _ = self.feature_reader.get_utt()
            if utt_id in self._usable and utt_mat is not None:
                batch_inputs.append(utt_mat)
                batch_targets.append(self._encoded[utt_id])
            else:
                if utt_id not in self._encoded:
                    log.warning("no targets for %s", utt_id)
                elif utt_mat is None:
                    log.warning("%s is too short to splice", utt_id)
        return batch_inputs, batch_targets

    def get_padded_batch(self, batcher) -> "PaddedBatch":  # noqa: F821
        """One padded host batch (the batch-source protocol of the JAX
        package's prefetcher)."""
        return batcher(*self.get_batch())

    def split(self) -> None:
        self.feature_reader.split()
        # drop carved-off utterances: a stale usable-set would let the
        # cursor ops spin forever on an exhausted scp
        self._usable &= set(self.feature_reader.reader.utt_ids)

    def skip_batch(self) -> None:
        """Advance the cursor by one batch without reading data
        (batchdispenser.py:103-113)."""
        if not self._usable:
            raise RuntimeError("no usable utterances to skip over")
        skipped = 0
        while skipped < self.size:
            utt_id = self.feature_reader.next_id()
            if utt_id in self._usable:
                skipped += 1

    def return_batch(self) -> None:
        """Rewind the cursor by one batch (batchdispenser.py:115-126)."""
        if not self._usable:
            raise RuntimeError("no usable utterances to rewind over")
        skipped = 0
        while skipped < self.size:
            utt_id = self.feature_reader.prev_id()
            if utt_id in self._usable:
                skipped += 1

    def compute_target_count(self) -> np.ndarray:
        """Bincount over all encoded targets → class prior numerator
        (batchdispenser.py:128-145)."""
        encoded = np.concatenate(list(self._encoded.values()))
        return np.bincount(encoded, minlength=self.target_coder.num_labels)

    @property
    def num_batches(self) -> float:
        """May be fractional (batchdispenser.py:147-155)."""
        return self.num_utt / self.size

    @property
    def num_utt(self) -> int:
        return len(self.target_dict)

    @property
    def num_labels(self) -> int:
        return self.target_coder.num_labels

    @property
    def max_input_length(self) -> int:
        return self.feature_reader.max_input_length


class TextBatchDispenser(BatchDispenser):
    """Targets from a Kaldi ``text`` file (batchdispenser.py:175-198)."""

    def read_target_file(self, target_path: str) -> dict[str, str]:
        target_dict: dict[str, str] = {}
        with open(target_path, "r") as fid:
            for line in fid:
                parts = line.strip().split(" ")
                target_dict[parts[0]] = " ".join(parts[1:])
        return target_dict


class AlignmentBatchDispenser(BatchDispenser):
    """Targets from a gzipped pdf-alignment archive
    (batchdispenser.py:200-223)."""

    def read_target_file(self, target_path: str) -> dict[str, str]:
        target_dict: dict[str, str] = {}
        with gzip.open(target_path, "rt") as fid:
            for line in fid:
                parts = line.strip().split(" ")
                target_dict[parts[0]] = " ".join(parts[1:])
        return target_dict

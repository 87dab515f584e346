"""Bulk batch loading through the native C++ ark reader.

Port of :mod:`tfkaldi_tpu.data.bulk_loader`: the production input path of
``cli.main``'s ``train_nnet`` (``[nnet] native_loader = False`` opts out).
The whole feature batch (read + CMVN + splice + padding) comes from one
native call per ark file in the batch
(:func:`tfkaldi_tpu_torch.io.native.read_cmvn_splice_batch`, the port's
copy of ``native/arkio.cpp``), so the host pays one ctypes call per batch
instead of a seek, a parse and numpy CMVN + splice per utterance. Batches
are byte-identical to the Python
:class:`~tfkaldi_tpu_torch.data.dispenser.AlignmentBatchDispenser` /
``TextBatchDispenser`` + :class:`~tfkaldi_tpu_torch.data.batching.DeviceBatcher`,
cursor semantics included (``skip_batch`` / ``return_batch`` / ``split``
over an index of the scp order).

``batches`` counts the batches each source has served since the last
reset (``"alignment"``, ``"text"``), so a caller can show which loader
served a run.
"""

from __future__ import annotations

import logging

import numpy as np

from tfkaldi_tpu_torch.data.batching import PaddedBatch, round_up
from tfkaldi_tpu_torch.io import ArkReader, native, read_utt2spk, scan_scp_shapes

log = logging.getLogger(__name__)

# batches served by source kind since the last reset
batches = {"alignment": 0, "text": 0}


class _IdentityStats:
    """Maps every speaker to identity CMVN stats (the apply_cmvn=False path)."""

    def __init__(self, stats: np.ndarray):
        self._stats = stats

    def __getitem__(self, _spk: str) -> np.ndarray:
        return self._stats


class _BulkSource:
    """The part the two sources share: CMVN stats per speaker, the cursor
    over ``_entries`` (``(utt, ark_path, offset, num_frames)`` of the usable
    utterances in scp order) and the native feature read of a batch.
    Subclasses set ``_entries`` and ``_with_targets`` (every utterance with
    targets, too-short ones included) and define ``get_batch``."""

    kind = ""

    def __init__(self, scpfile, cmvnfile, utt2spkfile, context_width, batch_size, bucket_multiple,
                 max_input_length):
        if not native.available():
            raise RuntimeError("native arkio unavailable")
        self.reader = ArkReader(scpfile)
        self._utt2spk = read_utt2spk(utt2spkfile)
        self.context_width = int(context_width)
        self.batch_size = int(batch_size)
        self.bucket_multiple = int(bucket_multiple)
        self._max_input_length = max_input_length
        self.cursor = 0
        self._num_batches_limit = None
        if cmvnfile:
            with ArkReader(cmvnfile) as cmvn_reader:
                self._cmvn = {
                    spk: np.ascontiguousarray(cmvn_reader.read_utt(spk), dtype=np.float32)
                    for spk in set(self._utt2spk.values())
                }
            self.feat_dim = int(next(iter(self._cmvn.values())).shape[1]) - 1
        else:
            # identity stats: (x - 0/1) / sqrt(1/1 - 0) == x, bit-exact
            dim = int(self.reader.read_utt_data(0).shape[1])
            self.reader.close()  # the batches are read natively; only the scp index stays
            ident = np.zeros((2, dim + 1), dtype=np.float32)
            ident[0, -1] = 1.0  # count
            ident[1, :-1] = 1.0  # Σx² -> var 1
            ident[1, -1] = 1.0
            self._cmvn = _IdentityStats(ident)
            self.feat_dim = dim

    # -- cursor semantics -------------------------------------------------

    @property
    def num_utt(self) -> int:
        """Utterances with targets: includes too-short ones and is NOT
        reduced by split(), exactly like the Python dispenser (reference
        batchdispenser.py:168-171)."""
        return len(self._with_targets)

    @property
    def num_batches(self) -> float:
        raw = self.num_utt / self.batch_size
        limit = self._num_batches_limit
        return raw if limit is None else min(raw, limit)

    def limit_num_batches(self, limit: float) -> None:
        """Cap ``num_batches`` at a value agreed between processes."""
        self._num_batches_limit = float(limit)

    @property
    def max_input_length(self) -> int:
        if self._max_input_length is None:
            raise AttributeError(f"{type(self).__name__} built without max_input_length")
        return int(self._max_input_length)

    def split(self) -> None:
        self._entries = self._entries[self.cursor :]
        self.cursor = 0

    def skip_batch(self) -> None:
        n = max(len(self._entries), 1)
        self.cursor = (self.cursor + self.batch_size) % n

    def return_batch(self) -> None:
        n = max(len(self._entries), 1)
        self.cursor = (self.cursor - self.batch_size) % n

    # -- batches ----------------------------------------------------------

    def _next_entries(self) -> list:
        n_avail = len(self._entries)
        if n_avail == 0:
            raise RuntimeError(
                "no usable utterances: every scp entry lacks targets or is too short to splice"
            )
        entries = [self._entries[(self.cursor + j) % n_avail] for j in range(self.batch_size)]
        self.cursor = (self.cursor + self.batch_size) % n_avail
        return entries

    def _read_features(self, entries: list, t_pad: int):
        """``(feats [n, t_pad, F·(2c+1)] f32, rows [n] int32)``: one native
        call per ark file in the batch (Kaldi data dirs split feats across
        per-job arks feats.1.ark..feats.N.ark)."""
        by_path: dict[str, list[int]] = {}
        for j, e in enumerate(entries):
            by_path.setdefault(e[1], []).append(j)

        def read_group(path, js):
            offsets = np.asarray([entries[j][2] for j in js], dtype=np.int64)
            stats = np.stack([self._cmvn[self._utt2spk[entries[j][0]]] for j in js])
            return native.read_cmvn_splice_batch(path, offsets, stats, self.context_width, t_pad, self.feat_dim)

        if len(by_path) == 1:  # common case: straight into the batch
            (path, js), = by_path.items()
            feats, rows = read_group(path, js)
        else:
            n = len(entries)
            feats = np.empty((n, t_pad, self.feat_dim * (2 * self.context_width + 1)), dtype=np.float32)
            rows = np.empty(n, dtype=np.int32)
            for path, js in by_path.items():
                feats[js], rows[js] = read_group(path, js)
        if np.any(rows < 0):
            raise RuntimeError("unexpected too-short utterance in bulk batch")
        batches[self.kind] += 1
        return feats, rows


class BulkAlignmentBatchSource(_BulkSource):
    """Native-backed batch source for frame-alignment training.

    Requires the native library; ``cli.main`` falls back to
    ``AlignmentBatchDispenser`` + ``DeviceBatcher`` when
    :func:`tfkaldi_tpu_torch.io.native.available` is False. Implements the
    dispenser protocol the training controller consumes
    (``get_padded_batch`` / ``split`` / ``skip_batch`` / ``return_batch`` /
    ``num_batches`` / ``limit_num_batches`` / ``max_input_length`` /
    ``max_target_length`` / ``compute_target_count``).
    """

    kind = "alignment"

    def __init__(
        self,
        scpfile: str,
        cmvnfile: str | None,
        utt2spkfile: str,
        context_width: int,
        alignments: dict[str, np.ndarray],
        batch_size: int,
        bucket_multiple: int = 128,
        num_labels: int | None = None,
        max_input_length: int | None = None,
    ):
        """``num_labels``: total pdf classes; sizes the prior exactly like
        ``AlignmentBatchDispenser.compute_target_count`` (a label that never
        occurs in training still gets a prior slot).

        ``cmvnfile=None`` disables CMVN (``apply_cmvn = False``): the native
        call runs with identity stats (mean 0, variance 1), bit-exact
        against the raw features.

        ``max_input_length``: the corpus-wide max frame count (the featdir
        ``maxlength`` file); batches pad to the bucketed batch max."""
        super().__init__(scpfile, cmvnfile, utt2spkfile, context_width, batch_size, bucket_multiple,
                         max_input_length)
        self.alignments = alignments
        self.num_labels = int(num_labels) if num_labels else None
        if self.num_labels is not None:
            # the guard AlignmentCoder.encode applies on the Python path: a pdf
            # id outside [0, num_labels) would corrupt the loss and the prior
            for utt, ali in alignments.items():
                if len(ali) and not (0 <= int(ali.min()) and int(ali.max()) < self.num_labels):
                    raise ValueError(f"alignment for {utt} has pdf ids outside [0, {self.num_labels})")
        # usable utterances in scp order: have targets; frame counts from the
        # alignments (frame-level targets: len == frames). _with_targets keeps
        # too-short utterances, which num_utt and the prior count span too
        # (batchdispenser.py:128-145, 168-171)
        self._entries = []
        self._with_targets: list[str] = []
        for utt, (path, offset) in zip(self.reader.utt_ids, self.reader.scp_data):
            ali = alignments.get(utt)
            if ali is None:
                log.warning("no targets for %s", utt)
                continue
            self._with_targets.append(utt)
            if len(ali) < 2 * self.context_width + 1:
                log.warning("%s is too short to splice", utt)
                continue
            self._entries.append((utt, path, offset, len(ali)))

    @property
    def max_target_length(self) -> int:
        """Frame-level targets: length == frame count, over every utterance
        with targets (too-short ones included)."""
        return max((len(self.alignments[u]) for u in self._with_targets), default=0)

    def get_padded_batch(self, batcher) -> PaddedBatch:
        """One padded host batch, honouring the batcher's padding policy
        (bucketed batch max, or pinned lengths)."""
        return self.get_batch(fixed_length=batcher.fixed_input_length, bucket_multiple=batcher.bucket_multiple)

    def get_batch(self, fixed_length: int | None = None, bucket_multiple: int | None = None) -> PaddedBatch:
        entries = self._next_entries()
        t_max = max(e[3] for e in entries)
        t_pad = fixed_length or round_up(t_max, bucket_multiple or self.bucket_multiple)
        if t_max > t_pad:
            raise ValueError("utterance longer than fixed padded length")
        feats, rows = self._read_features(entries, t_pad)
        targets = np.zeros((len(entries), t_pad), dtype=np.int32)
        for j, e in enumerate(entries):
            ali = self.alignments[e[0]]
            if len(ali) != rows[j]:
                raise ValueError(f"alignment length {len(ali)} != {rows[j]} frames for {e[0]}")
            targets[j, : len(ali)] = ali
        lengths = np.asarray(rows, dtype=np.int32)
        return PaddedBatch(feats, targets, lengths, lengths)

    def compute_target_count(self) -> np.ndarray:
        """Bincount over the targets of this source's scp (too-short
        utterances included), exactly the Python dispenser's count."""
        counted = [self.alignments[u] for u in self._with_targets]
        minlength = self.num_labels or (int(max(a.max() for a in counted)) + 1)
        return np.bincount(np.concatenate(counted), minlength=minlength)


class BulkTextBatchSource(_BulkSource):
    """Native-backed batch source for text-target training (CTC, RNN-T,
    attention): the features as :class:`BulkAlignmentBatchSource` reads
    them, the targets the coder-encoded transcriptions padded on the host.
    Frame counts come from the 15-byte ark header scan the Python
    dispenser's usable-set predicate uses
    (:func:`tfkaldi_tpu_torch.io.ark.scan_scp_shapes`)."""

    kind = "text"

    def __init__(
        self,
        scpfile: str,
        cmvnfile: str | None,
        utt2spkfile: str,
        context_width: int,
        target_coder,
        textfile: str,
        batch_size: int,
        bucket_multiple: int = 128,
        max_input_length: int | None = None,
    ):
        super().__init__(scpfile, cmvnfile, utt2spkfile, context_width, batch_size, bucket_multiple,
                         max_input_length)
        self.target_coder = target_coder
        # encode every target of this scp once (dispenser.py:41-52)
        target_dict: dict[str, str] = {}
        with open(textfile, "r") as fid:
            for line in fid:
                parts = line.strip().split(" ")
                target_dict[parts[0]] = " ".join(parts[1:])
        in_scp = set(self.reader.utt_ids)
        self._encoded = {utt: target_coder.encode(text) for utt, text in target_dict.items() if utt in in_scp}
        # usable = has targets AND long enough to splice
        with_targets = [
            (utt, entry) for utt, entry in zip(self.reader.utt_ids, self.reader.scp_data) if utt in self._encoded
        ]
        shapes = scan_scp_shapes([entry for _, entry in with_targets])
        min_frames = 2 * self.context_width + 1
        self._with_targets = [utt for utt, _ in with_targets]
        self._entries = []
        for (utt, (path, offset)), (rows, _cols) in zip(with_targets, shapes):
            if rows < min_frames:
                log.warning("%s is too short to splice", utt)
                continue
            self._entries.append((utt, path, offset, rows))
        for utt in self.reader.utt_ids:
            if utt not in self._encoded:
                log.warning("no targets for %s", utt)

    @property
    def num_labels(self) -> int:
        return self.target_coder.num_labels

    @property
    def max_target_length(self) -> int:
        """Max over every encoded target in this scp (too-short utterances
        included)."""
        return max((t.size for t in self._encoded.values()), default=0)

    def get_padded_batch(self, batcher) -> PaddedBatch:
        return self.get_batch(
            fixed_input_length=batcher.fixed_input_length,
            fixed_target_length=batcher.fixed_target_length,
            bucket_multiple=batcher.bucket_multiple,
        )

    def get_batch(
        self,
        fixed_input_length: int | None = None,
        fixed_target_length: int | None = None,
        bucket_multiple: int | None = None,
    ) -> PaddedBatch:
        entries = self._next_entries()
        bucket = bucket_multiple or self.bucket_multiple
        t_max = max(e[3] for e in entries)
        t_pad = fixed_input_length or round_up(t_max, bucket)
        if t_max > t_pad:
            raise ValueError("utterance longer than fixed padded length")
        feats, rows = self._read_features(entries, t_pad)
        encoded = [self._encoded[e[0]] for e in entries]
        target_lengths = np.asarray([t.size for t in encoded], dtype=np.int32)
        l_pad = fixed_target_length or round_up(int(target_lengths.max(initial=1)), bucket)
        if int(target_lengths.max(initial=0)) > l_pad:
            raise ValueError("utterance longer than fixed padded length")
        targets = np.zeros((len(entries), l_pad), dtype=np.int32)
        for j, t in enumerate(encoded):
            targets[j, : t.size] = t
        return PaddedBatch(feats, targets, np.asarray(rows, dtype=np.int32), target_lengths)

    def compute_target_count(self) -> np.ndarray:
        """Bincount over all encoded targets of this scp: the class prior
        numerator, exactly like the Python dispenser."""
        return np.bincount(np.concatenate(list(self._encoded.values())), minlength=self.target_coder.num_labels)

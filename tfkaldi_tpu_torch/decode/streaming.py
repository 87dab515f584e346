"""Test-set streaming: FeatureReader → padded batches for the device.

Port of :mod:`tfkaldi_tpu.decode.streaming` (host-side numpy). The decode
path reads+CMVNs+splices per utterance, packs bucket-padded batches and
makes one device call per batch (the reference ran one utterance per
``session.run``, decoder.py:49-71). Utterances too short to splice are
skipped, mirroring training (batchdispenser.py:85-90). The native stream
and the Python stream give byte-identical batches; which one runs is a
host-side choice of reader, not a kernel fallback.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from tfkaldi_tpu_torch.data.batching import round_up
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.io import native, scan_scp_shapes


def stream_padded_batches(
    reader: FeatureReader,
    *,
    batch_size: int,
    bucket_multiple: int = 128,
) -> Iterator[tuple[list[str], np.ndarray, np.ndarray]]:
    """Yield ``(utt_ids, inputs [b, T_pad, F], lengths [b])`` batches."""
    pending: list[tuple[str, np.ndarray]] = []

    def make():
        t_pad = round_up(max(u.shape[0] for _, u in pending), bucket_multiple)
        dim = pending[0][1].shape[1]
        inputs = np.zeros((len(pending), t_pad, dim), np.float32)
        lengths = np.zeros(len(pending), np.int32)
        for i, (_, u) in enumerate(pending):
            inputs[i, : u.shape[0]] = u
            lengths[i] = u.shape[0]
        utt_ids = [u for u, _ in pending]
        pending.clear()
        return utt_ids, inputs, lengths

    while True:
        utt_id, utt_mat, looped = reader.get_utt()
        if looped:
            break
        if utt_mat is None:
            continue  # too short to splice
        pending.append((utt_id, utt_mat))
        if len(pending) >= batch_size:
            yield make()
    if pending:
        yield make()


def pick_stream(reader: FeatureReader):
    """Choose the native bulk stream when it is usable for this reader
    (native lib present, reader at the head of its scp), else the Python
    per-utterance stream. Both produce byte-identical batches."""
    if native.available() and reader.reader.scp_position == 0:
        return stream_padded_batches_native
    return stream_padded_batches


def stream_padded_batches_native(
    reader: FeatureReader,
    *,
    batch_size: int,
    bucket_multiple: int = 128,
) -> Iterator[tuple[list[str], np.ndarray, np.ndarray]]:
    """Native-backed twin of :func:`stream_padded_batches`: same yielded
    batches byte-for-byte, but each batch is one bulk C++ call
    (read + CMVN + splice fused, native/arkio.cpp) instead of per-utterance
    Python parsing. Requires :func:`tfkaldi_tpu_torch.io.native.available`.

    Frame counts come from a cheap 15-byte header scan of the scp
    (io.ark.scan_scp_shapes), so padding is sized before any payload read.
    """
    ark = reader.reader
    c = int(reader.context_width)
    min_frames = 2 * c + 1
    shapes = scan_scp_shapes(ark.scp_data)
    usable = [
        (utt, path, off, rows)
        for utt, (path, off), (rows, _cols) in zip(ark.utt_ids, ark.scp_data, shapes)
        if rows >= min_frames
    ]
    if not usable:
        return
    dim = shapes[0][1]

    if reader.reader_cmvn is not None:
        stats_of = {}

        def utt_stats(utt: str) -> np.ndarray:
            spk = reader.utt2spk[utt]
            s = stats_of.get(spk)
            if s is None:
                s = np.ascontiguousarray(reader.reader_cmvn.read_utt(spk), np.float32)
                stats_of[spk] = s
            return s
    else:
        ident = np.zeros((2, dim + 1), dtype=np.float32)
        ident[0, -1] = 1.0
        ident[1, :] = 1.0  # Σx² == count ⇒ var 1; (x-0)/1 is bit-exact

        def utt_stats(_utt: str) -> np.ndarray:
            return ident

    for start in range(0, len(usable), batch_size):
        group = usable[start : start + batch_size]
        t_pad = round_up(max(rows for _, _, _, rows in group), bucket_multiple)
        inputs = np.zeros((len(group), t_pad, dim * (2 * c + 1)), np.float32)
        lengths = np.zeros(len(group), np.int32)
        by_path: dict[str, list[int]] = {}
        for j, (_, path, _, _) in enumerate(group):
            by_path.setdefault(path, []).append(j)
        for path, js in by_path.items():
            offsets = np.asarray([group[j][2] for j in js], np.int64)
            stats = np.stack([utt_stats(group[j][0]) for j in js])
            feats, rows = native.read_cmvn_splice_batch(
                path, offsets, stats, c, t_pad, dim
            )
            inputs[js] = feats
            lengths[js] = rows
        yield [utt for utt, _, _, _ in group], inputs, lengths

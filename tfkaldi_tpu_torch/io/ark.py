"""Kaldi binary ark/scp reading and writing.

A copy of :mod:`tfkaldi_tpu.io.ark` (pure numpy), kept in the port so that
it imports nothing of the JAX package.

Format (Kaldi "binary float matrix" record, as consumed/produced by the
reference at processing/ark.py:59-94 and :190-211):

    <key> ' ' \\x00 'B' {F|D} 'M' ' ' \\x04 <rows:int32le> \\x04 <cols:int32le> <row-major data>

The scp line is ``<key> <ark_path>:<offset>`` where ``offset`` points at the
``\\x00 B`` binary-mode marker (i.e. just past the key and its separator).

Interop notes vs the reference implementation:

- The reference writer omits the space between the key and the binary
  marker (processing/ark.py:204-206), which breaks sequential Kaldi reads
  (``copy-feats ark:...``) while scp-based access still works. We write the
  Kaldi-standard trailing space so both access paths work; our reader
  accepts either layout because it always seeks to the scp offset.
- The reference ``ArkReader.split()`` silently drops the final utterance
  (``[pos:-1]``, processing/ark.py:161-165); ours keeps it.
- The reference reopens the ark file for every utterance written
  (processing/ark.py:201-211); we keep file handles open.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Iterator

import numpy as np

_BINARY_HEADER_LEN = 5  # \x00 + 3-char token + trailing space
_DTYPES = {b"FM": (np.float32, 4), b"DM": (np.float64, 8)}


def read_ark_shape(fobj: BinaryIO, offset: int | None = None) -> tuple[int, int]:
    """Read only the ``(rows, cols)`` of a binary matrix record — a 15-byte
    header read, no data. Used for length-aware batching/shuffling."""
    if offset is not None:
        fobj.seek(offset, 0)
    header = fobj.read(_BINARY_HEADER_LEN)
    if len(header) < _BINARY_HEADER_LEN or header[1:2] != b"B":
        raise ValueError("ark record is not in binary mode")
    if header[2:4] not in _DTYPES:
        raise ValueError(f"unsupported ark matrix token {header[2:4]!r}")
    (_, rows) = struct.unpack("<bi", fobj.read(5))
    (_, cols) = struct.unpack("<bi", fobj.read(5))
    return rows, cols


def scan_scp_shapes(entries) -> list[tuple[int, int]]:
    """``(rows, cols)`` for each ``(path, offset)`` scp entry — header-only
    reads with one open handle per ark file. Used for length-aware
    shuffling/batching and spliceability checks."""
    shapes: list[tuple[int, int]] = []
    handles: dict[str, BinaryIO] = {}
    try:
        for path, offset in entries:
            fobj = handles.get(path)
            if fobj is None:
                fobj = handles[path] = open(path, "rb")
            shapes.append(read_ark_shape(fobj, int(offset)))
    finally:
        for fobj in handles.values():
            fobj.close()
    return shapes


def read_ark_matrix(fobj: BinaryIO, offset: int | None = None) -> np.ndarray:
    """Read one binary matrix record starting at ``offset`` (or current pos).

    Accepts float ('FM') and double ('DM') matrices; rejects text-mode and
    compressed archives (same contract as reference processing/ark.py:70-90).
    """
    if offset is not None:
        fobj.seek(offset, 0)
    header = fobj.read(_BINARY_HEADER_LEN)
    if len(header) < _BINARY_HEADER_LEN or header[1:2] != b"B":
        raise ValueError("ark record is not in binary mode")
    token = header[2:4]
    if token[0:1] == b"C":
        raise ValueError("compressed ark matrices are not supported")
    if token not in _DTYPES:
        raise ValueError(f"unsupported ark matrix token {token!r}")
    dtype, itemsize = _DTYPES[token]
    (_, rows) = struct.unpack("<bi", fobj.read(5))
    (_, cols) = struct.unpack("<bi", fobj.read(5))
    data = fobj.read(rows * cols * itemsize)
    if len(data) != rows * cols * itemsize:
        raise ValueError("truncated ark matrix record")
    return np.frombuffer(data, dtype=dtype).reshape(rows, cols)


def write_ark_matrix(fobj: BinaryIO, key: str, mat: np.ndarray) -> int:
    """Append one float32 binary matrix record; return the scp offset.

    Layout mirrors the reference writer (processing/ark.py:202-210) plus the
    Kaldi-standard space after the key. The returned offset points at the
    ``\\x00 B`` marker, which is where both Kaldi and our reader seek to.
    """
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    if mat.ndim != 2:
        raise ValueError("ark matrices must be 2-D")
    rows, cols = mat.shape
    fobj.write(key.encode("utf-8") + b" ")
    offset = fobj.tell()
    fobj.write(b"\x00BFM ")
    fobj.write(struct.pack("<bi", 4, rows))
    fobj.write(struct.pack("<bi", 4, cols))
    fobj.write(mat.tobytes())
    return offset


class ArkReader:
    """Random + sequential access to a Kaldi scp/ark archive.

    Mirrors the reference ArkReader surface (processing/ark.py:28-165): a
    cursor over scp entries with loop-around sequential reads
    (``read_next_utt`` returns ``looped=True`` once the cursor wraps,
    ark.py:105-118), cursor-only moves (``read_next_scp`` /
    ``read_previous_scp``), keyed random access, and ``split()`` which
    discards everything before the cursor (used to carve off a validation
    set).
    """

    def __init__(self, scp_path: str):
        self.scp_position = 0
        self.utt_ids: list[str] = []
        self.scp_data: list[tuple[str, int]] = []
        with open(scp_path, "r") as fin:
            for line in fin:
                line = line.strip()
                if not line:
                    continue
                utt_id, path_pos = line.split(" ", 1)
                path, pos = path_pos.rsplit(":", 1)
                self.utt_ids.append(utt_id)
                self.scp_data.append((path, int(pos)))
        self._handles: dict[str, BinaryIO] = {}
        self._index = {utt: i for i, utt in enumerate(self.utt_ids)}

    def __len__(self) -> int:
        return len(self.scp_data)

    def _open(self, path: str) -> BinaryIO:
        handle = self._handles.get(path)
        if handle is None:
            handle = open(path, "rb")
            self._handles[path] = handle
        return handle

    def close(self) -> None:
        for handle in self._handles.values():
            handle.close()
        self._handles.clear()

    def read_utt_data(self, index: int) -> np.ndarray:
        path, pos = self.scp_data[index]
        return read_ark_matrix(self._open(path), pos)

    def read_next_utt(self) -> tuple[str | None, np.ndarray | None, bool]:
        """Sequential read; loops to the start at EOF (ark.py:96-118)."""
        if not self.scp_data:
            return None, None, True
        if self.scp_position >= len(self.scp_data):
            looped = True
            self.scp_position = 0
        else:
            looped = False
        self.scp_position += 1
        idx = self.scp_position - 1
        return self.utt_ids[idx], self.read_utt_data(idx), looped

    def read_next_scp(self) -> str:
        """Advance the cursor without reading data (ark.py:120-134)."""
        if self.scp_position >= len(self.scp_data):
            self.scp_position = 0
        self.scp_position += 1
        return self.utt_ids[self.scp_position - 1]

    def read_previous_scp(self) -> str:
        """Move the cursor back one and return the id of the un-read
        utterance (ark.py:136-149).

        Divergence from the reference: it returns ``utt_ids[pos+1]`` after
        decrementing — the utterance *ahead* of the cursor — which (a)
        checks the wrong utterance in the dispenser's rewind bookkeeping
        and (b) raises IndexError when the cursor sits exactly at the end
        of the list. We return the utterance the cursor just moved over.
        """
        self.scp_position -= 1
        if self.scp_position < 0:
            self.scp_position = len(self.scp_data) - 1
        return self.utt_ids[self.scp_position]

    def read_utt(self, utt_id: str) -> np.ndarray:
        """Keyed random access (ark.py:151-159)."""
        return self.read_utt_data(self._index[utt_id])

    def split(self) -> None:
        """Drop everything before the cursor and reset it (ark.py:161-165).

        Unlike the reference we keep the final utterance (the reference's
        ``[pos:-1]`` slice drops it).
        """
        self.scp_data = self.scp_data[self.scp_position :]
        self.utt_ids = self.utt_ids[self.scp_position :]
        self.scp_position = 0
        self._index = {utt: i for i, utt in enumerate(self.utt_ids)}

    def __iter__(self) -> Iterator[tuple[str, np.ndarray]]:
        for i, utt_id in enumerate(self.utt_ids):
            yield utt_id, self.read_utt_data(i)

    def __enter__(self) -> "ArkReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ArkWriter:
    """Append float32 matrices to an ark file and emit the matching scp.

    Same surface as the reference writer (processing/ark.py:167-216). Keeps
    both files open for the writer's lifetime.
    """

    def __init__(self, scp_path: str, default_ark: str):
        self.scp_path = scp_path
        self.default_ark = default_ark
        os.makedirs(os.path.dirname(os.path.abspath(scp_path)), exist_ok=True)
        self._scp_file = open(scp_path, "w")
        self._ark_files: dict[str, BinaryIO] = {}

    def _open_ark(self, path: str) -> BinaryIO:
        handle = self._ark_files.get(path)
        if handle is None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            handle = open(path, "ab")
            self._ark_files[path] = handle
        return handle

    def write_next_utt(self, utt_id: str, utt_mat: np.ndarray, ark_path: str | None = None) -> None:
        ark = ark_path or self.default_ark
        offset = write_ark_matrix(self._open_ark(ark), utt_id, utt_mat)
        self._scp_file.write(f"{utt_id} {ark}:{offset}\n")

    def close(self) -> None:
        self._scp_file.close()
        for handle in self._ark_files.values():
            handle.close()
        self._ark_files.clear()

    def __enter__(self) -> "ArkWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

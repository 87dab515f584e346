"""Kaldi-consumer compatibility checker (``csrc/kaldi_consumer.cpp`` bindings).

A copy of :mod:`tfkaldi_tpu.io.kaldi_compat` for the port, on the port's
copy of ``native/kaldi_consumer.cpp``, built with ``g++`` at first use by
:class:`tfkaldi_tpu_torch.io.native.NativeLibrary` into
``build/tfkaldi_tpu_torch/``. A strict, independent C++ implementation of
the framing rules Kaldi's table readers and writers apply at the external
boundary (``copy-feats`` / ``latgen-faster-mapped``, reference
kaldi/decode.sh:54-62): used to verify that archives written by
:class:`tfkaldi_tpu_torch.io.ArkWriter` satisfy the contract (sequential
key + single-space rule, ``\\0B`` binary header at the scp offset, FM/DM
matrix framing), and that archives written with Kaldi's writer framing are
readable by :class:`tfkaldi_tpu_torch.io.ArkReader`.

This is a verification tool, not a production reader, and has no Python
fallback: when the library cannot be built, its functions raise. The
production bulk loader is :mod:`tfkaldi_tpu_torch.io.native` (arkio.cpp).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tfkaldi_tpu_torch.io.ark import ArkReader
from tfkaldi_tpu_torch.io.native import NativeLibrary

ERRORS = {
    -1: "cannot open file",
    -2: "EOF before requested record",
    -3: "could not read a key token",
    -4: "no whitespace after key (Kaldi: 'Invalid archive file format')",
    -5: "record does not start with \\0B (Kaldi: not binary)",
    -6: "bad matrix token (expected 'FM '/'DM ')",
    -7: "bad int32 size marker (expected \\x04)",
    -8: "EOF inside data payload",
    -9: "caller buffer too small",
    -10: "output write failure",
    -11: "negative dimensions",
    -12: "implausibly large dimensions (python-side sanity cap)",
}

# retry-allocation cap for malformed/corrupt archives: a garbage dims field
# must produce a KaldiFormatError, not a giant np.empty. Inclusive bound:
# the worst ACCEPTED retry allocation is (2^26 - 1) floats ≈ 256 MB; any
# claim at or above it raises. Real acoustic records are orders of
# magnitude smaller (an hour of 40-dim frames is ~14M elements).
_MAX_RETRY_ELEMS = 1 << 26


class KaldiFormatError(IOError):
    def __init__(self, code: int, context: str):
        self.code = code
        super().__init__(f"{context}: {ERRORS.get(code, 'unknown error')} (code {code})")


def _bind(lib) -> None:
    lib.kc_count.restype = ctypes.c_long
    lib.kc_count.argtypes = [ctypes.c_char_p]
    lib.kc_seq_read.restype = ctypes.c_int
    lib.kc_seq_read.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_char_p,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.kc_read_at.restype = ctypes.c_int
    lib.kc_read_at.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.kc_copy_feats.restype = ctypes.c_long
    lib.kc_copy_feats.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]


_LIB = NativeLibrary(
    "kaldiconsumer",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "kaldi_consumer.cpp"),
    _bind,
    "nothing: kaldi_compat raises",
)


def available() -> bool:
    return _LIB.available()


def _lib():
    lib = _LIB.load()
    if lib is None:
        raise RuntimeError("native kaldi_consumer unavailable")
    return lib


def count(ark_path: str) -> int:
    """Number of records a strict sequential Kaldi reader sees; raises
    :class:`KaldiFormatError` at the first framing violation."""
    rc = _lib().kc_count(ark_path.encode())
    if rc < 0:
        raise KaldiFormatError(rc, f"sequential scan of {ark_path}")
    return int(rc)


def seq_read(ark_path: str, index: int, max_elems: int = 1 << 20):
    """Read record ``index`` the way SequentialBaseFloatMatrixReader would.
    Returns ``(key, matrix float32)``."""
    lib = _lib()
    key = ctypes.create_string_buffer(1024)
    out = np.empty(max_elems, dtype=np.float32)
    rows, cols = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.kc_seq_read(
        ark_path.encode(), index, key, len(key), out, max_elems,
        ctypes.byref(rows), ctypes.byref(cols),
    )
    if rc == -9 and rows.value * cols.value > max_elems:
        if rows.value * cols.value >= _MAX_RETRY_ELEMS:
            raise KaldiFormatError(
                -12, f"record {index} in {ark_path} claims {rows.value}x{cols.value}"
            )
        return seq_read(ark_path, index, rows.value * cols.value)
    if rc != 0:
        raise KaldiFormatError(rc, f"sequential read of record {index} in {ark_path}")
    n = rows.value * cols.value
    # Kaldi keys are arbitrary non-whitespace bytes; surface undecodable
    # (e.g. corrupted) keys readably instead of raising UnicodeDecodeError
    return (
        key.value.decode(errors="replace"),
        out[:n].reshape(rows.value, cols.value).copy(),
    )


def read_at(ark_path: str, offset: int, max_elems: int = 1 << 20) -> np.ndarray:
    """Read a value at an scp byte offset the way
    RandomAccessBaseFloatMatrixReader would (``\\0B`` must start at
    ``offset``)."""
    lib = _lib()
    out = np.empty(max_elems, dtype=np.float32)
    rows, cols = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.kc_read_at(
        ark_path.encode(), offset, out, max_elems, ctypes.byref(rows), ctypes.byref(cols)
    )
    if rc == -9 and rows.value * cols.value > max_elems:
        if rows.value * cols.value >= _MAX_RETRY_ELEMS:
            raise KaldiFormatError(
                -12, f"record at {ark_path}:{offset} claims {rows.value}x{cols.value}"
            )
        return read_at(ark_path, offset, rows.value * cols.value)
    if rc != 0:
        raise KaldiFormatError(rc, f"random-access read at {ark_path}:{offset}")
    n = rows.value * cols.value
    return out[:n].reshape(rows.value, cols.value).copy()


def copy_feats(in_ark: str, out_ark: str, out_scp: str) -> int:
    """``copy-feats ark:in ark,scp:out,out_scp`` equivalent: strict
    sequential read + rewrite with Kaldi's TableWriter framing. Returns the
    record count."""
    rc = _lib().kc_copy_feats(in_ark.encode(), out_ark.encode(), out_scp.encode())
    if rc < 0:
        raise KaldiFormatError(rc, f"copy-feats {in_ark} -> {out_ark}")
    return int(rc)


def validate_archive(scp_path: str) -> int:
    """Full contract check of an scp+ark pair: every record must be readable
    both sequentially and via its scp offset, with identical bytes. Returns
    the number of records validated."""
    reader = ArkReader(scp_path)
    n = 0
    by_ark: dict[str, list] = {}
    for i, (key, (path, offset)) in enumerate(zip(reader.utt_ids, reader.scp_data)):
        by_ark.setdefault(path, []).append((i, key, offset))
    for path, records in by_ark.items():
        total = count(path)
        if total != len(records):
            raise KaldiFormatError(-2, f"{path}: {total} sequential records, scp lists {len(records)}")
        for seq_index, (_, key, offset) in enumerate(records):
            got_key, seq_mat = seq_read(path, seq_index)
            if got_key != key:
                raise KaldiFormatError(-3, f"{path} record {seq_index}: key {got_key!r} != scp {key!r}")
            ra_mat = read_at(path, offset)
            if not np.array_equal(seq_mat, ra_mat):
                raise KaldiFormatError(-8, f"{path} record {seq_index}: sequential != random-access")
            n += 1
    return n

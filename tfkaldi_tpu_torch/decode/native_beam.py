"""ctypes bindings for the native CTC prefix beam search.

A copy of :mod:`tfkaldi_tpu.decode.native_beam`. The C++ source is the
port's own copy of ``native/ctc_beam.cpp`` (``csrc/ctc_beam.cpp``), built
at first use with ``g++`` into ``<checkout>/build/tfkaldi_tpu_torch/`` by
:class:`tfkaldi_tpu_torch.io.native.NativeLibrary`. It is host code: when
it cannot be built, :func:`available` is False, the failure is logged, and
:class:`~tfkaldi_tpu_torch.decode.ctc.CTCDecoder` runs the Python beam of
:mod:`tfkaldi_tpu_torch.decode.ctc_beam` (and counts which one ran).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from tfkaldi_tpu_torch.io.native import NativeLibrary

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "ctc_beam.cpp")


def _bind(lib) -> None:
    lib.ctc_beam_search.restype = ctypes.c_int32
    lib.ctc_beam_search.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
    ]
    lib.ctc_beam_search_batch.restype = ctypes.c_int32
    lib.ctc_beam_search_batch.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]


_CTCBEAM = NativeLibrary("ctcbeam", SOURCE, _bind, "the Python beam")


def available() -> bool:
    return _CTCBEAM.available()


def _lib():
    lib = _CTCBEAM.load()
    if lib is None:
        raise RuntimeError("native ctc_beam unavailable")
    return lib


def ctc_beam_search_native(log_probs: np.ndarray, blank_id: int, beam_width: int = 16) -> np.ndarray:
    """Native single-utterance prefix beam search; same contract as
    :func:`tfkaldi_tpu_torch.decode.ctc_beam.ctc_beam_search_py`."""
    lib = _lib()
    lp = np.ascontiguousarray(log_probs, dtype=np.float32)
    t_len, v = lp.shape
    out = np.empty(max(t_len, 1), dtype=np.int32)
    n = lib.ctc_beam_search(lp, t_len, v, int(blank_id), int(beam_width), out, out.size)
    if n < 0:
        raise RuntimeError("ctc_beam_search failed")
    return out[:n].copy()


def ctc_beam_search_batch_native(
    log_probs: np.ndarray, lengths, blank_id: int, beam_width: int = 16
) -> list[np.ndarray]:
    """Batched native search over a padded ``[B, T, V]`` block, the
    utterances spread over the host's threads."""
    lib = _lib()
    lp = np.ascontiguousarray(log_probs, dtype=np.float32)
    b, t_max, v = lp.shape
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    max_out = max(t_max, 1)
    out = np.empty((b, max_out), dtype=np.int32)
    out_lens = np.empty(b, dtype=np.int32)
    rc = lib.ctc_beam_search_batch(
        lp, b, t_max, v, lengths, int(blank_id), int(beam_width), out, max_out, out_lens
    )
    if rc != 0 or (out_lens < 0).any():
        raise RuntimeError("ctc_beam_search_batch failed")
    return [out[i, : out_lens[i]].copy() for i in range(b)]

"""ctypes bindings for the native bulk ark loader (``csrc/arkio.cpp``).

A copy of :mod:`tfkaldi_tpu.io.native` for the port, binding the fused
read + CMVN + splice entry the decode stream uses. :class:`NativeLibrary`
builds one host C++ source of the port (this loader's ``csrc/arkio.cpp``,
the port's own copy of ``native/arkio.cpp``, or the CTC beam search's
``decode/csrc/ctc_beam.cpp``) at first use with ``g++`` into
``<checkout>/build/tfkaldi_tpu_torch/`` under a name that hashes the
source, so an edited source is rebuilt and nothing is ever written into
``native/``.

These libraries are host code, not device kernels: when one cannot be
built or loaded, its ``available()`` is False, the failure is logged at
warning level, and callers take their pure-Python path (the same results).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger(__name__)

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "arkio.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "tfkaldi_tpu_torch",
)


def _bind(lib) -> None:
    lib.ark_read_cmvn_splice_batch.restype = ctypes.c_int
    lib.ark_read_cmvn_splice_batch.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]


class NativeLibrary:
    """Build-on-first-use ctypes loader of one C++ source of the port
    (``libtk_<name>_<hash>.so``); ``bind(lib)`` declares the signatures.
    Thread-safe, tries once per process; ``fallback`` names the Python path
    a failure is logged against."""

    def __init__(self, name: str, source: str, bind, fallback: str):
        self.name, self.source, self._bind, self.fallback = name, source, bind, fallback
        self._lock = threading.Lock()
        self._lib = None
        self._tried = False

    def library_path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        return os.path.join(BUILD_DIR, f"libtk_{self.name}_{digest}.so")

    def _build(self, path: str) -> bool:
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-o", tmp, self.source],
                check=True,
                capture_output=True,
            )
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            log.warning("native %s: build of %s failed (%s); using %s", self.name, self.source, e, self.fallback)
            return False
        os.replace(tmp, path)  # atomic: a concurrent build never loads a torn file
        return True

    def load(self):
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            path = self.library_path()
            if not os.path.isfile(path) and not self._build(path):
                return None
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                log.warning("native %s: load of %s failed (%s); using %s", self.name, path, e, self.fallback)
                return None
            self._bind(lib)
            self._lib = lib
            return lib

    def available(self) -> bool:
        """True when the library is built and loaded (builds it on the
        first call)."""
        return self.load() is not None


_ARKIO = NativeLibrary("arkio", SOURCE, _bind, "the Python loader")


def available() -> bool:
    """True when the native ark loader is built and loaded (builds it on
    the first call)."""
    return _ARKIO.available()


def _lib():
    lib = _ARKIO.load()
    if lib is None:
        raise RuntimeError("native ark loader unavailable")
    return lib


def read_cmvn_splice_batch(
    ark_path: str, offsets, cmvn_stats, context_width: int, max_rows: int, dim: int
):
    """Bulk-read + CMVN + splice into a padded batch.

    Args:
        cmvn_stats: ``[n, 2, dim+1]`` float32 — each utterance's speaker
            stats.

    Returns ``(batch [n, max_rows, dim*(2c+1)] float32, rows [n] int32)``
    where ``rows[i] == -1`` marks an utterance too short to splice.
    """
    lib = _lib()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    cmvn_stats = np.ascontiguousarray(cmvn_stats, dtype=np.float32)
    n = len(offsets)
    if cmvn_stats.shape != (n, 2, dim + 1):
        raise ValueError(f"cmvn_stats shape {cmvn_stats.shape}, want {(n, 2, dim + 1)}")
    out = np.empty((n, max_rows, dim * (2 * context_width + 1)), dtype=np.float32)
    rows = np.empty(n, dtype=np.int32)
    rc = lib.ark_read_cmvn_splice_batch(
        ark_path.encode(), offsets, n, cmvn_stats, context_width, max_rows, dim, out, rows
    )
    if rc != 0:
        raise IOError(f"ark_read_cmvn_splice_batch failed with code {rc} on {ark_path}")
    return out, rows

"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all run in parallel) and linked into one shared
library with a plain C interface, written under
``<checkout>/build/tfkaldi_tpu_torch/`` and named by a hash of the sources
and of the headers they share (``ops/csrc/*.cuh``),
so an edited kernel is rebuilt and a stale library is never loaded. The
library is loaded with ``ctypes``; every pointer and the stream pass as
``c_void_p``. Each C entry returns ``cudaGetLastError()`` after its launch
(the step kernels of the recurrences: after the first launch that fails,
of the one launch per time step their C entry makes; the persistent
forward and backward: the error of the co-residency check or of the one
cooperative launch), and :func:`check` raises on a non-zero code.

A failed build raises: there is no fallback from a kernel to plain code.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "tfkaldi_tpu_torch",
)
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entries in csrc/*.cu
_SIGNATURES = {
    # kernel 1: (..., shape, relu, route (1 = TMA, 0 = SIMT edge, 2 = split-K),
    # the tile's rows, split-K workspace, splits, slabs a split, stream)
    "tk_fused_ffn_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P],
    "tk_fused_ffn_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P],
    "tk_gemm_smem": [_I, _I],
    "tk_gemm_blocks_per_sm": [_I, _I],
    # kernel 2: (..., shape, c, route, frames a tile, grid: ops/frame_preemph.py::frame_plan, stream)
    "tk_frame_preemph_f64": [_P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_double, _I, _I, _I, _P],
    "tk_frame_smem": [_I, _I, _I, _I],
    # kernel 3: (..., shape, route (1 = TMA, 0 = SIMT edge), stream)
    "tk_bn_dgrad_f32": [_P] * 11 + [_I, _I, _I, _I, _P],
    "tk_bn_dgrad_bf16": [_P] * 11 + [_I, _I, _I, _I, _P],
    # the recurrences: (pointer block, mask, dirs, T, B, H[, residuals], stream)
    **{f"tk_{cell}_fwd_{dt}": [_P, _P, _I, _I, _I, _I, _I, _P]
       for cell in ("lstm", "gru") for dt in ("f32", "bf16")},
    **{f"tk_{cell}_bwd_{dt}": [_P, _P, _I, _I, _I, _I, _P]
       for cell in ("lstm", "gru") for dt in ("f32", "bf16")},
    # the persistent forward: (..., residuals, row CTAs, barrier counters, stream)
    **{f"tk_{cell}_fwd_persistent_{dt}": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P]
       for cell in ("lstm", "gru") for dt in ("f32", "bf16")},
    "tk_rnn_fwd_smem": [_I, _I, _I],
    # the persistent backward: (pointer block, mask, dirs, T, B, H, row CTAs, barrier counters, stream)
    **{f"tk_{cell}_bwd_persistent_{dt}": [_P, _P, _I, _I, _I, _I, _I, _P, _P]
       for cell in ("lstm", "gru") for dt in ("f32", "bf16")},
    "tk_rnn_bwd_smem": [_I, _I, _I],
    # layers.product's backward: (g, out, batch, m, n, m8, n8, vec_in, stream)
    "tk_split3_bf16": [_P, _P, *[ctypes.c_longlong] * 5, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None  # wall time of this process's build, if it built


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
            "the CUDA kernels of tfkaldi_tpu_torch cannot be built"
        )
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    digest = hashlib.sha256()
    for path in _sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtk_kernels_{digest.hexdigest()[:16]}.so")


def ptxas_report_path(lib_path: str) -> str:
    """Where the build keeps ``nvcc -Xptxas -v``'s output for a library."""
    return f"{lib_path}.ptxas.txt"


def _compile(lib_path: str) -> None:
    """One ``nvcc -c`` per source, all started together, then one link."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.tmp.{os.getpid()}"
    nvcc = _nvcc()
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *flags, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    objs = []
    failed = []
    report = []
    for cmd, obj, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
        report.append(f"== {os.path.basename(cmd[-1])}\n{out}{err}")
        objs.append(obj)
    with open(ptxas_report_path(lib_path), "w") as f:  # registers, shared memory, spills per kernel
        f.write("\n".join(report))
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, lib_path)  # atomic: a concurrent build never loads a torn file
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.isfile(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch (a negative
    code: ``cuTensorMapEncodeTiled`` refused a TMA tensor map, ``-CUresult``,
    or -1000 when its entry point is missing)."""
    if code < 0:
        raise RuntimeError(f"{name}: TMA tensor map refused (code {code})")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")

"""The launch plan of the GEMM core (``csrc/gemm_sm90.cuh``) that kernels 1
and 3 share: which route a product takes, and that route's tile, stages,
grid, threads and shared memory, from the shape, the dtype and the operands'
alignment alone. Pure arithmetic, so the CPU tests reach it.

The product is ``C[n, m] = A[n, k] @ B`` with A row-major (K-major) and B
either K-major (``b_major="k"``: the rows of an ``[m, k]`` matrix, kernel
3's ``wᵀ``) or MN-major (``b_major="mn"``: a row-major ``[k, m]``, kernel
1's ``w``). Route ``"tma"`` needs what a TMA tensor map needs: every row
pitch a multiple of 16 bytes and every base pointer 16-byte aligned. Any
other shape takes route ``"simt"``, the core's register-blocked SGEMM with
masked scalar loads. The route is decided here and nowhere else: a kernel
that fails to build or launch raises, and no wrapper retries another route.
"""

from __future__ import annotations

import dataclasses

import torch

SMEM_PER_CTA = 232_448  # the most shared memory a Hopper block may use
ALIGN = 16  # bytes: TMA's rule for base addresses and row pitches
# (BM, BN, BK, STAGES) of the TMA route per dtype, as csrc/gemm_sm90.cuh
# TmaCfg sets them; the ring's stages are A [BM, BK] + B [BN, BK]
TMA_TILE = {torch.bfloat16: (128, 256, 64, 4), torch.float32: (128, 128, 32, 4)}
TMA_THREADS = 384  # a producer warpgroup and two consumer warpgroups
SIMT_TILE = (128, 128, 8, 2)  # two register-staged shared buffers
SIMT_THREADS = 256
EPI_PARAMS = 3  # [BN] f32 vectors the epilogue stages per tile (bias, scale, shift)
_ROUTE_CODE = {"tma": 1, "simt": 0}  # the C entries' `route` argument
_SIZE = {torch.bfloat16: 2, torch.float32: 4}


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """``route`` ("tma" or "simt"); the output tile ``bm`` x ``bn``, the
    depth ``bk`` of a stage and ``stages`` of them; ``grid`` (column tiles,
    row tiles); ``threads`` a block; ``smem_bytes`` of shared memory a
    block (dynamic on the TMA route, static on the SIMT route)."""

    route: str
    bm: int
    bn: int
    bk: int
    stages: int
    grid: tuple[int, int]
    threads: int
    smem_bytes: int

    @property
    def code(self) -> int:
        return _ROUTE_CODE[self.route]


def tma_smem(dtype) -> int:
    """Dynamic shared memory of the TMA route: the ring, a full and an
    empty mbarrier per stage, the epilogue's staged ``[3, BN]`` f32
    parameters, and 1024 bytes of slack to align the ring to the 128-byte
    swizzle's 1024-byte period (``TmaLayout::SMEM``)."""
    bm, bn, bk, stages = TMA_TILE[dtype]
    return stages * (bm + bn) * bk * _SIZE[dtype] + 2 * stages * 8 + EPI_PARAMS * bn * 4 + 1024


def tma_ok(n: int, k: int, m: int, dtype, b_major: str, ptrs) -> bool:
    """Whether TMA can describe both operands: a positive shape within its
    32-bit coordinates, row pitches of A (``k``) and B (``k`` or ``m``
    elements) that are multiples of 16 bytes, and 16-byte aligned
    pointers."""
    if dtype not in TMA_TILE or b_major not in ("k", "mn"):
        return False
    if min(n, k, m) < 1 or max(n, k, m) >= 2 ** 31:
        return False
    size = _SIZE[dtype]
    b_pitch = k if b_major == "k" else m
    return (k * size) % ALIGN == 0 and (b_pitch * size) % ALIGN == 0 and all(p % ALIGN == 0 for p in ptrs)


def gemm_plan(n: int, k: int, m: int, dtype, b_major: str, ptrs) -> GemmPlan:
    """The plan of ``[n, k] @ B -> [n, m]`` in ``dtype`` (float32 or
    bfloat16), B laid out as ``b_major`` ("k" or "mn"); ``ptrs`` are the
    operands' data pointers (ints), each of which must be 16-byte aligned
    for the TMA route."""
    if b_major not in ("k", "mn"):
        raise ValueError(f"gemm_plan: b_major {b_major!r}; want 'k' or 'mn'")
    if tma_ok(n, k, m, dtype, b_major, ptrs):
        bm, bn, bk, stages = TMA_TILE[dtype]
        route, threads, smem = "tma", TMA_THREADS, tma_smem(dtype)
    else:
        bm, bn, bk, stages = SIMT_TILE
        route, threads, smem = "simt", SIMT_THREADS, stages * (bm + bn) * bk * 4 + EPI_PARAMS * bn * 4
    return GemmPlan(route, bm, bn, bk, stages, (-(-m // bn), -(-n // bm)), threads, smem)

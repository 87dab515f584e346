"""The launch plan of the GEMM core (``csrc/gemm_sm90.cuh``) that kernels 1
and 3 share: which route a product takes, and that route's tile, stages,
grid, split of K, threads and shared memory, from the shape, the dtype and
the operands' alignment alone. Pure arithmetic, so the CPU tests reach it.

The product is ``C[n, m] = A[n, k] @ B`` with A row-major (K-major) and B
either K-major (``b_major="k"``: the rows of an ``[m, k]`` matrix, kernel
3's ``wᵀ``) or MN-major (``b_major="mn"``: a row-major ``[k, m]``, kernel
1's ``w``). Route ``"tma"`` needs what a TMA tensor map needs: every row
pitch a multiple of 16 bytes and every base pointer 16-byte aligned. Any
other shape takes route ``"simt"``, the core's register-blocked SGEMM with
masked scalar loads.

Route ``"splitk"`` is the TMA route with K cut into ``splits`` ranges of
``slabs`` BK-deep slabs, one range a CTA on grid z, then a second kernel
that sums the f32 partials in split order and applies the epilogue. Both
routes may also take the half tile, ``bm`` = HALF_BM (64) rows instead of
128, which doubles the CTAs at n in the hundreds (the f32 half tile holds
two blocks an SM). Either is planned for an MN-major product (kernel 1)
whose full-tile TMA grid leaves SMs idle, where :func:`model_us`'s model
of the run, waves of CTAs times the slabs each streams, finds a tile and
split faster than the TMA plan (a split by SPLIT_GAIN_US more, the host
cost of its second launch): the streamed DNN's 8–600 rows. The recipe's
shapes fill the card and keep the TMA plan.

The route is decided here and nowhere else: a kernel that fails to build
or launch raises, and no wrapper retries another route. Plans are cached
on their key (shape, dtype, B's layout, whether the pointers are aligned),
so a streamed chunk's six layer calls plan once.
"""

from __future__ import annotations

import dataclasses
import functools
import heapq

import torch

SMEM_PER_CTA = 232_448  # the most shared memory a Hopper block may use
SMEM_PER_SM = 233_472  # an SM's, its blocks' 1 KB reserves included
SMS = 132  # streaming multiprocessors of an H100 SXM
ALIGN = 16  # bytes: TMA's rule for base addresses and row pitches
# (BM, BN, BK, STAGES) of the TMA route per dtype, as csrc/gemm_sm90.cuh
# TmaCfg sets them; the ring's stages are A [BM, BK] + B [BN, BK]
TMA_TILE = {torch.bfloat16: (128, 256, 64, 4), torch.float32: (128, 128, 32, 4)}
HALF_BM = 64  # the half tile's rows (gemm_sm90.cuh HALF_BM)
TMA_THREADS = 384  # a producer warpgroup and two consumer warpgroups
SIMT_TILE = (128, 128, 8, 2)  # two register-staged shared buffers
SIMT_THREADS = 256
EPI_PARAMS = 3  # [BN] f32 vectors the epilogue stages per tile (bias, scale, shift)
_ROUTE_CODE = {"tma": 1, "simt": 0, "splitk": 2}  # the C entries' `route` argument
_SIZE = {torch.bfloat16: 2, torch.float32: 4}

# model_us's model of a TMA-core run, in microseconds. A CTA pays
# CTA_US of fixed cost and one memory latency (HBM_LATENCY_US for the
# share of its bytes that first come from HBM, L2_LATENCY_US for the rest:
# w is read by every row tile, x by every column tile), then streams its
# slabs, each at the slowest of its FMAs or tensor work (SM_FLOPS, the
# SM's rate on that tile, shared by the blocks an SM holds), its bytes
# (SM_BYTES_S an SM, shared likewise) and the latency over the ring's
# stages (the SM's memory pipeline, shared likewise); f32 warps of the
# split route skip the rows past the last one, the TMA route's and bf16
# warpgroups compute the whole tile. CTAs go in launch order to the slot
# that frees first (blocks_per_sm slots an SM), and the run takes no less
# than HBM needs to deliver x and w once. A split run adds REDUCE_US for
# the second kernel plus a write and a read of its f32 partials and the
# output's write. The rates and costs were fitted (least mean |log| error)
# to the device times of every tile and split count at the 24 streamed and
# gate shapes on an H100 80GB HBM3 at 700 W (``python -m
# tfkaldi_tpu_torch.profile_ffn --sweep``; ``--calibrate`` prints the
# model's pick beside the fastest; PERF.md §6 names the runs). They are a fit,
# not the card's rates: the f32 half tile's reaches the FMA peak because
# its latency term takes the time the FMAs do not.
SM_FLOPS = {(torch.float32, 128): 43e12 / SMS, (torch.float32, HALF_BM): 67e12 / SMS,
            (torch.bfloat16, 128): 800e12 / SMS, (torch.bfloat16, HALF_BM): 800e12 / SMS}
HBM_BYTES_S = 3.35e12
SM_BYTES_S = 130e9
HBM_LATENCY_US = 2.25
L2_LATENCY_US = 1.75
CTA_US = 0.25
REDUCE_US = 2.0
# a split run also costs the host a second launch: a split is taken only
# where it saves more device time than that (the median of the C entry's
# host time on the split plan less on the TMA plan, 5.0 us over the 19
# split rows of the fitted sweep: profile_ffn's host_parts_us, --calibrate)
SPLIT_GAIN_US = 5.0
MAX_SPLITS = 32
MAX_WAVES = 8  # split counts past this many waves of CTAs are not weighed


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """``route`` ("tma", "splitk" or "simt"); the output tile ``bm`` x
    ``bn`` (``bm`` HALF_BM: the half tile), the depth ``bk`` of a stage and ``stages`` of them; ``grid``
    (column tiles, row tiles); ``threads`` a block; ``smem_bytes`` of shared
    memory a block (dynamic on the TMA and split routes, static on the SIMT
    route); ``splits`` ranges of K on grid z, each of ``slabs`` BK-deep
    slabs (the last may hold fewer; 1 range of all of K off the split
    route)."""

    route: str
    bm: int
    bn: int
    bk: int
    stages: int
    grid: tuple[int, int]
    threads: int
    smem_bytes: int
    splits: int = 1
    slabs: int = 0

    @property
    def code(self) -> int:
        return _ROUTE_CODE[self.route]

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.splits

    def k_ranges(self, k: int) -> list[tuple[int, int]]:
        """The ``[k0, k1)`` each split streams (the split route's grid z)."""
        if self.route != "splitk":
            return [(0, k)]
        depth = self.slabs * self.bk
        return [(z * depth, min(k, (z + 1) * depth)) for z in range(self.splits)]

    def workspace_shape(self, n: int, m: int) -> tuple[int, int, int] | None:
        """The f32 partials ``[splits, n, m]`` of the split route, else None."""
        return (self.splits, n, m) if self.route == "splitk" else None


def tma_smem(dtype, bm: int | None = None) -> int:
    """Dynamic shared memory of the TMA route on tiles of ``bm`` rows (the
    dtype's full tile by default): the ring, a full and an empty mbarrier
    per stage, the epilogue's staged ``[3, BN]`` f32 parameters, and 1024
    bytes of slack to align the ring to the 128-byte swizzle's 1024-byte
    period (``TmaLayout::SMEM``). The split route's blocks are the TMA
    route's."""
    full, bn, bk, stages = TMA_TILE[dtype]
    bm = full if bm is None else bm
    return stages * (bm + bn) * bk * _SIZE[dtype] + 2 * stages * 8 + EPI_PARAMS * bn * 4 + 1024


def blocks_per_sm(dtype, bm: int) -> int:
    """Blocks of the TMA core an SM holds (``tma_blocks_per_sm``): two of
    the f32 half tile, else one."""
    return 2 if dtype == torch.float32 and bm == HALF_BM else 1


def _tma_shape_ok(n: int, k: int, m: int, dtype, b_major: str) -> bool:
    if dtype not in TMA_TILE or b_major not in ("k", "mn"):
        return False
    if min(n, k, m) < 1 or max(n, k, m) >= 2 ** 31:
        return False
    size = _SIZE[dtype]
    b_pitch = k if b_major == "k" else m
    return (k * size) % ALIGN == 0 and (b_pitch * size) % ALIGN == 0


def tma_ok(n: int, k: int, m: int, dtype, b_major: str, ptrs) -> bool:
    """Whether TMA can describe both operands: a positive shape within its
    32-bit coordinates, row pitches of A (``k``) and B (``k`` or ``m``
    elements) that are multiples of 16 bytes, and 16-byte aligned
    pointers."""
    return _tma_shape_ok(n, k, m, dtype, b_major) and all(p % ALIGN == 0 for p in ptrs)


def model_us(n: int, k: int, m: int, dtype, bm: int, splits: int) -> float:
    """The model's microseconds of ``[n, k] @ [k, m]`` on the TMA core with
    ``bm``-row tiles and K in ``splits`` ranges (1: the TMA route): the
    CTAs, each streaming its range's slabs over its row tile, dealt in
    launch order to the slot that frees first, but no sooner than HBM
    delivers x and w once; plus the reduction of a split run."""
    full, bn, bk, stages = TMA_TILE[dtype]
    nk = -(-k // bk)
    slabs = -(-nk // splits)
    splits = -(-nk // slabs)
    skip = splits > 1 and dtype == torch.float32
    size = _SIZE[dtype]
    blocks = blocks_per_sm(dtype, bm)
    row_tiles, col_tiles = -(-n // bm), -(-m // bn)
    # the share of the streamed bytes that first come from HBM: w is read
    # by every row tile and x by every column tile, the rest hit L2
    first = (n * k + k * m) / (row_tiles * k * m + col_tiles * k * n)
    latency_us = first * HBM_LATENCY_US + (1 - first) * L2_LATENCY_US

    def cta_us(rows: int, depth: int) -> float:
        flops = 2 * (rows if skip else bm) * bn * bk / (SM_FLOPS[dtype, bm] / blocks) * 1e6
        nbytes = (bn + rows) * bk * size / (SM_BYTES_S / blocks) * 1e6
        return CTA_US + latency_us + depth * max(flops, nbytes, latency_us * blocks / stages)

    free = [0.0] * (SMS * blocks)  # a heap of the slots' next free times
    for z in range(splits):
        depth = min(slabs, nk - z * slabs)
        for row0 in range(0, n, bm):
            us = cta_us(min(bm, n - row0), depth)
            for _ in range(col_tiles):
                heapq.heapreplace(free, free[0] + us)
    us = max(max(free), (n * k + k * m) * size / HBM_BYTES_S * 1e6)
    if splits > 1:
        us += REDUCE_US + (2 * splits * 4 + size) * n * m / HBM_BYTES_S * 1e6
    return us


def whole_splits(nk: int, most: int) -> list[int]:
    """The split counts up to ``most`` whose ranges of ``nk`` slabs are all
    full-depth but the last (each count once)."""
    return [s for s in range(1, min(nk, most) + 1) if -(-nk // -(-nk // s)) == s]


def tile_and_split(n: int, k: int, m: int, dtype) -> tuple[int, int]:
    """The tile rows and split count of an MN-major product: the pair with
    the least :func:`model_us` (a split counted SPLIT_GAIN_US dearer; the
    full tile, then the fewest splits, on a tie), ``(128, 1)`` (the TMA
    plan) where the full-tile grid alone fills the SMs. Ranges hold whole
    slabs and none is empty."""
    full, bn, bk, _ = TMA_TILE[dtype]
    if -(-m // bn) * -(-n // full) >= SMS:
        return full, 1
    nk = -(-k // bk)
    best, best_us = (full, 1), model_us(n, k, m, dtype, full, 1)
    for bm in (full, HALF_BM):
        tiles = -(-m // bn) * -(-n // bm)
        for splits in whole_splits(nk, min(MAX_SPLITS, MAX_WAVES * SMS * blocks_per_sm(dtype, bm) // tiles)):
            us = model_us(n, k, m, dtype, bm, splits) + (SPLIT_GAIN_US if splits > 1 else 0.0)
            if us < best_us:
                best, best_us = (bm, splits), us
    return best


def plan_uncached(n: int, k: int, m: int, dtype, b_major: str, aligned: bool) -> GemmPlan:
    """:func:`gemm_plan` without its cache, from whether every operand
    pointer is 16-byte aligned."""
    if b_major not in ("k", "mn"):
        raise ValueError(f"gemm_plan: b_major {b_major!r}; want 'k' or 'mn'")
    if aligned and _tma_shape_ok(n, k, m, dtype, b_major):
        bm, bn, bk, stages = TMA_TILE[dtype]
        nk = -(-k // bk)
        splits = 1
        if b_major == "mn":
            bm, splits = tile_and_split(n, k, m, dtype)
        grid = (-(-m // bn), -(-n // bm))
        if splits > 1:
            return GemmPlan("splitk", bm, bn, bk, stages, grid, TMA_THREADS, tma_smem(dtype, bm), splits,
                            -(-nk // splits))
        return GemmPlan("tma", bm, bn, bk, stages, grid, TMA_THREADS, tma_smem(dtype, bm), 1, nk)
    bm, bn, bk, stages = SIMT_TILE
    smem = stages * (bm + bn) * bk * 4 + EPI_PARAMS * bn * 4
    return GemmPlan("simt", bm, bn, bk, stages, (-(-m // bn), -(-n // bm)), SIMT_THREADS, smem, 1, -(-k // bk))


_cached_plan = functools.lru_cache(maxsize=4096)(plan_uncached)


def gemm_plan(n: int, k: int, m: int, dtype, b_major: str, ptrs) -> GemmPlan:
    """The plan of ``[n, k] @ B -> [n, m]`` in ``dtype`` (float32 or
    bfloat16), B laid out as ``b_major`` ("k" or "mn"); ``ptrs`` are the
    operands' data pointers (ints), each of which must be 16-byte aligned
    for the TMA and split routes."""
    return _cached_plan(n, k, m, dtype, b_major, all(p % ALIGN == 0 for p in ptrs))

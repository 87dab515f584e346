"""The launch plan of the GEMM core that kernels 1 and 3 share
(``ops.gemm_plan.gemm_plan``): which route a product takes, its tile,
stages, grid and shared memory, decided from the shape, the dtype and the
operands' alignment alone. Pure arithmetic: it runs on the CPU, with no
kernel and no card.
"""

import pytest
import torch

from tfkaldi_tpu_torch.ops import gemm_plan as gp
from tfkaldi_tpu_torch.ops.gemm_plan import gemm_plan

CD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SIZE = {"float32": 4, "bfloat16": 2}
ALIGNED = (1 << 20, 3 << 20)  # two 16-byte aligned base addresses
SMEM_PER_CTA = 232_448  # a Hopper block's shared memory


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8192, 65536])
@pytest.mark.parametrize("k", [440, 2048])
def test_recipe_ffn_shapes_take_tma(cd, n, k):
    """Kernel 1 at the recipe's layers: x [N, 440 | 2048] @ w [K, 2048],
    decode batches of 8192 rows and validation batches of 65,536."""
    assert gemm_plan(n, k, 2048, CD[cd], "mn", ALIGNED).route == "tma"


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_out", [440, 2048])
def test_recipe_bn_dgrad_shapes_take_tma(cd, k_out):
    """Kernel 3's product dh = dz [65536, 2048] @ w^T, w [440 | 2048, 2048]."""
    assert gemm_plan(65536, 2048, k_out, CD[cd], "k", ALIGNED).route == "tma"


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,m,b_major", [
    (300, 440, 257, "mn"),  # kernel 1: w's row pitch of 257 elements
    (129, 7, 5, "mn"),  # kernel 1: x's row pitch of 7 elements
    (300, 257, 129, "k"),  # kernel 3: dz's and w's row pitch of 257
    (131, 7, 5, "k"),
])
def test_card_tests_edge_shapes_take_simt(cd, n, k, m, b_major):
    """The card tests' odd shapes (tests/test_torch_cuda_kernels.py) keep the
    SIMT edge route: TMA needs row pitches that are multiples of 16 bytes."""
    plan = gemm_plan(n, k, m, CD[cd], b_major, ALIGNED)
    assert plan.route == "simt" and plan.code == 0
    assert (plan.bm, plan.bn, plan.bk, plan.stages, plan.threads) == (128, 128, 8, 2, 256)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", [0, 1])
def test_view_offset_by_two_elements_is_refused(cd, which):
    """A view that starts 2 elements into an aligned buffer (8 bytes in f32,
    4 in bf16) cannot be a TMA base address, whichever operand it is."""
    ptrs = list(ALIGNED)
    ptrs[which] += 2 * SIZE[cd]
    assert gemm_plan(8192, 2048, 2048, CD[cd], "mn", ptrs).route == "simt"
    # a real tensor view: torch.empty is aligned, [2:] is not
    base = torch.empty(4 * 64 + 2, dtype=CD[cd])
    view = base[2:].view(4, 64)
    assert base.data_ptr() % 16 == 0 and view.data_ptr() % 16 != 0
    assert gemm_plan(4, 64, 256, CD[cd], "k", (view.data_ptr(), ALIGNED[1])).route == "simt"
    assert gemm_plan(4, 64, 256, CD[cd], "k", (base.data_ptr(), ALIGNED[1])).route == "tma"


@pytest.mark.parametrize("cd,k,m,b_major,route", [
    ("float32", 442, 2048, "mn", "simt"),  # 1768-byte A rows
    ("float32", 444, 2048, "mn", "tma"),  # 1776 = 111 x 16
    ("bfloat16", 444, 2048, "mn", "simt"),  # 888-byte rows
    ("bfloat16", 448, 2048, "mn", "tma"),
    ("float32", 2048, 2001, "mn", "simt"),  # an MN-major B's pitch is m
    ("float32", 2048, 2001, "k", "tma"),  # a K-major B's pitch is k
    ("bfloat16", 2048, 2000, "mn", "tma"),  # the output layer's width
])
def test_row_pitch_rule(cd, k, m, b_major, route):
    assert gemm_plan(1024, k, m, CD[cd], b_major, ALIGNED).route == route


@pytest.mark.parametrize("cd,tile,smem", [
    # ring 4 x (A [128, 64] + B [256, 64]) bf16 + 8 barriers + [3, 256] f32 + 1024 alignment slack
    ("bfloat16", (128, 256, 64, 4), 4 * (128 + 256) * 64 * 2 + 64 + 3 * 256 * 4 + 1024),
    # ring 4 x (A [128, 32] + B [128, 32]) f32 + 8 barriers + [3, 128] f32 + 1024
    ("float32", (128, 128, 32, 4), 4 * (128 + 128) * 32 * 4 + 64 + 3 * 128 * 4 + 1024),
])
def test_tma_tile_stages_and_shared_memory(cd, tile, smem):
    plan = gemm_plan(8192, 2048, 2048, CD[cd], "mn", ALIGNED)
    assert (plan.bm, plan.bn, plan.bk, plan.stages) == tile
    assert plan.threads == 384  # a producer warpgroup, two consumer warpgroups
    assert plan.smem_bytes == gp.tma_smem(CD[cd]) == smem
    assert plan.smem_bytes <= SMEM_PER_CTA
    # a stage's depth is one 128-byte swizzle row of the operand type
    assert plan.bk * SIZE[cd] == 128


@pytest.mark.parametrize("n,k,m,cd,b_major,grid", [
    (8192, 2048, 2048, "bfloat16", "mn", (8, 64)),  # 128 x 256 tiles
    (8192, 440, 2048, "float32", "mn", (16, 64)),  # 128 x 128 tiles
    (65536, 2048, 440, "bfloat16", "k", (2, 512)),  # 440 columns: two 256-wide tiles
    (65536, 2048, 2048, "float32", "k", (16, 512)),
    (300, 440, 257, "float32", "mn", (3, 3)),  # SIMT: 128 x 128
    (1, 2048, 2048, "bfloat16", "mn", (8, 1)),
])
def test_grid(n, k, m, cd, b_major, grid):
    assert gemm_plan(n, k, m, CD[cd], b_major, ALIGNED).grid == grid


def test_every_tma_plan_is_launchable():
    """Over a sweep of shapes, a TMA plan always has every pitch a multiple
    of 16 bytes, fits a block's shared memory, and covers the output."""
    for cd in CD.values():
        size = SIZE["float32" if cd == torch.float32 else "bfloat16"]
        for n in (1, 127, 128, 129, 8192, 65537):
            for k in (1, 8, 440, 2048, 2050):
                for m in (1, 8, 257, 440, 2000, 2048):
                    for b_major in ("k", "mn"):
                        plan = gemm_plan(n, k, m, cd, b_major, ALIGNED)
                        if plan.route == "simt":
                            continue
                        assert (k * size) % 16 == 0
                        assert ((k if b_major == "k" else m) * size) % 16 == 0
                        assert plan.smem_bytes <= SMEM_PER_CTA
                        assert plan.grid[0] * plan.bn >= m and plan.grid[1] * plan.bm >= n


def test_bad_layout_raises():
    with pytest.raises(ValueError):
        gemm_plan(8, 8, 8, torch.float32, "nk", ALIGNED)

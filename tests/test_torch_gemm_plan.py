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
    """At a batch whose TMA grid fills the card (a smaller one may split
    K: the split route has the TMA route's pitch rule)."""
    assert gemm_plan(8192, k, m, CD[cd], b_major, ALIGNED).route == route


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


# ---- the split-K route (kernel 1 below one wave of tiles) ----

STREAM_ROWS = (8, 16, 64, 72, 600)  # the streamed DNN's B x T_pad (OnlineSplicedDecoder, T padded to 8)
GATE_SHAPES = ((2048, 48, 64), (2048, 64, 64))  # the hybrid held-out gate's layers


def _today_tma(n, k, m, cd):
    """The TMA plan as it stood before the split route, field for field."""
    bm, bn, bk, stages = gp.TMA_TILE[cd]
    return (("tma", bm, bn, bk, stages, (-(-m // bn), -(-n // bm)), 384, gp.tma_smem(cd)))


def _fields(plan):
    return (plan.route, plan.bm, plan.bn, plan.bk, plan.stages, plan.grid, plan.threads, plan.smem_bytes)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8192, 16384, 65536])
@pytest.mark.parametrize("k", [440, 2048])
def test_recipe_shapes_keep_todays_tma_plan(cd, n, k):
    """The recipe's kernel-1 layers (decode 8192, the flagship's 16,384
    validation rows, validation 65,536) and kernel 3's products at the same
    rows fill the card: the TMA plan as before, one range of all of K."""
    for b_major, shape in (("mn", (n, k, 2048)), ("k", (n, 2048, k)), ("k", (n, 1024, k))):
        plan = gemm_plan(*shape, CD[cd], b_major, ALIGNED)
        assert _fields(plan) == _today_tma(*shape, CD[cd])
        assert plan.splits == 1 and plan.k_ranges(shape[1]) == [(0, shape[1])]
        assert plan.workspace_shape(shape[0], shape[2]) is None


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 8, 13, 64, 600, 2048, 8192])
@pytest.mark.parametrize("k", [440, 2048])
def test_kernel3_never_splits(cd, n, k):
    """Kernel 3's K-major products keep the TMA plan at any row count: the
    split route is kernel 1's (the C entry refuses route 2 for a K-major
    B)."""
    for k_out in (440, 2048):
        plan = gemm_plan(n, k, k_out, CD[cd], "k", ALIGNED)
        assert _fields(plan) == _today_tma(n, k, k_out, CD[cd])


def _check_split(plan, n, k, m, cd):
    full, bn, bk, stages = gp.TMA_TILE[CD[cd]]
    bm = plan.bm
    assert plan.code == 2 and plan.splits >= 2 and bm in (full, gp.HALF_BM)
    assert (plan.bn, plan.bk, plan.stages, plan.threads) == (bn, bk, stages, 384)
    assert plan.grid == (-(-m // bn), -(-n // bm))  # the TMA route's tiles, K on grid z
    assert plan.ctas == plan.grid[0] * plan.grid[1] * plan.splits
    assert plan.smem_bytes == gp.tma_smem(CD[cd], bm) < SMEM_PER_CTA
    ranges = plan.k_ranges(k)
    # the splits partition [0, K) once, in whole slabs, none empty
    assert ranges[0][0] == 0 and ranges[-1][1] == k and len(ranges) == plan.splits
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(0 < k1 - k0 <= plan.slabs * bk and k0 % bk == 0 for k0, k1 in ranges)
    assert plan.workspace_shape(n, m) == (plan.splits, n, m)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", STREAM_ROWS + (1, 13))
@pytest.mark.parametrize("k", [440, 2048])
def test_streaming_rows_plan(cd, n, k):
    """Kernel 1 at the streamed DNN's rows: the TMA grid puts 8-80 CTAs
    on 132 SMs. Where the model finds a split faster, the plan splits K so
    that the CTAs fill the card in one or two waves, each streaming a
    disjoint slice of w; else it keeps the TMA plan."""
    m = 2048
    plan = gemm_plan(n, k, m, CD[cd], "mn", ALIGNED)
    today = _today_tma(n, k, m, CD[cd])
    tma_ctas = today[5][0] * today[5][1]
    assert tma_ctas < gp.SMS
    assert gp.tile_and_split(n, k, m, CD[cd]) == (plan.bm, plan.splits)
    if plan.route == "tma":
        if plan.bm == today[1]:
            assert _fields(plan) == today
        else:  # the half tile: twice the row tiles, its own ring
            assert plan.grid == (today[5][0], -(-n // gp.HALF_BM)) and plan.smem_bytes == gp.tma_smem(CD[cd], 64)
        return
    _check_split(plan, n, k, m, cd)
    assert plan.ctas >= 2 * tma_ctas
    model = gp.model_us(n, k, m, CD[cd], plan.bm, plan.splits)
    assert model + gp.SPLIT_GAIN_US < gp.model_us(n, k, m, CD[cd], today[1], 1)


# The plans at the streamed rows and the gate's layers: (dtype, n, k, m,
# route, tile rows, grid, splits). Each is the cheapest tile and split
# count in the device times of an H100 run (a split counted
# gemm_plan.SPLIT_GAIN_US dearer, the host's cost of its second launch),
# or within 13% of it (PERF.md §6, profile_ffn --sweep / --calibrate):
# the 64-row half tile on the TMA route for bf16 at K 440 and
# n 600 and for the gate's layers (twice the CTAs, no second launch); the
# half tile split for f32 n 600 and bf16 K 2048 at n <= 72.
CALIBRATED = [
    ("float32", 8, 440, 2048, "splitk", 128, (16, 1), 7),
    ("float32", 16, 440, 2048, "splitk", 128, (16, 1), 7),
    ("float32", 64, 440, 2048, "splitk", 128, (16, 1), 7),
    ("float32", 72, 440, 2048, "splitk", 128, (16, 1), 7),
    ("float32", 600, 440, 2048, "tma", 64, (16, 10), 1),
    ("float32", 8, 2048, 2048, "splitk", 128, (16, 1), 8),
    ("float32", 16, 2048, 2048, "splitk", 128, (16, 1), 8),
    ("float32", 64, 2048, 2048, "splitk", 64, (16, 1), 16),
    ("float32", 72, 2048, 2048, "splitk", 128, (16, 1), 8),
    ("float32", 600, 2048, 2048, "splitk", 64, (16, 10), 5),
    ("float32", 2048, 48, 64, "tma", 64, (1, 32), 1),
    ("float32", 2048, 64, 64, "tma", 64, (1, 32), 1),
    ("bfloat16", 8, 440, 2048, "tma", 64, (8, 1), 1),
    ("bfloat16", 16, 440, 2048, "tma", 64, (8, 1), 1),
    ("bfloat16", 64, 440, 2048, "tma", 64, (8, 1), 1),
    ("bfloat16", 72, 440, 2048, "tma", 64, (8, 2), 1),
    ("bfloat16", 600, 440, 2048, "tma", 64, (8, 10), 1),
    ("bfloat16", 8, 2048, 2048, "splitk", 64, (8, 1), 16),
    ("bfloat16", 16, 2048, 2048, "splitk", 64, (8, 1), 16),
    ("bfloat16", 64, 2048, 2048, "splitk", 64, (8, 1), 8),
    ("bfloat16", 72, 2048, 2048, "splitk", 64, (8, 2), 8),
    ("bfloat16", 600, 2048, 2048, "tma", 64, (8, 10), 1),
    ("bfloat16", 2048, 48, 64, "tma", 64, (1, 32), 1),
    ("bfloat16", 2048, 64, 64, "tma", 64, (1, 32), 1),
]


@pytest.mark.parametrize("cd,n,k,m,route,bm,grid,splits", CALIBRATED)
def test_streamed_and_gate_shapes_take_the_measured_plan(cd, n, k, m, route, bm, grid, splits):
    """Route, tile, grid and split count at each shape the card tests
    (tests/test_torch_cuda_kernels.py) and chip_smoke.py's kernel table
    give kernel 1 below one wave of tiles."""
    plan = gemm_plan(n, k, m, CD[cd], "mn", ALIGNED)
    assert (plan.route, plan.bm, plan.grid, plan.splits) == (route, bm, grid, splits)
    if route == "splitk":
        _check_split(plan, n, k, m, cd)
        assert plan.ctas >= 32 and plan.ctas <= 5 * gp.SMS * gp.blocks_per_sm(CD[cd], bm)
    else:
        assert plan.smem_bytes == gp.tma_smem(CD[cd], bm) and plan.slabs == -(-k // plan.bk)
        assert plan.k_ranges(k) == [(0, k)] and plan.workspace_shape(n, m) is None


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,m", GATE_SHAPES)
def test_gate_narrow_layers_plan(cd, n, k, m):
    """The hybrid gate's [2048, 48 | 64] @ [., 64]: one column tile of 16
    full row tiles, K of two f32 slabs (one bf16 slab). The half tile
    doubles the CTAs; a split would save less device time than its
    second launch costs the host."""
    plan = gemm_plan(n, k, m, CD[cd], "mn", ALIGNED)
    assert (plan.route, plan.bm, plan.splits) == ("tma", gp.HALF_BM, 1)
    assert plan.grid == (1, 32) and plan.ctas == 32
    assert gp.tile_and_split(n, k, m, CD[cd]) == (gp.HALF_BM, 1)


def test_every_split_plan_partitions_k():
    """Over a sweep of MN-major shapes: a split plan or the half tile only
    where the full-tile TMA grid leaves SMs idle, every range of K whole and
    non-empty."""
    for cd in ("float32", "bfloat16"):
        full, bn = gp.TMA_TILE[CD[cd]][:2]
        for n in (1, 7, 8, 100, 128, 129, 300, 600, 1000, 2048):
            for k in (48, 64, 256, 440, 448, 1000, 2048, 4096):
                for m in (64, 256, 1024, 2048):
                    plan = gemm_plan(n, k, m, CD[cd], "mn", ALIGNED)
                    if plan.route == "simt":
                        continue
                    if plan.route == "splitk" or plan.bm != full:
                        assert -(-m // bn) * -(-n // full) < gp.SMS
                    if plan.route == "splitk":
                        _check_split(plan, n, k, m, cd)
                    else:
                        assert plan.grid == (-(-m // bn), -(-n // plan.bm)) and plan.splits == 1


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(8, 2048), (72, 440), (600, 2048)])
def test_misaligned_streaming_view_keeps_simt(cd, n, k):
    """A view two elements into its buffer cannot be a TMA base address:
    the streamed rows then keep the SIMT edge route, not the split one."""
    ptrs = (ALIGNED[0] + 2 * SIZE[cd], ALIGNED[1])
    plan = gemm_plan(n, k, 2048, CD[cd], "mn", ptrs)
    assert plan.route == "simt" and plan.splits == 1 and plan.workspace_shape(n, 2048) is None


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,m,b_major", [(8, 2048, 2048, "mn"), (600, 440, 2048, "mn"), (2048, 48, 64, "mn"),
                                           (8192, 2048, 2048, "mn"), (65536, 2048, 440, "k"), (300, 440, 257, "mn")])
def test_cached_plan_equals_a_fresh_one(cd, n, k, m, b_major):
    """``gemm_plan`` caches on (shape, dtype, layout, alignment): a second
    call returns the same object, equal to a plan made afresh."""
    first = gemm_plan(n, k, m, CD[cd], b_major, ALIGNED)
    assert gemm_plan(n, k, m, CD[cd], b_major, (ALIGNED[1], ALIGNED[0])) is first
    assert first == gp.plan_uncached(n, k, m, CD[cd], b_major, True)
    assert gemm_plan(n, k, m, CD[cd], b_major, (ALIGNED[0] + 4, ALIGNED[1])) == gp.plan_uncached(
        n, k, m, CD[cd], b_major, False)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """Without a card, kernel 1's wrapper runs ``fused_ffn_block_ref`` on
    CPU tensors, plans nothing and launches nothing, at the streamed rows
    as at any other shape."""
    from tfkaldi_tpu_torch.ops import fused_mlp

    calls = []
    plain = fused_mlp.fused_ffn_block_ref

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    def no_plan(*args):
        raise AssertionError("a CPU call planned a launch")

    monkeypatch.setattr(fused_mlp, "fused_ffn_block_ref", spy)
    monkeypatch.setattr(fused_mlp, "gemm_plan", no_plan)
    gen = torch.Generator().manual_seed(0)
    before, by_route = fused_mlp.launches, dict(fused_mlp.launches_by_route)
    for n, k, m in ((8, 440, 64), (72, 64, 96), (13, 48, 64)):
        x, w = torch.randn(n, k, generator=gen), torch.randn(k, m, generator=gen)
        b, scale, shift = torch.randn(m, generator=gen), torch.rand(m, generator=gen), torch.randn(m, generator=gen)
        got = fused_mlp.fused_ffn_block(x, w, b, scale, shift)
        torch.testing.assert_close(got, torch.relu((x @ w + b) * scale + shift), rtol=1e-5, atol=1e-5)
    assert calls == [(8, 440), (72, 64), (13, 48)]
    assert fused_mlp.launches == before and fused_mlp.launches_by_route == by_route


# ---- the half tile (64 rows) ----


@pytest.mark.parametrize("cd,ring", [
    # 4 x (A [64, 32] + B [128, 32]) f32: two blocks an SM
    ("float32", 4 * (64 + 128) * 32 * 4),
    # 4 x (A [64, 64] + B [256, 64]) bf16: one block an SM
    ("bfloat16", 4 * (64 + 256) * 64 * 2),
])
def test_half_tile_shared_memory_and_blocks(cd, ring):
    """The half tile's ring holds A's 64 rows; the f32 half tile's blocks
    fit two to an SM, each with its 1 KB reserve, the others one."""
    bn = gp.TMA_TILE[CD[cd]][1]
    smem = gp.tma_smem(CD[cd], gp.HALF_BM)
    assert smem == ring + 64 + 3 * bn * 4 + 1024
    blocks = gp.blocks_per_sm(CD[cd], gp.HALF_BM)
    assert blocks == (2 if cd == "float32" else 1)
    assert blocks * (smem + 1024) <= gp.SMEM_PER_SM
    assert gp.blocks_per_sm(CD[cd], gp.TMA_TILE[CD[cd]][0]) == 1
    # A's box of 64 rows keeps B's boxes on the 1024-byte swizzle period
    assert (gp.HALF_BM * 128) % 1024 == 0


@pytest.mark.parametrize("nk,most,want", [
    (64, 8, [1, 2, 3, 4, 5, 6, 7, 8]),  # f32 K 2048: 64 slabs of 32
    (14, 14, [1, 2, 3, 4, 5, 7, 14]),  # f32 K 440: 6 ranges of 3 slabs would be 5 (one empty)
    (7, 32, [1, 2, 3, 4, 7]),  # bf16 K 440
    (2, 32, [1, 2]),  # the gate's f32 K 48 | 64
])
def test_whole_splits(nk, most, want):
    """A split count is weighed only once, where every range but the last
    holds ceil(nk / splits) slabs and none is empty."""
    assert gp.whole_splits(nk, most) == want
    for s in want:
        slabs = -(-nk // s)
        assert (s - 1) * slabs < nk <= s * slabs


def test_split_workspace_is_kept_per_stream(monkeypatch):
    """The wrapper's split workspace: one buffer a (device, stream), reused
    while large enough and replaced by a larger one when not."""
    from tfkaldi_tpu_torch.ops import fused_mlp

    monkeypatch.setattr(fused_mlp, "_workspaces", {})
    cpu = torch.device("cpu")
    first = fused_mlp._workspace(cpu, 7, 1000)
    assert fused_mlp._workspace(cpu, 7, 600) == first
    other = fused_mlp._workspace(cpu, 8, 600)
    assert other != first and len(fused_mlp._workspaces) == 2
    grown = fused_mlp._workspace(cpu, 7, 5000)
    assert fused_mlp._workspaces[(None, 7)].numel() == 5000 and grown == fused_mlp._workspaces[(None, 7)].data_ptr()
    assert fused_mlp._workspaces[(None, 7)].dtype == torch.float32

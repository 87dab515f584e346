"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips (inside the ``cuda`` fixture) when ``torch.cuda.is_available()`` is
false, as on a CPU-only machine. The file imports no JAX, so it runs where
the GPU is but JAX is not:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q -m cuda

Tolerances: f32 FFN 1e-4 absolute on O(1..10) outputs (both sides are full
f32 contractions in a different order; TF32 is off); bf16 FFN one bf16
rounding step at the outputs' magnitude (< 16, so 0.0625); framing
bit-equal (both round ``x - c*prev`` twice in f64, no FMA). BN backward
(kernel 3): dz bit-equal (the same f32 operations in the same order, no
FMA contraction), dh within 1e-5 of max|ref| in f32 (sums in another
order) and one bf16 step (2^-7 of max|ref|) in bf16.

Kernels 1 and 3 run their products on the GEMM core of
``csrc/gemm_sm90.cuh``; each case names the route ``ops.gemm_plan`` gives
its shape (``tma``: TMA + wgmma for bf16, TMA + FMA for f32; ``splitk``:
kernel 1 below one wave of tiles, K split over grid z and the partials
summed in a fixed order, so a repeat call is bit-equal; ``simt``: the
edge route for row pitches that are not multiples of 16 bytes, or
misaligned views) and asserts that the launch was counted on it. Kernel 1
reads w as an MN-major B, kernel 3 reads w as a K-major B. Kernel 2's
cases name the route ``ops.frame_preemph.frame_plan`` gives them (``bulk``:
cp.async.bulk staging and 16-byte stores; ``edge``: odd frame length, odd
S, a misaligned view) and assert the launch was counted on it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
from tfkaldi_tpu_torch.models.dnn import DNN, DNNConfig
from tfkaldi_tpu_torch.ops import bn_fused_bwd
from tfkaldi_tpu_torch.ops import frame_preemph as fp
from tfkaldi_tpu_torch.ops import fused_mlp
from tfkaldi_tpu_torch.ops.gemm_plan import gemm_plan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tfkaldi_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _ffn_operands(seed, n, k, m, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, k, generator=g)
    w = torch.randn(k, m, generator=g) / k ** 0.5
    b, scale, shift = torch.randn(m, generator=g) * 0.1, torch.rand(m, generator=g) + 0.5, torch.randn(m, generator=g) * 0.1
    return [t.to(device) for t in (x, w, b, scale, shift)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.0625)])
@pytest.mark.parametrize("n,k,m,route", [
    (300, 440, 257, "simt"), (129, 7, 5, "simt"),
    (1024, 2048, 2000, "tma"),  # ragged N: 2000 columns of 128- / 256-wide tiles
    (1000, 440, 2048, "tma"),  # ragged rows and depth (440 = 6.9 bf16 / 13.75 f32 stages)
    (128, 64, 256, "tma"),  # one tile, one stage
    # the recipe's layers: the served path's decode batches (8,192 rows) and
    # the training paths' validation batches (128 x 512 frames), on whole
    # 128-row tiles
    (8192, 440, 2048, "tma128"), (8192, 2048, 2048, "tma128"),
    (65536, 440, 2048, "tma128"), (65536, 2048, 2048, "tma128"),
])
@pytest.mark.parametrize("affine,relu", [(True, True), (False, False)])
def test_fused_ffn_matches_plain(cuda, dtype, tol, n, k, m, route, affine, relu):
    """``route`` is the TMA core's route (``tma128``: on 128-row tiles);
    where the TMA grid leaves SMs idle the plan may split K (``splitk``,
    the route its plan names)."""
    x, w, b, scale, shift = _ffn_operands(n + k + m, n, k, m, cuda)
    x, w = x.to(dtype), w.to(dtype)
    if not affine:
        scale = shift = None
    plan = gemm_plan(n, k, m, dtype, "mn", (x.data_ptr(), w.data_ptr()))
    if route == "tma128":
        assert (plan.route, plan.bm) == ("tma", 128)
        route = "tma"
    assert plan.route == route or (route, plan.route) == ("tma", "splitk")
    route = plan.route
    before, by_route = fused_mlp.launches, dict(fused_mlp.launches_by_route)
    got = fused_mlp.fused_ffn_block(x, w, b, scale, shift, relu=relu)
    want = fused_mlp.fused_ffn_block_ref(x, w, b, scale, shift, relu=relu)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert fused_mlp.launches_by_route == {**by_route, route: by_route[route] + 1}
    assert got.dtype == dtype and got.shape == (n, m)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.0625)])
@pytest.mark.parametrize("n", [1, 8, 13, 16, 64, 72, 600])
@pytest.mark.parametrize("k", [440, 2048])
def test_fused_ffn_streaming_rows(cuda, dtype, tol, n, k):
    """The streamed DNN's hidden layers (``OnlineSplicedDecoder``: B x T_pad
    rows, T padded to 8; 1 and 13 rows off that grid): fewer rows than one
    128-row tile, or a ragged last tile, on the route the plan names
    (``splitk`` where splitting K beats the TMA grid's few CTAs, else
    ``tma``): the tile's rows past n read as zeros and are not stored. The
    planned call twice: on the split route the two are bit-equal."""
    x, w, b, scale, shift = _ffn_operands(n + k, n, k, 2048, cuda)
    x, w = x.to(dtype), w.to(dtype)
    route = gemm_plan(n, k, 2048, dtype, "mn", (x.data_ptr(), w.data_ptr())).route
    assert route in ("splitk", "tma")
    before = dict(fused_mlp.launches_by_route)
    got = fused_mlp.fused_ffn_block(x, w, b, scale, shift)
    again = fused_mlp.fused_ffn_block(x, w, b, scale, shift)
    want = fused_mlp.fused_ffn_block_ref(x, w, b, scale, shift)
    torch.cuda.synchronize()
    assert fused_mlp.launches_by_route == {**before, route: before[route] + 2}
    assert got.shape == (n, 2048) and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert route != "splitk" or torch.equal(got, again)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.0625)])
@pytest.mark.parametrize("n,k,m", [(2048, 48, 64), (2048, 64, 64), (2048, 440, 2048), (2048, 2048, 2048),
                                   (16384, 2048, 2048)])
def test_fused_ffn_gate_narrow_layers(cuda, dtype, tol, n, k, m):
    """The held-out gates' layers without the BN affine: the hybrid gate's
    two (16 utterances x 128 frames, 16-dim spliced input, 64 units: one
    column tile), and the flagship gate's first and inner layers at its 16
    decode utterances and its 128 validation utterances (x the 128-frame
    bucket); each on the route the plan names."""
    x, w, b, _, _ = _ffn_operands(n + k + m, n, k, m, cuda)
    x, w = x.to(dtype), w.to(dtype)
    route = gemm_plan(n, k, m, dtype, "mn", (x.data_ptr(), w.data_ptr())).route
    before = dict(fused_mlp.launches_by_route)
    got = fused_mlp.fused_ffn_block(x, w, b, None, None)
    want = fused_mlp.fused_ffn_block_ref(x, w, b, None, None)
    torch.cuda.synchronize()
    assert fused_mlp.launches_by_route == {**before, route: before[route] + 1}
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", [(8, 2048), (72, 2048), (600, 2048), (13, 440)])
def test_fused_ffn_splitk_repeat_is_bit_equal(cuda, dtype, n, k):
    """The split route sums its f32 partials in a fixed split order, with
    no atomics: two calls on the same inputs give the same bits, on the
    128-row tile and on the 64-row half tile. Also every tile and split
    count of the shape agrees with the plain version."""
    from tfkaldi_tpu_torch.profile_ffn import variant

    x, w, b, scale, shift = _ffn_operands(n * k, n, k, 2048, cuda)
    x, w = x.to(dtype), w.to(dtype)
    plan = gemm_plan(n, k, 2048, dtype, "mn", (x.data_ptr(), w.data_ptr()))
    assert plan.route in ("splitk", "tma")
    want = fused_mlp.fused_ffn_block_ref(x, w, b, scale, shift)
    tol = 1e-4 if dtype == torch.float32 else 0.0625
    nk = -(-k // plan.bk)
    for bm in (128, 64):
        split = variant(plan, n, k, dtype, bm, max(2, plan.splits))
        first = fused_mlp.launch(split, x, w, b, scale, shift)
        second = fused_mlp.launch(split, x, w, b, scale, shift)
        torch.cuda.synchronize()
        assert torch.equal(first, second), bm
        for splits in (1, 2, 3, plan.splits, nk):
            got = fused_mlp.launch(variant(plan, n, k, dtype, bm, splits), x, w, b, scale, shift)
            torch.cuda.synchronize()
            assert (got.float() - want.float()).abs().max().item() <= tol, (bm, splits)


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_plan_matches_the_source(cuda, dtype, bm):
    """The plan's shared memory and blocks an SM on each tile are the ones
    the source sets for it (``tk_gemm_smem``, ``tk_gemm_blocks_per_sm``):
    at the recipe's shapes for kernels 1 and 3, and at a streamed row
    count, whose split route keeps the TMA route's blocks."""
    from tfkaldi_tpu_torch.ops import _build
    from tfkaldi_tpu_torch.ops.gemm_plan import blocks_per_sm, plan_uncached

    lib, bf16 = _build.load(), int(dtype == torch.bfloat16)
    assert blocks_per_sm(dtype, bm) == lib.tk_gemm_blocks_per_sm(bf16, bm)
    for n, k, m, major in ((8192, 2048, 2048, "mn"), (65536, 440, 2048, "mn"), (65536, 2048, 2048, "k"),
                           (600, 2048, 2048, "mn"), (8, 440, 2048, "mn")):
        plan = plan_uncached(n, k, m, dtype, major, True)
        if plan.bm == bm:
            assert plan.smem_bytes == lib.tk_gemm_smem(bf16, bm), (n, k, m, major)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.0625)])
def test_fused_ffn_misaligned_view_takes_simt(cuda, dtype, tol):
    """x starting 2 elements into its buffer cannot be a TMA base address:
    the same product runs on the SIMT route and agrees."""
    x, w, b, scale, shift = _ffn_operands(7, 256, 64, 256, cuda)
    buf = torch.empty(256 * 64 + 2, device=cuda, dtype=dtype)
    view = buf[2:].view(256, 64)
    view.copy_(x)
    before = fused_mlp.launches_by_route["simt"]
    got = fused_mlp.fused_ffn_block(view, w.to(dtype), b, scale, shift)
    want = fused_mlp.fused_ffn_block_ref(x.to(dtype), w.to(dtype), b, scale, shift)
    torch.cuda.synchronize()
    assert fused_mlp.launches_by_route["simt"] == before + 1
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_fused_ffn_rejects_mixed_dtypes(cuda):
    x, w, b, _, _ = _ffn_operands(0, 8, 8, 8, cuda)
    with pytest.raises(TypeError):
        fused_mlp.fused_ffn_block(x, w.bfloat16(), b)


FRAME_CASES = {
    # name: (b, s, wl, ws, t_max, preemph, eff lengths (None: s - 137 i), route, forced plan fields)
    "bulk": (4, 4000, 400, 160, 23, 0.97, None, "bulk", {}),
    "bulk_past_end": (2, 1000, 400, 160, 5, 0.97, None, "bulk", {}),
    "bulk_preemph_zero": (2, 2000, 400, 160, 11, 0.0, None, "bulk", {}),
    "bulk_eff_len_zero": (3, 4000, 400, 160, 23, 0.97, [0, 4000, 17], "bulk", {}),
    "bulk_s_below_wl": (2, 300, 400, 160, 1, 0.97, [300, 251], "bulk", {}),
    "bulk_t_max_one": (2, 400, 400, 160, 1, 0.97, [400, 399], "bulk", {}),
    "bulk_odd_step": (2, 4000, 400, 147, 25, 0.97, [4000, 1234], "bulk", {}),
    # many tiles a block: both staging buffers and their mbarrier phases turn over
    "bulk_persistent": (16, 80000, 400, 160, 498, 0.97, None, "bulk", {"frames": 1, "grid": 7}),
    "bulk_odd_frames": (4, 4000, 400, 160, 23, 0.97, None, "bulk", {"frames": 3}),
    "bulk_odd_frames_persistent": (16, 80000, 400, 160, 498, 0.97, None, "bulk", {"frames": 3, "grid": 5}),
    "edge_odd_wl": (2, 3000, 551, 220, 11, 0.97, [3000, 2013], "edge", {}),
    "edge_odd_s": (2, 4001, 400, 160, 23, 0.97, None, "edge", {}),
    "edge_offset_view": (4, 4000, 400, 160, 23, 0.97, None, "edge", {}),
    "edge_t_max_one": (2, 301, 400, 160, 1, 0.97, [301, 0], "edge", {}),
    "edge_persistent": (3, 4001, 400, 160, 23, 0.97, None, "edge", {"frames": 2, "grid": 2}),
    # the kernel table's batches: 16 x 5 s and 16 x 8 s at 16 kHz (the longest
    # bucket the served run pads to), planned, and one float into their buffer
    "bulk_5s": (16, 80000, 400, 160, 498, 0.97, None, "bulk", {}),
    "bulk_8s": (16, 128000, 400, 160, 798, 0.97, None, "bulk", {}),
    "edge_offset_view_5s": (16, 80000, 400, 160, 498, 0.97, None, "edge", {}),
    "edge_offset_view_8s": (16, 128000, 400, 160, 798, 0.97, None, "edge", {}),
}


@pytest.mark.parametrize("name", sorted(FRAME_CASES))
def test_frame_preemph_bit_equal_to_plain(cuda, name):
    """Kernel 2 on both routes at the plan's edge shapes, bit-equal to the
    plain version; the launch is counted on the route the plan names, and
    the plan's shared memory is the source's (``tk_frame_smem``)."""
    from tfkaldi_tpu_torch.ops import _build

    b, s, wl, ws, t_max, preemph, eff, route, force = FRAME_CASES[name]
    rng = np.random.default_rng(s)
    host = np.round(rng.standard_normal(b * s + 1) * 800).astype(np.float32)
    if name.startswith("edge_offset_view"):  # one sample into an aligned buffer
        sig = torch.from_numpy(host).to(cuda)[1:].view(b, s)
    else:
        sig = torch.from_numpy(host[: b * s]).to(cuda).view(b, s)
    eff = torch.tensor(eff if eff is not None else [s - 137 * i for i in range(b)], dtype=torch.int32, device=cuda)
    args = dict(preemph=preemph, frame_step=ws, frame_len=wl, t_max=t_max)
    force = dict(force)
    grid = force.pop("grid", None)
    plan = fp.plan_for(sig, torch.empty(b, t_max, wl, dtype=torch.float64, device=cuda), t_max, wl, ws, **force)
    if grid is not None:
        plan = dataclasses.replace(plan, grid=grid)
    assert plan.route == route
    assert plan.smem_bytes == _build.load().tk_frame_smem(wl, ws, plan.frames, plan.code)
    before, by_route = fp.launches, dict(fp.launches_by_route)
    got = fp.frame_preemph(sig, eff, **args, plan=plan if force or grid else None)
    want = fp.frame_preemph_ref(sig, eff, **args)
    torch.cuda.synchronize()
    assert fp.launches == before + 1
    assert fp.launches_by_route == {**by_route, route: by_route[route] + 1}
    assert got.shape == (b, t_max, wl) and got.dtype == torch.float64
    assert torch.equal(got, want)


def test_frame_preemph_refuses_a_plan_of_another_route(cuda):
    sig = torch.zeros(2, 4001, device=cuda)
    eff = torch.full((2,), 4001, dtype=torch.int32, device=cuda)
    bulk = fp.frame_plan(2, 4000, 23, 400, 160, (0, 0))
    with pytest.raises(ValueError, match="route"):
        fp.frame_preemph(sig, eff, preemph=0.97, frame_step=160, frame_len=400, t_max=23, plan=bulk)


@pytest.mark.parametrize("feature_type,dynamic", [("fbank", "nodelta"), ("mfcc", "ddelta")])
def test_features_on_card_match_cpu(cuda, feature_type, dynamic):
    """f64 on both sides (DGEMM order differs), cast to f32: <= 1e-6 in
    err / max(|ref|, 1)."""
    opts = FeatureOpts(feature_type=feature_type, dynamic=dynamic, nfilt=40 if feature_type == "fbank" else 23)
    rng = np.random.default_rng(1)
    lens = np.asarray([16000, 9000, 12345])
    batch = np.zeros((3, 16000), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = np.round(rng.standard_normal(n) * 4000)
    before = fp.launches
    got, nf = FeatureExtractor(opts, 16000, cuda)(batch, lens)
    want, nf_cpu = FeatureExtractor(opts, 16000, "cpu")(batch, lens)
    assert fp.launches == before + 1
    np.testing.assert_array_equal(nf, nf_cpu)
    got, want = got.cpu().numpy(), want.numpy()
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)) <= 1e-6


def test_dnn_on_card_matches_cpu(cuda):
    """Every hidden layer goes through the kernel on the card; logits agree
    with the CPU's plain versions to 1e-4."""
    cfg = DNNConfig(input_dim=440, num_labels=300, num_hidden_layers=3, num_hidden_units=512,
                    batch_norm=True)
    torch.manual_seed(0)
    model = DNN(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) / p.shape[0] ** 0.5)
        model.bn_mean.copy_(torch.randn_like(model.bn_mean) * 0.2)
        model.bn_var.copy_(torch.rand_like(model.bn_var) + 0.5)
    inputs = torch.randn(3, 200, 440)
    before = fused_mlp.launches
    with torch.inference_mode():
        want = model(inputs)
        got = model.to(cuda)(inputs.to(cuda))
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + cfg.num_hidden_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def _bn_operands(n, h, k, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    mask = (torch.rand(n, generator=g) > 0.25).float()
    mask[: min(n, 130)] = 0.0  # a whole 128-row tile of padding rows
    grad = torch.randn(n, h, generator=g) * mask[:, None]
    z = torch.randn(n, h, generator=g)
    w = torch.randn(k, h, generator=g) / h ** 0.5
    mean, beta = torch.randn(h, generator=g) * 0.1, torch.randn(h, generator=g) * 0.1
    r = torch.rand(h, generator=g) + 0.5
    c1, c2 = torch.randn(h, generator=g) * 0.01, torch.randn(h, generator=g) * 0.01
    grad, z = grad.to(dtype), z.to(dtype)
    return [t.to(device) for t in (grad, z, mask, w, mean, r, beta, c1, c2)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("n,h,k,route", [
    (300, 257, 129, "simt"), (131, 7, 5, "simt"),
    (1024, 2048, 440, "tma"),  # ragged N: 440 columns of dh
    (512, 256, 2048, "tma"),
    (1000, 64, 256, "tma"),  # ragged rows, one stage
    # the recipe's training step (128 x 512 frames; w [2048, 2048] and the
    # first layer's [440, 2048], whose launch is the dz pass alone), an
    # 8,192-row batch, and the held-out flagship's (128 x the 128-frame
    # bucket); the product on whole 128-row tiles
    (65536, 2048, 2048, "tma128"), (65536, 2048, 440, "tma128"), (8192, 2048, 2048, "tma128"),
    (16384, 2048, 2048, "tma128"),
])
@pytest.mark.parametrize("need_dh", [True, False])
def test_bn_dgrad_matches_plain(cuda, dtype, tol, n, h, k, route, need_dh):
    args = _bn_operands(n, h, k, dtype, cuda, n + h + k)
    if route == "tma128":
        route = "tma"
        plan = gemm_plan(n, h, k, dtype, "k", (args[0].data_ptr(), args[3].to(dtype).data_ptr()))
        assert (plan.route, plan.bm) == ("tma", 128)
    if not need_dh and route == "tma":
        route = "dz"  # the vector dz pass alone
    before, by_route = bn_fused_bwd.launches, dict(bn_fused_bwd.launches_by_route)
    dh, dz = bn_fused_bwd.bn_dgrad(*args, need_dh=need_dh)
    dh0, dz0 = bn_fused_bwd.bn_dgrad_ref(*args, dtype, need_dh=need_dh)
    torch.cuda.synchronize()
    assert bn_fused_bwd.launches == before + 1
    assert bn_fused_bwd.launches_by_route == {**by_route, route: by_route[route] + 1}
    assert dz.dtype == dtype and torch.equal(dz, dz0)
    if not need_dh:
        assert dh is None
        return
    assert dh.dtype == dtype and dh.shape == (n, k)
    err = (dh.float() - dh0.float()).abs().max() / dh0.float().abs().max()
    assert err.item() <= tol
    # padding rows (mask 0, zero cotangent) produce exactly zero gradients
    assert not dz[:130].any() and not dh[:130].any()


def test_bn_dgrad_rejects_mixed_dtypes(cuda):
    args = _bn_operands(64, 32, 16, torch.float32, cuda, 0)
    args[0] = args[0].bfloat16()
    with pytest.raises(TypeError):
        bn_fused_bwd.bn_dgrad(*args)


def _train_gradients(model, cfg, device, arrays):
    """Gradients of the masked-CE loss sum of a copy of ``model`` on
    ``device``, and the kernel-3 launches they took."""
    from tfkaldi_tpu_torch.data.batching import PaddedBatch
    from tfkaldi_tpu_torch.train.trainer import Trainer

    m = DNN(cfg)
    m.load_state_dict(model.state_dict())
    m.to(device)
    batch = PaddedBatch(*(torch.from_numpy(a).to(device) for a in arrays))
    before = bn_fused_bwd.launches
    loss, _ = Trainer.loss_sum(m, batch, train=True)
    loss.backward()
    if device != "cpu":
        torch.cuda.synchronize()
    return {n: p.grad.double().cpu() for n, p in m.named_parameters()}, bn_fused_bwd.launches - before


def _train_setup(dtype):
    """A 3-layer, 512-unit relu+BN DNN (every hidden layer through
    BnReluLayer) and a masked batch."""
    cfg = DNNConfig(input_dim=440, num_labels=300, num_hidden_layers=3, num_hidden_units=512,
                    batch_norm=True, compute_dtype=dtype)
    torch.manual_seed(0)
    model = DNN(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) / p.shape[0] ** 0.5)
    rng = np.random.default_rng(0)
    lengths = np.asarray([200, 150, 97], np.int32)
    arrays = (rng.standard_normal((3, 200, 440)).astype(np.float32),
              rng.integers(0, 300, (3, 200)).astype(np.int32), lengths, lengths)
    return model, cfg, arrays


def _grad_errors(got, want):
    """max|got - ref| / max(max|ref|, 1e-3) per parameter, the hidden
    biases left out (see _assert_grads_close)."""
    return {
        name: (got[name] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-3)
        for name, ref in want.items()
        if not (name.startswith("hidden.") and name.endswith(".b"))
    }


def _assert_grads_close(got, want, tol):
    for name, ref in want.items():
        if name.startswith("hidden.") and name.endswith(".b"):
            # batchnorm removes the bias: its exact gradient is 0, and both
            # sides hold rounding noise far below the layer's beta gradient
            beta = want[name[:-1] + "beta"].abs().max().item()
            assert max(ref.abs().max().item(), got[name].abs().max().item()) < 1e-2 * beta, name
    for name, err in _grad_errors(got, want).items():
        assert err <= tol, name


# bf16 card vs CPU: how much further the card's bf16 gradients may lie from
# the f32 gradients than the CPU's bf16 gradients do (see the test). On an
# NVIDIA H100 80GB HBM3 (700 W) the card's error was 0.99x the CPU's
# (0.2090 vs 0.2104) and card vs CPU 0.0870, with 1.1e-4 of layer 0's bf16
# pre-activations one step apart and no relu gate flipped there.
BF16_CARD_VS_CPU_FACTOR = 2.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_gradients_on_card_match_cpu(cuda, dtype):
    """Every hidden layer's backward launches kernel 3 on the card (the
    first without dh).

    f32: the gradients agree with the CPU's plain versions within 1e-4 of
    max(max|ref|, 1e-3) (sums in another order).

    bf16: the card and the CPU each round the f32 products of the forward
    to bf16, and the products differ in their last bits (cuBLAS and the
    CPU's BLAS sum in other orders), so some pre-activations land one bf16
    step apart and, near zero, flip the relu gate. That noise is of the
    size of bf16's own rounding and carries down the layers, so the card
    is not held to the CPU's bf16 numbers but to the f32 gradients of the
    same weights: its error there is at most BF16_CARD_VS_CPU_FACTOR times
    the CPU's bf16 error. The readings are printed (``-s``)."""
    from tfkaldi_tpu_torch import layers

    model, cfg, arrays = _train_setup(dtype)
    want, cpu_launches = _train_gradients(model, cfg, "cpu", arrays)
    got, launches = _train_gradients(model, cfg, cuda, arrays)
    assert cpu_launches == 0 and launches == cfg.num_hidden_layers
    if dtype == torch.float32:
        _assert_grads_close(got, want, 1e-4)
        return
    f32, _ = _train_gradients(model, dataclasses.replace(cfg, compute_dtype=torch.float32), "cpu", arrays)
    card_err, cpu_err, cross = _grad_errors(got, f32), _grad_errors(want, f32), _grad_errors(got, want)
    # the cause, read in layer 0, whose inputs are the same on both sides
    x = torch.from_numpy(arrays[0]).reshape(-1, cfg.input_dim)
    mask = torch.from_numpy((np.arange(arrays[0].shape[1])[None, :] < arrays[2][:, None]).reshape(-1)).float()
    layer = model.hidden[0]
    gates = []
    for device in ("cpu", cuda):
        args = [t.detach().to(device) for t in (x, layer.w, layer.b, layer.beta, mask)]
        z = layers.affine(*args[:3], dtype)
        mean, var, _ = layers.masked_moments(z.float(), args[4])
        act = layers.batchnorm(z.float(), mean, var, args[3], cfg.bn_eps, dtype)
        gates.append((z.cpu(), act.cpu() > 0))
    real = mask.bool()
    z_apart = (gates[0][0] != gates[1][0])[real].float().mean().item()
    gate_flips = (gates[0][1] != gates[1][1])[real].float().mean().item()
    print(f"bf16 gradients, max|diff| / max(max|f32 ref|, 1e-3): card vs f32 {max(card_err.values())!r}, "
          f"CPU vs f32 {max(cpu_err.values())!r}, card vs CPU {max(cross.values())!r} "
          f"(worst {max(cross, key=cross.get)}); layer 0 real rows: bf16 pre-activations apart "
          f"{z_apart!r}, relu gates flipped {gate_flips!r}")
    for name, err in card_err.items():
        assert err <= BF16_CARD_VS_CPU_FACTOR * max(cpu_err.values()), name
    _assert_grads_close(got, want, float("inf"))  # the hidden biases stay noise


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_train_gradients_kernel_vs_plain_on_card(cuda, dtype, tol, monkeypatch):
    """The same forward on the same card, the backward through kernel 3
    and through its plain version: f32 within 1e-4, bf16 within 2e-2 of
    max(max|ref|, 1e-3) (the bounds of tests/test_bn_fused_bwd.py; in bf16
    a dh rounded one bf16 step apart carries down the layers)."""
    model, cfg, arrays = _train_setup(dtype)
    got, launches = _train_gradients(model, cfg, cuda, arrays)
    monkeypatch.setattr(bn_fused_bwd, "bn_dgrad", bn_fused_bwd.bn_dgrad_ref)
    want, plain_launches = _train_gradients(model, cfg, cuda, arrays)
    assert launches == cfg.num_hidden_layers and plain_launches == 0
    _assert_grads_close(got, want, tol)


class _CountingDispenser:
    """Batch k holds the value k everywhere; the cursor rewinds."""

    def __init__(self):
        self.cursor = 0

    def get_padded_batch(self, batcher):
        self.cursor += 1
        k = float(self.cursor)
        inputs = [np.full((n, 8), k, np.float32) for n in (100, 37)]
        targets = [np.full(n, self.cursor, np.int32) for n in (100, 37)]
        return batcher(inputs, targets)

    def return_batch(self):
        self.cursor -= 1


def test_prefetch_to_card_through_pinned_buffers(cuda):
    """The pinned-buffer, non_blocking path exists only on a card: batches
    arrive on the device in order and intact, and a rewind accounts for
    the prefetched ones."""
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.prefetch import PrefetchingBatchSource

    with PrefetchingBatchSource(_CountingDispenser(), DeviceBatcher(), depth=2, device=cuda) as source:
        got = [source.next() for _ in range(3)]
        source.rewind(1)
        again = source.next()
        torch.cuda.synchronize()
    for k, batch in enumerate(got + [again], start=1):
        k = min(k, 3)
        assert batch.inputs.device.type == "cuda" and batch.inputs.shape == (2, 128, 8)
        assert torch.all(batch.inputs[0, :100] == k) and torch.all(batch.inputs[1, :37] == k)
        assert not batch.inputs[0, 100:].any() and not batch.inputs[1, 37:].any()
        assert batch.input_lengths.tolist() == [100, 37] and torch.all(batch.targets[0, :100] == k)

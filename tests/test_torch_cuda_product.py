"""``layers.product``'s tensor-core route on the card, at the Conformer (L)
transducer's shapes, against the widened route it replaces.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips (inside the ``cuda`` fixture) when ``torch.cuda.is_available()`` is
false. The file imports no JAX:

    python -m pytest tests/test_torch_cuda_product.py --noconftest -q -m cuda -s

The shapes are the cell's (batches of 32 utterances, T' up to 415 frames
after the ×4 front end, 8 heads of 64, U+1 = 129 label positions, joint
blocks of 32 frames): the attention scores ``[32, 8, T', 64] × [.., 64,
T']``, the position term over the batch ``[32, 8, T', 64] × [8, 64,
2T'-1]``, the FFN ``[32·T', 512] × [512, 2048]`` and the joint ``[32, 32,
129, 640] × [640, 1024]``. The forward is held to f32 summation-order size
(its distance from an f64 product within 4× the widened route's, and within
the worst case ``K·2^-24·(|a|·|b|)``); the gradients, after their bf16
rounding, are equal to the widened chain's but for ties.
"""

import pytest
import torch

from tests.test_torch_product_route import _values, assert_ties_only, gradient_scales
from tfkaldi_tpu_torch import layers
from tfkaldi_tpu_torch.ops import bf16_split

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
T = 415
SHAPES = {
    "scores": ((32, 8, T, 64), (32, 8, T, 64), True),  # b is the keys' transposed view
    "position": ((32, 8, T, 64), (8, 64, 2 * T - 1), False),
    "ffn": ((32 * T, 512), (512, 2048), False),
    "joint": ((32, 32, 129, 640), (640, 1024), False),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the tensor-core route runs only on a card")
    from tfkaldi_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _operands(name, device, a_dtype=BF16, seed=0):
    sa, sb, transposed = SHAPES[name]
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(*sa, generator=gen, device=device).to(a_dtype)
    b = torch.randn(*sb, generator=gen, device=device).to(BF16)
    return a, (b.transpose(-1, -2) if transposed else b)


def _widened(a, b):
    return torch.matmul(a.to(BF16).float(), b.to(BF16).float())


@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_within_summation_order(cuda, name):
    a, b = _operands(name, cuda)
    before = dict(layers.product_routes)
    out = layers.product(a, b, BF16)
    assert layers.product_routes["tensor_core"] == before["tensor_core"] + 1
    assert layers.product_routes["widened"] == before["widened"]
    wide = _widened(a, b)
    assert out.dtype == torch.float32 and out.shape == wide.shape
    exact = torch.matmul(a.double(), b.double())
    scale = torch.matmul(a.double().abs(), b.double().abs())
    k = a.shape[-1]
    err, err_wide = (out.double() - exact).abs(), (wide.double() - exact).abs()
    print(f"{name}: max |tensor core - f64| {err.max().item():.3e}, widened {err_wide.max().item():.3e}, "
          f"relative to |a||b| {(err / scale).max().item():.3e} / {(err_wide / scale).max().item():.3e}")
    assert err.max() <= 4 * err_wide.max()
    assert torch.all(err <= k * 2.0 ** -24 * scale)


@pytest.mark.parametrize("a_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("name", list(SHAPES))
def test_gradients_equal_but_for_ties(cuda, name, a_dtype):
    """After the bf16 rounding each gradient equals the widened chain's but
    for ties (up to one in twenty elements: 3.2% measured where an element
    sums 396k terms, the joint's weight gradient); before it, each is within
    ``k·2^-23·scale`` of the f64 gradient (the error bound of a k-term f32
    sum whose adds truncate: the tensor cores' f32 accumulation is not
    round-to-nearest f32). Against the f64 gradient rounded to bf16, each
    misses at most 20× as often as the widened chain (17× measured, the
    joint's weight gradient; 0.7-7× elsewhere)."""
    a, b = _operands(name, cuda, a_dtype, seed=1)
    a.requires_grad_()
    b = b.detach().requires_grad_()
    out = layers.product(a, b, BF16)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda) * 1e-3
    new = torch.autograd.grad(out, (a, b), g)
    old = torch.autograd.grad(_widened(a, b), (a, b), g)
    a16 = a.detach().to(BF16)
    unrounded = layers.split_term_grads(a16, b.detach(), g)
    a64, b64, g64 = a16.double(), b.detach().double(), g.double()
    exact = (torch.matmul(g64, b64.transpose(-1, -2)).sum_to_size(a.shape),
             torch.matmul(a64.transpose(-1, -2), g64).sum_to_size(b.shape))
    n = b.shape[-1]
    for what, x, y, f, e, scale, k in zip("ab", new, old, unrounded, exact, gradient_scales(a, b, g),
                                          (3 * n, 3 * out.numel() // n)):
        differ = assert_ties_only(x, y, scale, k, share=0.05)
        assert torch.all((f.double() - e).abs() <= k * 2.0 ** -23 * scale)
        rounded = e.to(BF16).to(x.dtype)
        miss, miss_old = int((x != rounded).sum()), int((y != rounded).sum())
        print(f"{name} d{what} ({a_dtype}): {differ} of {x.numel()} differ from the widened chain after the bf16 "
              f"rounding; {miss} / {miss_old} (widened) differ from the f64 gradient rounded; max |f32 - f64| "
              f"/ scale {((f.double() - e).abs() / scale).max().item():.3e}")
        assert miss <= 20 * max(miss_old, 1)


# the cell's joint cotangent [B·c·(U+1), V] (whole float4s: the vectorised
# read) and its attention scores' [B, H, T', T'] (T' 415: the scalar read)
CELL_COTANGENTS = {"joint": ((32 * 32 * 129, 1024), "vec4"), "scores": ((32, 8, T, T), "scalar")}


@pytest.mark.parametrize("name", list(CELL_COTANGENTS))
def test_split_kernel_at_the_cell_cotangents(cuda, name):
    """At the cell's cotangents: one launch on the read route of the shape,
    bit-equal to the plain split."""
    shape, route = CELL_COTANGENTS[name]
    g = torch.randn(*shape, generator=torch.Generator(device=cuda).manual_seed(0), device=cuda) * 1e-3
    before = dict(bf16_split.launches_by_route)
    out = bf16_split.split3(g)
    ref = bf16_split.split3_ref(g)
    torch.cuda.synchronize()
    assert bf16_split.launches_by_route == {**before, route: before[route] + 1}
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("kind", ["normal", "tiny", "huge", "negative", "mixed_scales", "zero"])
def test_split_kernel_equals_the_plain_split(cuda, kind):
    g = _values(kind, torch.Generator().manual_seed(3)).to(cuda)  # [257, 193]: the scalar route
    wide = torch.cat([g, g[:, :63]], dim=1)  # [257, 256]: the vectorised route
    # views: offset, strided; batches whose rows are padded one by one
    for x in (g, wide, wide[:, 1:129], wide.reshape(-1)[4:].reshape(-1, 4), g[:255].reshape(5, 51, 193),
              wide[:256].reshape(4, 64, 256), wide[:255].reshape(5, 51, 256)):
        before = dict(bf16_split.launches_by_route)
        out = bf16_split.split3(x)
        assert sum(bf16_split.launches_by_route.values()) == sum(before.values()) + 1
        ref = bf16_split.split3_ref(x.cpu())
        assert torch.equal(out.cpu().view(torch.int16), ref.view(torch.int16))
    assert bf16_split.launches_by_route["vec4"] > 0 and bf16_split.launches_by_route["scalar"] > 0


def test_f32_operands_keep_the_widened_route(cuda):
    a, b = _operands("joint", cuda, torch.float32)
    b = b.float()
    before = dict(layers.product_routes)
    out = layers.product(a, b, torch.float32)
    assert layers.product_routes == {"tensor_core": before["tensor_core"], "widened": before["widened"] + 1}
    assert torch.equal(out, torch.matmul(a, b))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def test_timing_against_the_widened_route(cuda):
    """Device ms a call at the cell's shapes: the widened route, the
    tensor-core route, and a bf16 ``torch.matmul`` (bf16 result) as the
    library's yardstick; forward, and forward with the backward of both
    operands. The route must win where the products bound the time (the
    FFN, the joint). The attention products contract over 64 and are bound
    by memory: their forward wins, but the split backward moves about 2.7×
    the widened one's bytes (the cotangent read, its three terms written
    and read by both GEMMs), so forward with backward may lose there; those
    are printed, not asserted."""
    from tfkaldi_tpu_torch.profile_ffn import events_ms

    print(torch.cuda.get_device_name(0))
    slower = []
    for name in SHAPES:
        a, b = _operands(name, cuda)
        a.requires_grad_()
        b = b.detach().requires_grad_()
        g = torch.randn(_widened(a, b).shape, device=cuda)

        def step(fn):
            return lambda: torch.autograd.grad(fn(), (a, b), g)

        with torch.no_grad():
            fwd = [events_ms(lambda: _widened(a, b), calls=5), events_ms(lambda: layers.product(a, b, BF16), calls=5),
                   events_ms(lambda: torch.matmul(a, b), calls=5)]
        both = [events_ms(step(lambda: _widened(a, b)), calls=5),
                events_ms(step(lambda: layers.product(a, b, BF16)), calls=5),
                events_ms(step(lambda: torch.matmul(a, b).float()), calls=5)]
        print(f"{name}: forward widened {fwd[0]:.4f} ms, tensor core {fwd[1]:.4f}, bf16 matmul {fwd[2]:.4f}; "
              f"forward+backward {both[0]:.4f} / {both[1]:.4f} / {both[2]:.4f}")
        split = [events_ms(lambda: bf16_split.split3(g), calls=5), events_ms(lambda: bf16_split.split3_ref(g), calls=5)]
        print(f"{name}: split of the {tuple(g.shape)} cotangent {split[0]:.4f} ms, torch ops {split[1]:.4f}")
        if fwd[1] >= fwd[0] or (both[1] >= both[0] and name in ("ffn", "joint")):
            slower.append(name)
    assert not slower

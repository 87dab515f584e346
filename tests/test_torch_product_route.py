"""``layers.product``'s two routes on the CPU.

The CPU keeps the widened route (bf16 operands widened exactly, an f32
GEMM), so every CPU call is bit-equal to the old expression and the JAX
parity tests see no change. The tensor-core route runs only on a card
(``tests/test_torch_cuda_product.py``); its arithmetic is held here: the
three-term split of the f32 cotangent is exact, and the split-term products,
with each bf16 × bf16 → f32 GEMM emulated by an f32 GEMM of the widened
operands, give the widened chain's gradients.
"""

import pytest
import torch

from tfkaldi_tpu_torch import layers
from tfkaldi_tpu_torch.ops.bf16_split import split3

BF16 = torch.bfloat16
TINY = 2.0 ** -100  # every term of the split a normal bf16 down to |g| = 2^-103
BF16_MAX = torch.finfo(BF16).max


def _old(a, b, cd):
    return torch.matmul(a.to(cd).float(), b.to(cd).float())


def _values(kind: str, gen) -> torch.Tensor:
    g = torch.randn(257, 193, generator=gen)
    if kind == "normal":
        return g
    if kind == "tiny":
        return g.sign() * (1 + g.abs()) * TINY
    if kind == "huge":
        return (g / g.abs().max()) * (0.99 * BF16_MAX)
    if kind == "negative":
        return -g.abs() * 1e3
    if kind == "mixed_scales":
        return g * torch.pow(2.0, torch.randint(-90, 90, g.shape, generator=gen).float())
    return torch.zeros_like(g)


def _terms(g):
    """:func:`split3`'s three terms of ``g [M, N]`` as f32, after checking
    the padding (rows and columns to multiples of 8) is zeros."""
    m, n = g.shape
    out = split3(g)
    assert out.dtype == BF16 and out.shape == (-(-m // 8) * 8, 3 * (-(-n // 8) * 8))
    blocks = out.unflatten(-1, (3, out.shape[-1] // 3)).float()
    inner = torch.zeros_like(blocks, dtype=torch.bool)
    inner[:m, :, :n] = True
    assert torch.all(blocks[~inner] == 0)
    return blocks[:m, :, :n].unbind(-2)


@pytest.mark.parametrize("kind", ["normal", "tiny", "huge", "negative", "mixed_scales", "zero"])
def test_split3_is_exact(kind):
    g = _values(kind, torch.Generator().manual_seed(3))
    g1, g2, g3 = _terms(g)
    assert torch.equal(g1, g.to(BF16).float())
    assert torch.equal(g2, (g - g1).to(BF16).float())
    total = (g1 + g2) + g3
    assert torch.equal(total.view(torch.int32), g.view(torch.int32))
    assert torch.equal(g1 + (g2 + g3), g)


def test_split3_near_the_smallest_normal():
    """Below 2^-103 the later terms fall below bf16's smallest normal and
    keep fewer bits: the sum is off by at most half bf16's least
    subnormal, 2^-134."""
    g = torch.randn(257, 193, generator=torch.Generator().manual_seed(4)) * torch.finfo(torch.float32).tiny
    g1, g2, g3 = _terms(g)
    assert torch.all(((g1 + g2) + g3 - g).abs() <= 2.0 ** -134)


SHAPES = [((48, 40), (40, 24)),  # affine
          ((2, 3, 5, 40), (40, 24)),  # the joint: [B, c, U+1, J] × [J, V]
          ((2, 4, 7, 16), (2, 4, 16, 9)),  # attention scores, probs @ v
          ((2, 4, 7, 16), (4, 16, 13)),  # the position term: [H, dh, 2T-1] over the batch
          ((7, 16), (3, 16, 9))]  # a over b's batch


@pytest.mark.parametrize("cd", [torch.float32, BF16])
@pytest.mark.parametrize("sa,sb", SHAPES)
def test_cpu_calls_keep_the_widened_route(sa, sb, cd):
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(*sa, generator=gen, requires_grad=True)
    b = torch.randn(*sb, generator=gen).to(cd).requires_grad_()
    before = dict(layers.product_routes)
    out = layers.product(a, b, cd)
    assert layers.product_routes["widened"] == before["widened"] + 1
    assert layers.product_routes["tensor_core"] == before["tensor_core"]
    ref = _old(a, b, cd)
    assert out.dtype == torch.float32 and torch.equal(out, ref)
    g = torch.randn(out.shape, generator=gen)
    assert all(torch.equal(x, y) for x, y in zip(torch.autograd.grad(out, (a, b), g),
                                                torch.autograd.grad(ref, (a, b), g)))


@pytest.fixture
def emulated_gemms(monkeypatch):
    """``torch.mm`` / ``torch.bmm`` with ``out_dtype`` (no CPU kernel) as
    f32 GEMMs of the widened bf16 operands: the same products, exact in f32,
    summed in another order."""
    mm, bmm = torch.mm, torch.bmm

    def widen(fn):
        def call(x, y, out_dtype=None):
            assert x.dtype == y.dtype == BF16 and out_dtype == torch.float32
            return fn(x.float(), y.float())
        return call

    monkeypatch.setattr(torch, "mm", widen(mm))
    monkeypatch.setattr(torch, "bmm", widen(bmm))


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(2.0, torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)


def gradient_scales(a, b, g):
    """``(|g|·|b|ᵀ, |a|ᵀ·|g|)`` summed to the operands' shapes: what each
    gradient's f32 rounding is relative to."""
    af, bf = a.detach().float().abs(), b.detach().float().abs()
    return (torch.matmul(g.abs(), bf.transpose(-1, -2)).sum_to_size(a.shape),
            torch.matmul(af.transpose(-1, -2), g.abs()).sum_to_size(b.shape))


def assert_ties_only(x, y, scale, k, share=0.01):
    """bf16 gradients ``x`` and ``y`` equal but for ties: f32 sums of ``k``
    terms that differ by their rounding (``k·2^-24·scale``) and fall on two
    sides of a bf16 rounding point, in at most ``share`` of the elements (a
    wrong gradient differs almost everywhere). Returns how many differ."""
    assert x.dtype == y.dtype and x.shape == y.shape
    x, y = x.float(), y.float()
    differ = x != y
    assert differ.sum() <= max(1, int(x.numel() * share))
    assert torch.all(((x - y).abs() <= _bf16_ulp(y) + k * 2.0 ** -24 * scale)[differ])
    return int(differ.sum())


@pytest.mark.parametrize("a_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("sa,sb", SHAPES)
def test_split_term_backward_gives_the_widened_gradients(sa, sb, a_dtype, emulated_gemms):
    gen = torch.Generator().manual_seed(7)
    a = torch.randn(*sa, generator=gen).to(a_dtype).requires_grad_()
    b = torch.randn(*sb, generator=gen).to(BF16).requires_grad_()
    out = layers._Bf16Product.apply(a.to(BF16), b)  # product's tensor-core branch
    ref = _old(a, b, BF16)
    assert torch.equal(out, ref)  # the emulated forward is the widened GEMM itself
    g = torch.randn(out.shape, generator=gen) * 1e-2
    new, old = torch.autograd.grad(out, (a, b), g), torch.autograd.grad(ref, (a, b), g)
    n = sb[-1]
    scales = gradient_scales(a, b, g)
    inner = (3 * n, 3 * out.numel() // n)  # the most terms one element of each sums
    for x, y, scale, k in zip(new, old, scales, inner):
        assert_ties_only(x, y, scale, k)
    # before the rounding: the split-term products are the f32 gradients to f32 rounding
    ga, gb = layers.split_term_grads(a.detach().to(BF16), b.detach(), g)
    exact = (torch.matmul(g, b.detach().float().transpose(-1, -2)).sum_to_size(sa),
             torch.matmul(a.detach().to(BF16).float().transpose(-1, -2), g).sum_to_size(sb))
    for x, y, scale, k in zip((ga, gb), exact, scales, inner):
        assert x.dtype == torch.float32 and torch.all((x - y).abs() <= k * 2.0 ** -24 * scale)


def test_split_term_backward_without_every_gradient(emulated_gemms):
    gen = torch.Generator().manual_seed(11)
    a = torch.randn(6, 5, generator=gen).to(BF16)
    b = torch.randn(5, 4, generator=gen).to(BF16).requires_grad_()
    out = layers._Bf16Product.apply(a, b)
    (db,) = torch.autograd.grad(out, (b,), torch.ones_like(out))
    (db_ref,) = torch.autograd.grad(_old(a, b, BF16), (b,), torch.ones_like(out))
    assert torch.equal(db, db_ref)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_plain_recurrences_keep_the_widened_products(cell):
    """The plain recurrences that kernels 4-7 are held to take their
    per-step products from ``layers.widened_product``, not from
    ``layers.product``, so that on a card too they sum as the f32 GEMM does:
    their steps leave ``product_routes`` as it was."""
    from tfkaldi_tpu_torch.ops import gru_scan, lstm_scan

    scan, gates = (lstm_scan, 4) if cell == "lstm" else (gru_scan, 3)
    gen = torch.Generator().manual_seed(13)
    t, b, h = 5, 3, 8
    gx = torch.randn(t, b, gates * h, generator=gen)
    wh = torch.randn(h, gates * h, generator=gen).to(BF16)
    mask = (torch.arange(t)[:, None] < torch.tensor([5, 3, 1])[None, :]).float()[:, :, None]
    dys = torch.randn(t, b, h, generator=gen)
    before = dict(layers.product_routes)
    outs = scan.forward(gx, wh, mask)
    if cell == "lstm":
        _, acts, cs, _ = outs
        dgx = scan.backward_scan(dys, acts, cs, mask, wh)
    else:
        _, acts, hs, _, ghns = outs
        dgx, _ = scan.backward_scan(dys, acts, hs, ghns, mask, wh)
    assert layers.product_routes == before
    assert torch.isfinite(dgx).all() and dgx.abs().sum() > 0

"""The port's RNN-T lattice loss against the JAX package's, on the CPU.

``tfkaldi_tpu_torch.ops.rnnt_loss`` against ``tfkaldi_tpu.ops.rnnt_loss``
on the same seeded numpy inputs (the shapes of tests/test_rnnt_loss.py and
tests/test_rnnt_pruned.py):

- the materialized ``rnnt_loss`` and the alpha core: the per-row loss
  within LOSS_RTOL (1e-6) relative and the logit gradient (autograd
  against ``jax.grad``) within GRAD_ATOL (1e-4) absolute:
  ``torch.logcumsumexp`` rounds otherwise than XLA's associative scan;
  a nonzero blank id, padding invariance, empty label rows, finite
  gradients under garbage padding;
- the banded loss on random monotone bands, values and gradients, and a
  full-width band equal to the dense loss;
- band starts exactly: the diagonal band, the guided band at stride 1 and
  4 on the peaky lattices of tests/test_rnnt_pruned.py, and
  ``_finalize_band_starts`` on shared integer inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfkaldi_tpu.ops import rnnt_loss as jax_rnnt
from tfkaldi_tpu_torch.ops import rnnt_loss

LOSS_RTOL = 1e-6
GRAD_ATOL = 1e-4


def random_case(rng, b=3, t=9, u=5, v=6, blank=0):
    logits = rng.standard_normal((b, t, u + 1, v)).astype(np.float32) * 2.0
    labels = rng.integers(0, v, (b, u)).astype(np.int32)
    labels[labels == blank] = (blank + 1) % v
    t_lens = rng.integers(u + 1, t + 1, (b,)).astype(np.int32)
    u_lens = rng.integers(1, u + 1, (b,)).astype(np.int32)
    t_lens[0], u_lens[0] = t, u
    return logits, labels, t_lens, u_lens


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def loss_and_grad(logits, labels, t_lens, u_lens, blank, weights):
    """Both sides' per-row loss and the gradient of ``Σ weights · loss``
    with respect to the logits."""
    def jloss(x):
        return jnp.sum(jax_rnnt.rnnt_loss(x, labels, t_lens, u_lens, blank) * weights)

    want = np.asarray(jax_rnnt.rnnt_loss(jnp.asarray(logits), labels, t_lens, u_lens, blank))
    want_g = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got = rnnt_loss.rnnt_loss(x, *_torch(labels, t_lens, u_lens), blank)
    (got * torch.from_numpy(weights)).sum().backward()
    return got.detach().numpy(), want, x.grad.numpy(), want_g


@pytest.mark.parametrize("blank", [0, 3, 5], ids=["blank0", "blank3", "blank_last"])
def test_materialized_loss_and_grad_match_jax(blank):
    rng = np.random.default_rng(10 + blank)
    logits, labels, t_lens, u_lens = random_case(rng, blank=blank)
    weights = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    got, want, g, want_g = loss_and_grad(logits, labels, t_lens, u_lens, blank, weights)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(g, want_g, atol=GRAD_ATOL)
    assert np.abs(want_g).max() > 1e-2  # the gradient is not trivially zero


def test_alpha_core_and_masks_match_jax():
    """``rnnt_alpha_loss`` on shared scores, ``mask_label_scores`` and
    ``rnnt_alphas`` exactly where no cumulative op is involved."""
    rng = np.random.default_rng(1)
    b, t, u = 4, 8, 5
    lp_blank = -rng.uniform(0.1, 3.0, (b, t, u + 1)).astype(np.float32)
    lp_label = -rng.uniform(0.1, 3.0, (b, t, u)).astype(np.float32)
    t_lens = np.array([8, 5, 1, 7], np.int32)
    u_lens = np.array([5, 0, 2, 3], np.int32)
    masked = np.asarray(jax_rnnt.mask_label_scores(jnp.asarray(lp_label), u_lens))
    np.testing.assert_array_equal(rnnt_loss.mask_label_scores(*_torch(lp_label, u_lens)).numpy(), masked)
    want = np.asarray(jax_rnnt.rnnt_alpha_loss(jnp.asarray(lp_blank), jnp.asarray(masked), t_lens, u_lens))
    got = rnnt_loss.rnnt_alpha_loss(*_torch(lp_blank, masked, t_lens, u_lens)).numpy()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    want_a = np.asarray(jax_rnnt.rnnt_alphas(jnp.asarray(lp_blank), jnp.asarray(masked)))
    np.testing.assert_allclose(rnnt_loss.rnnt_alphas(*_torch(lp_blank, masked)).numpy(), want_a, rtol=LOSS_RTOL)


def test_padding_invariance_and_empty_labels():
    """Garbage past the lengths on both axes leaves the loss as it is; a row
    with no labels scores the all-blank path."""
    rng = np.random.default_rng(2)
    logits, labels, t_lens, u_lens = random_case(rng, b=3, t=7, u=4)
    u_lens[1] = 0
    big = rng.standard_normal((3, 11, 7, 6)).astype(np.float32) * 5
    big[:, :7, :5] = logits
    big_labels = rng.integers(1, 6, (3, 6)).astype(np.int32)
    big_labels[:, :4] = labels
    small = rnnt_loss.rnnt_loss(*_torch(logits, labels, t_lens, u_lens), 0).numpy()
    large = rnnt_loss.rnnt_loss(*_torch(big, big_labels, t_lens, u_lens), 0).numpy()
    np.testing.assert_allclose(large, small, rtol=LOSS_RTOL)
    lp = torch.log_softmax(torch.from_numpy(logits[1]), -1).double()
    all_blank = -lp[: t_lens[1], 0, 0].sum().item()
    assert abs(small[1] - all_blank) <= 1e-5 * abs(all_blank)
    np.testing.assert_allclose(small, np.asarray(jax_rnnt.rnnt_loss(logits, labels, t_lens, u_lens, 0)),
                               rtol=LOSS_RTOL)


def test_gradients_finite_under_padding():
    rng = np.random.default_rng(3)
    logits, labels, t_lens, u_lens = random_case(rng, b=3, t=9, u=5)
    logits[:, 6:] = 1e4  # huge garbage in the padded frames
    t_lens[:] = np.minimum(t_lens, 6)
    weights = np.ones(3, np.float32)
    got, want, g, want_g = loss_and_grad(logits, labels, t_lens, u_lens, 0, weights)
    assert np.isfinite(g).all() and np.isfinite(got).all()
    assert np.abs(g[:, 6:]).max() == 0.0
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(g, want_g, atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# the banded lattice
# ---------------------------------------------------------------------------


def dense_scores(logits, labels, u_lens, blank=0):
    """log_softmax → (lp_blank [B, T, U+1], masked lp_label [B, T, U]) as
    numpy."""
    b, t, u1, _ = logits.shape
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    idx = torch.from_numpy(labels).long()[:, None, :, None].expand(b, t, u1 - 1, 1)
    lab = torch.gather(lp[:, :, : u1 - 1], 3, idx)[..., 0]
    return lp[..., blank].numpy(), rnnt_loss.mask_label_scores(lab, torch.from_numpy(u_lens)).numpy()


def gather_band(arr, starts, s_range, fill=jax_rnnt._NEG):
    """``[B, T, W] → [B, T, S]`` at global ``u = starts[t] + s`` (numpy)."""
    gidx = starts[:, :, None] + np.arange(s_range)[None, None, :]
    val = np.take_along_axis(arr, np.clip(gidx, 0, arr.shape[2] - 1), axis=2)
    return np.where(gidx < arr.shape[2], val, fill).astype(np.float32)


def random_bands(rng, b, t, u, s, t_lens, u_lens):
    """Monotone starts with p[0] = 0, jumps ≤ S−1, the exit node covered."""
    p = np.zeros((b, t), np.int32)
    for i in range(b):
        top = max(int(u_lens[i]) + 1 - s, 0)
        for tt in range(1, t):
            p[i, tt] = min(p[i, tt - 1] + rng.integers(0, s), top, max(u + 1 - s, 0))
        p[i, int(t_lens[i]) - 1:] = top
        p[i] = np.maximum.accumulate(p[i])
    return p


@pytest.mark.parametrize("seed", [0, 1])
def test_banded_loss_and_grad_match_jax(seed):
    rng = np.random.default_rng(30 + seed)
    b, t, u, s = 4, 10, 6, 3
    logits, labels, t_lens, u_lens = random_case(rng, b=b, t=t, u=u)
    lp_blank, lp_label = dense_scores(logits, labels, u_lens)
    starts = random_bands(rng, b, t, u, s, t_lens, u_lens)
    bb = gather_band(lp_blank, starts, s)
    ll = np.array(jax_rnnt.mask_band_label_scores(jnp.asarray(gather_band(lp_label, starts, s)), starts, u_lens))
    np.testing.assert_array_equal(
        rnnt_loss.mask_band_label_scores(*_torch(gather_band(lp_label, starts, s), starts, u_lens)).numpy(), ll)
    weights = rng.uniform(0.5, 1.5, b).astype(np.float32)

    def jloss(x, y):
        return jnp.sum(jax_rnnt.rnnt_alpha_loss_banded(x, y, starts, t_lens, u_lens) * weights)

    want = np.asarray(jax_rnnt.rnnt_alpha_loss_banded(jnp.asarray(bb), jnp.asarray(ll), starts, t_lens, u_lens))
    want_gb, want_gl = (np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1))(jnp.asarray(bb), jnp.asarray(ll)))
    xb, xl = (torch.from_numpy(a).requires_grad_() for a in (bb, ll))
    got = rnnt_loss.rnnt_alpha_loss_banded(xb, xl, *_torch(starts, t_lens, u_lens))
    (got * torch.from_numpy(weights)).sum().backward()
    assert np.all(want < 1e8)  # every band covers its exit
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(xb.grad.numpy(), want_gb, atol=GRAD_ATOL)
    np.testing.assert_allclose(xl.grad.numpy(), want_gl, atol=GRAD_ATOL)


def test_full_width_band_equals_dense():
    rng = np.random.default_rng(4)
    logits, labels, t_lens, u_lens = random_case(rng)
    u = labels.shape[1]
    starts = rnnt_loss.diagonal_band_starts(*_torch(t_lens, u_lens), logits.shape[1], u, u + 1)
    assert not starts.any()
    lp_blank, lp_label = dense_scores(logits, labels, u_lens)
    p = starts.numpy()
    banded = rnnt_loss.rnnt_alpha_loss_banded(*_torch(gather_band(lp_blank, p, u + 1),
                                                       gather_band(lp_label, p, u + 1), p, t_lens, u_lens))
    dense = rnnt_loss.rnnt_loss(*_torch(logits, labels, t_lens, u_lens), 0)
    np.testing.assert_allclose(banded.numpy(), dense.numpy(), rtol=LOSS_RTOL)


def test_diagonal_starts_match_jax_exactly():
    rng = np.random.default_rng(5)
    for t_max, u_max, s in ((9, 5, 2), (11, 6, 3), (16, 6, 7), (128, 128, 16), (7, 3, 10)):
        t_lens = rng.integers(1, t_max + 1, 6).astype(np.int32)
        u_lens = rng.integers(0, u_max + 1, 6).astype(np.int32)
        want = np.asarray(jax_rnnt.diagonal_band_starts(jnp.asarray(t_lens), jnp.asarray(u_lens), t_max, u_max, s))
        got = rnnt_loss.diagonal_band_starts(*_torch(t_lens, u_lens), t_max, u_max, s)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def peaky(rng, b, t, u, v, t_lens, u_lens):
    """All mass on one late-burst monotone path (tests/test_rnnt_pruned.py)."""
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    peak = np.full((b, t, u + 1, v), -6.0, np.float32)
    for i in range(b):
        tl, ul = int(t_lens[i]), int(u_lens[i])
        peak[i, :, :, 0] = 4.0
        for j in range(ul):
            peak[i, tl - ul + j, j, labels[i, j]] = 10.0
    return peak, labels


@pytest.mark.parametrize("stride,t,s", [(1, 12, 3), (2, 24, 3), (4, 24, 4)])
def test_guided_starts_match_jax_exactly(stride, t, s):
    """On the peaky lattices the guided band finds the burst; the starts are
    JAX's exactly, and the banded loss recovers the dense one."""
    rng = np.random.default_rng(2 if stride == 1 else 21)
    b, u, v = 2, 6, 7
    t_lens = np.array([t, t - 2 if stride == 1 else t - 5], np.int32)
    u_lens = np.array([6, 5], np.int32)
    logits, labels = peaky(rng, b, t, u, v, t_lens, u_lens)
    lp_blank, lp_label = dense_scores(logits, labels, u_lens)
    want = np.asarray(jax_rnnt.guided_band_starts(jnp.asarray(lp_blank), jnp.asarray(lp_label), jnp.asarray(t_lens),
                                                  jnp.asarray(u_lens), s, proxy_stride=stride))
    got = rnnt_loss.guided_band_starts(*_torch(lp_blank, lp_label, t_lens, u_lens), s, proxy_stride=stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    p = got.numpy()
    banded = rnnt_loss.rnnt_alpha_loss_banded(*_torch(gather_band(lp_blank, p, s), gather_band(lp_label, p, s), p,
                                                       t_lens, u_lens))
    dense = rnnt_loss.rnnt_loss(*_torch(logits, labels, t_lens, u_lens), 0)
    np.testing.assert_allclose(banded.numpy(), dense.numpy(), rtol=1e-3, atol=1e-3)


def test_guided_starts_on_random_lattices_match_jax():
    """Random (non-peaky) scores, strides 1 and 4: the same starts where the
    occupancy argmax is not a near-tie (every case here)."""
    rng = np.random.default_rng(6)
    logits, labels, t_lens, u_lens = random_case(rng, b=5, t=11, u=6)
    lp_blank, lp_label = dense_scores(logits, labels, u_lens)
    for stride, s in ((1, 2), (1, 7), (4, 3)):
        want = np.asarray(jax_rnnt.guided_band_starts(jnp.asarray(lp_blank), jnp.asarray(lp_label),
                                                      jnp.asarray(t_lens), jnp.asarray(u_lens), s,
                                                      proxy_stride=stride))
        got = rnnt_loss.guided_band_starts(*_torch(lp_blank, lp_label, t_lens, u_lens), s, proxy_stride=stride)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"stride {stride} S {s}")


def test_proxy_betas_match_jax():
    rng = np.random.default_rng(7)
    logits, labels, t_lens, u_lens = random_case(rng, b=4, t=8, u=5)
    lp_blank, lp_label = dense_scores(logits, labels, u_lens)
    want = np.asarray(jax_rnnt._proxy_betas(jnp.asarray(lp_blank), jnp.asarray(lp_label), t_lens, u_lens))
    got = rnnt_loss._proxy_betas(*_torch(lp_blank, lp_label, t_lens, u_lens)).numpy()
    live = want > -1e8
    np.testing.assert_array_equal(got > -1e8, live)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-5, atol=1e-5)


def test_finalize_band_starts_matches_jax_exactly():
    rng = np.random.default_rng(8)
    for s in (1, 2, 4, 16):
        raw = rng.integers(-6, 20, (6, 15)).astype(np.int32)
        t_lens = rng.integers(1, 16, 6).astype(np.int32)
        u_lens = rng.integers(0, 18, 6).astype(np.int32)
        want = np.asarray(jax_rnnt._finalize_band_starts(jnp.asarray(raw), jnp.asarray(t_lens), jnp.asarray(u_lens),
                                                         s))
        got = rnnt_loss._finalize_band_starts(*_torch(raw, t_lens, u_lens), s)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"S {s}")

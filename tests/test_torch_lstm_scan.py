"""The port's plain LSTM scan (``tfkaldi_tpu_torch.ops.lstm_scan``) against
``tfkaldi_tpu.ops.lstm_scan``, on the CPU.

The shapes and lengths of tests/test_pallas_lstm.py (T 16, B 8, H 128,
lengths [T, T-3, T//2, 5, 2, 1, T, T-1]) with garbage (7.7) in the padding
of ``gx``; both directions, f32 and bf16; values, residuals and the
gradients of ``gx`` and ``wh`` under a fixed cotangent.

Tolerances, max|diff| / max|ref|: f32 1e-5 (the two sides differ in the
summation order of f32 products only; measured ≤ 3.7e-7 in these cases
and in the GRU's). bf16 1e-3: both sides round ``h`` (forward) and
``dgates`` (backward) to bf16 before each product and at the dW_h
contraction, and a last-bit difference between two f32 sums can move one
of those roundings by a bf16 step, which then travels on through the
recurrence (measured ≤ 2.2e-4 here, ≤ 4.5e-4 in the GRU's); the rounded
stream ``h_cd`` itself one bf16 step, 2^-8 (measured 2.0e-3 in the GRU's
seed-1 case, where one such flip happens in the forward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfkaldi_tpu.ops import lstm_scan as jax_lstm_scan
from tfkaldi_tpu_torch.ops import lstm_scan

T, B, H = 16, 8, 128
LENGTHS = [T, T - 3, T // 2, 5, 2, 1, T, T - 1]
TOL = {"float32": 1e-5, "bfloat16": 1e-3}
H_CD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


def scan_data(gates: int, seed: int = 0):
    """``gx`` (garbage 7.7 in the padding), ``wh``, ``mask [T, B, 1]`` and a
    cotangent, as numpy."""
    rng = np.random.default_rng(seed)
    mask = (np.arange(T)[:, None] < np.array(LENGTHS)[None, :])[:, :, None].astype(np.float32)
    gx = rng.standard_normal((T, B, gates * H)).astype(np.float32)
    gx[mask[:, :, 0] == 0] = 7.7
    wh = (rng.standard_normal((H, gates * H)) / np.sqrt(H)).astype(np.float32)
    cot = rng.standard_normal((T, B, H)).astype(np.float32)
    return gx, wh, mask, cot


def rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def jax_values_and_grads(scan, gx, wh, mask, cot, cd: str, reverse: bool):
    def loss(gx, wh):
        return jnp.sum(scan(gx, wh, jnp.asarray(mask), jnp.dtype(cd), 1, reverse) * cot)

    ys = scan(jnp.asarray(gx), jnp.asarray(wh), jnp.asarray(mask), jnp.dtype(cd), 1, reverse)
    dgx, dwh = jax.grad(loss, argnums=(0, 1))(jnp.asarray(gx), jnp.asarray(wh))
    return np.asarray(ys), np.asarray(dgx), np.asarray(dwh)


def port_values_and_grads(scan, gx, wh, mask, cot, cd: str, reverse: bool):
    g = torch.tensor(gx, requires_grad=True)
    w = torch.tensor(wh, requires_grad=True)
    ys = scan(g, w, torch.from_numpy(mask), getattr(torch, cd), reverse)
    (ys * torch.from_numpy(cot)).sum().backward()
    return ys.detach().numpy(), g.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_jax(cd, reverse):
    gx, wh, mask, cot = scan_data(4)
    want = jax_values_and_grads(jax_lstm_scan.lstm_scan, gx, wh, mask, cot, cd, reverse)
    got = port_values_and_grads(lstm_scan.lstm_scan, gx, wh, mask, cot, cd, reverse)
    for name, g, w in zip(("ys", "dgx", "dwh"), got, want):
        assert rel(g, w) <= TOL[cd], (name, rel(g, w))
    # padded frames emit zeros; the 7.7 garbage never reaches a real frame
    assert np.all(got[0][mask[:, :, 0] == 0] == 0)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lstm_residuals_match_jax(cd):
    """The three residual streams of the forward (gates, cells, rounded h)
    equal the JAX ``_forward``'s."""
    gx, wh, mask, _ = scan_data(4, seed=1)
    _, (acts, cs, h_cds, _, _) = jax_lstm_scan._forward(
        jnp.asarray(gx), jnp.asarray(wh), jnp.asarray(mask), jnp.dtype(cd), 1, True)
    _, acts_p, cs_p, h_cds_p = lstm_scan.forward(
        torch.from_numpy(gx), torch.from_numpy(wh).to(getattr(torch, cd)), torch.from_numpy(mask), reverse=True)
    assert h_cds_p.dtype == getattr(torch, cd)
    for got, want in ((acts_p, acts), (cs_p, cs)):
        assert rel(got.numpy(), want) <= TOL[cd]
    assert rel(h_cds_p.float().numpy(), jnp.asarray(h_cds, jnp.float32)) <= H_CD_TOL[cd]


def test_lstm_frozen_carry_past_each_length():
    """A frame past an utterance's end leaves the carry as it was: the last
    real output of each row is also what a shorter T would give."""
    gx, wh, mask, _ = scan_data(4, seed=2)
    ys, *_ = lstm_scan.forward(torch.from_numpy(gx), torch.from_numpy(wh), torch.from_numpy(mask))
    for b, n in enumerate(LENGTHS):
        short, *_ = lstm_scan.forward(torch.from_numpy(gx[:n, b: b + 1]), torch.from_numpy(wh),
                                      torch.ones(n, 1, 1))
        torch.testing.assert_close(ys[:n, b], short[:, 0], rtol=0, atol=1e-6)

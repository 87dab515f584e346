"""The port's plain GRU scan (``tfkaldi_tpu_torch.ops.gru_scan``) against
``tfkaldi_tpu.ops.gru_scan``, on the CPU: the shapes, lengths, garbage and
tolerances of tests/test_torch_lstm_scan.py, whose docstring gives the
readings of both files. ``dW_h`` contracts against ``dgh``, whose n block
carries the reset gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_lstm_scan import (
    H_CD_TOL,
    TOL,
    H,
    jax_values_and_grads,
    port_values_and_grads,
    rel,
    scan_data,
)
from tfkaldi_tpu.ops import gru_scan as jax_gru_scan
from tfkaldi_tpu_torch.ops import gru_scan


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_matches_jax(cd, reverse):
    gx, wh, mask, cot = scan_data(3)
    want = jax_values_and_grads(jax_gru_scan.gru_scan, gx, wh, mask, cot, cd, reverse)
    got = port_values_and_grads(gru_scan.gru_scan, gx, wh, mask, cot, cd, reverse)
    for name, g, w in zip(("ys", "dgx", "dwh"), got, want):
        assert rel(g, w) <= TOL[cd], (name, rel(g, w))
    assert np.all(got[0][mask[:, :, 0] == 0] == 0)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_gru_residuals_match_jax(cd):
    """The four residual streams (gates, h, rounded h, gh_n) equal the JAX
    ``_forward``'s."""
    gx, wh, mask, _ = scan_data(3, seed=1)
    _, (acts, hs, h_cds, ghns, _, _) = jax_gru_scan._forward(
        jnp.asarray(gx), jnp.asarray(wh), jnp.asarray(mask), jnp.dtype(cd), 1, True)
    _, acts_p, hs_p, h_cds_p, ghns_p = gru_scan.forward(
        torch.from_numpy(gx), torch.from_numpy(wh).to(getattr(torch, cd)), torch.from_numpy(mask), reverse=True)
    for got, want in ((acts_p, acts), (hs_p, hs), (ghns_p, ghns)):
        assert rel(got.numpy(), want) <= TOL[cd]
    assert rel(h_cds_p.float().numpy(), jnp.asarray(h_cds, jnp.float32)) <= H_CD_TOL[cd]


def test_gru_dgh_is_dgx_with_the_reset_factor():
    """``dgh`` equals ``dgx`` in the r and z blocks and ``dgx_n · r`` in the
    n block (the operand of dW_h, gru_scan.py:147-152)."""
    gx, wh, mask, cot = scan_data(3, seed=2)
    _, acts, hs, _, ghns = gru_scan.forward(torch.from_numpy(gx), torch.from_numpy(wh), torch.from_numpy(mask))
    dgx, dgh = gru_scan.backward_scan(torch.from_numpy(cot), acts, hs, ghns, torch.from_numpy(mask),
                                      torch.from_numpy(wh))
    assert torch.equal(dgh[..., : 2 * H], dgx[..., : 2 * H])
    assert torch.equal(dgh[..., 2 * H:], dgx[..., 2 * H:] * acts[..., :H])

"""The port's bidirectional recurrences (``ops.lstm_bidi``, ``ops.gru_bidi``)
against the JAX package's interleaved-direction Pallas kernels
(``pallas_lstm.lstm_scan_bidi``, ``pallas_gru.gru_scan_bidi``), on the CPU.

The JAX kernels run through the Pallas interpreter, as
tests/test_pallas_lstm.py runs them (a fixture sets ``interpret = True``
and restores it); the port's wrappers, given CPU tensors, run the plain
versions of kernels 4-7. Shapes, lengths, garbage and tolerances are those
of tests/test_torch_lstm_scan.py: values and the gradients of both
directions' ``gx`` and ``wh``, f32 and bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_lstm_scan import TOL, rel, scan_data
from tfkaldi_tpu.ops import pallas_gru, pallas_lstm
from tfkaldi_tpu_torch.ops import gru_bidi, gru_scan, lstm_bidi, lstm_scan, rnn_bidi

CELLS = {
    "lstm": (4, pallas_lstm.lstm_scan_bidi, lstm_bidi.lstm_scan_bidi, lstm_bidi, lstm_scan.lstm_scan),
    "gru": (3, pallas_gru.gru_scan_bidi, gru_bidi.gru_scan_bidi, gru_bidi, gru_scan.gru_scan),
}


@pytest.fixture(autouse=True)
def _interpret_mode():
    saved = pallas_lstm.interpret, pallas_gru.interpret
    pallas_lstm.interpret = pallas_gru.interpret = True
    yield
    pallas_lstm.interpret, pallas_gru.interpret = saved


def _bidi_data(gates, seed):
    gxf, whf, mask, cotf = scan_data(gates, seed)
    gxb, whb, _, cotb = scan_data(gates, seed + 100)
    return gxf, gxb, whf, whb, mask, cotf, cotb


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bidi_matches_pallas_interpret(cell, cd):
    gates, jax_fn, port_fn, mod, _ = CELLS[cell]
    gxf, gxb, whf, whb, mask, cotf, cotb = _bidi_data(gates, seed=3)

    def jax_loss(*args):
        ysf, ysb = jax_fn(*args, jnp.asarray(mask), jnp.dtype(cd))
        return jnp.sum(ysf * cotf) + jnp.sum(ysb * cotb), (ysf, ysb)

    jargs = [jnp.asarray(a) for a in (gxf, gxb, whf, whb)]
    (_, want_ys), want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(*jargs)

    targs = [torch.tensor(a, requires_grad=True) for a in (gxf, gxb, whf, whb)]
    ysf, ysb = port_fn(*targs, torch.from_numpy(mask), getattr(torch, cd))
    ((ysf * torch.from_numpy(cotf)).sum() + (ysb * torch.from_numpy(cotb)).sum()).backward()

    for name, got, want in zip(("ysf", "ysb"), (ysf, ysb), want_ys):
        assert rel(got.detach().numpy(), want) <= TOL[cd], (name, rel(got.detach().numpy(), want))
    for name, t, want in zip(("dgxf", "dgxb", "dwhf", "dwhb"), targs, want_grads):
        assert rel(t.grad.numpy(), want) <= TOL[cd], (name, rel(t.grad.numpy(), want))
    c = mod.CELL  # CPU tensors never reach a kernel
    assert c.fwd_persistent_launches == c.fwd_launches == c.bwd_persistent_launches == c.bwd_launches == 0


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_one_direction_and_eval_path(cell):
    """A unidirectional layer (one direction through ``run``) is the forward
    scan of module 1/3, with and without gradients; the eval path (no
    residuals) gives the training forward's outputs."""
    gates, _, port_fn, mod, scan = CELLS[cell]
    gxf, gxb, whf, whb, mask, _, _ = _bidi_data(gates, seed=4)
    gx, wh, m = (torch.from_numpy(a) for a in (gxf, whf, mask))
    want = scan(gx, wh, m, torch.bfloat16)
    (got,) = rnn_bidi.run(mod.CELL, [gx.requires_grad_()], [wh], m, torch.bfloat16)
    assert torch.equal(got.detach(), want.detach())
    with torch.inference_mode():
        (got_eval,) = rnn_bidi.run(mod.CELL, [gx], [wh], m, torch.bfloat16)
        both_eval = port_fn(gx, torch.from_numpy(gxb), wh, torch.from_numpy(whb), m, torch.bfloat16)
    assert torch.equal(got_eval, want.detach())
    both = port_fn(gx, torch.from_numpy(gxb).requires_grad_(), wh, torch.from_numpy(whb), m, torch.bfloat16)
    for a, b in zip(both_eval, both):
        assert torch.equal(a, b.detach())

"""The port's fused BN backward (kernel 3's plain twin and ``BnReluLayer``)
against the JAX package, on the CPU.

- ``bn_dgrad_ref`` against JAX ``bn_fused_bwd._fused_dgrad`` in Pallas
  interpret mode, on the same numpy inputs (n = 512, h = 256, k = 128).
  f32: ``max|diff| / max|ref| <= 1e-5`` (f32 sums of 256 products in
  another order, and XLA:CPU may contract the dz formula into FMAs).
  bf16: every element within one bf16 step of the reference (both sides
  round an f32 value that may differ in its last bits), or, where a dh sum
  cancels to a value far below its terms, within the f32 accumulation
  noise of 1e-5 of max|ref|.
- ``BnReluLayer``'s forward is bit-identical to the port's unfused train
  chain (the same ops in the same order).
- Loss, batchnorm stats and every gradient of a 2-layer, 256-unit
  relu+BN DNN under masked CE against ``jax.value_and_grad`` of the
  unfused JAX model: normalized error < 1e-5 in f32 and < 2e-2 in bf16,
  the bounds of tests/test_bn_fused_bwd.py. The hidden biases, whose exact
  gradient is 0 under batchnorm, hold rounding noise on both sides: each
  must stay below 1e-2 of its layer's beta gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfkaldi_tpu.models.dnn import DNN as JaxDNN
from tfkaldi_tpu.models.dnn import DNNConfig as JaxDNNConfig
from tfkaldi_tpu.ops import bn_fused_bwd as jax_bn
from tfkaldi_tpu_torch.convert import dnn_from_jax
from tfkaldi_tpu_torch import layers
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.models.dnn import DNN, DNNConfig
from tfkaldi_tpu_torch.ops import bn_fused_bwd
from tfkaldi_tpu_torch.train.trainer import Trainer

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _dgrad_inputs(n=512, h=256, k=128, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    mask = f32(rng.random(n) > 0.2)
    return dict(
        g=f32(rng.standard_normal((n, h))) * mask[:, None],
        z=f32(rng.standard_normal((n, h))),
        mask=mask,
        wt=f32(rng.standard_normal((h, k)) / np.sqrt(h)),
        mean=f32(rng.standard_normal(h) * 0.1),
        r=f32(rng.uniform(0.5, 2.0, h)),
        beta=f32(rng.standard_normal(h) * 0.1),
        c1=f32(rng.standard_normal(h) * 0.01),
        c2=f32(rng.standard_normal(h) * 0.01),
    )


def _bf16_step(ref):
    """One bf16 spacing at each element's magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_jax_interpret_kernel(dtype):
    jdt, tdt = DTYPES[dtype]
    a = _dgrad_inputs()
    dh_j, dz_j = jax_bn._fused_dgrad(
        jnp.asarray(a["g"], jdt), jnp.asarray(a["z"], jdt), jnp.asarray(a["mask"]),
        jnp.asarray(a["wt"], jdt), *(jnp.asarray(a[v]) for v in ("mean", "r", "beta", "c1", "c2")),
        interpret=True,
    )
    t = {name: torch.from_numpy(v) for name, v in a.items()}
    before = bn_fused_bwd.launches
    dh, dz = bn_fused_bwd.bn_dgrad(
        t["g"].to(tdt), t["z"].to(tdt), t["mask"], t["wt"].t().to(tdt),
        t["mean"], t["r"], t["beta"], t["c1"], t["c2"],
    )
    assert bn_fused_bwd.launches == before  # CPU tensors take the plain version
    assert dh.dtype == tdt and dz.dtype == tdt and dh.shape == (512, 128) and dz.shape == (512, 256)
    for got, want in ((dh, dh_j), (dz, dz_j)):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            assert np.abs(got - want).max() / np.abs(want).max() <= 1e-5
        else:
            bound = np.maximum(_bf16_step(want), 1e-5 * np.abs(want).max())
            assert np.all(np.abs(got - want) <= bound)


def test_no_dh_launch_writes_dz_only():
    a = {k: torch.from_numpy(v) for k, v in _dgrad_inputs(n=64, h=32, k=16).items()}
    args = (a["g"], a["z"], a["mask"], a["wt"].t(), a["mean"], a["r"], a["beta"], a["c1"], a["c2"])
    dh, dz = bn_fused_bwd.bn_dgrad(*args, need_dh=False)
    assert dh is None
    assert torch.equal(dz, bn_fused_bwd.bn_dgrad(*args)[1])


def _layer_inputs(dtype, n=300, k=48, h=64, seed=1):
    rng = np.random.default_rng(seed)
    h_in = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((k, h)) / np.sqrt(k)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(h) * 0.1).astype(np.float32))
    beta = torch.from_numpy((rng.standard_normal(h) * 0.1).astype(np.float32))
    mask = torch.from_numpy((np.arange(n) < n - 37).astype(np.float32))
    return h_in, w, b, beta, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_forward_bit_identical_to_unfused_chain(dtype):
    h_in, w, b, beta, mask = _layer_inputs(dtype)
    act, mean, var = bn_fused_bwd.BnReluLayer.apply(h_in, w, b, beta, mask, 1e-3)
    z = layers.affine(h_in, w, b, dtype)
    mean0, var0, _ = layers.masked_moments(z.float(), mask)
    act0 = torch.relu(layers.batchnorm(z.float(), mean0, var0, beta, 1e-3, dtype))
    assert act.dtype == dtype
    assert torch.equal(act, act0) and torch.equal(mean, mean0) and torch.equal(var, var0)


# ---------------------------------------------------------------------------
# the whole DNN against JAX autodiff of the unfused model
# ---------------------------------------------------------------------------

IN, UNITS, LAYERS, OUT = 256, 256, 2, 64


def _models(dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = dict(input_dim=IN, num_labels=OUT, num_hidden_layers=LAYERS, num_hidden_units=UNITS,
               nonlin="relu", batch_norm=True)
    jax_model = JaxDNN(JaxDNNConfig(**cfg, compute_dtype=jdt, fused_bn_bwd=False))
    params, state = jax_model.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(7)
    # a non-zero output layer: with the zero init every hidden gradient is 0
    params["out"]["w"] = (rng.standard_normal((UNITS, OUT)) / np.sqrt(UNITS)).astype(np.float32)
    params["out"]["b"] = (rng.standard_normal(OUT) * 0.1).astype(np.float32)
    for layer in params["hidden"]:
        layer["beta"] = (rng.standard_normal(UNITS) * 0.1).astype(np.float32)
    port = DNN(DNNConfig(**cfg, compute_dtype=tdt))
    port.load_state_dict(dnn_from_jax(params, state))
    return jax_model, params, state, port


def _batch(b=4, t=128, seed=0):
    rng = np.random.default_rng(seed)
    inputs = rng.standard_normal((b, t, IN)).astype(np.float32)
    lengths = rng.integers(t // 2, t + 1, (b,)).astype(np.int32)
    targets = rng.integers(0, OUT, (b, t)).astype(np.int32)
    return inputs, lengths, targets


def _jax_loss(model):
    def loss(params, state, inputs, lengths, targets):
        logits, new_state = model.apply(params, state, inputs, lengths, train=True)
        mask = jnp.arange(logits.shape[1])[None, :] < lengths[:, None]
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
        return jnp.sum(ce * mask), new_state

    return loss


def _port_loss_and_grads(port, inputs, lengths, targets):
    batch = PaddedBatch(*(torch.from_numpy(a) for a in (inputs, targets, lengths, lengths)))
    loss, _ = Trainer.loss_sum(port, batch, train=True)
    loss.backward()
    grads = {n: p.grad.double().numpy() for n, p in port.named_parameters()}
    return loss.item(), grads


def _flat_jax_grads(g):
    out = {f"out.{k}": np.asarray(v, np.float64) for k, v in g["out"].items()}
    for l, layer in enumerate(g["hidden"]):
        out.update({f"hidden.{l}.{k}": np.asarray(v, np.float64) for k, v in layer.items()})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_unfused_autodiff(dtype):
    jax_model, params, state, port = _models(dtype)
    inputs, lengths, targets = _batch()
    (loss_j, state_j), g_j = jax.value_and_grad(_jax_loss(jax_model), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state), inputs, lengths, targets
    )
    loss, grads = _port_loss_and_grads(port, inputs, lengths, targets)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert abs(loss - float(loss_j)) / abs(float(loss_j)) < tol
    for name in ("bn_mean", "bn_var"):
        want = np.asarray(state_j[name], np.float64)
        got = getattr(port, name).double().numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < tol, name
    flat = _flat_jax_grads(g_j)
    assert set(flat) == set(grads)
    for name, want in flat.items():
        if name.startswith("hidden.") and name.endswith(".b"):
            # batchnorm removes the bias: its exact gradient is 0, and both
            # frameworks hold rounding noise there, far below the layer's
            # beta gradient
            beta = np.abs(flat[name[:-1] + "beta"]).max()
            assert max(np.abs(want).max(), np.abs(grads[name]).max()) < 1e-2 * beta, name
            continue
        scale = max(np.abs(want).max(), 1e-3)
        assert np.abs(grads[name] - want).max() / scale < tol, name


def test_poisoned_padding_rows_leave_gradients_unchanged():
    _, params, state, port = _models("float32")
    inputs, lengths, targets = _batch()
    _, grads = _port_loss_and_grads(port, inputs, lengths, targets)
    poisoned = inputs.copy()
    for i, n in enumerate(lengths):
        poisoned[i, n:] = 1e3
    port2 = DNN(port.config)
    port2.load_state_dict(dnn_from_jax(params, state))
    _, grads2 = _port_loss_and_grads(port2, poisoned, lengths, targets)
    for name, g in grads.items():
        np.testing.assert_allclose(grads2[name], g, atol=1e-5, err_msg=name)


def test_eval_path_unchanged():
    """The eval forward takes the fused FFN block on the moving stats: it
    matches the JAX eval forward (1e-4: f32 sums in another order, and the
    BN affine folded into scale/shift) and updates no statistics."""
    jax_model, params, state, port = _models("float32")
    inputs, lengths, _ = _batch(seed=3)
    want, _ = jax_model.apply(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                              inputs, lengths, train=False)
    mean0 = port.bn_mean.clone()
    with torch.inference_mode():
        got = port(torch.from_numpy(inputs), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert torch.equal(port.bn_mean, mean0)

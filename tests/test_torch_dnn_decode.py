"""Port's DNN eval forward and likelihood emission vs the JAX package.

Parameters come from the JAX ``DNN.init(PRNGKey(0))`` (with batchnorm
stats, ``beta`` and the output layer moved away from their identity
inits), converted by ``convert.dnn_from_jax``. The JAX side runs its
``Decoder._compute`` unfused and with ``use_pallas_ffn`` (Pallas interpret
mode on the CPU); the port runs its fused-block plain version on CPU
tensors. Tolerance rtol = atol = 1e-4: f32 sums in a different order through
two 512-wide layers, and the eval batchnorm folded into scale/shift on the
port's side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfkaldi_tpu.decode.decoder import Decoder as JaxDecoder
from tfkaldi_tpu.models.dnn import DNN as JaxDNN
from tfkaldi_tpu.models.dnn import DNNConfig as JaxDNNConfig
from tfkaldi_tpu_torch.convert import dnn_from_jax
from tfkaldi_tpu_torch.decode.decoder import Decoder
from tfkaldi_tpu_torch.models.dnn import DNN, DNNConfig
from tfkaldi_tpu_torch.ops import fused_mlp

TOL = dict(rtol=1e-4, atol=1e-4)
IN, HID, LAYERS, OUT = 440, 512, 2, 16


def _jax_model(use_pallas=False, **over):
    cfg = dict(input_dim=IN, num_labels=OUT, num_hidden_layers=LAYERS, num_hidden_units=HID,
               nonlin="relu", batch_norm=True, use_pallas_ffn=use_pallas)
    cfg.update(over)
    model = JaxDNN(JaxDNNConfig(**cfg))
    params, state = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    params["out"]["w"] = (rng.standard_normal((HID, OUT)) / np.sqrt(HID)).astype(np.float32)
    params["out"]["b"] = (rng.standard_normal(OUT) * 0.1).astype(np.float32)
    if cfg["batch_norm"]:
        for layer in params["hidden"]:
            layer["beta"] = (rng.standard_normal(HID) * 0.1).astype(np.float32)
        state["bn_mean"] = state["bn_mean"] + 0.3
        state["bn_var"] = state["bn_var"] * 1.7
    return model, params, state


def _port_model(params, state, **over):
    cfg = dict(input_dim=IN, num_labels=OUT, num_hidden_layers=LAYERS, num_hidden_units=HID,
               nonlin="relu", batch_norm=True)
    cfg.update(over)
    model = DNN(DNNConfig(**cfg))
    model.load_state_dict(dnn_from_jax(params, state))
    return model.requires_grad_(False)  # eval forward only


def _inputs(seed=2):
    rng = np.random.default_rng(seed)
    inputs = rng.standard_normal((4, 128, IN)).astype(np.float32)
    lengths = np.asarray([128, 100, 64, 128], np.int32)
    return inputs, lengths


def _prior():
    p = np.random.default_rng(9).uniform(0.5, 1.5, OUT)
    return (p / p.sum()).astype(np.float32)


def _jax_outputs(model, params, state, inputs, lengths):
    jp = jax.tree.map(jnp.asarray, params)
    js = jax.tree.map(jnp.asarray, state)
    logits, _ = model.apply(jp, js, jnp.asarray(inputs), jnp.asarray(lengths), train=False)
    dec = JaxDecoder(model, jp, js, _prior())
    likes = dec._compute(jnp.asarray(inputs), jnp.asarray(lengths), jp, js)
    return np.asarray(logits), np.asarray(likes)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_logits_and_likelihoods_match_jax(use_pallas):
    model, params, state = _jax_model(use_pallas)
    inputs, lengths = _inputs()
    want_logits, want_likes = _jax_outputs(model, params, state, inputs, lengths)
    port = _port_model(params, state)
    before = fused_mlp.launches
    logits = port(torch.from_numpy(inputs), torch.from_numpy(lengths)).numpy()
    likes = Decoder(port, _prior()).compute_batch(inputs, lengths).numpy()
    assert fused_mlp.launches == before  # CPU tensors take the plain version
    np.testing.assert_allclose(logits, want_logits, **TOL)
    np.testing.assert_allclose(likes, want_likes, **TOL)


def test_unfused_chain_matches_jax():
    """sigmoid + l2-norm does not fit the fused epilogue: plain tensor code."""
    over = dict(nonlin="sigmoid", l2_norm=True)
    model, params, state = _jax_model(**over)
    inputs, lengths = _inputs(3)
    want_logits, _ = _jax_outputs(model, params, state, inputs, lengths)
    logits = _port_model(params, state, **over)(torch.from_numpy(inputs)).numpy()
    np.testing.assert_allclose(logits, want_logits, **TOL)


def test_padding_rows_do_not_change_real_rows():
    _, params, state = _jax_model()
    port = _port_model(params, state)
    inputs, lengths = _inputs()
    base = port(torch.from_numpy(inputs)).numpy()
    noisy = inputs.copy()
    for b, n in enumerate(lengths):
        noisy[b, n:] = 1e3 * np.random.default_rng(b).standard_normal(noisy[b, n:].shape)
    out = port(torch.from_numpy(noisy)).numpy()
    for b, n in enumerate(lengths):
        np.testing.assert_array_equal(out[b, :n], base[b, :n])


@pytest.mark.parametrize("depth", [0, 1])
def test_depth_selector_matches_jax(depth):
    model, params, state = _jax_model(layerwise_init=True)
    state["depth"] = np.asarray(depth, np.int32)
    inputs, lengths = _inputs(4)
    want_logits, _ = _jax_outputs(model, params, state, inputs, lengths)
    logits = _port_model(params, state, layerwise_init=True)(torch.from_numpy(inputs)).numpy()
    np.testing.assert_allclose(logits, want_logits, **TOL)


def test_config_parses_like_jax():
    conf = {"num_hidden_layers": "3", "num_hidden_units": "64", "nonlin": "tanh",
            "batch_norm": "True", "l2_norm": "True", "dropout": "0.8", "add_layer_period": "2"}
    port = DNNConfig.from_config(conf, 99, 7)
    ref = JaxDNNConfig.from_config(conf, 99, 7)
    for field in ("input_dim", "num_labels", "num_hidden_layers", "num_hidden_units", "nonlin",
                  "batch_norm", "l2_norm", "layerwise_init", "bn_eps"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.compute_dtype == torch.float32

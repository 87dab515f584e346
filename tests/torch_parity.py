"""Shared checks of a port model against its JAX model on the CPU, for the
families whose JAX ``apply`` reaches no Pallas kernel (the TDNN and the
CNN): the same seeded params through ``convert``, the same numpy inputs,
and the tolerances of tests/test_torch_trainer.py and test_torch_rnn.py.

- f32 forward (train and eval): logits at real frames within 1e-5 of
  max|ref|, the batchnorm moving stats within 1e-5;
- gradients of a fixed linear functional of the logits within 1e-4 of each
  leaf's max|ref|; in training the bias ``b`` of a batchnorm layer has an
  exactly-zero true gradient (the batch moments remove it), so on both
  sides it must stay rounding noise: below BN_BIAS_NOISE of the layer's
  ``beta`` gradient;
- bf16: the port's distance from the JAX f32 result within BF16_RATIO of
  the JAX bf16 result's own distance (+ 1e-5 for what the rounding leaves
  as it is), the JAX side run op by op so that it rounds where its code
  says;
- a trajectory of a few steps of the port's ``Trainer`` against the JAX
  ``Trainer`` from one converted state.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfkaldi_tpu.data.batching import PaddedBatch as JaxPaddedBatch
from tfkaldi_tpu.train import Trainer as JaxTrainer
from tfkaldi_tpu.train import TrainerConfig as JaxTrainerConfig
from tfkaldi_tpu_torch.convert import train_state_from_jax
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.models import build_model
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

F32_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_RATIO = 2.0
BN_BIAS_NOISE = 1e-4


def rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def random_start(jax_model, seed: int, scale: float = 0.3):
    """The JAX model's params and state with every leaf redrawn from a
    seeded normal (the output layer too, so the logits see every hidden
    unit), the moving stats away from (0, 1). Numpy leaves."""
    params, state = jax_model.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32), params)

    def stat(name, a):
        a = np.asarray(a)
        if "var" in name:
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if "mean" in name:
            return (rng.standard_normal(a.shape) * 0.2).astype(np.float32)
        return a

    state = {k: ([stat(k, s) for s in v] if isinstance(v, list) else stat(k, v)) for k, v in state.items()}
    return params, state


def batch(rng, b: int, t: int, f: int, lengths) -> tuple[np.ndarray, np.ndarray]:
    """Seeded inputs ``[b, t, f]`` with garbage past each length (the models
    must mask it) and the lengths."""
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    for i, n in enumerate(lengths):
        x[i, n:] = 1e3
    return x, lengths


def port_model(config, state_dict):
    model = build_model(config)
    model.load_state_dict(state_dict)
    return model


def _bn_bias(name: str, names) -> bool:
    """The bias of a batchnorm layer: in training its true gradient is
    exactly zero (the batch moments remove it)."""
    return name.endswith(".b") and name[:-2] + ".beta" in names


def _real(lengths, t):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def _jax_logits_and_grads(jax_model, params, state, x, lengths, weights, train, *, jit: bool):
    """The JAX model's logits, new state and the gradients of ``sum(logits ·
    weights)``. ``jit`` compiles the whole gradient once (fast); without it
    every op runs on its own, so each bf16 rounding the model's code states
    happens, where a compiled fusion may keep the excess precision (XLA's
    ``xla_allow_excess_precision``, on by default)."""
    jstate = jax.tree.map(jnp.asarray, state)

    def loss(p):
        logits, new_state = jax_model.apply(p, jstate, jnp.asarray(x), jnp.asarray(lengths), train=train)
        return jnp.sum(logits * weights), (logits, new_state)

    grad = jax.grad(loss, has_aux=True)
    grads, (logits, new_state) = (jax.jit(grad) if jit else grad)(jax.tree.map(jnp.asarray, params))
    return np.asarray(logits), jax.tree.map(np.asarray, new_state), jax.tree.map(np.asarray, grads)


def _port_logits_and_grads(model, x, lengths, weights, train):
    model.zero_grad()
    logits = model(torch.from_numpy(x), torch.from_numpy(lengths), train=train)
    torch.sum(logits * torch.from_numpy(weights)).backward()
    grads = {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()}
    return logits.detach().numpy(), grads


def check_f32(jax_model, config, convert, params, state, x, lengths, *, train: bool):
    """f32 forward, moving stats and gradients of the port against JAX."""
    real = _real(lengths, x.shape[1])
    weights = (np.random.default_rng(7).standard_normal((*x.shape[:2], config.num_labels)) * real[..., None])
    weights = weights.astype(np.float32)
    j_logits, j_state, j_grads = _jax_logits_and_grads(jax_model, params, state, x, lengths, weights, train,
                                                       jit=True)
    model = port_model(config, convert(params, state))
    logits, grads = _port_logits_and_grads(model, x, lengths, weights, train)
    assert rel(logits[real], j_logits[real]) <= F32_TOL, rel(logits[real], j_logits[real])
    want_sd = convert(params, j_state)
    for name, buf in model.named_buffers():
        if name != "depth":
            assert rel(buf.numpy(), want_sd[name].numpy()) <= F32_TOL, name
    want = convert(j_grads, {"depth": np.int32(0)})
    for name, g in grads.items():
        if train and _bn_bias(name, grads):
            dbeta = max(np.abs(grads[name[:-2] + ".beta"]).max(), 1e-30)
            assert np.abs(g).max() <= BN_BIAS_NOISE * dbeta, name
            assert np.abs(want[name].numpy()).max() <= BN_BIAS_NOISE * dbeta, name
            continue
        assert rel(g, want[name].numpy()) <= GRAD_TOL, (name, rel(g, want[name].numpy()))
    return logits, grads


def check_bf16(jax_bf16, jax_f32, config, convert, params, state, x, lengths, *, train: bool):
    """bf16 logits and gradients by the 2x rule against the JAX f32 run.
    Returns the port's gradients and the JAX bf16 run's, by the port's
    names."""
    real = _real(lengths, x.shape[1])
    weights = (np.random.default_rng(8).standard_normal((*x.shape[:2], config.num_labels)) * real[..., None])
    weights = weights.astype(np.float32)
    runs = {name: _jax_logits_and_grads(m, params, state, x, lengths, weights, train, jit=name == "f32")
            for name, m in (("bf16", jax_bf16), ("f32", jax_f32))}
    model = port_model(config, convert(params, state))
    logits, grads = _port_logits_and_grads(model, x, lengths, weights, train)
    mine, theirs = rel(logits[real], runs["f32"][0][real]), rel(runs["bf16"][0][real], runs["f32"][0][real])
    print(f"bf16 logits: port {mine!r}, JAX {theirs!r} from the f32 result")  # shown with -s
    assert theirs > 0 and mine <= BF16_RATIO * theirs + F32_TOL, (mine, theirs)
    want = {name: convert(run[2], {"depth": np.int32(0)}) for name, run in runs.items()}
    for name, g in grads.items():
        if train and _bn_bias(name, grads):
            continue  # rounding noise on every side (see check_f32)
        ref = want["f32"][name].numpy()
        mine, theirs = rel(g, ref), rel(want["bf16"][name].numpy(), ref)
        assert mine <= BF16_RATIO * theirs + F32_TOL, (name, mine, theirs)
    return grads, {name: g.numpy() for name, g in want["bf16"].items()}


def check_trajectory(jax_model, config, params, state, *, steps: int, f: int, seed: int):
    """``steps`` updates of the port's ``Trainer`` and of the JAX ``Trainer``
    from one converted state (dropout 1), on seeded batches of ragged
    lengths: every step loss within 1e-5 relative; then the parameters
    within 2e-5 absolute (a step moves them by about lr = 1e-3), the Adam
    slots within 1e-4 of each leaf's max|value|, the moving stats within
    1e-5. The batchnorm layers' biases (a zero true gradient) only stay
    within ``steps`` Adam steps of their start."""
    jtrainer = JaxTrainer(jax_model, JaxTrainerConfig(init_learning_rate=1e-3, num_steps=50))
    jstate = jtrainer.init_state(jax.random.PRNGKey(seed))
    jstate = dataclasses.replace(jstate, params=jax.tree.map(jnp.asarray, params),
                                 model_state=jax.tree.map(jnp.asarray, state))
    port_state = train_state_from_jax(jax.tree.map(np.asarray, jstate), config)
    start = {n: p.detach().numpy().copy() for n, p in port_state.model.named_parameters()}
    trainer = Trainer(config, TrainerConfig(init_learning_rate=1e-3, num_steps=50), device="cpu")
    rng = np.random.default_rng(seed)
    for step in range(steps):
        lengths = rng.integers(8, 17, 3).astype(np.int32)
        x, _ = batch(rng, 3, 16, f, lengths)
        x[~_real(lengths, 16)] = 0.0
        y = rng.integers(0, config.num_labels, (3, 16)).astype(np.int32)
        jstate, jloss = jtrainer.update(jstate, JaxPaddedBatch(x, y, lengths, lengths))
        port_state, loss = trainer.update(port_state, PaddedBatch(*(torch.from_numpy(a) for a in (x, y, lengths,
                                                                                                     lengths))))
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss)), (step, loss.item(), float(jloss))
    want = train_state_from_jax(jax.tree.map(np.asarray, jstate), config)
    assert port_state.step == want.step == steps and port_state.adam_t == want.adam_t == steps
    want_params = dict(want.model.named_parameters())
    for name, p in port_state.model.named_parameters():
        got, ref = p.detach().numpy(), want_params[name].detach().numpy()
        if _bn_bias(name, want_params):
            bound = steps * steps * 1e-3
            assert np.abs(got - start[name]).max() <= bound and np.abs(ref - start[name]).max() <= bound, name
            continue
        np.testing.assert_allclose(got, ref, atol=2e-5, err_msg=name)
        for slot in ("adam_m", "adam_v"):
            a, b = getattr(port_state, slot)[name].numpy(), getattr(want, slot)[name].numpy()
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), (slot, name)
    want_buffers = dict(want.model.named_buffers())
    for name, buf in port_state.model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want_buffers[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Import into a test module to run it on one intra-op torch thread: the
    port's streaming steps are many small ops, and a worker's threads only
    contend with the other test workers; the worker gets its threads back
    after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

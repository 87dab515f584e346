"""The port's model + trainer against the contract of tests/test_trainer.py
and against the JAX ``Trainer``, on the CPU.

Weights cross over through ``convert`` (the RNG streams of the two
frameworks differ, so nothing compares random bits). Tolerances, with their
reasons, sit beside each comparison.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfkaldi_tpu.data.batching import PaddedBatch as JaxPaddedBatch
from tfkaldi_tpu.models import DNN as JaxDNN
from tfkaldi_tpu.models import DNNConfig as JaxDNNConfig
from tfkaldi_tpu.train import Trainer as JaxTrainer
from tfkaldi_tpu.train import TrainerConfig as JaxTrainerConfig
from tfkaldi_tpu_torch.convert import train_state_from_jax
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.models.dnn import DNNConfig
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

MODEL = dict(input_dim=12, num_labels=7, num_hidden_layers=2, num_hidden_units=16, nonlin="relu")


def _trainer(num_steps=10, **over):
    tcfg = {k: over.pop(k) for k in ("init_learning_rate", "learning_rate_decay", "micro_batches") if k in over}
    return Trainer(DNNConfig(**{**MODEL, **over}), TrainerConfig(num_steps=num_steps, **tcfg), device="cpu")


def _batch(rng, b=4, t=10, f=12, labels=7, lengths=None):
    lengths = np.asarray(lengths if lengths is not None else [t] * b, np.int32)
    inputs = rng.standard_normal((b, t, f)).astype(np.float32)
    targets = rng.integers(0, labels, (b, t)).astype(np.int32)
    for i, n in enumerate(lengths):
        inputs[i, n:] = 0
        targets[i, n:] = 0
    return inputs, targets, lengths


def _torch(arrays) -> PaddedBatch:
    inputs, targets, lengths = arrays
    return PaddedBatch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (inputs, targets, lengths, lengths)))


def _widen(arrays, extra):
    inputs, targets, lengths = arrays
    return (np.pad(inputs, ((0, 0), (0, extra), (0, 0))), np.pad(targets, ((0, 0), (0, extra))), lengths)


def test_forward_shapes_and_zero_output_layer():
    trainer = _trainer()
    state = trainer.init_state(0)
    batch = _torch(_batch(np.random.default_rng(0), lengths=[10, 7, 3, 10]))
    with torch.inference_mode():
        logits = state.model(batch.inputs, batch.input_lengths)
    assert logits.shape == (4, 10, 7)
    assert torch.all(logits == 0)  # zero-init output layer


@pytest.mark.parametrize("batch_norm,extra,tol", [(False, 6, 1e-6), (True, 4, 1e-5)])
def test_padding_invariance(batch_norm, extra, tol):
    """More padding changes neither the loss nor the update (masked CE and
    masked batchnorm moments; the bounds of tests/test_trainer.py)."""
    trainer = _trainer(batch_norm=batch_norm)
    arrays = _batch(np.random.default_rng(1 + batch_norm), b=2, t=8, lengths=[8, 5])
    s1, l1 = trainer.update(trainer.init_state(1), _torch(arrays))
    s2, l2 = trainer.update(trainer.init_state(1), _torch(_widen(arrays, extra)))
    assert abs(l1.item() - l2.item()) <= tol
    for (name, a), b in zip(s1.model.named_parameters(), s2.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=tol, err_msg=name)


def test_grad_accumulation_equivalence():
    """Four microbatches give the update of the whole batch (no BN or
    dropout, so the microbatch order cannot matter)."""
    arrays = _batch(np.random.default_rng(3), b=8, t=6, lengths=[6, 5, 4, 6, 3, 6, 5, 4])
    s1, l1 = _trainer(micro_batches=1).update(_trainer().init_state(4), _torch(arrays))
    s4, l4 = _trainer(micro_batches=4).update(_trainer().init_state(4), _torch(arrays))
    assert np.isclose(l1.item(), l4.item(), rtol=1e-6)
    for a, b in zip(s1.model.parameters(), s4.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=2e-6)


def test_tf_adam_semantics_tiny_model():
    """One step against a numpy replication of the reference optimizer
    (trainer.py:108-184): frame mean, clip, exp-decay LR, TF-Adam with eps
    outside the sqrt."""
    trainer = Trainer(
        DNNConfig(input_dim=3, num_labels=2, num_hidden_layers=1, num_hidden_units=4),
        TrainerConfig(init_learning_rate=0.01, learning_rate_decay=0.5, num_steps=20),
        device="cpu",
    )
    state = trainer.init_state(6)
    with torch.no_grad():  # a non-zero output layer, so every gradient is live
        state.model.out.w.copy_(torch.from_numpy(np.random.default_rng(1).standard_normal((4, 2)).astype(np.float32)))
    arrays = _batch(np.random.default_rng(6), b=2, t=4, f=3, labels=2, lengths=[4, 3])
    p = {n: t.detach().double().numpy().copy() for n, t in state.model.named_parameters()}
    x = arrays[0].reshape(-1, 3).astype(np.float64)
    y = arrays[1].reshape(-1)
    mask = (np.arange(4)[None, :] < arrays[2][:, None]).reshape(-1)
    z = x @ p["hidden.0.w"] + p["hidden.0.b"]
    h = np.maximum(z, 0)
    logits = h @ p["out.w"] + p["out.b"]
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob /= prob.sum(1, keepdims=True)
    dlogits = prob.copy()
    dlogits[np.arange(len(y)), y] -= 1
    dlogits *= mask[:, None]
    dz = (dlogits @ p["out.w"].T) * (z > 0)
    grads = {"hidden.0.w": x.T @ dz, "hidden.0.b": dz.sum(0), "out.w": h.T @ dlogits, "out.b": dlogits.sum(0)}
    lr_t = 0.01 * 0.5 ** (0 / 20) * np.sqrt(1 - 0.999) / (1 - 0.9)
    new_state, _ = trainer.update(state, _torch(arrays))
    for name, g in grads.items():
        g = np.clip(g / mask.sum(), -1, 1)
        want = -lr_t * (0.1 * g) / (np.sqrt(0.001 * np.square(g)) + 1e-8)
        got = dict(new_state.model.named_parameters())[name].detach().numpy() - p[name]
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)


def test_loss_decreases_on_learnable_data():
    trainer = _trainer(num_steps=50, batch_norm=True, init_learning_rate=0.01)
    state = trainer.init_state(8)
    rng = np.random.default_rng(8)
    losses = []
    for _ in range(30):
        inputs = rng.standard_normal((8, 10, 12)).astype(np.float32)
        targets = (inputs.sum(-1) > 0).astype(np.int32)  # label from sign
        state, loss = trainer.update(state, _torch((inputs, targets, np.full(8, 10, np.int32))))
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.7, losses


def test_halve_learning_rate_and_add_layer():
    trainer = _trainer(layerwise_init=True)
    state = trainer.init_state(9)
    assert state.lr_fact == 1.0
    state = trainer.halve_learning_rate(state)
    assert state.lr_fact == 0.5
    assert int(state.model.depth) == 0
    with torch.no_grad():  # non-zero output layer and Adam slots, then add a layer
        for name in ("out.w", "out.b"):
            dict(state.model.named_parameters())[name].add_(1.0)
            state.adam_m[name].add_(1.0)
            state.adam_v[name].add_(1.0)
    state = trainer.add_layer(state)
    assert int(state.model.depth) == 1
    for name in ("out.w", "out.b"):
        assert not dict(state.model.named_parameters())[name].any()
        assert not state.adam_m[name].any() and not state.adam_v[name].any()


def test_depth_selector_changes_forward():
    trainer = _trainer(layerwise_init=True, num_hidden_layers=3)
    model = trainer.init_state(10).model
    with torch.no_grad():
        model.out.w.fill_(1.0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 5, 12)).astype(np.float32))
    with torch.inference_mode():
        out0 = model(x).clone()
        model.depth.fill_(2)
        out2 = model(x)
    assert not torch.allclose(out0, out2)


def test_evaluate_frame_weighted_average():
    trainer = _trainer()
    state = trainer.init_state(11)
    rng = np.random.default_rng(11)
    b1 = _torch(_batch(rng, b=2, t=6, lengths=[6, 2]))
    b2 = _torch(_batch(rng, b=2, t=6, lengths=[3, 3]))
    # zero-init output → uniform softmax → ln(num_labels) per frame
    assert np.isclose(trainer.evaluate(state, [b1, b2]), np.log(7), atol=1e-5)


def test_dropout_only_in_training(monkeypatch):
    """Eval is deterministic; in training each unit is kept with
    probability p and scaled by 1/p (checked by statistics over 64,000
    units: the kept fraction within 0.01 of p, about 5 standard errors)."""
    from tfkaldi_tpu_torch.models import dnn as port_dnn

    trainer = _trainer(dropout=0.5)
    state = trainer.init_state(12)
    batch = _torch(_batch(np.random.default_rng(12)))
    assert trainer.evaluate(state, [batch]) == trainer.evaluate(state, [batch])
    trainer.update(state, batch)  # the training step draws its masks
    model = state.model
    with torch.no_grad():
        model.hidden[0].w.zero_()
        model.hidden[0].b.fill_(1.0)  # layer 0 is exactly 1 before its dropout
        model.hidden[1].w.copy_(torch.eye(16))
        model.hidden[1].b.zero_()  # layer 1 passes layer 0's dropped output on
    seen = []
    nonlin = port_dnn._nonlin
    monkeypatch.setattr(port_dnn, "_nonlin", lambda z, kind: seen.append(nonlin(z, kind)) or seen[-1])
    x = torch.ones(40, 100, 12)
    model(x, torch.full((40,), 100), train=True, generator=trainer.dropout_generator(state))
    assert torch.all(seen[0] == 1.0)
    assert set(torch.unique(seen[1]).tolist()) <= {0.0, 2.0}  # dropped, or kept and scaled by 1/p
    kept = (seen[1] == 2.0).float().mean().item()
    assert abs(kept - 0.5) < 0.01


# ---------------------------------------------------------------------------
# trajectory against the JAX Trainer
# ---------------------------------------------------------------------------

TRAJ = dict(input_dim=20, num_labels=9, num_hidden_layers=2, num_hidden_units=32, nonlin="relu", batch_norm=True)
# the trajectory's models: the flagship recipe's relu + batchnorm (config_AURORA4.cfg), and
# config_CGN.cfg's relu + l2_norm without batchnorm (its dropout 0.5 set to 1: the RNG
# streams differ, so dropout is held by test_dropout_only_in_training instead)
TRAJ_CASES = {"relu_bn": TRAJ, "relu_l2_norm": {**TRAJ, "batch_norm": False, "l2_norm": True}}


def _jax_start(seed=0, model_cfg=TRAJ):
    model = JaxDNN(JaxDNNConfig(**model_cfg))
    jtrainer = JaxTrainer(model, JaxTrainerConfig(init_learning_rate=1e-3, num_steps=50))
    state = jtrainer.init_state(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, state.params)
    # a non-zero output layer: no early gradient sits at exactly 0
    params["out"]["w"] = (rng.standard_normal(params["out"]["w"].shape) * 0.3).astype(np.float32)
    params["out"]["b"] = (rng.standard_normal(params["out"]["b"].shape) * 0.1).astype(np.float32)
    state = dataclasses.replace(state, params=jax.tree.map(jnp.asarray, params))
    return jtrainer, state


@pytest.mark.parametrize("case", sorted(TRAJ_CASES))
def test_five_step_trajectory_matches_jax(case):
    """Five steps from the same converted state with dropout 1: the step
    losses agree within 1e-5 relative (f32 sums in another order). Adam
    slots and parameters: within 1e-4 of each leaf's max|value| (v, m) and
    2e-5 absolute (parameters; a step moves them by about lr = 1e-3). The
    hidden biases of the batchnorm layers have an exactly-zero true
    gradient, so their Adam steps follow the sign of rounding noise and are
    compared only for staying within 5 steps (5 lr·√(1−β2)/(1−β1)·5) of the
    start; without batchnorm they are compared like every parameter."""
    model_cfg = TRAJ_CASES[case]
    batch_norm = model_cfg["batch_norm"]
    jtrainer, jstate = _jax_start(model_cfg=model_cfg)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), DNNConfig(**model_cfg))
    trainer = Trainer(DNNConfig(**model_cfg), TrainerConfig(init_learning_rate=1e-3, num_steps=50), device="cpu")
    rng = np.random.default_rng(5)
    for step in range(5):
        arrays = _batch(rng, b=4, t=16, f=20, labels=9, lengths=rng.integers(8, 17, 4))
        jstate, jloss = jtrainer.update(jstate, JaxPaddedBatch(arrays[0], arrays[1], arrays[2], arrays[2]))
        state, loss = trainer.update(state, _torch(arrays))
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss)), step
    assert state.step == int(jstate.step) == 5 and state.adam_t == int(jstate.adam_t) == 5
    want = train_state_from_jax(jax.tree.map(np.asarray, jstate), DNNConfig(**model_cfg))
    for name, p in state.model.named_parameters():
        got, ref = p.detach().numpy(), dict(want.model.named_parameters())[name].detach().numpy()
        if batch_norm and name.startswith("hidden.") and name.endswith(".b"):
            assert np.abs(got).max() <= 5 * 5 * 1e-3 and np.abs(ref).max() <= 5 * 5 * 1e-3, name
            continue
        np.testing.assert_allclose(got, ref, atol=2e-5, err_msg=name)
        for slot in ("adam_m", "adam_v"):
            a, b = getattr(state, slot)[name].numpy(), getattr(want, slot)[name].numpy()
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), (slot, name)
    for name in ("bn_mean", "bn_var") if batch_norm else ():
        np.testing.assert_allclose(getattr(state.model, name).numpy(), getattr(want.model, name).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_learning_rate_in_float32_matches_jax():
    """lr = init·decay^(step/num_steps)·lr_fact in float32, as JAX computes
    it (trainer.py:414-420): equal to within one f32 ulp (numpy's and XLA's
    float32 ``pow`` may round differently)."""
    trainer = Trainer(DNNConfig(**MODEL), TrainerConfig(init_learning_rate=1e-3, learning_rate_decay=0.1,
                                                        num_steps=37), device="cpu")
    state = trainer.init_state(0)
    for step, fact in ((0, 1.0), (5, 0.5), (36, 0.125)):
        state.step, state.lr_fact = step, fact
        want = 1e-3 * jnp.power(0.1, jnp.float32(step) / 37) * jnp.float32(fact)
        got = trainer.learning_rate(state)
        assert got.dtype == np.float32
        assert abs(got - np.float32(want)) <= np.spacing(np.float32(want))


def test_unsupported_losses_and_specaugment_raise(tmp_path):
    """An unpaired loss is refused; ``specaugment = True`` trains (it is
    ported: the knob reaches the trainer and masks every training batch)."""
    from configparser import ConfigParser

    from tests.synthetic import make_featdir
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.nnet import Nnet

    def config(**over):
        cfg = ConfigParser()
        cfg["directories"] = {"expdir": str(tmp_path)}
        cfg["nnet"] = {"name": "net", "num_hidden_units": "8", "num_hidden_layers": "1", **over}
        return cfg

    with pytest.raises(ValueError, match="model = transducer and loss = rnnt"):  # ported: it pairs with transducer
        Nnet(config(loss="rnnt"), 4, 5, device="cpu")
    featdir, alifile, info = make_featdir(tmp_path)
    disp = AlignmentBatchDispenser(
        FeatureReader(f"{featdir}/feats.scp", f"{featdir}/cmvn.scp", f"{featdir}/utt2spk", 0, 60),
        AlignmentCoder(identity_normalizer, info["num_labels"]), 4, alifile)
    net = Nnet(config(specaugment="True", batch_size="4", valid_batches="1", num_epochs="1",
                      spec_time_width="4", spec_freq_width="2"),
               info["feat_dim"], info["num_labels"], device="cpu")
    calls = []
    spec_augment = Trainer.spec_augment
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Trainer, "spec_augment", lambda self, state, batch: calls.append(state.step)
                   or spec_augment(self, state, batch))
        state = net.train(disp)
    assert calls == list(range(state.step)) and state.step > 0
    assert all(p.isfinite().all() for p in state.model.parameters())


# bench.py's DNN (440 -> 6x2048 relu+BN -> 2000, compute_dtype bfloat16) at
# a width the CPU runs
BENCH_SMALL = dict(input_dim=20, num_labels=9, num_hidden_layers=3, num_hidden_units=32, nonlin="relu",
                   batch_norm=True)
BF16_RATIO = 2.0  # the rule of tests/test_torch_rnn.py


def _rel(a, ref):
    return float(np.abs(np.asarray(a, np.float64) - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_trajectory_matches_jax(seed):
    """bench.py's configuration (relu+BN, ``compute_dtype`` bfloat16) at
    small width: four steps of the port's ``Trainer`` against the JAX
    ``Trainer`` from one converted state, dropout 1. Both round the products'
    operands, the pre-activations and the backward's dz to bf16, but sum in
    another order, so a bf16 rounding can land one step apart and travel on.
    The yardstick is the bf16 rounding itself: against the JAX f32 run of the
    same start and batches, every step loss, parameter and Adam slot of the
    port lies within BF16_RATIO of the JAX bf16 run's own distance (+ 1e-5,
    the f32 tolerance, for a value the rounding leaves as it is). The hidden
    biases of the BN layers have an exactly-zero gradient, so their Adam
    steps follow rounding noise: they only stay within 4 steps of lr
    (4 lr·√(1−β2)/(1−β1)·4) of the start."""
    runs = {}
    for name, cd in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        model = JaxDNN(JaxDNNConfig(**BENCH_SMALL, compute_dtype=cd))
        jtrainer = JaxTrainer(model, JaxTrainerConfig(init_learning_rate=1e-3, num_steps=50))
        jstate = jtrainer.init_state(jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed)
        params = jax.tree.map(np.asarray, jstate.params)
        params["out"]["w"] = (rng.standard_normal(params["out"]["w"].shape) * 0.3).astype(np.float32)
        jstate = dataclasses.replace(jstate, params=jax.tree.map(jnp.asarray, params))
        runs[name] = [jtrainer, jstate, []]
    cfg = DNNConfig(**BENCH_SMALL, compute_dtype=torch.bfloat16)
    state = train_state_from_jax(jax.tree.map(np.asarray, runs["bf16"][1]), cfg)
    trainer = Trainer(cfg, TrainerConfig(init_learning_rate=1e-3, num_steps=50), device="cpu")
    rng = np.random.default_rng(10 + seed)
    losses = []
    for step in range(4):
        arrays = _batch(rng, b=4, t=16, f=20, labels=9, lengths=rng.integers(8, 17, 4))
        for run in runs.values():
            run[1], jloss = run[0].update(run[1], JaxPaddedBatch(arrays[0], arrays[1], arrays[2], arrays[2]))
            run[2].append(float(jloss))
        state, loss = trainer.update(state, _torch(arrays))
        losses.append(loss.item())
    f32_cfg = DNNConfig(**BENCH_SMALL)
    want = {n: train_state_from_jax(jax.tree.map(np.asarray, r[1]), f32_cfg) for n, r in runs.items()}
    mine, theirs = _rel(losses, np.asarray(runs["f32"][2])), _rel(runs["bf16"][2], np.asarray(runs["f32"][2]))
    print(f"bf16 step losses: port {mine!r}, JAX {theirs!r} from the f32 run")  # shown with -s
    assert mine <= BF16_RATIO * theirs + 1e-5, (mine, theirs)
    assert theirs > 0  # the JAX run did round to bf16
    got_params = dict(state.model.named_parameters())
    for name, p in dict(want["f32"].model.named_parameters()).items():
        got = got_params[name].detach().numpy()
        jbf = dict(want["bf16"].model.named_parameters())[name].detach().numpy()
        if name.startswith("hidden.") and name.endswith(".b"):
            assert np.abs(got).max() <= 4 * 4 * 1e-3 and np.abs(jbf).max() <= 4 * 4 * 1e-3, name
            continue
        ref = p.detach().numpy()
        mine, theirs = _rel(got, ref), _rel(jbf, ref)
        assert mine <= BF16_RATIO * theirs + 1e-5, (name, mine, theirs)
        for slot in ("adam_m", "adam_v"):
            ref = getattr(want["f32"], slot)[name].numpy()
            mine = _rel(getattr(state, slot)[name].numpy(), ref)
            theirs = _rel(getattr(want["bf16"], slot)[name].numpy(), ref)
            assert mine <= BF16_RATIO * theirs + 1e-5, (slot, name, mine, theirs)
    for name in ("bn_mean", "bn_var"):
        ref = getattr(want["f32"].model, name).numpy()
        mine = _rel(getattr(state.model, name).numpy(), ref)
        theirs = _rel(getattr(want["bf16"].model, name).numpy(), ref)
        assert mine <= BF16_RATIO * theirs + 1e-5, (name, mine, theirs)

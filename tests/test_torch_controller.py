"""The port's training controller: the cases of tests/test_controller.py,
and one run side by side with the JAX package's controller.

Checkpoints are ``torch.save`` files (``training/step{N}.pt``,
``training/validated.pt`` + ``validated.meta.json``, ``final.pt``). The
Orbax-only legacy-rng case has no counterpart. ``visualise`` writes
TensorBoard event files under ``<savedir>/logdir`` and ``profile_steps`` a
torch.profiler Chrome trace under ``<savedir>/profile``.
"""

import dataclasses
import glob
import json
import os
from configparser import ConfigParser

import jax
import numpy as np
import pytest
import torch

from tests.synthetic import make_featdir
from tfkaldi_tpu.data import AlignmentBatchDispenser as JaxDispenser
from tfkaldi_tpu.data import AlignmentCoder as JaxCoder
from tfkaldi_tpu.data import DeviceBatcher as JaxBatcher
from tfkaldi_tpu.data import FeatureReader as JaxReader
from tfkaldi_tpu.data import identity_normalizer as jax_identity
from tfkaldi_tpu.models import DNN as JaxDNN
from tfkaldi_tpu.models import DNNConfig as JaxDNNConfig
from tfkaldi_tpu.train import NnetTrainOptions as JaxOptions
from tfkaldi_tpu.train import Trainer as JaxTrainer
from tfkaldi_tpu.train import TrainerConfig as JaxTrainerConfig
from tfkaldi_tpu.train import TrainingController as JaxController
from tfkaldi_tpu.utils import MetricsLogger as JaxMetrics
from tfkaldi_tpu_torch.convert import load_checkpoint, train_state_from_jax
from tfkaldi_tpu_torch.data.batching import DeviceBatcher
from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
from tfkaldi_tpu_torch.models.dnn import DNNConfig
from tfkaldi_tpu_torch.nnet import Nnet
from tfkaldi_tpu_torch.train import NnetTrainOptions, Trainer, TrainerConfig, TrainingController
from tfkaldi_tpu_torch.train import checkpoint as ckpt
from tfkaldi_tpu_torch.utils import MetricsLogger

MODEL = dict(input_dim=6 * 3, num_labels=5, num_hidden_layers=2, num_hidden_units=8)


def _reader_args(featdir):
    return (f"{featdir}/feats.scp", f"{featdir}/cmvn.scp", f"{featdir}/utt2spk", 1, 60)


def _pipeline(
    tmp_path, *, lr, valid_retries, num_epochs=2, check_freq=2, seed=0,
    valid_adapt=True, learnable=False, micro_batches=2, batch_norm=False,
):
    featdir, alifile, info = make_featdir(
        tmp_path, num_speakers=2, utts_per_speaker=8, feat_dim=6, num_labels=5,
        seed=seed, learnable=learnable,
    )
    dispenser = AlignmentBatchDispenser(
        FeatureReader(*_reader_args(featdir)), AlignmentCoder(identity_normalizer, info["num_labels"]),
        4, alifile,
    )
    num_steps = int(dispenser.num_batches * num_epochs)
    trainer = Trainer(DNNConfig(**MODEL, batch_norm=batch_norm),
                      TrainerConfig(init_learning_rate=lr, num_steps=num_steps, micro_batches=micro_batches),
                      device="cpu")
    opts = NnetTrainOptions(
        savedir=str(tmp_path / "save"), num_epochs=num_epochs, batch_size=4, valid_batches=1,
        valid_frequency=2, valid_adapt=valid_adapt, valid_retries=valid_retries, check_freq=check_freq,
    )
    controller = TrainingController(trainer, dispenser, DeviceBatcher(bucket_multiple=16), opts)
    return controller, trainer, opts


def _params(state):
    return [p.detach().numpy() for p in state.model.parameters()]


def test_divergent_lr_triggers_rollback_and_termination(tmp_path):
    controller, trainer, opts = _pipeline(tmp_path, lr=100.0, valid_retries=1)
    state = controller.train()
    assert state.lr_fact < 1.0
    assert state.step < int(controller.dispenser.num_batches * opts.num_epochs)
    assert os.path.isfile(os.path.join(opts.savedir, "final.pt"))


def test_checkpoints_written_and_resumable(tmp_path):
    controller, trainer, opts = _pipeline(tmp_path, lr=1e-3, valid_retries=3, valid_adapt=False)
    state = controller.train()
    assert glob.glob(os.path.join(opts.savedir, "training", "step*.pt")), "expected periodic checkpoints"
    final = load_checkpoint(opts.savedir)
    for name, value in state.model.state_dict().items():
        assert torch.equal(final[name], value), name
    restored = ckpt.restore_state(os.path.join(opts.savedir, "training", f"step{state.step}.pt"),
                                  trainer.init_state(0))
    for a, b in zip(_params(restored), _params(state)):
        np.testing.assert_array_equal(a, b)
    assert restored.step == state.step and restored.lr_fact == state.lr_fact
    assert restored.adam_t == state.adam_t
    for name, m in state.adam_m.items():
        assert torch.equal(restored.adam_m[name], m) and torch.equal(restored.adam_v[name], state.adam_v[name])


def test_prior_written_and_normalized(tmp_path):
    controller, _, opts = _pipeline(tmp_path, lr=1e-3, valid_retries=3, valid_adapt=False)
    controller.train()
    prior = np.load(os.path.join(opts.savedir, "prior.npy"))
    np.testing.assert_allclose(prior.sum(), 1.0, rtol=1e-6)
    assert (prior > 0).all()  # synthetic data covers all classes


def _nnet_config(tmp_path, **over):
    cfg = ConfigParser()
    cfg["directories"] = {"expdir": str(tmp_path / "exp")}
    cfg["nnet"] = {
        "name": "net", "context_width": "1", "num_hidden_units": "16",
        "num_hidden_layers": "1", "add_layer_period": "0", "starting_step": "0",
        "nonlin": "relu", "l2_norm": "False", "dropout": "1", "batch_norm": "False",
        "num_epochs": "1", "initial_learning_rate": "0.01", "learning_rate_decay": "1",
        "batch_size": "4", "numutterances_per_minibatch": "-1", "valid_batches": "1",
        "valid_frequency": "2", "valid_adapt": "False", "valid_retries": "0",
        "check_freq": "10", "visualise": "False", **over,
    }
    return cfg


def _read_trace(savedir):
    (name,) = os.listdir(os.path.join(savedir, "profile"))
    assert name.endswith(".pt.trace.json")
    with open(os.path.join(savedir, "profile", name)) as f:
        return json.load(f)


@pytest.mark.parametrize("over", [{"visualise": "True"}, {"profile_steps": "1"}])
def test_visualise_and_profile_raise(tmp_path, over):
    """The two knobs train instead of raising: ``visualise`` leaves one
    parseable event file under ``<savedir>/logdir`` with a ``train/loss``
    per step equal to metrics.jsonl's (as f32), a ``valid/loss`` per
    validation and one histogram per parameter; ``profile_steps = 1`` leaves
    one Chrome trace under ``<savedir>/profile`` with one ``train_step``
    span (the step at ``profile_start``)."""
    from tfkaldi_tpu_torch.utils import tb_events

    featdir, alifile, info = make_featdir(tmp_path)
    disp = AlignmentBatchDispenser(FeatureReader(*_reader_args(featdir)),
                                   AlignmentCoder(identity_normalizer, info["num_labels"]), 4, alifile)
    net = Nnet(_nnet_config(tmp_path, **over, num_epochs="2"), input_dim=info["feat_dim"],
               num_labels=info["num_labels"], device="cpu")
    state = net.train(disp)
    with open(os.path.join(net.savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    assert len(steps) == state.step == 6
    if "visualise" in over:
        assert not os.path.exists(os.path.join(net.savedir, "profile"))
        (name,) = os.listdir(os.path.join(net.savedir, "logdir"))
        events = tb_events.read_events(os.path.join(net.savedir, "logdir", name))
        losses = [(step, vals["train/loss"]) for step, vals in events if "train/loss" in vals]
        assert losses == [(m["step"], float(np.float32(m["loss"]))) for m in steps]
        assert [step for step, vals in events if "valid/loss" in vals] == [2, 4, 6]
        hist = [tag for step, vals in events for tag, v in vals.items() if v == "histogram" and step == 6]
        assert sorted(hist) == sorted(["params['hidden'][0]['w']", "params['hidden'][0]['b']",
                                       "params['out']['w']", "params['out']['b']"])
    else:
        assert not os.path.exists(os.path.join(net.savedir, "logdir"))
        spans = [e for e in _read_trace(net.savedir)["traceEvents"] if e.get("name") == "train_step"]
        assert len(spans) == 1


def test_trace_profile_and_step_timer(tmp_path):
    """``trace_profile`` writes one Chrome trace of its region (``stop`` is
    idempotent)."""
    from tfkaldi_tpu_torch.utils.profiling import trace_profile

    with trace_profile(str(tmp_path / "p")) as trace:
        with torch.profiler.record_function("region"):
            torch.ones(8).sum()
    assert trace.stop() == trace.path and os.listdir(tmp_path / "p") == [os.path.basename(trace.path)]
    with open(trace.path) as f:
        assert any(e.get("name") == "region" for e in json.load(f)["traceEvents"])


class _FailingDispenser:
    """A dispenser that raises from its ``fail_at``-th batch on."""

    def __init__(self, dispenser, fail_at):
        self.dispenser, self.fail_at, self.served = dispenser, fail_at, 0

    def __getattr__(self, name):
        return getattr(self.dispenser, name)

    def get_padded_batch(self, batcher):
        self.served += 1
        if self.served >= self.fail_at:
            raise OSError("the ark went away")
        return self.dispenser.get_padded_batch(batcher)


@pytest.mark.parametrize("case", ["rollback", "termination", "exception"])
def test_profile_window_stops_on_every_exit(tmp_path, case):
    """A profile window of 3 steps is cut short, and its trace still
    written, by a validation rollback (lr 100: the validation after step 1
    regresses, the run retries once), by that rollback's termination
    (no retries), and by an exception in the data loader; it is taken once
    a run."""
    exception = case == "exception"
    controller, _, opts = _pipeline(tmp_path, lr=1e-3 if exception else 100.0, valid_adapt=not exception,
                                    valid_retries=0 if case == "termination" else 1, num_epochs=3)
    controller.opt = opts = dataclasses.replace(opts, profile_steps=3, profile_start=2 if exception else 0)
    if exception:
        # 1 validation batch, then training batches from step 0: the 5th is step 4's
        controller.dispenser = _FailingDispenser(controller.dispenser, fail_at=6)
        with pytest.raises(RuntimeError, match="prefetch worker failed"):
            controller.train()
    else:
        state = controller.train()
        assert state.lr_fact < 1.0
    spans = [e for e in _read_trace(opts.savedir)["traceEvents"] if e.get("name") == "train_step"]
    # steps 0-1 before the rollback at step 2; steps 2-3 and step 4's failed fetch
    assert len(spans) == (3 if exception else 2)


def test_resume_is_bit_exact(tmp_path):
    """Straight-through training and checkpoint-restart training give
    identical final parameters (the whole state is restored; the dispenser
    fast-forward replays the data stream)."""
    kw = dict(lr=0.01, valid_retries=0, num_epochs=2, check_freq=2, valid_adapt=False)
    state_a = _pipeline(tmp_path / "a", **kw)[0].train()
    ctrl_b1, _, opts_b = _pipeline(tmp_path / "b", **kw)
    ctrl_b1.train()
    ctrl_b2, _, _ = _pipeline(tmp_path / "b2", **kw)
    ctrl_b2.opt = dataclasses.replace(ctrl_b2.opt, starting_step=2, savedir=opts_b.savedir)
    state_b = ctrl_b2.train()
    assert state_a.step == state_b.step > 2
    for a, b in zip(_params(state_a), _params(state_b)):
        np.testing.assert_array_equal(a, b)


def test_retry_halvings_compound(tmp_path):
    controller, _, _ = _pipeline(tmp_path, lr=500.0, valid_retries=2)
    assert controller.train().lr_fact <= 0.25


class _Crash(RuntimeError):
    pass


def _crash_at_step_5(ctrl):
    def hook(step, **kw):
        if step == 5:
            raise _Crash()

    ctrl.metrics_hook = hook
    with pytest.raises(_Crash):
        ctrl.train()


def test_validated_checkpoint_survives_crash_and_rolls_back(tmp_path):
    """Validations at steps 2 and 4 persist the rollback point; a crash in
    the 6th update, a resume from step5.pt with a divergent LR, and the
    step-6 regression rolls back bit-exact onto the pre-crash validated
    parameters with the halved lr_fact."""
    kw = dict(valid_retries=0, num_epochs=4, check_freq=5, learnable=True)
    ctrl1, trainer1, opts1 = _pipeline(tmp_path, lr=1e-2, **kw)
    _crash_at_step_5(ctrl1)
    validated_path = os.path.join(opts1.savedir, "training", "validated.pt")
    meta = ckpt.load_validated_meta(validated_path)
    assert meta is not None and meta["step"] == 4
    template = trainer1.init_state(0)
    validated1 = ckpt.restore_state(validated_path, template)
    step5 = ckpt.restore_state(os.path.join(opts1.savedir, "training", "step5.pt"), template)
    assert any(not np.array_equal(a, b) for a, b in zip(_params(step5), _params(validated1)))

    ctrl2, _, _ = _pipeline(tmp_path, lr=500.0, **kw)
    ctrl2.opt = dataclasses.replace(ctrl2.opt, starting_step=5, savedir=opts1.savedir)
    state = ctrl2.train()
    assert state.step == 4
    for a, b in zip(_params(state), _params(validated1)):
        np.testing.assert_array_equal(a, b)
    assert state.lr_fact == 0.5


def test_training_is_deterministic_across_runs(tmp_path):
    states = [
        _pipeline(tmp_path / sub, lr=0.01, valid_retries=1, num_epochs=2, check_freq=2)[0].train()
        for sub in ("r1", "r2")
    ]
    assert states[0].step == states[1].step
    for a, b in zip(_params(states[0]), _params(states[1])):
        np.testing.assert_array_equal(a, b)


def test_stale_validated_sidecar_rebaselines(tmp_path):
    """A sidecar that names an older step than its stored state is not
    trusted: resume re-baselines on the resumed state (step 5), so the
    step-6 regression rolls back there."""
    kw = dict(valid_retries=0, num_epochs=4, check_freq=5, learnable=True)
    ctrl1, _, opts1 = _pipeline(tmp_path, lr=1e-2, **kw)
    _crash_at_step_5(ctrl1)
    meta_path = os.path.join(opts1.savedir, "training", "validated.meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    assert meta["step"] == 4
    with open(meta_path, "w") as f:
        json.dump({"loss": meta["loss"], "step": 2}, f)
    ctrl2, _, _ = _pipeline(tmp_path, lr=500.0, **kw)
    ctrl2.opt = dataclasses.replace(ctrl2.opt, starting_step=5, savedir=opts1.savedir)
    assert ctrl2.train().step == 5


def test_average_params_arithmetic():
    a = {"w": torch.tensor([1.0, 2.0]), "b": torch.tensor([0.0], dtype=torch.bfloat16)}
    b = {"w": torch.tensor([3.0, 6.0]), "b": torch.tensor([2.0], dtype=torch.bfloat16)}
    avg = ckpt.average_params([a, b])
    np.testing.assert_allclose(avg["w"].numpy(), [2.0, 4.0])
    assert avg["b"].dtype == torch.bfloat16
    np.testing.assert_allclose(avg["b"].float().numpy(), [1.0])
    same = ckpt.average_params([a, a, a])
    np.testing.assert_allclose(same["w"].numpy(), a["w"].numpy())
    with pytest.raises(ValueError):
        ckpt.average_params([])


def test_average_last_smooths_final(tmp_path):
    controller, trainer, opts = _pipeline(tmp_path, lr=0.01, valid_retries=0, valid_adapt=False,
                                          num_epochs=2, check_freq=2)
    controller.opt = opts = dataclasses.replace(opts, average_last=2)
    state = controller.train()
    tdir = os.path.join(opts.savedir, "training")
    steps = sorted(int(f[4:-3]) for f in os.listdir(tdir)
                   if f.startswith("step") and f.endswith(".pt") and int(f[4:-3]) != state.step)
    template = trainer.init_state(0)
    prev = ckpt.restore_state(os.path.join(tdir, f"step{steps[-1]}.pt"), template)
    end_raw = ckpt.restore_state(os.path.join(tdir, f"step{state.step}.pt"), template)
    want = ckpt.average_params([end_raw.params(), prev.params()])
    final = load_checkpoint(opts.savedir)
    for name, value in want.items():
        np.testing.assert_allclose(final[name].numpy(), value.detach().numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(state.params()[name].detach().numpy(), final[name].numpy(), rtol=1e-6)
    assert any(not np.allclose(final[n].numpy(), p.detach().numpy()) for n, p in end_raw.params().items())


# ---------------------------------------------------------------------------
# side by side with the JAX controller
# ---------------------------------------------------------------------------


def test_side_by_side_with_jax_controller(tmp_path):
    """One featdir, one initial TrainState (JAX's, converted), batchnorm on,
    no microbatching: the step losses in metrics.jsonl agree within 1e-4
    relative (f32 sums in another order, carried through 10 Adam steps),
    and so do the validation losses; the validation decisions, the final
    step, lr_fact and prior.npy are equal."""
    featdir, alifile, info = make_featdir(tmp_path, num_speakers=2, utts_per_speaker=8, feat_dim=6,
                                          num_labels=5, learnable=True)
    lr, num_epochs = 0.05, 3
    cfg = dict(**MODEL, batch_norm=True)
    runs = {}
    for side in ("jax", "port"):
        savedir = str(tmp_path / side)
        if side == "jax":
            disp = JaxDispenser(JaxReader(*_reader_args(featdir)), JaxCoder(jax_identity, 5), 4, alifile)
            num_steps = int(disp.num_batches * num_epochs)
            trainer = JaxTrainer(JaxDNN(JaxDNNConfig(**cfg)),
                                 JaxTrainerConfig(init_learning_rate=lr, num_steps=num_steps))
            jax_state = trainer.init_state(jax.random.PRNGKey(0))
            # copied out before the JAX steps donate its buffers
            start = jax.tree.map(lambda a: np.array(a, copy=True), jax_state)
            opts = JaxOptions(savedir=savedir, num_epochs=num_epochs, batch_size=4, valid_batches=1,
                              valid_frequency=2, valid_retries=2, check_freq=100)
            metrics, batcher, cls, state = JaxMetrics, JaxBatcher(bucket_multiple=16), JaxController, jax_state
        else:
            disp = AlignmentBatchDispenser(FeatureReader(*_reader_args(featdir)),
                                           AlignmentCoder(identity_normalizer, 5), 4, alifile)
            trainer = Trainer(DNNConfig(**cfg), TrainerConfig(init_learning_rate=lr, num_steps=num_steps),
                              device="cpu")
            opts = NnetTrainOptions(savedir=savedir, num_epochs=num_epochs, batch_size=4, valid_batches=1,
                                    valid_frequency=2, valid_retries=2, check_freq=100)
            metrics, batcher, cls = MetricsLogger, DeviceBatcher(bucket_multiple=16), TrainingController
            state = train_state_from_jax(start, DNNConfig(**cfg))
        logger = metrics(os.path.join(savedir, "metrics.jsonl"))
        validations = []
        ctrl = cls(trainer, disp, batcher, opts, metrics_hook=logger,
                   validation_hook=lambda step, loss, v=validations: v.append((step, loss)))
        final = ctrl.train(state)
        logger.close()
        with open(os.path.join(savedir, "metrics.jsonl")) as f:
            losses = [(m["step"], m["loss"]) for m in map(json.loads, f)]
        runs[side] = dict(final=final, validations=validations, losses=losses,
                          prior=np.load(os.path.join(savedir, "prior.npy")))
    jx, pt = runs["jax"], runs["port"]
    assert [s for s, _ in pt["losses"]] == [s for s, _ in jx["losses"]]
    np.testing.assert_allclose([v for _, v in pt["losses"]], [v for _, v in jx["losses"]], rtol=1e-4)
    assert [s for s, _ in pt["validations"]] == [s for s, _ in jx["validations"]]
    np.testing.assert_allclose([v for _, v in pt["validations"]], [v for _, v in jx["validations"]], rtol=1e-4)

    def decisions(vals, baseline):
        out = []
        for _, v in vals:
            out.append(v <= baseline)
            baseline = v if v <= baseline else baseline
        return out

    assert len(pt["validations"]) >= 3
    assert pt["final"].step == int(jx["final"].step)
    assert pt["final"].lr_fact == float(jx["final"].lr_fact)
    np.testing.assert_array_equal(pt["prior"], jx["prior"])
    assert decisions(pt["validations"], np.inf) == decisions(jx["validations"], np.inf)

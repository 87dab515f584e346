"""SpecAugment in the port's trainer against the JAX package's, on the CPU.

The six cases of tests/test_specaugment.py on the port, then:

- parity: bands drawn by JAX's own code path (``jax.random`` as
  tfkaldi_tpu/train/trainer.py:366-375 draws them) through the port's
  ``spec_augment_apply`` equal JAX's ``_spec_augment`` output bit for bit;
- statistics: the port's draws (torch generators) against JAX's (threefry),
  which share no bits: the width and start means within 4σ of each other
  over 4000 draws, and the same ranges;
- zero masks: the trajectory equals SpecAugment off bit for bit, and the
  dropout stream is the same with SpecAugment on;
- the CTC recipe's spliced input (``context_width = 2``).
"""

import dataclasses
from configparser import ConfigParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import make_featdir
from tfkaldi_tpu.data.batching import PaddedBatch as JaxPaddedBatch
from tfkaldi_tpu.models import DNN as JaxDNN
from tfkaldi_tpu.models import DNNConfig as JaxDNNConfig
from tfkaldi_tpu.train import Trainer as JaxTrainer
from tfkaldi_tpu.train import TrainerConfig as JaxTrainerConfig
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
from tfkaldi_tpu_torch.models import DNNConfig, RNNConfig
from tfkaldi_tpu_torch.nnet import Nnet
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig, spec_augment_apply, spec_augment_draw

SPEC = dict(spec_raw_dim=8, spec_time_masks=2, spec_time_width=6, spec_freq_masks=1, spec_freq_width=3)
MODEL = dict(input_dim=24, num_labels=5, num_hidden_layers=1, num_hidden_units=16)


def _setup(spec=True, model=None, **over):
    cfg = TrainerConfig(spec_augment=spec, **{**SPEC, **over})
    return Trainer(model or DNNConfig(**MODEL), cfg, device="cpu")


def _arrays(seed=0, b=4, t=32, d=24):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, t - 5, t // 2, t - 1], np.int32)[:b]
    return (np.abs(rng.standard_normal((b, t, d))).astype(np.float32) + 1.0,
            rng.integers(0, 5, (b, t)).astype(np.int32), lengths, lengths)


def _batch(seed=0, **kw):
    return PaddedBatch(*(torch.from_numpy(a) for a in _arrays(seed, **kw)))


def test_masks_zero_bands_and_repeat_over_splice():
    trainer = _setup()
    batch = _batch()
    x = trainer.spec_augment(trainer.init_state(0), batch).inputs.numpy()
    orig = batch.inputs.numpy()
    assert (x == 0).any(), "no mask applied"
    changed = (x == 0) & (orig != 0)
    time_masked_rows = np.all(x == 0, axis=2)
    for bi in range(x.shape[0]):
        col_masked = np.all(changed[bi, ~time_masked_rows[bi]], axis=0)
        for raw in range(8):
            states = {bool(col_masked[c]) for c in (raw, raw + 8, raw + 16)}
            assert len(states) == 1, f"freq band not repeated across splice: column {raw}"
        # a time band never reaches past the utterance's real frames
        assert not time_masked_rows[bi, int(batch.input_lengths[bi]):].any()


def test_augment_is_deterministic_in_seed_and_step():
    """The bands derive from ``(seed, step)``: the same pair draws the same
    masks (resume and rollback replay), another step or seed others."""
    trainer = _setup()
    batch = _batch()
    state = trainer.init_state(7)
    a = trainer.spec_augment(state, batch).inputs
    b = trainer.spec_augment(state, batch).inputs
    state.step = 1
    c = trainer.spec_augment(state, batch).inputs
    state.step, state.seed = 0, 8
    d = trainer.spec_augment(state, batch).inputs
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_off_by_default_and_eval_untouched():
    assert not TrainerConfig().spec_augment
    on, off = _setup(spec=True), _setup(spec=False)
    batch = _batch()
    s_on, s_off = on.init_state(0), off.init_state(0)
    # the zero-initialised output layer makes the step-0 loss input-independent
    s_on, _ = on.update(s_on, batch)
    s_off, _ = off.update(s_off, batch)
    _, l_on = on.update(s_on, batch)
    _, l_off = off.update(s_off, batch)
    assert float(l_on) != float(l_off)
    assert on.evaluate(on.init_state(0), [batch]) == off.evaluate(off.init_state(0), [batch])


def test_train_runs_and_losses_stay_finite():
    trainer = _setup()
    batch = _batch()
    state = trainer.init_state(1)
    for _ in range(3):
        state, loss = trainer.update(state, batch)
        assert np.isfinite(float(loss))


def test_resume_replays_identical_masks():
    """Two runs from the same seed end bit-identical, and a state rewound
    to step 1 draws step 1's masks again (resume and rollback)."""
    runs = []
    for _ in range(2):
        trainer = _setup()
        state = trainer.init_state(3)
        batch = _batch()
        for _ in range(3):
            state, _ = trainer.update(state, batch)
        runs.append(state)
    for a, b in zip(runs[0].model.parameters(), runs[1].model.parameters()):
        assert torch.equal(a, b)
    # a state rewound to step 1 (a rollback's restore) draws step 1's masks again
    trainer = _setup()
    replay = trainer.init_state(3)
    replay, _ = trainer.update(replay, batch)
    step1 = trainer.spec_augment(replay, batch).inputs
    replay, _ = trainer.update(replay, batch)
    replay.step = 1
    assert torch.equal(trainer.spec_augment(replay, batch).inputs, step1)


def test_cli_config_key_wires_through(tmp_path, monkeypatch):
    """``[nnet] specaugment = True`` and its keys reach the trainer through
    ``Nnet.train``, with ``spec_raw_dim`` the pre-splice dim."""
    featdir, alifile, info = make_featdir(tmp_path)
    cfg = ConfigParser()
    cfg["directories"] = {"expdir": str(tmp_path / "exp")}
    cfg["nnet"] = {
        "name": "specnet", "context_width": "1", "num_hidden_units": "16", "num_hidden_layers": "1",
        "add_layer_period": "0", "starting_step": "0", "nonlin": "relu", "l2_norm": "False", "dropout": "1",
        "batch_norm": "False", "num_epochs": "1", "initial_learning_rate": "0.01", "learning_rate_decay": "1",
        "batch_size": "4", "numutterances_per_minibatch": "-1", "valid_batches": "1", "valid_frequency": "2",
        "valid_adapt": "False", "valid_retries": "0", "check_freq": "10", "visualise": "False",
        "specaugment": "True", "spec_time_width": "4", "spec_freq_width": "2",
    }
    reader = FeatureReader(f"{featdir}/feats.scp", f"{featdir}/cmvn.scp", f"{featdir}/utt2spk", 1, 60)
    disp = AlignmentBatchDispenser(reader, AlignmentCoder(identity_normalizer, info["num_labels"]), 4, alifile)
    seen = []
    original = Trainer.spec_augment

    def spy(self, state, batch):
        seen.append(self.config)
        return original(self, state, batch)

    monkeypatch.setattr(Trainer, "spec_augment", spy)
    net = Nnet(cfg, input_dim=info["feat_dim"], num_labels=info["num_labels"], device="cpu")
    state = net.train(disp)
    assert np.isfinite(float(state.lr_fact)) and len(seen) == state.step > 0
    cfg0 = seen[0]
    assert (cfg0.spec_augment, cfg0.spec_time_width, cfg0.spec_freq_width, cfg0.spec_raw_dim) == \
        (True, 4, 2, info["feat_dim"])
    assert (cfg0.spec_time_masks, cfg0.spec_freq_masks) == (2, 2)


def _jax_bands(key, b, n_masks, max_width, limits):
    """JAX's draw, as tfkaldi_tpu/train/trainer.py:371-375 writes it."""
    kw, ks = jax.random.split(key)
    widths = jax.random.randint(kw, (b, n_masks), 0, max_width + 1)
    starts = jax.random.randint(ks, (b, n_masks), 0, jnp.iinfo(jnp.int32).max)
    starts = starts % jnp.maximum(limits[:, None] - widths, 1)
    return torch.from_numpy(np.array(widths)), torch.from_numpy(np.array(starts))


@pytest.mark.parametrize("over,dtype", [
    ({}, "float32"),
    (dict(spec_raw_dim=0, spec_freq_width=7), "float32"),
    (dict(spec_freq_masks=0), "float32"),
    (dict(spec_time_masks=0, spec_freq_masks=3), "float32"),
    (dict(spec_time_masks=3, spec_time_width=20), "bfloat16"),
])
def test_apply_equals_jax_on_jax_draws(over, dtype):
    """JAX's bands through the port's ``spec_augment_apply``: bitwise equal
    to ``Trainer._spec_augment`` of the JAX package (f32 and bf16 inputs)."""
    cfg = {**SPEC, **over}
    jtrainer = JaxTrainer(JaxDNN(JaxDNNConfig(**MODEL)), JaxTrainerConfig(spec_augment=True, **cfg))
    arrays = _arrays(seed=5)
    jbatch = JaxPaddedBatch(*(jnp.asarray(a) for a in arrays))
    jbatch = dataclasses.replace(jbatch, inputs=jbatch.inputs.astype(dtype))
    for seed in range(4):
        rng = jax.random.PRNGKey(seed)
        want = np.asarray(jtrainer._spec_augment(jbatch, rng).inputs.astype(jnp.float32))
        kt, kf = jax.random.split(jax.random.fold_in(rng, 0x5AEC))
        b, _, d = jbatch.inputs.shape
        time_bands = freq_bands = None
        if cfg["spec_time_masks"] > 0 and cfg["spec_time_width"] > 0:
            time_bands = _jax_bands(kt, b, cfg["spec_time_masks"], cfg["spec_time_width"], jbatch.input_lengths)
        if cfg["spec_freq_masks"] > 0 and cfg["spec_freq_width"] > 0:
            raw = cfg["spec_raw_dim"] or d
            freq_bands = _jax_bands(kf, b, cfg["spec_freq_masks"], cfg["spec_freq_width"],
                                    jnp.full((b,), raw, jnp.int32))
        batch = PaddedBatch(torch.from_numpy(arrays[0]).to(getattr(torch, dtype)),
                            *(torch.from_numpy(a) for a in arrays[1:]))
        got = spec_augment_apply(batch, time_bands, freq_bands, cfg["spec_raw_dim"]).inputs
        assert got.dtype == getattr(torch, dtype)
        assert np.array_equal(got.float().numpy(), want), seed
        assert (want == 0).any() or seed


def test_draws_match_jax_distribution():
    """Widths uniform on [0, W] and starts reduced modulo max(limit − w, 1),
    drawn by torch and by JAX over 4000 rows: each mean within 4σ of the
    other's (σ of a difference of two means of uniform draws) and the same
    observed range."""
    n, w = 4000, 20
    limits = np.random.default_rng(0).integers(5, 200, n).astype(np.int32)
    ours = spec_augment_draw(torch.Generator().manual_seed(0), n, 1, w, torch.from_numpy(limits))
    theirs = _jax_bands(jax.random.PRNGKey(0), n, 1, w, jnp.asarray(limits))
    (ow, os_), (tw, ts) = ([a.numpy()[:, 0].astype(np.float64) for a in pair] for pair in (ours, theirs))
    assert ow.min() == tw.min() == 0 and ow.max() == tw.max() == w
    sigma_w = np.sqrt(((w + 1) ** 2 - 1) / 12 * 2 / n)
    assert abs(ow.mean() - tw.mean()) <= 4 * sigma_w
    span_o, span_t = np.maximum(limits - ow, 1), np.maximum(limits - tw, 1)
    assert (os_ >= 0).all() and (os_ < span_o).all() and (ts >= 0).all() and (ts < span_t).all()
    # start / span is uniform on {0, 1/span, ..., (span-1)/span}: mean (span-1)/(2 span), variance < 1/12
    uo, ut = os_ / span_o, ts / span_t
    sigma_u = np.sqrt(1 / (12 * n))
    assert abs(uo.mean() - ut.mean()) <= 4 * np.sqrt(2) * sigma_u
    for u, span in ((uo, span_o), (ut, span_t)):
        assert abs(u.mean() - ((span - 1) / (2 * span)).mean()) <= 4 * sigma_u


def test_zero_masks_and_the_dropout_stream():
    """With 0 masks SpecAugment changes nothing: the trajectory (dropout
    0.8) is bit-identical to SpecAugment off; and with masks on, the step's
    dropout generator draws what it draws with SpecAugment off."""
    model = DNNConfig(**MODEL, dropout=0.8)
    zero = _setup(spec=True, model=model, spec_time_masks=0, spec_freq_masks=0)
    off = _setup(spec=False, model=model)
    batch = _batch()
    a, b = zero.init_state(2), off.init_state(2)
    for _ in range(3):
        a, la = zero.update(a, batch)
        b, lb = off.update(b, batch)
        assert float(la) == float(lb)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    on = _setup(spec=True, model=model)
    state = on.init_state(2)
    on.spec_augment(state, batch)
    drawn = torch.rand(64, generator=on.dropout_generator(state))
    assert torch.equal(drawn, torch.rand(64, generator=off.dropout_generator(off.init_state(2))))
    assert not torch.equal(drawn, torch.rand(64, generator=torch.Generator().manual_seed(0)))


def test_ctc_with_spliced_context():
    """The CTC recipe's input: ``context_width = 2`` splices 5 copies of an
    8-dim frame; the frequency band repeats over all 5, the time bands stay
    inside each row's frames, and CTC training on the masked batches runs."""
    raw, copies = 8, 5
    model = RNNConfig(input_dim=raw * copies, num_labels=6, num_layers=1, hidden_units=8, bidirectional=True)
    trainer = _setup(model=model, spec_raw_dim=raw, spec_freq_width=3, loss_type="ctc", ctc_blank_id=5)
    x, _, lengths, _ = _arrays(seed=3, d=raw * copies)
    targets = np.random.default_rng(4).integers(0, 5, (4, 6)).astype(np.int32)
    batch = PaddedBatch(torch.from_numpy(x), torch.from_numpy(targets), torch.from_numpy(lengths),
                        torch.from_numpy(np.array([6, 4, 3, 5], np.int32)))
    state = trainer.init_state(0)
    masked = trainer.spec_augment(state, batch).inputs.numpy().reshape(4, 32, copies, raw)
    banded = 0
    for bi in range(4):
        rows = ~np.all(masked[bi] == 0, axis=(1, 2))
        assert not (~rows)[lengths[bi]:].any()
        zero_cols = np.all(masked[bi, rows] == 0, axis=0)  # [copies, raw]
        assert (zero_cols == zero_cols[0]).all()
        banded += int(zero_cols[0].any())
    assert banded > 0
    losses = []
    for _ in range(3):
        state, loss = trainer.update(state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()

"""The port's transducer model and its training loss against the JAX package,
on the CPU.

At tiny widths (a 2-block causal conformer, d_model 32, 2 heads, ffn 32,
kernel 3, ``subsample`` 1, 2 and 4, or one 8-unit LSTM layer; a 1 x 8 LSTM
prediction network over 6-wide embeddings; joint 10; 4 labels + the blank;
``joint_chunk_t`` 3, so T is not a multiple of it), from JAX-initialised
weights with non-zero biases and moving statistics carried over by
``convert.transducer_from_jax``:

- ``encode`` and ``predict``; ``lattice_scores`` (dense) and
  ``lattice_scores_pruned`` (diagonal and guided bands, the band starts
  exactly): values within TOL (1e-5) of max|JAX| and the gradients of every
  parameter under the lattice loss within GRAD_TOL (1e-4) of max|JAX| per
  tensor, in f32; in bf16 by the 2x rule of tests/test_torch_rnn.py (the
  port's distance from the JAX f32 result within 2x the JAX bf16
  result's, + TOL);
- a full-width band equals the dense loss;
- the ``Trainer``'s ``rnnt`` loss on both routes against the JAX
  ``Trainer._loss_sum`` (LOSS_RTOL 1e-5 relative), and a 4-step f32
  trajectory from one converted ``TrainState`` at dropout 1 (losses 1e-5
  relative, parameters 2e-5 absolute);
- the ``Nnet`` pairing, the recipe's ``[nnet]`` read by both configs, and
  ``convert.transducer_from_jax``.
"""

import dataclasses
from configparser import ConfigParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfkaldi_tpu.data.batching import PaddedBatch as JaxPaddedBatch
from tfkaldi_tpu.models.transducer import Transducer as JaxTransducer
from tfkaldi_tpu.models.transducer import TransducerConfig as JaxTransducerConfig
from tfkaldi_tpu.ops import rnnt_loss as jax_rnnt
from tfkaldi_tpu.train import Trainer as JaxTrainer
from tfkaldi_tpu.train import TrainerConfig as JaxTrainerConfig
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.convert import save_checkpoint, train_state_from_jax, transducer_from_jax
from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.models import Transducer, TransducerConfig, build_model
from tfkaldi_tpu_torch.nnet import Nnet
from tfkaldi_tpu_torch.ops import rnnt_loss
from tfkaldi_tpu_torch.train import trainer as trainer_mod
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

V = 4  # labels; the blank = 4
IN = 5
TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
BF16_RATIO = 2.0
ENCODERS = {
    "conformer_s1": dict(enc_type="conformer", subsample=1),
    "conformer_s2": dict(enc_type="conformer", subsample=2),
    "conformer_s4": dict(enc_type="conformer", subsample=4),
    "lstm": dict(enc_type="lstm"),
}


def rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
                 / max(np.abs(np.asarray(want, np.float64)).max(), 1e-30))


def _kwargs(enc_type="conformer", subsample=1, **kw):
    extra = ()
    if enc_type == "conformer":
        extra = (("num_blocks", "2"), ("d_model", "32"), ("num_heads", "2"), ("ffn_dim", "32"),
                 ("conv_kernel", "3"), ("subsample", str(subsample)), ("attention_left_context", "6"),
                 ("attention_right_context", "0"), ("causal_conv", "True"))
    return dict(input_dim=IN, num_labels=V, enc_type=enc_type, enc_layers=1, enc_units=8, pred_layers=1,
                pred_units=8, embed_dim=6, joint_units=10, joint_chunk_t=3, enc_extra=extra, **kw)


def _jax(cd="float32", **over):
    return JaxTransducer(JaxTransducerConfig(compute_dtype=jnp.dtype(cd), **_kwargs(**over)))


def _port_config(cd="float32", **over):
    return TransducerConfig(compute_dtype=getattr(torch, cd), **_kwargs(**over))


def _weights(model, seed):
    """JAX init, then non-zero biases of the joint and both output layers,
    and moving statistics away from (0, 1)."""
    params, state = model.init(jax.random.PRNGKey(seed))
    params, state = jax.tree.map(np.array, params), jax.tree.map(np.array, state)
    rng = np.random.default_rng(seed + 100)
    for p in (params["joint"], params["enc"]["out"], params["pred"]["out"]):
        p["b"] = (rng.standard_normal(p["b"].shape) * 0.3).astype(np.float32)
    enc_state = state.get("enc", {})
    if "bn_conv_mean" in enc_state:
        enc_state["bn_conv_mean"] = (rng.standard_normal(enc_state["bn_conv_mean"].shape) * 0.1).astype(np.float32)
        enc_state["bn_conv_var"] = rng.uniform(0.5, 2.0, enc_state["bn_conv_var"].shape).astype(np.float32)
    return params, state


def _port(params, state, cd="float32", **over):
    model = Transducer(_port_config(cd, **over))
    model.load_state_dict(transducer_from_jax(params, state))
    return model


def _synth(seed, b=3, t=13, u=4):
    """Padded inputs and labels with garbage in the padding."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, IN)).astype(np.float32)
    xl = np.array([t, t - 3, t - 5][:b], np.int32)
    for i, n in enumerate(xl):
        x[i, n:] = rng.standard_normal((t - n, IN)) * 5
    y = rng.integers(0, V, (b, u)).astype(np.int32)
    yl = np.array([u, 1, 3][:b], np.int32)
    for i, n in enumerate(yl):
        y[i, n:] = rng.integers(0, V, u - n)
    return x, xl, y, yl


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _grads(model) -> dict:
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters() if p.grad is not None}


def _jax_grads(grads) -> dict:
    return {k: v.numpy() for k, v in transducer_from_jax(jax.tree.map(np.asarray, grads), {}).items()}


def _check_grads(got: dict, want: dict, tol: float = GRAD_TOL):
    """Each gradient within ``tol`` of its max|JAX|; an attention key bias,
    whose gradient is 0 in exact arithmetic (the softmax ignores a shift of
    a whole row) and rounding noise on both sides, within ``tol`` of the
    largest gradient of all."""
    assert set(got) == set(want), set(got) ^ set(want)
    scale = max(np.abs(w).max() for w in want.values())
    err = {n: (np.abs(got[n] - want[n]).max() / scale if n.endswith(".bk") else rel(got[n], want[n])) for n in want}
    bad = {n: e for n, e in err.items() if e > tol}
    assert not bad, bad


@pytest.mark.parametrize("enc", list(ENCODERS))
def test_encode_and_predict_match_jax(enc):
    over = ENCODERS[enc]
    jm = _jax(**over)
    params, state = _weights(jm, seed=len(enc))
    model = _port(params, state, **over)
    x, xl, y, yl = _synth(1)
    want_enc, _ = jm.encode(_jnp(params), _jnp(state), jnp.asarray(x), jnp.asarray(xl), train=False)
    want_pred = jm.predict(_jnp(params), jnp.asarray(y), jnp.asarray(yl), train=False)
    with torch.no_grad():
        got_enc = model.encode(torch.from_numpy(x), torch.from_numpy(xl))
        got_pred = model.predict(torch.from_numpy(y), torch.from_numpy(yl))
    assert got_enc.shape == want_enc.shape == (3, -(-13 // over.get("subsample", 1)), 10)
    assert got_pred.shape == want_pred.shape == (3, 5, 10)
    t_out = np.asarray(jm.output_lengths(jnp.asarray(xl)))
    np.testing.assert_array_equal(model.output_lengths(torch.from_numpy(xl)).numpy(), t_out)
    for i, n in enumerate(t_out):  # the frames past each row's length are not compared
        assert rel(got_enc[i, :n].numpy(), want_enc[i, :n]) <= TOL
    for i, n in enumerate(yl):
        assert rel(got_pred[i, : n + 1].numpy(), want_pred[i, : n + 1]) <= TOL
    assert model.subsample_factor == jm.subsample_factor


def _dense_loss_jax(jm, params, state, args):
    lpb, lpl, _ = jm.lattice_scores(params, state, *args, train=False)
    t_out = jm.output_lengths(args[1])
    return jnp.sum(jax_rnnt.rnnt_alpha_loss(lpb, jax_rnnt.mask_label_scores(lpl, args[3]), t_out, args[3])), (lpb, lpl)


def _pruned_loss_jax(jm, params, state, args):
    lpb, lpl, starts, _ = jm.lattice_scores_pruned(params, state, *args, train=False)
    t_out = jm.output_lengths(args[1])
    return jnp.sum(jax_rnnt.rnnt_alpha_loss_banded(lpb, lpl, starts, t_out, args[3])), (lpb, lpl, starts)


def _port_loss(model, args, pruned: bool):
    t_out = model.output_lengths(args[1])
    if pruned:
        lpb, lpl, starts = model.lattice_scores_pruned(*args)
        return rnnt_loss.rnnt_alpha_loss_banded(lpb, lpl, starts, t_out, args[3]).sum(), (lpb, lpl, starts)
    lpb, lpl = model.lattice_scores(*args)
    return rnnt_loss.rnnt_alpha_loss(lpb, rnnt_loss.mask_label_scores(lpl, args[3]), t_out, args[3]).sum(), (lpb,
                                                                                                            lpl)


def _run_both(over, seed, pruned, cd="float32"):
    """Loss, scores and parameter gradients of the JAX model and of the
    port on the same weights and batch."""
    jm = _jax(cd, **over)
    params, state = _weights(_jax(**over), seed=seed)
    x, xl, y, yl = _synth(seed + 1)
    jargs = tuple(map(jnp.asarray, (x, xl, y, yl)))
    fn = _pruned_loss_jax if pruned else _dense_loss_jax
    (want, want_scores), jgrads = jax.value_and_grad(lambda p: fn(jm, p, _jnp(state), jargs), has_aux=True)(
        _jnp(params))
    model = _port(params, state, cd, **over)
    got, scores = _port_loss(model, tuple(map(torch.from_numpy, (x, xl, y, yl))), pruned)
    got.backward()
    return (got.item(), [s.detach() for s in scores], _grads(model)), (float(want), want_scores, _jax_grads(jgrads))


@pytest.mark.parametrize("enc", ["conformer_s4", "lstm"])
def test_lattice_scores_and_grads_match_jax(enc):
    """The dense fused scores (T' not a multiple of joint_chunk_t) and the
    gradients of every parameter under the dense lattice loss (subsample 1
    and 2 take the banded tests below)."""
    (got, scores, grads), (want, want_scores, want_grads) = _run_both(ENCODERS[enc], 3, pruned=False)
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    for g, w in zip(scores, want_scores):
        assert rel(g.numpy(), w) <= TOL
    _check_grads(grads, want_grads)


@pytest.mark.parametrize("band,enc", [("diagonal", "conformer_s2"), ("guided", "conformer_s1"),
                                      ("guided", "lstm")])
def test_pruned_scores_and_grads_match_jax(band, enc):
    """The banded scores, their starts exactly, and the gradients under the
    banded loss (S = 3 of U+1 = 5 label positions; the guided band at
    stride 2)."""
    over = {**ENCODERS[enc], "prune_s": 3, "prune_band": band, "prune_proxy_stride": 2}
    (got, scores, grads), (want, want_scores, want_grads) = _run_both(over, 5, pruned=True)
    np.testing.assert_array_equal(scores[2].numpy(), np.asarray(want_scores[2]))
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    for g, w in zip(scores[:2], want_scores[:2]):
        assert rel(g.numpy(), w) <= TOL
    _check_grads(grads, want_grads)


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "banded"])
def test_scores_and_grads_bf16_two_x_rule(pruned):
    """bf16 compute (the banded block's own roundings included): the
    port's loss, scores and gradients against the JAX f32 run within 2x the
    JAX bf16 run's distance from it, + TOL (GRAD_TOL for gradients)."""
    over = {**ENCODERS["conformer_s4"], "prune_s": 3, "prune_band": "diagonal"}
    _, want32 = _run_both(over, 7, pruned)
    (got, scores, grads), want = _run_both(over, 7, pruned, "bfloat16")
    for what, g, w, w32, tol in (
        ("loss", got, want[0], want32[0], TOL),
        *((f"score {i}", s.numpy(), ws, ws32, TOL) for i, (s, ws, ws32) in enumerate(zip(scores[:2], want[1][:2],
                                                                                         want32[1][:2]))),
        *((name, grads[name], want[2][name], want32[2][name], GRAD_TOL) for name in want32[2]),
    ):
        mine, theirs = rel(g, w32), rel(w, w32)
        assert mine <= BF16_RATIO * theirs + tol, (what, mine, theirs)


def test_apply_transducer_matches_jax_and_the_fused_scores():
    """The materialized lattice ``[B, T', U+1, V]`` against JAX's
    ``apply_transducer`` (TOL), and ``rnnt_loss`` on it against the fused
    dense route's loss (LOSS_RTOL)."""
    over = ENCODERS["lstm"]
    jm = _jax(**over)
    params, state = _weights(jm, 11)
    model = _port(params, state, **over)
    x, xl, y, yl = _synth(12)
    want, _ = jm.apply_transducer(_jnp(params), _jnp(state), *map(jnp.asarray, (x, xl, y, yl)), train=False)
    args = tuple(map(torch.from_numpy, (x, xl, y, yl)))
    with torch.no_grad():
        logits = model.apply_transducer(*args)
        fused, _ = _port_loss(model, args, pruned=False)
    assert logits.shape == want.shape == (3, 13, 5, V + 1)
    assert rel(logits.numpy(), want) <= TOL
    materialized = rnnt_loss.rnnt_loss(logits, args[2], args[1], args[3], V).sum()
    assert abs(materialized.item() - fused.item()) <= LOSS_RTOL * abs(fused.item())


def test_full_width_band_equals_dense():
    """prune_s = U+1 with the diagonal band: every start 0, the banded loss
    and gradients equal the dense ones to rounding."""
    over = ENCODERS["conformer_s2"]
    _, xl, y, _ = x_all = _synth(9)
    dense = _port(*_weights(_jax(**over), 9), **over)
    full = _port(*_weights(_jax(**over), 9), **over, prune_s=y.shape[1] + 1, prune_band="diagonal")
    args = tuple(map(torch.from_numpy, x_all))
    got_d, _ = _port_loss(dense, args, pruned=False)
    got_f, (_, _, starts) = _port_loss(full, args, pruned=True)
    assert not starts.any()
    got_d.backward()
    got_f.backward()
    assert abs(got_f.item() - got_d.item()) <= LOSS_RTOL * abs(got_d.item())
    _check_grads(_grads(full), _grads(dense), 1e-5)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _trainers(over, lr=1e-3, seed=0):
    jm = _jax(**over)
    jtrainer = JaxTrainer(jm, JaxTrainerConfig(init_learning_rate=lr, num_steps=50, loss_type="rnnt"))
    jstate = jtrainer.init_state(jax.random.PRNGKey(seed))
    params, model_state = _weights(jm, seed)
    jstate = dataclasses.replace(jstate, params=_jnp(params), model_state=_jnp(model_state))
    cfg = _port_config(**over)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    trainer = Trainer(cfg, TrainerConfig(init_learning_rate=lr, num_steps=50, loss_type="rnnt"), device="cpu")
    return jtrainer, jstate, trainer, state, cfg


def _batches(arrays):
    x, xl, y, yl = arrays
    return JaxPaddedBatch(*map(jnp.asarray, (x, y, xl, yl))), PaddedBatch(*map(torch.from_numpy, (x, y, xl, yl)))


@pytest.mark.parametrize("prune_s,route", [(3, "banded"), (5, "dense"), (0, "dense")])
def test_rnnt_loss_sum_matches_jax(prune_s, route):
    """``Trainer.loss_sum`` with ``loss_type = rnnt``: the banded route
    when ``0 < prune_s <= U_pad`` (U_pad 4), else the dense one; the
    divisor is the real input frames, not the encoder's."""
    over = {**ENCODERS["conformer_s2"], "prune_s": prune_s, "prune_band": "diagonal"}
    jtrainer, jstate, trainer, state, _ = _trainers(over, seed=3)
    jbatch, batch = _batches(_synth(4))
    want, (_, want_frames) = jtrainer._loss_sum(jstate.params, jstate.model_state, jbatch, train=False, rng=None)
    for k in trainer_mod.rnnt_routes:
        trainer_mod.rnnt_routes[k] = 0
    with torch.no_grad():
        got, frames = trainer.loss_sum(state.model, batch, train=False, loss_type="rnnt")
    assert trainer_mod.rnnt_routes == {"banded": int(route == "banded"), "dense": int(route == "dense")}
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want)), (got.item(), float(want))
    assert frames.item() == float(want_frames) == batch.input_lengths.sum()


def test_four_step_trajectory_matches_jax():
    """Four banded-loss steps (conformer-s2, guided band S 3, f32, dropout
    1) from one converted state: the losses within 1e-5 relative, the
    parameters within 2e-5 absolute (a step moves them by about lr =
    1e-3; the key biases, driven by rounding noise, within 2 x 4 x lr), the
    moving statistics within 1e-6."""
    over = {**ENCODERS["conformer_s2"], "prune_s": 3, "prune_band": "guided", "prune_proxy_stride": 2}
    jtrainer, jstate, trainer, state, cfg = _trainers(over, seed=5)
    for step in range(4):
        jbatch, batch = _batches(_synth(20 + step))
        jstate, jloss = jtrainer.update(jstate, jbatch)
        state, loss = trainer.update(state, batch)
        assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), (step, loss.item(), float(jloss))
    want = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    want_params = dict(want.model.named_parameters())
    for name, p in state.model.named_parameters():
        atol = 2 * 4 * 1e-3 if name.endswith(".bk") else 2e-5
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].detach().numpy(), atol=atol, err_msg=name)
    for name in ("enc.bn_conv_mean", "enc.bn_conv_var"):
        np.testing.assert_allclose(state.model.state_dict()[name].numpy(), want.model.state_dict()[name].numpy(),
                                   atol=1e-6, err_msg=name)
    assert state.adam_t == int(jstate.adam_t) == 4


def test_padding_invariance():
    """More frame and label padding, filled with garbage, leaves the summed
    loss of both routes as it is."""
    x, xl, y, yl = _synth(8)
    rng = np.random.default_rng(9)
    x2 = np.concatenate([x, rng.standard_normal((3, 7, IN)).astype(np.float32) * 4], axis=1)
    y2 = np.concatenate([y, rng.integers(0, V, (3, 3)).astype(np.int32)], axis=1)
    for prune_s in (0, 3):
        over = {**ENCODERS["conformer_s4"], "prune_s": prune_s, "prune_band": "diagonal"}
        _, _, trainer, state, _ = _trainers(over, seed=7)
        with torch.no_grad():
            losses = [trainer.loss_sum(state.model, _batches(a)[1], train=False, loss_type="rnnt")[0].item()
                      for a in ((x, xl, y, yl), (x2, xl, y2, yl))]
        assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0]), (prune_s, losses)


# ---------------------------------------------------------------------------
# the facade, the config, the converter
# ---------------------------------------------------------------------------


def test_nnet_pairing_and_decodes(tmp_path):
    def config(**over):
        cfg = ConfigParser()
        cfg.read_dict({"directories": {"expdir": str(tmp_path)},
                       "nnet": {"name": "t", "context_width": "0", "enc_type": "lstm", "num_hidden_layers": "1",
                                "num_hidden_units": "8", "pred_units": "8", "embed_dim": "4", "joint_units": "6",
                                **over}})
        return cfg

    for model, loss in (("transducer", "ctc"), ("lstm", "rnnt"), ("transducer", "cross_entropy")):
        with pytest.raises(ValueError, match="model = transducer and loss = rnnt"):
            Nnet(config(model=model, loss=loss), 5, V, device="cpu")
    net = Nnet(config(model="transducer", loss="rnnt"), 5, V, device="cpu")
    assert isinstance(net.model, Transducer) and net.blank_id == V == net.model.blank_id
    assert net.model.vocab_size == V + 1 and not net.model.config.enc_bidirectional
    with pytest.raises(ValueError, match="per-frame posteriors"):
        net.decode(None, None)
    # LM fusion follows the JAX package's rules (nnet.py:400-432): beam only, the table over the alphabet
    arpa = tmp_path / "bigram.arpa"
    arpa.write_text("\\data\\\nngram 1=3\nngram 2=1\n\n\\1-grams:\n-0.5\ta\t-0.3\n-0.7\tb\n-99\t<s>\n\n"
                    "\\2-grams:\n-0.2\ta b\n\n\\end\\\n")

    class _Coder:
        alphabet = ["a", "b", "c", "d"]

    with pytest.raises(ValueError, match="needs beam_width > 1"):
        Nnet(config(model="transducer", loss="rnnt", lm_path=str(arpa)), 5, V, device="cpu").load_text_decoder(_Coder())
    net = Nnet(config(model="transducer", loss="rnnt", lm_path=str(arpa), beam_width="3"), 5, V, device="cpu")
    save_checkpoint(net.savedir, net.model.state_dict())
    dec = net.load_text_decoder(_Coder())
    assert isinstance(dec, TransducerBeamDecoder) and dec.beam == 3 and dec.fusion.table.shape == (V + 1, V)
    with pytest.raises(ValueError, match="add_layer_period"):
        Nnet(config(model="transducer", loss="rnnt", add_layer_period="3"), 5, V, device="cpu")


def test_config_from_nnet_section():
    """config_AURORA4_transducer.cfg's ``[nnet]`` as written, read by both
    configs; the encoder is built from the nine encoder keys alone."""
    conf = synthetic.transducer_nnet()
    cfg = TransducerConfig.from_config(conf, 40, 35)
    jcfg = JaxTransducerConfig.from_config(conf, 40, 35)
    for field in ("enc_type", "enc_layers", "enc_units", "enc_bidirectional", "pred_layers", "pred_units",
                  "embed_dim", "joint_units", "dropout", "joint_chunk_t", "prune_s", "prune_band",
                  "prune_proxy_stride", "enc_extra"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.compute_dtype == torch.bfloat16 and (cfg.prune_s, cfg.prune_band) == (16, "diagonal")
    enc = cfg.encoder_config()
    assert (enc.num_blocks, enc.d_model, enc.subsample, enc.conformer, enc.causal_conv, enc.num_labels,
            enc.left_context, enc.right_context, enc.dropout) == (12, 256, 4, True, True, 320, 64, 0, 0.9)
    pred = cfg.predictor_config()
    assert (pred.input_dim, pred.hidden_units, pred.num_layers, pred.bidirectional) == (128, 320, 1, False)


@pytest.mark.parametrize("enc", ["conformer_s4", "lstm"])
def test_convert_round_trip(enc):
    """Every parameter and buffer of the port's model comes from the JAX
    pytree, with its shape; the train state's Adam moments map by name."""
    over = ENCODERS[enc]
    jm = _jax(**over)
    params, state = _weights(jm, 1)
    sd = transducer_from_jax(params, state)
    model = build_model(_port_config(**over))
    assert set(sd) == set(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())
    np.testing.assert_array_equal(sd["embed"].numpy(), params["embed"])
    np.testing.assert_array_equal(sd["joint.w"].numpy(), params["joint"]["w"])
    np.testing.assert_array_equal(sd["pred.layers.0.0.wh"].numpy(), params["pred"]["layers"][0][0]["wh"])
    jtrainer = JaxTrainer(jm, JaxTrainerConfig(loss_type="rnnt"))
    jstate = jax.tree.map(np.asarray, jtrainer.init_state(jax.random.PRNGKey(0)))
    st = train_state_from_jax(jstate, _port_config(**over))
    assert set(st.adam_m) == set(dict(st.model.named_parameters()))

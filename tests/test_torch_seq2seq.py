"""The port's attention recipe against the JAX package, on the CPU.

At the tiny widths of tests/test_seq2seq.py (encoder: 2 conformer blocks
or one 8-unit recurrent layer; decoder: 2 blocks, d_model 12, 2 heads,
ffn 16; 4 labels + SOS/EOS), from JAX-initialised weights with non-zero
output and CTC heads carried over by ``convert.seq2seq_from_jax``:

- ``apply_joint`` (attention and CTC logits) for the conformer (with and
  without ``subsample = 4``, and with ``embed_dim != d_model``), the BiLSTM
  and the BiGRU encoder (the recurrences on their plain scans), eval and
  train (dropout 1); f32 within 1e-5 of max|JAX|, bf16 by the 2x rule of
  tests/test_torch_rnn.py;
- the ``Trainer``'s attention loss (``ctc_weight`` 0.3 and 0,
  ``label_smoothing`` 0.1) against the JAX ``Trainer._loss_sum`` within
  1e-5 relative, and a 5-step trajectory from one converted ``TrainState``
  (losses 1e-5 relative, parameters 2e-5 absolute);
- padding invariance of the loss in both axes (frames and labels);
- ``nbest_prefixes``, and ``CTCRescoreDecoder.decode_batch`` (identical
  transcripts, attention scores within 1e-5 relative) against the JAX ones;
- an overfit canary for the rescoring decode; the ``Nnet`` pairing and its
  decode modes (``beam``, the default, and ``rescoring``, which reads no
  ``lm_path``); ``cli.main --steps
  dnn_train_features,dnn_test_features,train_nnet,test_nnet`` on a tiny
  attention workspace.
"""

import dataclasses
import json
import logging
import os
from configparser import ConfigParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfkaldi_tpu.data.batching import PaddedBatch as JaxPaddedBatch
from tfkaldi_tpu.decode import ctc_beam as jax_ctc_beam
from tfkaldi_tpu.decode.seq2seq import CTCRescoreDecoder as JaxCTCRescoreDecoder
from tfkaldi_tpu.models.seq2seq import AttentionSeq2Seq as JaxAttentionSeq2Seq
from tfkaldi_tpu.models.seq2seq import Seq2SeqConfig as JaxSeq2SeqConfig
from tfkaldi_tpu.train import Trainer as JaxTrainer
from tfkaldi_tpu.train import TrainerConfig as JaxTrainerConfig
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.convert import save_checkpoint, seq2seq_from_jax, train_state_from_jax
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.data.target_coder import TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
from tfkaldi_tpu_torch.decode import ctc_beam
from tfkaldi_tpu_torch.decode.seq2seq import CTCRescoreDecoder, Seq2SeqBeamDecoder
from tfkaldi_tpu_torch.models import AttentionSeq2Seq, Seq2SeqConfig
from tfkaldi_tpu_torch.nnet import Nnet
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

V = 4  # labels; SOS/EOS (and the CTC blank) = 4
IN = 5
TOL = 1e-5
BF16_RATIO = 2.0
ENCODERS = {
    "conformer": dict(enc_type="conformer"),
    "conformer_s4": dict(enc_type="conformer", subsample=4),
    "conformer_embed8": dict(enc_type="conformer", embed_dim=8),
    "lstm": dict(enc_type="lstm"),
    "gru": dict(enc_type="gru"),
}


class _IdCoder:
    alphabet = ["a", "b", "c", "d"]

    def decode(self, ids):
        return " ".join(str(i) for i in np.asarray(ids))


def rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
                 / max(np.abs(np.asarray(want, np.float64)).max(), 1e-30))


def _kwargs(enc_type="conformer", subsample=None, **kw):
    extra = ()
    if enc_type == "conformer":
        extra = (("num_blocks", "2"), ("d_model", "12"), ("num_heads", "2"), ("ffn_dim", "16"),
                 ("conv_kernel", "3"))
        if subsample:
            extra += (("subsample", str(subsample)),)
    return dict(input_dim=IN, num_labels=V, enc_type=enc_type, enc_layers=1, enc_units=8, enc_extra=extra,
                dec_blocks=2, d_model=12, num_heads=2, ffn_dim=16, **kw)


def _jax(cd="float32", **over):
    return JaxAttentionSeq2Seq(JaxSeq2SeqConfig(compute_dtype=jnp.dtype(cd), **_kwargs(**over)))


def _port_config(cd="float32", **over):
    return Seq2SeqConfig(compute_dtype=getattr(torch, cd), **_kwargs(**over))


def _weights(model, seed):
    """JAX init, then non-zero decoder and CTC heads and moving statistics
    away from (0, 1)."""
    params, state = model.init(jax.random.PRNGKey(seed))
    params, state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed + 100)
    for head in ("out", "ctc_head"):
        if head in params:
            params[head]["w"] = (rng.standard_normal(params[head]["w"].shape) * 0.5).astype(np.float32)
            params[head]["b"] = (rng.standard_normal(params[head]["b"].shape) * 0.1).astype(np.float32)
    enc_state = state.get("enc", {})
    if "bn_conv_mean" in enc_state:
        enc_state["bn_conv_mean"] = (rng.standard_normal(enc_state["bn_conv_mean"].shape) * 0.1).astype(np.float32)
        enc_state["bn_conv_var"] = rng.uniform(0.5, 2.0, enc_state["bn_conv_var"].shape).astype(np.float32)
    return params, state


def _port(params, state, cd="float32", **over):
    model = AttentionSeq2Seq(_port_config(cd, **over))
    model.load_state_dict(seq2seq_from_jax(params, state))
    return model


def _synth(seed, b=3, t=16, u=3):
    """Padded inputs (garbage in the padding) and label rows that a CTC head
    on every fourth frame can align (repeats included)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, IN)).astype(np.float32)
    xl = np.array([t, t - 3, t - 6][:b], np.int32)
    for i, n in enumerate(xl):
        x[i, n:] = rng.standard_normal((t - n, IN)) * 5
    y = rng.integers(0, V, (b, u)).astype(np.int32)
    y[0, 1] = y[0, 0]  # a repeat
    yl = np.array([u, 1, 2][:b], np.int32)
    return x, xl, y, yl


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("enc", list(ENCODERS))
def test_joint_logits_match_jax(enc, train):
    over = {**ENCODERS[enc], "ctc_weight": 0.3}
    jm = _jax(**over)
    params, state = _weights(jm, seed=len(enc))
    model = _port(params, state, **over)
    x, xl, y, yl = _synth(1)
    att, ctc_logits, _ = jm.apply_joint(_jnp(params), _jnp(state), *map(jnp.asarray, (x, xl, y, yl)), train=train)
    with torch.no_grad():
        got_att, got_ctc = model.apply_joint(*map(torch.from_numpy, (x, xl, y, yl)), train=train)
    assert got_att.shape == att.shape == (3, 4, V + 1)
    assert got_ctc.shape == ctc_logits.shape
    assert rel(got_att.numpy(), att) <= TOL, rel(got_att.numpy(), att)
    assert rel(got_ctc.numpy(), ctc_logits) <= TOL, rel(got_ctc.numpy(), ctc_logits)
    # the teacher-forced forward alone (a fresh model: training moved the moving statistics)
    want, _ = jm.apply_seq2seq(_jnp(params), _jnp(state), *map(jnp.asarray, (x, xl, y, yl)), train=False)
    with torch.no_grad():
        got = _port(params, state, **over)(*map(torch.from_numpy, (x, xl, y, yl)))
    assert rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("enc", ["conformer_s4", "lstm"])
def test_joint_logits_match_jax_bf16(enc):
    """bf16 compute, by the 2x rule: the port's distance from the JAX f32
    result within 2x the JAX bf16 result's (+ 1e-5)."""
    over = {**ENCODERS[enc], "ctc_weight": 0.3}
    params, state = _weights(_jax(**over), seed=5)
    x, xl, y, yl = _synth(2)
    args = list(map(jnp.asarray, (x, xl, y, yl)))
    want32 = _jax(**over).apply_joint(_jnp(params), _jnp(state), *args, train=False)[:2]
    want = _jax("bfloat16", **over).apply_joint(_jnp(params), _jnp(state), *args, train=False)[:2]
    with torch.no_grad():
        got = _port(params, state, "bfloat16", **over).apply_joint(*map(torch.from_numpy, (x, xl, y, yl)))
    for what, g, w, w32 in zip(("attention", "ctc"), got, want, want32):
        mine, theirs = rel(g.numpy(), w32), rel(w, w32)
        print(f"bf16 {enc} {what} logits: port {mine!r}, JAX {theirs!r} from the f32 result")  # shown with -s
        assert theirs > 0 and mine <= BF16_RATIO * theirs + TOL, (what, mine, theirs)


def _trainers(over, lr=1e-3, seed=0):
    """The JAX trainer and a state with non-zero heads, and the port's
    trainer and the converted state."""
    jm = _jax(**over)
    jtrainer = JaxTrainer(jm, JaxTrainerConfig(init_learning_rate=lr, num_steps=50, loss_type="attention"))
    jstate = jtrainer.init_state(jax.random.PRNGKey(seed))
    params, model_state = _weights(jm, seed)
    jstate = dataclasses.replace(jstate, params=_jnp(params), model_state=_jnp(model_state))
    cfg = _port_config(**over)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    trainer = Trainer(cfg, TrainerConfig(init_learning_rate=lr, num_steps=50, loss_type="attention"), device="cpu")
    return jtrainer, jstate, trainer, state, cfg


def _batches(arrays):
    """``(x, xl, y, yl)`` as the JAX and the port's ``PaddedBatch``
    (inputs, targets, input lengths, target lengths)."""
    x, xl, y, yl = arrays
    return JaxPaddedBatch(*map(jnp.asarray, (x, y, xl, yl))), _batch(arrays)


def _batch(arrays):
    x, xl, y, yl = arrays
    return PaddedBatch(*map(torch.from_numpy, (x, y, xl, yl)))


@pytest.mark.parametrize("ctc_weight", [0.3, 0.0])
def test_attention_loss_sum_matches_jax(ctc_weight):
    """``Trainer.loss_sum`` with ``loss_type = attention`` (EOS at each
    length, smoothing 0.1, the joint CTC term over ``output_lengths``) and
    its divisor, the real input frames."""
    over = {**ENCODERS["conformer_s4"], "ctc_weight": ctc_weight, "label_smoothing": 0.1}
    jtrainer, jstate, trainer, state, _ = _trainers(over, seed=3)
    jbatch, batch = _batches(_synth(4))
    want, (_, want_frames) = jtrainer._loss_sum(jstate.params, jstate.model_state, jbatch, train=False, rng=None)
    with torch.no_grad():
        got, frames = trainer.loss_sum(state.model, batch, train=False, loss_type="attention")
    assert abs(got.item() - float(want)) <= TOL * abs(float(want)), (got.item(), float(want))
    assert frames.item() == float(want_frames) == batch.input_lengths.sum()


def _num_alignments(labels, frames: int) -> int:
    """The number of CTC alignments of ``labels`` in ``frames`` frames,
    counted exactly: paths through the blank-interleaved labels that start
    in one of the first two states and end in one of the last two, a label
    reachable from the one before it directly unless the two are equal."""
    ext = [None]
    for lab in labels:
        ext += [int(lab), None]
    alpha = [1, 1] + [0] * (len(ext) - 2)
    for _ in range(frames - 1):
        alpha = [alpha[s] + (alpha[s - 1] if s else 0)
                 + (alpha[s - 2] if s >= 2 and ext[s] is not None and ext[s] != ext[s - 2] else 0)
                 for s in range(len(ext))]
    return alpha[-1] + alpha[-2]


def test_loss_is_uniform_at_init():
    """Zero-init decoder and CTC heads: both uniform over V+1, so the joint
    loss is ``(1-w)·Σ(U+1)·ln(V+1) + w·Σ(T'·ln(V+1) − ln N)`` whatever the
    smoothing (the uniform-posterior value the card suite checks at full width)."""
    w = 0.3
    cfg = _port_config(**ENCODERS["conformer_s4"], ctc_weight=w, label_smoothing=0.1)
    trainer = Trainer(cfg, TrainerConfig(loss_type="attention"), device="cpu")
    state = trainer.init_state(11)
    x, xl, y, yl = _synth(12)
    with torch.no_grad():
        got, _ = trainer.loss_sum(state.model, _batch((x, xl, y, yl)), train=False, loss_type="attention")
    t_out = (xl + 3) // 4
    ln_v = np.log(V + 1)
    att = sum(int(u) + 1 for u in yl) * ln_v
    ctc_part = sum(int(t) * ln_v - np.log(_num_alignments(y[i, : yl[i]], int(t))) for i, t in enumerate(t_out))
    want = (1 - w) * att + w * ctc_part
    assert abs(got.item() - want) <= 1e-5 * want, (got.item(), want)


def test_five_step_trajectory_matches_jax():
    """Five joint-loss steps (conformer-s4, w 0.3, ε 0.1, f32, dropout 1)
    from one converted state: the step losses within 1e-5 relative, the
    parameters within 2e-5 absolute (a step moves them by about lr = 1e-3;
    the key biases, driven by rounding noise, within 2 x 5 x lr), the
    moving statistics within 1e-6."""
    over = {**ENCODERS["conformer_s4"], "ctc_weight": 0.3, "label_smoothing": 0.1}
    jtrainer, jstate, trainer, state, cfg = _trainers(over, seed=5)
    for step in range(5):
        jbatch, batch = _batches(_synth(20 + step))
        jstate, jloss = jtrainer.update(jstate, jbatch)
        state, loss = trainer.update(state, batch)
        assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss)), (step, loss.item(), float(jloss))
    want = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    want_params = dict(want.model.named_parameters())
    for name, p in state.model.named_parameters():
        # a key bias's gradient is 0 in exact arithmetic (the softmax ignores
        # a shift of a whole row), so Adam steps both sides' key biases by
        # their rounding noise: up to lr a step each way
        atol = 2 * 5 * 1e-3 if name.endswith(".bk") else 2e-5
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].detach().numpy(), atol=atol, err_msg=name)
    for name in ("enc.bn_conv_mean", "enc.bn_conv_var"):
        np.testing.assert_allclose(state.model.state_dict()[name].numpy(), want.model.state_dict()[name].numpy(),
                                   atol=1e-6, err_msg=name)
    assert state.adam_t == int(jstate.adam_t) == 5


def test_padding_invariance_both_axes():
    """More frame padding and more label padding, both filled with garbage,
    leave the summed joint loss as it is."""
    over = {**ENCODERS["conformer_s4"], "ctc_weight": 0.3}
    _, _, trainer, state, _ = _trainers(over, seed=7)
    x, xl, y, yl = _synth(8)
    rng = np.random.default_rng(9)
    x2 = np.concatenate([x, rng.standard_normal((3, 9, IN)).astype(np.float32) * 4], axis=1)
    y2 = np.concatenate([y, rng.integers(0, V, (3, 4)).astype(np.int32)], axis=1)
    for i in range(3):
        x2[i, xl[i]:] = rng.standard_normal((x2.shape[1] - xl[i], IN)) * 4
        y2[i, yl[i]:] = rng.integers(0, V, y2.shape[1] - yl[i])
    with torch.no_grad():
        losses = [trainer.loss_sum(state.model, _batch(a), train=False, loss_type="attention")[0].item()
                  for a in ((x, xl, y, yl), (x2, xl, y2, yl))]
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0]), losses


def test_nbest_prefixes_match_jax():
    rng = np.random.default_rng(13)
    lp = np.log(rng.dirichlet(np.ones(V + 1) * 0.5, size=9))
    beams, jbeams = ctc_beam.initial_beams(), jax_ctc_beam.initial_beams()
    for frame in lp:
        beams = ctc_beam.beam_step(beams, frame, V, 6)
        jbeams = jax_ctc_beam.beam_step(jbeams, frame, V, 6)
    for n in (1, 3, 6, 10):
        assert ctc_beam.nbest_prefixes(beams, n) == jax_ctc_beam.nbest_prefixes(jbeams, n)
    assert len(ctc_beam.nbest_prefixes(beams, 10)) == len(beams) <= 6


@pytest.mark.parametrize("enc,beam,weight", [("conformer_s4", 4, 0.5), ("conformer", 3, 0.3), ("gru", 4, 0.7)])
def test_rescoring_matches_jax(enc, beam, weight):
    """Two-pass decode on converted weights: identical transcripts, n-best
    lists and CTC scores; the attention scores within 1e-5 relative of JAX's
    scores of the same hypotheses."""
    over = {**ENCODERS[enc], "ctc_weight": 0.3}
    jm = _jax(**over)
    params, state = _weights(jm, seed=17)
    x, xl, _, _ = _synth(18, b=3, t=24)
    jdec = JaxCTCRescoreDecoder(jm, _jnp(params), _jnp(state), _IdCoder(), beam_width=beam, rescore_weight=weight)
    want = jdec.decode_batch(x, xl)
    dec = CTCRescoreDecoder(_port(params, state, **over), _IdCoder(), beam_width=beam, rescore_weight=weight)
    got = dec.decode_batch(x, xl)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    b, n, l1 = dec.last_tokens.shape
    memory, _ = jdec._first(jdec.params, jnp.asarray(x), jnp.asarray(xl, jnp.int32))
    t, d = memory.shape[1:]
    enc_lens = np.asarray(jm.output_lengths(jnp.asarray(xl)))
    mem_valid = jnp.arange(t)[None, :] < jnp.asarray(enc_lens)[:, None]
    want_att = np.asarray(jdec._score(
        jdec.params, jnp.broadcast_to(memory[:, None], (b, n, t, d)).reshape(b * n, t, d),
        jnp.broadcast_to(mem_valid[:, None], (b, n, t)).reshape(b * n, t),
        jnp.asarray(dec.last_tokens.reshape(b * n, l1)), jnp.asarray(dec.last_hyp_lens.reshape(b * n)),
    )).reshape(b, n)
    filled = np.isfinite(dec.last_ctc_scores)
    assert filled[:, 0].all()
    assert rel(dec.last_att_scores[filled], want_att[filled]) <= TOL
    assert set(dec.seconds) == {"pass1", "beam", "pass2"} and all(s > 0 for s in dec.seconds.values())


def test_attention_rescoring_recovers_and_weights_behave():
    """The port's BiLSTM-encoder joint model trained on one batch (its own
    init and Trainer, 200 steps at lr 3e-2) decodes the training
    transcripts by rescoring; weight
    extremes (pure CTC, pure attention) do too, with no NaN from unfilled
    n-best slots."""
    cfg = _port_config(**ENCODERS["lstm"], ctc_weight=0.3, label_smoothing=0.0)
    trainer = Trainer(cfg, TrainerConfig(init_learning_rate=3e-2, num_steps=1000, loss_type="attention"),
                      device="cpu")
    state = trainer.init_state(66)
    rng = np.random.default_rng(65)
    x = rng.standard_normal((2, 12, IN)).astype(np.float32)
    xl = np.full(2, 12, np.int32)
    y = np.array([[1, 3, 2], [0, 2, 1]], np.int32)
    batch = PaddedBatch(*map(torch.from_numpy, (x, y, xl, np.array([3, 3], np.int32))))
    for _ in range(200):
        state, loss = trainer.update(state, batch)
    assert loss.item() < 0.05
    for w in (0.0, 0.5, 1.0):
        got = CTCRescoreDecoder(state.model, _IdCoder(), beam_width=4, rescore_weight=w).decode_batch(x, xl)
        for row in range(2):
            np.testing.assert_array_equal(got[row], y[row], err_msg=f"w={w} row={row}")


def test_rescoring_requires_joint_model():
    with pytest.raises(ValueError, match="ctc_weight"):
        CTCRescoreDecoder(AttentionSeq2Seq(_port_config()), _IdCoder())


def test_nnet_pairing_and_unported_decodes(tmp_path):
    def config(**over):
        cfg = ConfigParser()
        cfg.read_dict({"directories": {"expdir": str(tmp_path)},
                       "nnet": {"name": "s", "context_width": "0", "enc_type": "lstm", "num_hidden_layers": "1",
                                "num_hidden_units": "8", "dec_blocks": "1", "d_model": "12", "num_heads": "2",
                                "ffn_dim": "16", **over}})
        return cfg

    for model, loss in (("seq2seq", "ctc"), ("lstm", "attention")):
        with pytest.raises(ValueError, match="seq2seq"):
            Nnet(config(model=model, loss=loss), 5, V, device="cpu")
    net = Nnet(config(model="seq2seq", loss="attention", ctc_weight="0.3"), 5, V, device="cpu")
    assert isinstance(net.model, AttentionSeq2Seq) and net.model.config.enc_bidirectional
    assert net.model.vocab_size == V + 1 and net.model.sos_eos_id == V
    with pytest.raises(ValueError, match="per-frame posteriors"):
        net.decode(None, None)
    save_checkpoint(net.savedir, net.model.state_dict())
    assert isinstance(net.load_text_decoder(_IdCoder()), Seq2SeqBeamDecoder)  # decode_mode = beam, the default
    # decode_mode = rescoring reads no lm_path (nnet.py:366-377): the file is never opened
    rescoring = Nnet(config(model="seq2seq", loss="attention", ctc_weight="0.3", decode_mode="rescoring",
                            lm_path="lm.arpa"), 5, V, device="cpu")
    assert isinstance(rescoring.load_text_decoder(_IdCoder()), CTCRescoreDecoder)
    with pytest.raises(ValueError, match="subsample > 1 needs loss = ctc"):
        Nnet(config(model="conformer", num_blocks="1", subsample="4"), 5, V, device="cpu")


def test_config_from_nnet_section():
    """config_AURORA4_attention.cfg's ``[nnet]`` as written, read by both
    configs."""
    conf = synthetic.attention_nnet()
    cfg = Seq2SeqConfig.from_config(conf, 40, 35)
    jcfg = JaxSeq2SeqConfig.from_config(conf, 40, 35)
    for field in ("enc_type", "enc_extra", "dec_blocks", "d_model", "num_heads", "ffn_dim", "embed_dim",
                  "label_smoothing", "ctc_weight", "dropout", "ln_eps"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.compute_dtype == torch.bfloat16 and cfg.ctc_weight == 0.3 and cfg.dec_blocks == 4
    enc = cfg.encoder_config()
    assert (enc.num_blocks, enc.d_model, enc.subsample, enc.conformer, enc.num_labels) == (12, 256, 4, True, 256)


# ---------------------------------------------------------------------------
# the CLI on a tiny workspace
# ---------------------------------------------------------------------------

STEPS = "dnn_train_features,dnn_test_features,train_nnet,test_nnet"
TINY_NNET = {"num_blocks": 2, "d_model": 16, "ffn_dim": 16, "conv_kernel": 3, "dec_blocks": 1, "batch_size": 4,
             "valid_batches": 1, "num_epochs": 2, "valid_frequency": 2, "check_freq": 2, "beam_width": 4}


@pytest.fixture(scope="module")
def attention_workspace(tmp_path_factory):
    """config_AURORA4_attention.cfg's [nnet] as written (synthetic.attention_nnet)
    at tiny widths, batch 4, beam 4, on a tiny workspace whose transcripts
    are at most an eighth of the frames, trained and decoded through the
    CLI on the CPU."""
    root = str(tmp_path_factory.mktemp("attention"))
    ws = synthetic.make_train_workspace(root, num_pdfs=20, hidden_units=16, hidden_layers=2, num_train=16,
                                        num_test=4, min_seconds=0.5, max_seconds=1.5, text_density=8,
                                        nnet={**synthetic.attention_nnet(), **TINY_NNET})
    logger = logging.getLogger("tfkaldi_tpu_torch")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        assert cli_main.main(["--config", ws["cfg_path"], "--steps", STEPS, "--device", "cpu"]) == 0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return ws, [r.getMessage() for r in records]


def test_cli_trains_and_decodes_attention_text(attention_workspace):
    ws, messages = attention_workspace
    savedir = ws["savedir"]
    assert os.path.basename(savedir) == "attention_conformer_s4"
    state = torch.load(os.path.join(savedir, "final.pt"), weights_only=True)
    assert state["out.w"].shape == (16, 36) and state["ctc_head.w"].shape == (16, 36)  # 35 characters + SOS/EOS
    assert state["enc.in_proj.w"].shape == (4 * 40, 16)  # 4 stacked frames of 40 fbanks
    decoded = open(os.path.join(savedir, "decode", "text")).read().splitlines()
    test_utts = [line.split()[0] for line in open(os.path.join(ws["test_featdir"], "text"))]
    assert [line.split()[0] for line in decoded] == test_utts
    alphabet = set(TextCoder(aurora4_normalizer).alphabet)
    assert all(set(line.split()[1:]) <= alphabet for line in decoded)
    assert any(m.startswith("attention CER: %WER") for m in messages)
    assert any(m.startswith("attention WER: %WER") for m in messages)
    assert any(m.startswith("checkpoint averaging") for m in messages)  # average_last = 5
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    assert len(steps) == 8 and all(np.isfinite(s["loss"]) for s in steps)

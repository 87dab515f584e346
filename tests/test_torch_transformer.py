"""The port's transformer / conformer encoder against the JAX package, on the CPU.

The same weights (JAX ``init`` with a non-zero output layer and moving
statistics away from the identity, carried over by
``convert.transformer_from_jax``) and the same seeded inputs (ragged
lengths, garbage in the padding) go through ``Transformer.apply`` and the
port's ``Transformer``, at the tiny widths of tests/test_seq2seq.py (2
blocks, d_model 12, 2 heads, ffn 16, kernel 3):

- eval and train (dropout 1: batch statistics, the moving statistics
  updated) for the transformer and the conformer, ``subsample`` 1 and 4,
  the causal conv, and time-restricted attention; f32 within 1e-5 of
  max|JAX|, bf16 by the rule of tests/test_torch_rnn.py (the port's
  distance from the JAX f32 result within 2x the JAX bf16 result's, +
  1e-5);
- the gradients of a CTC loss on the tiny conformer-s4, port autograd
  against ``jax.grad`` of the JAX ``Trainer``'s loss, f32, within 1e-4 of
  each gradient's max|JAX| (the key biases, whose gradient is 0 in exact
  arithmetic, below 1e-4 of the key weights' on both sides);
- padding invariance: more padding frames, and other content in them, do
  not move the logits at real frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfkaldi_tpu.data.batching import PaddedBatch as JaxPaddedBatch
from tfkaldi_tpu.models.transformer import Transformer as JaxTransformer
from tfkaldi_tpu.models.transformer import TransformerConfig as JaxTransformerConfig
from tfkaldi_tpu.models.transformer import sinusoidal_positions as jax_positions
from tfkaldi_tpu.train import Trainer as JaxTrainer
from tfkaldi_tpu.train import TrainerConfig as JaxTrainerConfig
from tfkaldi_tpu_torch.convert import transformer_from_jax
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.models import Transformer, TransformerConfig
from tfkaldi_tpu_torch.models.transformer import sinusoidal_positions
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

IN, OUT = 5, 7
TINY = dict(input_dim=IN, num_labels=OUT, num_blocks=2, d_model=12, num_heads=2, ffn_dim=16, conv_kernel=3)
TOL = 1e-5
BF16_RATIO = 2.0

CASES = {
    "transformer": dict(conformer=False),
    "conformer": dict(conformer=True),
    "transformer_s4": dict(conformer=False, subsample=4),
    "conformer_s4": dict(conformer=True, subsample=4),
    "conformer_causal_banded": dict(conformer=True, causal_conv=True, left_context=3, right_context=0),
    "conformer_s4_banded": dict(conformer=True, subsample=4, left_context=2, right_context=1),
}


def rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
                 / max(np.abs(np.asarray(want, np.float64)).max(), 1e-30))


def _jax_model(cd="float32", **over):
    return JaxTransformer(JaxTransformerConfig(compute_dtype=jnp.dtype(cd), **TINY, **over))


def _weights(model, seed):
    """JAX init, then a non-zero output layer and moving statistics away
    from (0, 1), so that no output is trivially zero or unnormalised."""
    params, state = model.init(jax.random.PRNGKey(seed))
    params, state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed + 100)
    params["out"]["w"] = (rng.standard_normal(params["out"]["w"].shape) * 0.5).astype(np.float32)
    params["out"]["b"] = (rng.standard_normal(params["out"]["b"].shape) * 0.1).astype(np.float32)
    for blk in params["blocks"]:
        if "conv" in blk:
            blk["conv"]["bn_beta"] = (rng.standard_normal(blk["conv"]["bn_beta"].shape) * 0.1).astype(np.float32)
    if "bn_conv_mean" in state:
        state["bn_conv_mean"] = (rng.standard_normal(state["bn_conv_mean"].shape) * 0.1).astype(np.float32)
        state["bn_conv_var"] = rng.uniform(0.5, 2.0, state["bn_conv_var"].shape).astype(np.float32)
    return params, state


def _port(params, state, cd="float32", **over):
    model = Transformer(TransformerConfig(compute_dtype=getattr(torch, cd), **TINY, **over))
    model.load_state_dict(transformer_from_jax(params, state))
    return model


def _inputs(seed, b=3, t=13):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, IN)).astype(np.float32)
    lengths = np.array([t, t - 4, t - 7][:b], np.int32)
    for i, n in enumerate(lengths):
        x[i, n:] = rng.standard_normal((t - n, IN)) * 5  # garbage in the padding
    return x, lengths


def _jax_apply(model, params, state, x, lengths, train):
    out, new_state = model.apply(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                                 jnp.asarray(x), jnp.asarray(lengths), train=train)
    return np.asarray(out, np.float32), jax.tree.map(np.asarray, new_state)


def _port_apply(model, x, lengths, train):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(lengths), train=train).float().numpy()


def test_positions_are_the_jax_tables():
    """The decoder's numpy table bit for bit; the encoder's f32 table (the
    transformer's ``_sinusoidal_at``) within f32 rounding of it."""
    np.testing.assert_array_equal(sinusoidal_positions(37, 12), jax_positions(37, 12))
    from tfkaldi_tpu.models.transformer import _sinusoidal_at
    from tfkaldi_tpu_torch.models.transformer import sinusoidal_at

    want = np.asarray(_sinusoidal_at(jnp.arange(37), 12))
    assert np.abs(sinusoidal_at(37, 12, "cpu").numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(CASES))
def test_encoder_matches_jax_f32(case, train):
    over = CASES[case]
    jm = _jax_model(**over)
    params, state = _weights(jm, seed=len(case))
    model = _port(params, state, **over)
    x, lengths = _inputs(1)
    want, want_state = _jax_apply(jm, params, state, x, lengths, train)
    got = _port_apply(model, x, lengths, train)
    t_out = -(-x.shape[1] // over.get("subsample", 1))
    assert got.shape == want.shape == (3, t_out, OUT)
    assert rel(got, want) <= TOL, rel(got, want)
    if over["conformer"]:
        # train: the moving statistics move by (1 - decay)·(batch - moving); eval: they stay
        for name in ("bn_conv_mean", "bn_conv_var"):
            np.testing.assert_allclose(getattr(model, name).numpy(), want_state[name], rtol=0, atol=1e-6,
                                       err_msg=name)
        moved = not np.array_equal(model.bn_conv_mean.numpy(), state["bn_conv_mean"])
        assert moved == train


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", ["transformer", "conformer_s4", "conformer_causal_banded"])
def test_encoder_matches_jax_bf16(case, train):
    """bf16 compute: the residual stream, the dense outputs and the
    attention probabilities rounded to bf16 on both sides, sums in another
    order: the port's distance from the JAX f32 result within 2x the JAX
    bf16 result's."""
    over = CASES[case]
    params, state = _weights(_jax_model(**over), seed=7)
    x, lengths = _inputs(2)
    want32, _ = _jax_apply(_jax_model(**over), params, state, x, lengths, train)
    want, _ = _jax_apply(_jax_model("bfloat16", **over), params, state, x, lengths, train)
    got = _port_apply(_port(params, state, "bfloat16", **over), x, lengths, train)
    mine, theirs = rel(got, want32), rel(want, want32)
    print(f"bf16 {case} {train}: port {mine!r}, JAX {theirs!r} from the f32 result")  # shown with -s
    assert theirs > 0  # the JAX run did round
    assert mine <= BF16_RATIO * theirs + TOL, (mine, theirs)


def test_ctc_gradients_match_jax_grad():
    """Port autograd against ``jax.grad`` of the JAX ``Trainer``'s CTC loss
    on the tiny conformer-s4 (train mode, dropout 1), f32: the summed loss
    within 1e-5 relative, every gradient within 1e-4 of its max|JAX|."""
    over = dict(conformer=True, subsample=4)
    jm = _jax_model(**over)
    params, state = _weights(jm, seed=3)
    x, lengths = _inputs(4, b=3, t=24)
    blank = OUT - 1
    targets = np.array([[1, 2, 2], [3, 0, 0], [4, 5, 0]], np.int32)  # a repeat in row 0
    tgt_len = np.array([3, 1, 2], np.int32)
    jtrainer = JaxTrainer(jm, JaxTrainerConfig(loss_type="ctc", ctc_blank_id=blank))
    jbatch = JaxPaddedBatch(jnp.asarray(x), jnp.asarray(targets), jnp.asarray(lengths), jnp.asarray(tgt_len))

    def jloss(p):
        return jtrainer._loss_sum(p, jax.tree.map(jnp.asarray, state), jbatch, train=True, rng=None)[0]

    jparams = jax.tree.map(jnp.asarray, params)
    want_loss, want_grads = jax.value_and_grad(jloss)(jparams)
    want = transformer_from_jax(jax.tree.map(np.asarray, want_grads), {})

    cfg = TransformerConfig(**TINY, **over)
    trainer = Trainer(cfg, TrainerConfig(loss_type="ctc", ctc_blank_id=blank), device="cpu")
    state0 = trainer.init_state(0)
    state0.model.load_state_dict(transformer_from_jax(params, state))
    batch = PaddedBatch(*(torch.from_numpy(a) for a in (x, targets, lengths, tgt_len)))
    grads, loss, frames = trainer.gradients(state0, batch)
    assert abs(loss.item() - float(want_loss)) <= TOL * abs(float(want_loss))
    assert frames.item() == lengths.sum()
    assert set(grads) == set(want)
    for name, g in grads.items():
        if name.endswith(".bk"):
            # a key bias shifts every score of a row alike, which the softmax
            # ignores: its gradient is 0 in exact arithmetic, so both sides hold
            # rounding noise, small against the key weights' gradient
            scale = np.abs(want[name[:-2] + "wk"].numpy()).max()
            assert max(np.abs(g.numpy()).max(), np.abs(want[name].numpy()).max()) <= 1e-4 * scale, name
            continue
        assert rel(g.numpy(), want[name].numpy()) <= 1e-4, (name, rel(g.numpy(), want[name].numpy()))


@pytest.mark.parametrize("case", ["conformer", "conformer_s4"])
def test_padding_invariance(case):
    """More padding frames (with other content) leave the logits at real
    frames as they are, including a subsampling group that straddles an
    utterance's end."""
    over = CASES[case]
    params, state = _weights(_jax_model(**over), seed=9)
    model = _port(params, state, **over)
    x, lengths = _inputs(5, t=13)
    base = _port_apply(model, x, lengths, train=False)
    rng = np.random.default_rng(6)
    wide = np.concatenate([x, rng.standard_normal((3, 11, IN)).astype(np.float32) * 3], axis=1)
    for i, n in enumerate(lengths):
        wide[i, n:] = rng.standard_normal((wide.shape[1] - n, IN)) * 7
    got = _port_apply(model, wide, lengths, train=False)
    out_len = model.output_lengths(lengths)
    for i, n in enumerate(out_len):
        np.testing.assert_allclose(got[i, :n], base[i, :n], rtol=0, atol=1e-5)


def test_config_from_nnet_section():
    """The ``[nnet]`` keys of config_AURORA4_attention.cfg's encoder, and
    the shape checks of the JAX config."""
    from tfkaldi_tpu_torch import synthetic

    conf = {**synthetic.attention_nnet(), "conformer": "True"}
    cfg = TransformerConfig.from_config(conf, 40, 256)
    assert (cfg.num_blocks, cfg.d_model, cfg.num_heads, cfg.ffn_dim, cfg.conv_kernel, cfg.subsample) == (
        12, 256, 4, 1024, 15, 4)
    assert cfg.conformer and cfg.compute_dtype == torch.bfloat16 and cfg.dropout == 0.9
    jcfg = JaxTransformerConfig.from_config(conf, 40, 256)
    for field in ("num_blocks", "d_model", "num_heads", "ffn_dim", "conv_kernel", "subsample", "left_context",
                  "right_context", "causal_conv", "dropout", "ln_eps", "bn_eps", "bn_decay"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    for bad in (dict(d_model=10, num_heads=4), dict(conformer=True, conv_kernel=0), dict(subsample=0),
                dict(left_context=-2)):
        with pytest.raises(ValueError):
            TransformerConfig(**{**TINY, **bad})
    # an even kernel pads TF's SAME, (k-1)//2 before and k//2 after (the JAX config refuses it)
    assert TransformerConfig(**{**TINY, "conformer": True, "conv_kernel": 4}).conv_kernel == 4
    model = Transformer(dataclasses.replace(cfg, num_blocks=1))
    assert model.blocks[0].conv.w_dw.shape == (256, 1, 15) and model.bn_conv_mean.shape == (1, 256)


def test_cross_entropy_needs_one_to_one_frames():
    """Frame CE on a transformer: the JAX ``Trainer``'s loss and divisor
    (the target frames); with ``subsample > 1`` both trainers refuse it."""
    jm = _jax_model()
    params, state = _weights(jm, seed=11)
    x, lengths = _inputs(12)
    targets = np.random.default_rng(13).integers(0, OUT, x.shape[:2]).astype(np.int32)
    jtrainer = JaxTrainer(jm, JaxTrainerConfig(loss_type="cross_entropy"))
    jbatch = JaxPaddedBatch(jnp.asarray(x), jnp.asarray(targets), jnp.asarray(lengths), jnp.asarray(lengths))
    want, (_, want_frames) = jtrainer._loss_sum(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                                                jbatch, train=False, rng=None)
    batch = PaddedBatch(*(torch.from_numpy(a) for a in (x, targets, lengths, lengths)))
    with torch.no_grad():
        got, frames = Trainer.loss_sum(_port(params, state), batch, train=False)
    assert abs(got.item() - float(want)) <= TOL * abs(float(want)) and frames.item() == float(want_frames)
    s4 = _port(*_weights(_jax_model(subsample=4), seed=11), subsample=4)
    with pytest.raises(ValueError, match="1:1"):
        Trainer.loss_sum(s4, batch, train=False)


@pytest.mark.parametrize("beam", [1, 4])
def test_ctc_decode_of_a_subsampled_encoder_matches_jax(beam):
    """The CTC text decode of a conformer-s4 (``model = conformer`` with
    ``loss = ctc``): each row searched over its ``ceil(T/4)`` output
    frames, as the JAX ``CTCDecoder`` does."""
    from tfkaldi_tpu.decode.ctc import CTCDecoder as JaxCTCDecoder
    from tfkaldi_tpu_torch.decode.ctc import CTCDecoder

    over = CASES["conformer_s4"]
    jm = _jax_model(**over)
    params, state = _weights(jm, seed=14)
    x, lengths = _inputs(15, t=40)
    blank = OUT - 1
    want = JaxCTCDecoder(jm, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state), None, blank,
                         beam_width=beam).decode_batch(x, lengths)
    got = CTCDecoder(_port(params, state, **over), None, blank, beam_width=beam).decode_batch(x, lengths)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert any(len(g) for g in got)

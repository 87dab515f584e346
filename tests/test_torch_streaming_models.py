"""The port's stream methods (conformer / transformer, transducer encoder,
LSTM / GRU) against the JAX package's and against the port's own offline
forward, on the CPU.

Seeded JAX weights (every leaf redrawn by ``torch_parity.random_start``,
the output layers and batchnorm statistics included) go through
``convert.transformer_from_jax`` / ``transducer_from_jax`` /
``rnn_from_jax``; the models are small: 2 blocks, ``d_model`` 32,
``subsample`` 2 and 4, ``attention_left_context`` 8, ``conv_kernel`` 5,
causal conv, f32 (the port rounds the conformer's GLU to ``compute_dtype``
where the JAX stream keeps it in f32, which in f32 is the same thing).

- each chunk's logits at its valid positions, and every carry leaf after
  it, within TOL of JAX's ``apply_stream`` (``rel``: max error over max
  |ref|), the flush likewise, ragged rows and a row that idles included;
- the chunked stream (chunks 1, 3, 7 and the whole utterance, then the
  flush) equals the port's own offline ``forward`` within TOL: the same
  roundings, attention sums over another key count;
- ``merge_stream_carry`` takes the selected rows exactly, as JAX's;
- ``Transducer.encode_stream`` / ``encode_stream_flush`` within TOL of
  JAX's, and ``validate_streamable`` refuses what JAX refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.torch_parity import random_start, rel
from tfkaldi_tpu.models.rnn import GRU as JaxGRU
from tfkaldi_tpu.models.rnn import LSTM as JaxLSTM
from tfkaldi_tpu.models.rnn import RNNConfig as JaxRNNConfig
from tfkaldi_tpu.models.transducer import Transducer as JaxTransducer
from tfkaldi_tpu.models.transducer import TransducerConfig as JaxTransducerConfig
from tfkaldi_tpu.models.transformer import Transformer as JaxTransformer
from tfkaldi_tpu.models.transformer import TransformerConfig as JaxTransformerConfig
from tfkaldi_tpu_torch.convert import rnn_from_jax, transducer_from_jax, transformer_from_jax
from tfkaldi_tpu_torch.models import GRU, LSTM, RNNConfig, Transducer, TransducerConfig, Transformer, TransformerConfig

TOL = 1e-5
F, T = 5, 23
LENGTHS = np.asarray([23, 17, 9, 0])  # ragged rows and one that never speaks


def _cfg(cls, subsample, conformer=True, **kw):
    return cls(input_dim=F, num_labels=7, num_blocks=2, d_model=32, num_heads=4, ffn_dim=32, conformer=conformer,
               conv_kernel=5, left_context=8, right_context=0, causal_conv=True, subsample=subsample, **kw)


def _models(subsample, conformer=True, seed=0):
    jm = JaxTransformer(_cfg(JaxTransformerConfig, subsample, conformer))
    params, state = random_start(jm, seed)
    model = Transformer(_cfg(TransformerConfig, subsample, conformer))
    model.load_state_dict(transformer_from_jax(params, state))
    return jm, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state), model.eval()


def _inputs(seed=1):
    x = np.random.default_rng(seed).standard_normal((len(LENGTHS), T, F)).astype(np.float32)
    return x


def _chunks(chunk):
    for t0 in range(0, T, chunk):
        yield t0, np.clip(LENGTHS - t0, 0, chunk).astype(np.int32)


def _carry_np(carry):
    return {k: np.asarray(v) for k, v in carry.items()}


@pytest.mark.parametrize("subsample", [2, 4])
@pytest.mark.parametrize("conformer", [True, False])
def test_conformer_stream_matches_jax(subsample, conformer):
    """Chunks of 3 frames: each chunk's valid logits and the carry after it
    within TOL of JAX's ``apply_stream``; the output counts equal; the
    flush's logits, counts and carry too."""
    jm, params, state, model = _models(subsample, conformer)
    x = _inputs()
    jcarry = jm.init_stream_carry(len(LENGTHS))
    carry = model.init_stream_carry(len(LENGTHS))
    assert set(carry) == set(jcarry)
    with torch.no_grad():
        for t0, v in _chunks(3):
            chunk = x[:, t0: t0 + 3]
            jn = np.asarray(jm.stream_output_lengths(jcarry, jnp.asarray(v)))
            n = model.stream_output_lengths(carry, torch.from_numpy(v)).numpy()
            np.testing.assert_array_equal(n, jn)
            jy, jcarry = jm.apply_stream(params, state, jnp.asarray(chunk), jnp.asarray(v), jcarry)
            y, carry = model.apply_stream(torch.from_numpy(chunk), torch.from_numpy(v), carry)
            jy = np.asarray(jy)
            for i, k in enumerate(n):
                if k:
                    assert rel(y[i, :k].numpy(), jy[i, :k]) <= TOL, (t0, i)
            jc = _carry_np(jcarry)
            for key, leaf in carry.items():
                if key in ("pos", "in_fill"):
                    np.testing.assert_array_equal(leaf.numpy(), jc[key])
                else:
                    assert rel(leaf.numpy(), jc[key]) <= TOL, key
        jy, jn, jcarry = jm.apply_stream_flush(params, state, jcarry)
        y, n, carry = model.apply_stream_flush(carry)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    rows = n.numpy() > 0
    assert rows.any()
    assert rel(y.numpy()[rows], np.asarray(jy)[rows]) <= TOL
    np.testing.assert_array_equal(carry["in_fill"].numpy(), 0)


@pytest.mark.parametrize("subsample", [1, 2, 4])
@pytest.mark.parametrize("chunk", [1, 3, 7, T])
def test_chunked_equals_offline(subsample, chunk):
    """The stream of chunks then the flush gives, row by row, the port's
    offline ``forward`` on the whole padded batch (ceil(n/s) positions)."""
    _, _, _, model = _models(subsample)
    x = torch.from_numpy(_inputs(2))
    lengths = torch.from_numpy(LENGTHS)
    with torch.no_grad():
        full = model(x, lengths)
        carry = model.init_stream_carry(len(LENGTHS))
        outs = [[] for _ in LENGTHS]
        for t0, v in _chunks(chunk):
            n = model.stream_output_lengths(carry, torch.from_numpy(v))
            y, carry = model.apply_stream(x[:, t0: t0 + chunk], torch.from_numpy(v), carry)
            for i, k in enumerate(n):
                outs[i].append(y[i, :k])
        y, n, carry = model.apply_stream_flush(carry)
        for i, k in enumerate(n):
            outs[i].append(y[i, :k])
    want_n = model.output_lengths(lengths)
    scale = full.abs().max().item()
    for i, k in enumerate(want_n):
        got = torch.cat(outs[i])
        assert got.shape[0] == k
        if k:
            assert (got - full[i, :k]).abs().max().item() <= TOL * scale, i


def test_conformer_merge_and_validate():
    """``merge_stream_carry`` takes the selected rows of ``new`` exactly
    (caches on their batch dim 1), as JAX's; a row of length 0 keeps its
    carry bit for bit; non-causal configs are refused, as JAX refuses."""
    jm, params, state, model = _models(2)
    x = _inputs(3)
    v = np.asarray([3, 3, 0, 2], np.int32)
    with torch.no_grad():
        c0 = model.init_stream_carry(4)
        _, c1 = model.apply_stream(torch.from_numpy(x[:, :3]), torch.from_numpy(v), c0)
        _, c2 = model.apply_stream(torch.from_numpy(x[:, 3:6]), torch.from_numpy(v), c1)
    for key in c1:  # the idle row 2 is untouched
        bdim = 1 if key in ("h_cache", "conv_cache") else 0
        np.testing.assert_array_equal(c2[key].select(bdim, 2).numpy(), c1[key].select(bdim, 2).numpy())
    take = np.asarray([True, False, True, False])
    merged = model.merge_stream_carry(torch.from_numpy(take), c2, c1)
    jmerged = jm.merge_stream_carry(jnp.asarray(take), {k: jnp.asarray(t.numpy()) for k, t in c2.items()},
                                    {k: jnp.asarray(t.numpy()) for k, t in c1.items()})
    for key in merged:
        np.testing.assert_array_equal(merged[key].numpy(), np.asarray(jmerged[key]))
    for bad in (dict(left_context=-1), dict(right_context=2), dict(causal_conv=False)):
        kw = {"left_context": 8, "right_context": 0, "causal_conv": True, **bad}
        with pytest.raises(ValueError, match="stream"):
            JaxTransformer(_cfg(JaxTransformerConfig, 1).__class__(
                **{**_cfg(JaxTransformerConfig, 1).__dict__, **kw})).validate_streamable()
        with pytest.raises(ValueError, match="stream"):
            Transformer(TransformerConfig(**{**_cfg(TransformerConfig, 1).__dict__, **kw})).init_stream_carry(1)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_merge_stream_carry(cell):
    """The RNNs' ``merge_stream_carry`` against JAX's on the carries of a
    two-chunk stream; merged rows continue as their source would."""
    jcls, cls = (JaxLSTM, LSTM) if cell == "lstm" else (JaxGRU, GRU)
    jm = jcls(JaxRNNConfig(input_dim=F, num_labels=3, num_layers=2, hidden_units=7))
    params, _ = random_start(jm, 5)
    model = cls(RNNConfig(input_dim=F, num_labels=3, num_layers=2, hidden_units=7, cell=cell))
    model.load_state_dict(rnn_from_jax(params))
    x = torch.from_numpy(_inputs(4)[:, :8])
    v = torch.tensor([4, 4, 0, 3])
    with torch.no_grad():
        c0 = model.init_stream_carry(4)
        _, c1 = model.apply_stream(x[:, :4], v, c0)
        _, c2 = model.apply_stream(x[:, 4:8], v, c1)
        take = torch.tensor([True, False, False, True])
        merged = model.merge_stream_carry(take, c2, c1)
    jmerged = jm.merge_stream_carry(jnp.asarray(take.numpy()), [tuple(jnp.asarray(a.numpy()) for a in layer)
                                                                for layer in c2],
                                    [tuple(jnp.asarray(a.numpy()) for a in layer) for layer in c1])
    for layer, jlayer in zip(merged, jmerged):
        for a, ja in zip(layer, jlayer):
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    for layer, l1, l2 in zip(merged, c1, c2):
        for a, a1, a2 in zip(layer, l1, l2):
            np.testing.assert_array_equal(a[take].numpy(), a2[take].numpy())
            np.testing.assert_array_equal(a[~take].numpy(), a1[~take].numpy())


def _transducer_kw(enc, subsample):
    kw = dict(input_dim=F, num_labels=4, enc_layers=1, enc_units=16, pred_layers=1, pred_units=16, embed_dim=6,
              joint_units=16)
    if enc == "conformer":
        kw.update(enc_type="conformer", enc_extra=(
            ("num_blocks", "2"), ("d_model", "32"), ("num_heads", "4"), ("ffn_dim", "32"), ("conv_kernel", "5"),
            ("subsample", str(subsample)), ("attention_left_context", "8"), ("attention_right_context", "0"),
            ("causal_conv", "True")))
    return kw


@pytest.mark.parametrize("enc,subsample", [("lstm", 1), ("conformer", 2), ("conformer", 4)])
def test_transducer_encode_stream_matches_jax(enc, subsample):
    """``encode_stream`` chunk by chunk and ``encode_stream_flush`` within
    TOL of JAX's (outputs at valid positions, the counts exactly)."""
    kw = _transducer_kw(enc, subsample)
    jm = JaxTransducer(JaxTransducerConfig(**kw))
    params, _ = random_start(jm, 6)
    state = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(6))[1])
    if "bn_conv_mean" in state["enc"]:  # moving stats away from (0, 1)
        rng = np.random.default_rng(8)
        state["enc"]["bn_conv_mean"] = (rng.standard_normal(state["enc"]["bn_conv_mean"].shape) * 0.2).astype(
            np.float32)
        state["enc"]["bn_conv_var"] = rng.uniform(0.5, 2.0, state["enc"]["bn_conv_var"].shape).astype(np.float32)
    model = Transducer(TransducerConfig(**kw)).eval()
    model.load_state_dict(transducer_from_jax(params, state))
    params, state = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)
    model.validate_streamable()
    jm.validate_streamable()
    x = _inputs(7)
    jcarry = jm.encoder.init_stream_carry(len(LENGTHS))
    carry = model.enc.init_stream_carry(len(LENGTHS))
    with torch.no_grad():
        for t0, v in _chunks(5):
            chunk = x[:, t0: t0 + 5]
            je, jn, jcarry = jm.encode_stream(params, state, jnp.asarray(chunk), jnp.asarray(v), jcarry)
            e, n, carry = model.encode_stream(torch.from_numpy(chunk), torch.from_numpy(v), carry)
            np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
            for i, k in enumerate(n.numpy()):
                if k:
                    assert rel(e[i, :k].numpy(), np.asarray(je)[i, :k]) <= TOL
        je, jn, _ = jm.encode_stream_flush(params, state, jcarry)
        e, n, _ = model.encode_stream_flush(carry)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert e.shape == tuple(je.shape)
    rows = n.numpy() > 0
    if rows.any():
        assert rel(e.numpy()[rows], np.asarray(je)[rows]) <= TOL
    bidi = Transducer(TransducerConfig(**{**_transducer_kw("lstm", 1), "enc_bidirectional": True}))
    with pytest.raises(ValueError, match="unidirectional"):
        bidi.validate_streamable()

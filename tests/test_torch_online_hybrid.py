"""The port's streaming hybrid likelihood emitters against the JAX
package's and against the port's offline ``Decoder``, on the CPU.

Twins of the hybrid cases of tests/test_online.py (``OnlineRecurrentDecoder``
:95-135, ``OnlineSplicedDecoder`` :189-255, ``OnlineWindowedDecoder``
:343-467). Seeded JAX weights (``torch_parity.random_start``: batchnorm
statistics away from (0, 1)) go through ``convert``; inputs are seeded
numpy features of 3 ragged rows, zero past each length. The port's DNN runs
kernel 1's plain version here.

- ``OnlineSplicedDecoder`` (a 2 x 16 DNN with batchnorm) at ``context_width``
  0 and 2 and chunks of 1, 5 and 64 frames, rows of 64, 37 and 1 frames;
- ``OnlineWindowedDecoder`` for a 3-layer TDNN (receptive field 6 + 6) and a
  2-conv CNN (3 + 3) at chunks of 1, 5 and 64, and a TDNN at seeded random
  chunkings;
- ``OnlineRecurrentDecoder`` for a 2 x 16 unidirectional LSTM and GRU at
  chunks of 8;

each held to JAX's emitter on the same chunks within the JAX test's bar
(TOL_SPLICED 1e-5, TOL_WINDOWED and TOL_RECURRENT 2e-5) and to the port's
offline ``Decoder`` on offline-spliced features within the same bar (a
product of other row counts may round otherwise). The guards: a call before
``reset``, a bidirectional model, a subsampling model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.torch_parity import random_start
from tfkaldi_tpu.decode.online import OnlineRecurrentDecoder as JaxRecurrent
from tfkaldi_tpu.decode.online import OnlineSplicedDecoder as JaxSpliced
from tfkaldi_tpu.decode.online import OnlineWindowedDecoder as JaxWindowed
from tfkaldi_tpu.models import CNN as JaxCNN
from tfkaldi_tpu.models import DNN as JaxDNN
from tfkaldi_tpu.models import GRU as JaxGRU
from tfkaldi_tpu.models import LSTM as JaxLSTM
from tfkaldi_tpu.models import TDNN as JaxTDNN
from tfkaldi_tpu.models import CNNConfig as JaxCNNConfig
from tfkaldi_tpu.models import DNNConfig as JaxDNNConfig
from tfkaldi_tpu.models import RNNConfig as JaxRNNConfig
from tfkaldi_tpu.models import TDNNConfig as JaxTDNNConfig
from tfkaldi_tpu_torch.convert import cnn_from_jax, dnn_from_jax, rnn_from_jax, tdnn_from_jax
from tfkaldi_tpu_torch.decode.decoder import Decoder
from tfkaldi_tpu_torch.decode.online import OnlineRecurrentDecoder, OnlineSplicedDecoder, OnlineWindowedDecoder
from tfkaldi_tpu_torch.frontend.cmvn import splice
from tfkaldi_tpu_torch.models import CNN, DNN, GRU, LSTM, TDNN, CNNConfig, DNNConfig, RNNConfig, TDNNConfig
from tfkaldi_tpu_torch.models import Transformer, TransformerConfig

TOL_SPLICED = 1e-5
TOL_WINDOWED = 2e-5
TOL_RECURRENT = 2e-5


def _pair(jax_cls, jax_cfg_cls, cls, cfg_cls, convert, seed=0, **cfg):
    """(JAX model, params, state, port model) from one seeded start."""
    jm = jax_cls(jax_cfg_cls(**cfg))
    params, state = random_start(jm, seed, scale=0.4)
    model = cls(cfg_cls(**cfg))
    model.load_state_dict(convert(params, state))
    tree = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    return jm, tree(params), tree(state), model.eval()


def _feats(seed, lengths, total, dim):
    x = np.random.default_rng(seed).standard_normal((len(lengths), total, dim)).astype(np.float32)
    for row, n in enumerate(lengths):
        x[row, n:] = 0
    return x


def _prior(o):
    return np.random.default_rng(o).uniform(0.5, 1.5, o).astype(np.float32) / o


def _chunked(dec, feats, lengths, bounds):
    """Stream ``feats`` through ``dec`` at the chunk ``bounds``, then flush;
    per row the emitted frames."""
    dec.reset(len(lengths))
    got = [[] for _ in lengths]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        likes, nnew = dec.step(feats[:, lo:hi], np.clip(lengths - lo, 0, hi - lo).astype(np.int32))
        for row in range(len(lengths)):
            got[row].append(np.asarray(likes)[row, : nnew[row]])
    likes, nnew = dec.flush()
    for row in range(len(lengths)):
        got[row].append(np.asarray(likes)[row, : nnew[row]])
    return [np.concatenate(g) for g in got]


def _check(port, jax_out, offline, lengths, tol):
    for row, n in enumerate(lengths):
        assert port[row].shape == (n, offline.shape[2]) == jax_out[row].shape
        np.testing.assert_allclose(port[row], jax_out[row], rtol=0, atol=tol)
        np.testing.assert_allclose(port[row], offline[row, :n], rtol=0, atol=tol)


def _offline(model, prior, feats, lengths, c):
    return Decoder(model, prior).compute_batch(splice(torch.from_numpy(feats), c), lengths).numpy()


@pytest.mark.parametrize("c", [0, 2])
@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_spliced_dnn_matches_jax_and_offline(c, chunk):
    dim, labels, total = 6, 7, 64
    jm, params, state, model = _pair(JaxDNN, JaxDNNConfig, DNN, DNNConfig, dnn_from_jax, input_dim=dim * (2 * c + 1),
                                     num_labels=labels, num_hidden_layers=2, num_hidden_units=16, batch_norm=True)
    prior = _prior(labels)
    lengths = np.asarray([64, 37, 1], np.int32)
    feats = _feats(6, lengths, total, dim)
    bounds = [*range(0, total, chunk), total]
    port = _chunked(OnlineSplicedDecoder(model, prior, c), feats, lengths, bounds)
    jax_out = _chunked(JaxSpliced(jm, params, state, prior, context_width=c), feats, lengths, bounds)
    _check(port, jax_out, _offline(model, prior, feats, lengths, c), lengths, TOL_SPLICED)


def _windowed_pair(family, c, dim, labels, seed=0):
    if family == "tdnn":
        pair = _pair(JaxTDNN, JaxTDNNConfig, TDNN, TDNNConfig, tdnn_from_jax, seed, input_dim=dim * (2 * c + 1),
                     num_labels=labels, num_hidden_layers=3, num_hidden_units=16, context="-2,-1,0,1,2;-1,0,1;-3,0,3")
        assert (pair[3].left_receptive, pair[3].right_receptive) == (6, 6)
    else:
        pair = _pair(JaxCNN, JaxCNNConfig, CNN, CNNConfig, cnn_from_jax, seed, input_dim=dim * (2 * c + 1),
                     num_labels=labels, filters="8,8", kernels="5x3;3x3", pool="2,1", num_channels=2 * c + 1,
                     num_hidden_layers=1, num_hidden_units=16)
        assert (pair[3].left_receptive, pair[3].right_receptive) == (3, 3)
    return pair


@pytest.mark.parametrize("family", ["tdnn", "cnn"])
@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_windowed_matches_jax_and_offline(family, chunk):
    dim, c, labels, total = 6, 1, 7, 41
    jm, params, state, model = _windowed_pair(family, c, dim, labels)
    prior = _prior(labels)
    lengths = np.asarray([41, 23, 2], np.int32)
    feats = _feats(9, lengths, total, dim)
    bounds = [*range(0, total, chunk), total]
    port = _chunked(OnlineWindowedDecoder(model, prior, c), feats, lengths, bounds)
    jax_out = _chunked(JaxWindowed(jm, params, state, prior, context_width=c), feats, lengths, bounds)
    _check(port, jax_out, _offline(model, prior, feats, lengths, c), lengths, TOL_WINDOWED)


def test_windowed_random_chunkings():
    """Seeded random cut patterns over the windowed TDNN: the buffer and
    window index arithmetic at every cut, against JAX and the offline
    decode."""
    dim, c, labels, total = 5, 2, 6, 29
    jm, params, state, model = _pair(JaxTDNN, JaxTDNNConfig, TDNN, TDNNConfig, tdnn_from_jax, 7,
                                     input_dim=dim * (2 * c + 1), num_labels=labels, num_hidden_layers=2,
                                     num_hidden_units=12, context="-2,0,2;-1,0,1")
    prior = _prior(labels)
    rng = np.random.default_rng(17)
    lengths = np.asarray([29, 13], np.int32)
    feats = _feats(17, lengths, total, dim)
    offline = _offline(model, prior, feats, lengths, c)
    for _ in range(4):
        cuts = sorted(rng.choice(np.arange(1, total), size=rng.integers(1, 7), replace=False).tolist())
        bounds = [0, *cuts, total]
        port = _chunked(OnlineWindowedDecoder(model, prior, c), feats, lengths, bounds)
        jax_out = _chunked(JaxWindowed(jm, params, state, prior, context_width=c), feats, lengths, bounds)
        _check(port, jax_out, offline, lengths, TOL_WINDOWED)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_recurrent_matches_jax_and_offline(cell):
    cfg = dict(input_dim=8, num_labels=5, num_layers=2, hidden_units=16, bidirectional=False)
    jax_cls, cls = (JaxLSTM, LSTM) if cell == "lstm" else (JaxGRU, GRU)
    jm = jax_cls(JaxRNNConfig(**cfg))
    params, state = random_start(jm, 0, scale=0.4)
    model = cls(RNNConfig(**cfg, cell=cell)).eval()
    model.load_state_dict(rnn_from_jax(params))
    params, state = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state)
    prior = _prior(5)
    lengths = np.asarray([24, 13], np.int32)
    feats = _feats(2, lengths, 24, 8)
    dec, jdec = OnlineRecurrentDecoder(model, prior), JaxRecurrent(jm, params, state, prior)
    dec.reset(2)
    jdec.reset(2)
    port, jax_out = [], []
    for pos in range(0, 24, 8):
        cl = np.clip(lengths - pos, 0, 8).astype(np.int32)
        port.append(dec.step(feats[:, pos: pos + 8], cl))
        jax_out.append(np.asarray(jdec.step(feats[:, pos: pos + 8], cl)))
    assert dec.step(np.zeros((2, 0, 8), np.float32), np.zeros(2, np.int32)).shape == (2, 0, 5)
    port, jax_out = np.concatenate(port, axis=1), np.concatenate(jax_out, axis=1)
    offline = Decoder(model, prior).compute_batch(feats, lengths).numpy()
    _check([port[r, :n] for r, n in enumerate(lengths)], [jax_out[r, :n] for r, n in enumerate(lengths)], offline,
           lengths, TOL_RECURRENT)


def test_emitter_guards():
    prior = np.full((4,), 0.25, np.float32)
    dnn = DNN(DNNConfig(input_dim=6, num_labels=4, num_hidden_layers=1, num_hidden_units=8))
    tdnn = TDNN(TDNNConfig(input_dim=6, num_labels=4, num_hidden_layers=1, num_hidden_units=8, context="-1,0,1"))
    gru = GRU(RNNConfig(input_dim=6, num_labels=4, num_layers=1, hidden_units=8, cell="gru"))
    for dec in (OnlineSplicedDecoder(dnn, prior, 1), OnlineWindowedDecoder(tdnn, prior, 1)):
        with pytest.raises(RuntimeError, match="reset"):
            dec.step(np.zeros((1, 4, 6), np.float32), np.asarray([4]))
        with pytest.raises(RuntimeError, match="reset"):
            dec.flush()
    with pytest.raises(RuntimeError, match="reset"):
        OnlineRecurrentDecoder(gru, prior).step(np.zeros((1, 4, 6), np.float32), np.asarray([4]))
    bidi = LSTM(RNNConfig(input_dim=6, num_labels=4, num_layers=1, hidden_units=8, bidirectional=True))
    with pytest.raises(ValueError, match="unidirectional"):
        OnlineRecurrentDecoder(bidi, prior)
    sub = Transformer(TransformerConfig(input_dim=6, num_labels=4, num_blocks=1, d_model=8, num_heads=2, ffn_dim=8,
                                        left_context=4, right_context=0, causal_conv=True, subsample=2))
    with pytest.raises(ValueError, match="per input frame"):
        OnlineRecurrentDecoder(sub, prior)

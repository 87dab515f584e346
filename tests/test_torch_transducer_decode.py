"""The port's transducer decoders against the JAX package's, on the CPU.

From JAX-initialised weights converted by ``convert.transducer_from_jax``
(the tiny models of tests/test_transducer_beam.py: a 1 x 8 LSTM encoder, a
1 x 6 LSTM prediction network, joint 6, 4 labels + the blank; and a 2-block
causal conformer-s2 encoder):

- ``LSTM.apply_stream`` / ``GRU.apply_stream`` fed one frame at a time
  equal the full-sequence forward (f32 within 1e-6 of max|ref|), and one
  chunk equals JAX's ``apply_stream``;
- greedy: ids and frames identical to ``TransducerDecoder``'s, the
  confidences within CONF_TOL (1e-5);
- beam: n-best ids identical to ``TransducerBeamDecoder``'s and the scores
  within SCORE_TOL (1e-4) absolute, for seeds 0-2; beam 1 equals greedy;
  n-best sorted and unique; ``decode_batch_aligned``; ``decode_to_file``;
- the LM-fused beam (a trigram ``DenseFusionTable`` over the 4 labels, the
  same ARPA file on both sides): n-best ids identical to JAX's fused
  ``TransducerBeamDecoder`` and scores within SCORE_TOL, the best
  hypothesis' frames and acoustic (pre-fusion) posteriors as JAX's; a
  zero-weight table (``lm_alpha 0``, ``lm_beta 0``) gives the unfused
  n-best exactly;
- end to end: ``cli.main --steps dnn_train_features,dnn_test_features,
  train_nnet,test_nnet --device cpu`` on config_AURORA4_transducer.cfg's
  ``[nnet]`` at tiny width writes ``decode/text`` and logs the CER.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfkaldi_tpu.decode.lm import ArpaLM as JaxArpaLM
from tfkaldi_tpu.decode.lm import DenseFusionTable as JaxDenseFusionTable
from tfkaldi_tpu.decode.transducer import TransducerDecoder as JaxTransducerDecoder
from tfkaldi_tpu.decode.transducer_beam import TransducerBeamDecoder as JaxTransducerBeamDecoder
from tfkaldi_tpu.models.rnn import GRU as JaxGRU
from tfkaldi_tpu.models.rnn import LSTM as JaxLSTM
from tfkaldi_tpu.models.rnn import RNNConfig as JaxRNNConfig
from tfkaldi_tpu.models.transducer import Transducer as JaxTransducer
from tfkaldi_tpu.models.transducer import TransducerConfig as JaxTransducerConfig
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.convert import rnn_from_jax, transducer_from_jax
from tfkaldi_tpu_torch.data.target_coder import TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
from tfkaldi_tpu_torch.decode import transducer as transducer_decode
from tfkaldi_tpu_torch.decode.lm import ArpaLM, DenseFusionTable
from tfkaldi_tpu_torch.decode.transducer import TransducerDecoder
from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
from tfkaldi_tpu_torch.models import GRU, LSTM, RNNConfig, Transducer, TransducerConfig

CONF_TOL = 1e-5
SCORE_TOL = 1e-4
CONFORMER = (("num_blocks", "2"), ("d_model", "16"), ("num_heads", "2"), ("ffn_dim", "16"), ("conv_kernel", "3"),
             ("subsample", "2"), ("attention_left_context", "4"), ("attention_right_context", "0"),
             ("causal_conv", "True"))


class _IdCoder:
    def decode(self, ids):
        return " ".join(str(i) for i in np.asarray(ids))


def tiny(seed=0, enc="lstm"):
    """The JAX model and its weights, and the port's model on them."""
    kw = dict(input_dim=5, num_labels=4, enc_layers=1, enc_units=8, pred_layers=1, pred_units=6, embed_dim=4,
              joint_units=6)
    if enc == "conformer":
        kw.update(enc_type="conformer", enc_extra=CONFORMER)
    jm = JaxTransducer(JaxTransducerConfig(**kw))
    params, state = jm.init(jax.random.PRNGKey(seed))
    model = Transducer(TransducerConfig(**kw))
    model.load_state_dict(transducer_from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)))
    return jm, params, state, model


def random_batch(rng, b=3, t=9, f=5):
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    lens = rng.integers(max(2, t - 4), t + 1, (b,)).astype(np.int32)
    lens[0] = t
    return x, lens


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_apply_stream_equals_full_forward(cell):
    """One frame at a time, the carry threaded through, a ragged batch:
    the outputs at real frames equal the full-sequence forward's, the
    final carry is each row's last real state; one 6-frame chunk equals
    JAX's ``apply_stream``."""
    jcls, cls = (JaxLSTM, LSTM) if cell == "lstm" else (JaxGRU, GRU)
    jm = jcls(JaxRNNConfig(input_dim=5, num_labels=3, num_layers=2, hidden_units=7))
    params, _ = jm.init(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    params["out"]["w"] = np.random.default_rng(4).standard_normal(params["out"]["w"].shape).astype(np.float32)
    model = cls(RNNConfig(input_dim=5, num_labels=3, num_layers=2, hidden_units=7, cell=cell))
    model.load_state_dict(rnn_from_jax(params))
    rng = np.random.default_rng(5)
    x, lens = random_batch(rng, b=3, t=8)
    xt, lt = torch.from_numpy(x), torch.from_numpy(lens)
    with torch.no_grad():
        full = model(xt, lt)
        carry, outs = model.init_stream_carry(3), []
        for t in range(8):
            y, carry = model.apply_stream(xt[:, t: t + 1], (lt > t).int(), carry)
            outs.append(y)
        stepped = torch.cat(outs, dim=1)
        chunk, _ = model.apply_stream(xt[:, :6], lt.clamp(max=6), model.init_stream_carry(3))
    for i, n in enumerate(lens):
        np.testing.assert_allclose(stepped[i, :n].numpy(), full[i, :n].numpy(), atol=1e-6 * full.abs().max().item())
    want, _ = jm.apply_stream(jax.tree.map(jnp.asarray, params), {}, jnp.asarray(x[:, :6]),
                              jnp.asarray(np.minimum(lens, 6)), jm.init_stream_carry(3))
    np.testing.assert_allclose(chunk.numpy(), np.asarray(want), atol=1e-5 * np.abs(np.asarray(want)).max())
    with pytest.raises(ValueError, match="unidirectional"):
        cls(RNNConfig(input_dim=5, num_labels=3, bidirectional=True, cell=cell)).init_stream_carry(2)


@pytest.mark.parametrize("seed,enc", [(0, "lstm"), (1, "lstm"), (2, "conformer")])
def test_greedy_matches_jax(seed, enc):
    jm, params, state, model = tiny(seed, enc)
    x, lens = random_batch(np.random.default_rng(seed + 10), b=3, t=14)
    jdec = JaxTransducerDecoder(jm, params, state, _IdCoder(), max_symbols_per_frame=3)
    want = jdec.decode_batch(x, lens)
    dec = TransducerDecoder(model, _IdCoder(), max_symbols_per_frame=3)
    got = dec.decode_batch(x, lens)
    assert sum(len(w) for w in want) > 3  # the search emits labels
    for g, w, gf, wf, gc, wc in zip(got, want, dec.last_label_frames, jdec.last_label_frames,
                                    dec.last_label_confs, jdec.last_label_confs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_allclose(gc, wc, atol=CONF_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_beam_nbest_matches_jax(seed):
    """Beam 3, two expansions a frame (ties among retired beams broken
    toward the lower index, as ``lax.top_k``)."""
    jm, params, state, model = tiny(seed)
    x, lens = random_batch(np.random.default_rng(seed + 10), b=2, t=7)
    want = JaxTransducerBeamDecoder(jm, params, state, _IdCoder(), beam_width=3,
                                    max_symbols_per_frame=2).decode_batch_nbest(x, lens)
    got = TransducerBeamDecoder(model, _IdCoder(), beam_width=3, max_symbols_per_frame=2).decode_batch_nbest(x, lens)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for (g_ids, g_score), (w_ids, w_score) in zip(g_row, w_row):
            np.testing.assert_array_equal(g_ids, w_ids)
            assert abs(g_score - w_score) <= SCORE_TOL, (g_score, w_score)


def test_beam_conformer_aligned_matches_jax():
    """Beam 4 over the subsampled conformer encoder: the best hypothesis'
    ids and frames identical, its posteriors within CONF_TOL."""
    jm, params, state, model = tiny(4, "conformer")
    x, lens = random_batch(np.random.default_rng(14), b=2, t=12)
    want = JaxTransducerBeamDecoder(jm, params, state, _IdCoder(), beam_width=4).decode_batch_aligned(x, lens)
    got = TransducerBeamDecoder(model, _IdCoder(), beam_width=4).decode_batch_aligned(x, lens)
    for (gi, gf, gc), (wi, wf, wc) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_allclose(gc, wc, atol=CONF_TOL)


def test_beam1_equals_greedy_and_nbest_sorted_unique():
    _, _, _, model = tiny(5)
    x, lens = random_batch(np.random.default_rng(6), b=3, t=10)
    greedy = TransducerDecoder(model, _IdCoder()).decode_batch(x, lens)
    beam1 = TransducerBeamDecoder(model, _IdCoder(), beam_width=1).decode_batch(x, lens)
    for g, b in zip(greedy, beam1):
        np.testing.assert_array_equal(g, b)
    for row in TransducerBeamDecoder(model, _IdCoder(), beam_width=4).decode_batch_nbest(x, lens):
        scores = [s for _, s in row]
        assert scores == sorted(scores, reverse=True)
        seqs = [tuple(ids.tolist()) for ids, _ in row]
        assert len(seqs) == len(set(seqs)), "the merge left duplicate prefixes"


def test_decode_to_file(tmp_path, monkeypatch):
    """One line per utterance, in order, greedy and beam."""
    _, _, _, model = tiny(9)
    rng = np.random.default_rng(10)
    feats = {u: rng.standard_normal((n, 5)).astype(np.float32) for u, n in (("utt1", 6), ("utt2", 9))}

    def fake_stream(reader, batch_size, bucket_multiple):
        padded = np.zeros((2, 9, 5), np.float32)
        for i, f in enumerate(feats.values()):
            padded[i, : f.shape[0]] = f
        yield list(feats), padded, np.array([6, 9], np.int32)

    monkeypatch.setattr(transducer_decode, "pick_stream", lambda reader: fake_stream)
    for dec in (TransducerDecoder(model, _IdCoder()), TransducerBeamDecoder(model, _IdCoder(), beam_width=2)):
        out = tmp_path / "text"
        assert dec.decode_to_file(None, str(out)) == 2
        lines = out.read_text().splitlines()
        assert [line.split()[0] for line in lines] == ["utt1", "utt2"]


TOKENS = ["a", "b", "c", "d"]  # the 4 labels as LM tokens
TRIGRAM_ARPA = ("\\data\\\nngram 1=5\nngram 2=4\nngram 3=2\n\n\\1-grams:\n-0.6\ta\t-0.3\n-0.7\tb\t-0.2\n"
                "-0.9\tc\n-1.1\td\n-99\t<s>\t-0.3\n\n\\2-grams:\n-0.2\ta b\t-0.1\n-0.9\tb a\n-0.3\t<s> a\t-0.1\n"
                "-0.6\t<s> c\n\n\\3-grams:\n-0.25\t<s> a b\n-0.45\ta b a\n\n\\end\\\n")


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "tri.arpa"
    path.write_text(TRIGRAM_ARPA)
    return str(path)


@pytest.mark.parametrize("seed,enc", [(0, "lstm"), (1, "lstm"), (2, "conformer")])
def test_fused_beam_matches_jax(seed, enc, arpa):
    """Beam 3, two expansions a frame, the trigram fused at alpha 0.8, beta
    0.3: the n-best, and the best hypothesis' frames and posteriors (the
    acoustic ones, before fusion) as JAX's."""
    jm, params, state, model = tiny(seed, enc)
    x, lens = random_batch(np.random.default_rng(seed + 20), b=2, t=10)
    jtable = JaxDenseFusionTable(JaxArpaLM.load(arpa), TOKENS, TOKENS, alpha=0.8, beta=0.3)
    table = DenseFusionTable(ArpaLM.load(arpa), TOKENS, TOKENS, alpha=0.8, beta=0.3)
    jdec = JaxTransducerBeamDecoder(jm, params, state, _IdCoder(), beam_width=3, max_symbols_per_frame=2,
                                    fusion_table=jtable)
    dec = TransducerBeamDecoder(model, _IdCoder(), beam_width=3, max_symbols_per_frame=2, fusion_table=table)
    want, got = jdec.decode_batch_nbest(x, lens), dec.decode_batch_nbest(x, lens)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for (g_ids, g_score), (w_ids, w_score) in zip(g_row, w_row):
            np.testing.assert_array_equal(g_ids, w_ids)
            assert abs(g_score - w_score) <= SCORE_TOL, (g_score, w_score)
    assert sum(len(ids) for row in got for ids, _ in row) > 0
    for (gi, gf, gc), (wi, wf, wc) in zip(dec.decode_batch_aligned(x, lens), jdec.decode_batch_aligned(x, lens)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_allclose(gc, wc, atol=CONF_TOL)


def test_zero_weight_fusion_equals_unfused(arpa):
    _, _, _, model = tiny(3)
    x, lens = random_batch(np.random.default_rng(23), b=3, t=10)
    zero = DenseFusionTable(ArpaLM.load(arpa), TOKENS, TOKENS, alpha=0.0, beta=0.0)
    assert not zero.table.any()
    base = TransducerBeamDecoder(model, _IdCoder(), beam_width=4).decode_batch_nbest(x, lens)
    fused = TransducerBeamDecoder(model, _IdCoder(), beam_width=4, fusion_table=zero).decode_batch_nbest(x, lens)
    for a, b in zip(base, fused):
        assert [(ids.tolist(), score) for ids, score in a] == [(ids.tolist(), score) for ids, score in b]


# ---------------------------------------------------------------------------
# the CLI on a tiny workspace
# ---------------------------------------------------------------------------

STEPS = "dnn_train_features,dnn_test_features,train_nnet,test_nnet"
TINY_NNET = {"num_blocks": 2, "d_model": 16, "ffn_dim": 16, "conv_kernel": 3, "pred_units": 8, "embed_dim": 4,
             "joint_units": 8, "batch_size": 4, "valid_batches": 1, "num_epochs": 2, "valid_frequency": 2,
             "check_freq": 2, "beam_width": 2}


@pytest.fixture(scope="module")
def transducer_workspace(tmp_path_factory):
    """config_AURORA4_transducer.cfg's [nnet] as written
    (synthetic.transducer_nnet) at tiny widths, batch 4, beam 2, on a tiny
    workspace with transcripts of at most an eighth of the frames, trained
    and decoded through the CLI on the CPU."""
    root = str(tmp_path_factory.mktemp("transducer"))
    ws = synthetic.make_train_workspace(root, num_pdfs=20, hidden_units=16, hidden_layers=2, num_train=16,
                                        num_test=4, min_seconds=0.5, max_seconds=1.5, text_density=8,
                                        nnet={**synthetic.transducer_nnet(), **TINY_NNET})
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


def test_cli_trains_and_decodes_transducer_text(transducer_workspace):
    ws, messages = transducer_workspace
    savedir = ws["savedir"]
    assert os.path.basename(savedir) == "transducer_conformer_s4"
    state = torch.load(os.path.join(savedir, "final.pt"), weights_only=True)
    assert state["joint.w"].shape == (8, 36) and state["embed"].shape == (36, 4)  # 35 characters + the blank
    assert state["enc.in_proj.w"].shape == (4 * 40, 16)  # 4 stacked frames of 40 fbanks
    assert state["pred.layers.0.0.wh"].shape == (8, 32)
    decoded = open(os.path.join(savedir, "decode", "text")).read().splitlines()
    test_utts = [line.split()[0] for line in open(os.path.join(ws["test_featdir"], "text"))]
    assert [line.split()[0] for line in decoded] == test_utts
    alphabet = set(TextCoder(aurora4_normalizer).alphabet)
    assert all(set(line.split()[1:]) <= alphabet for line in decoded)
    assert any(m.startswith("transducer CER: %WER") for m in messages)
    assert any(m.startswith("transducer WER: %WER") for m in messages)
    assert any(m.startswith("checkpoint averaging") for m in messages)  # average_last = 5
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    assert len(steps) == 8 and all(np.isfinite(s["loss"]) for s in steps)

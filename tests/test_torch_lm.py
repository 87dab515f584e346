"""The port's ARPA LM and shallow fusion against the JAX package, on the CPU.

- ``ArpaLM``: direct hits, backoff, ``<unk>``, context truncation, ``.gz``
  round trip and malformed files, against ``tfkaldi_tpu.decode.lm.ArpaLM``
  on the same files (tests/test_lm.py's bigram and trigram);
- ``FusionScorer`` values against JAX's, with and without BOS;
- ``DenseFusionTable`` bit-equal to JAX's for the bigram and the trigram, and
  ``lm_extension_scores`` on tensors equal to JAX's gather exactly;
- ``fusion_from_config`` and ``ctc_scorer_from_config``;
- the fused CTC Python beam: ids, label frames and posteriors equal to
  ``tfkaldi_tpu.decode.ctc_beam.ctc_beam_search_py`` with the same scorer,
  and a strongly biased LM flips an acoustically ambiguous outcome;
- ``CTCDecoder(fusion_scorer=...)`` takes the fused route (counted in
  ``beam_runs["fused"]``, never the native beam), and ``Nnet.decode_text``
  with ``lm_path`` writes the JAX fused ``CTCDecoder``'s ``text``;
- ``synthetic.write_char_arpa``: a normalised character trigram over the
  coder's whole alphabet that both packages' ``ArpaLM`` read alike.
"""

import gzip
import math
import os
from configparser import ConfigParser
from itertools import product

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.synthetic import make_featdir
from tfkaldi_tpu.data.feature_reader import FeatureReader as JaxFeatureReader
from tfkaldi_tpu.data.target_coder import TextCoder as JaxTextCoder
from tfkaldi_tpu.data.target_normalizers import aurora4_normalizer as jax_aurora4_normalizer
from tfkaldi_tpu.decode import ctc as jax_ctc
from tfkaldi_tpu.decode import lm as jax_lm
from tfkaldi_tpu.decode.ctc_beam import ctc_beam_search_py as jax_beam_py
from tfkaldi_tpu.models import LSTM as JaxLSTM
from tfkaldi_tpu.models import RNNConfig as JaxRNNConfig
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.convert import rnn_from_jax, save_checkpoint
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.data.target_coder import TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
from tfkaldi_tpu_torch.decode import ctc, lm, native_beam
from tfkaldi_tpu_torch.decode.ctc_beam import ctc_beam_search_py
from tfkaldi_tpu_torch.models import LSTM, RNNConfig
from tfkaldi_tpu_torch.nnet import Nnet

LN10 = math.log(10.0)

BIGRAM_ARPA = """\\data\\
ngram 1=4
ngram 2=3

\\1-grams:
-0.5\ta\t-0.30103
-0.7\tb\t-0.30103
-1.0\t<s>\t-0.30103
-0.9\t<unk>

\\2-grams:
-0.2\ta b
-0.9\tb a
-0.3\t<s> a

\\end\\
"""

TRIGRAM_ARPA = """\\data\\
ngram 1=4
ngram 2=4
ngram 3=2

\\1-grams:
-0.5\ta\t-0.30103
-0.7\tb\t-0.2
-1.0\t<s>\t-0.30103
-0.9\t<unk>

\\2-grams:
-0.2\ta b\t-0.1
-0.9\tb a\t-0.15
-0.3\t<s> a\t-0.1
-0.6\t<s> b

\\3-grams:
-0.25\t<s> a b
-0.45\ta b a

\\end\\
"""


@pytest.fixture
def paths(tmp_path):
    out = {}
    for name, text in (("bigram", BIGRAM_ARPA), ("trigram", TRIGRAM_ARPA)):
        out[name] = str(tmp_path / f"{name}.arpa")
        with open(out[name], "w") as f:
            f.write(text)
        out[f"{name}.gz"] = str(tmp_path / f"{name}.arpa.gz")
        with gzip.open(out[f"{name}.gz"], "wt") as f:
            f.write(text)
    return out


@pytest.mark.parametrize("name", ["bigram", "trigram", "bigram.gz", "trigram.gz"])
def test_arpa_scores_match_jax(paths, name):
    mine, theirs = lm.ArpaLM.load(paths[name]), jax_lm.ArpaLM.load(paths[name])
    assert mine.order == theirs.order == (2 if name.startswith("bigram") else 3)
    words = ["a", "b", "<s>", "<unk>", "zzz"]
    for n in range(4):
        for context in product(words, repeat=n):
            for word in words[:2] + ["zzz"]:
                assert mine.score(context, word) == theirs.score(context, word), (context, word)


def test_arpa_backoff_unk_and_truncation(paths):
    bigram = lm.ArpaLM.load(paths["bigram"])
    np.testing.assert_allclose(bigram.score(("a",), "b"), -0.2 * LN10)
    np.testing.assert_allclose(bigram.score(("b",), "b"), (-0.30103 - 0.7) * LN10)  # backoff(b) + P1(b)
    np.testing.assert_allclose(bigram.score(("zzz",), "a"), -0.5 * LN10)  # unlisted context: no penalty
    np.testing.assert_allclose(bigram.score((), "zzz"), -0.9 * LN10)  # unknown word: <unk>
    np.testing.assert_allclose(bigram.score(("x", "y", "a"), "b"), -0.2 * LN10)  # order-1 words of context
    no_unk = lm.ArpaLM(1, {("a",): -1.0}, {})
    assert no_unk.score((), "q") == -20.0 * LN10


def test_arpa_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.arpa"
    bad.write_text("\\1-grams:\n-0.5\n\\end\\\n")
    with pytest.raises(ValueError, match="malformed"):
        lm.ArpaLM.load(str(bad))
    empty = tmp_path / "empty.arpa"
    empty.write_text("hello\n")
    with pytest.raises(ValueError, match="no n-gram"):
        lm.ArpaLM.load(str(empty))


@pytest.mark.parametrize("bos", ["<s>", None])
@pytest.mark.parametrize("name", ["bigram", "trigram"])
def test_fusion_scorer_matches_jax(paths, name, bos):
    tokens = ["a", "b", "<blank>"]
    mine = lm.FusionScorer(lm.ArpaLM.load(paths[name]), tokens, alpha=0.8, beta=0.25, bos=bos)
    theirs = jax_lm.FusionScorer(jax_lm.ArpaLM.load(paths[name]), tokens, alpha=0.8, beta=0.25, bos=bos)
    for n in range(4):
        for prefix in product(range(2), repeat=n):
            for v in range(2):
                assert mine(prefix, v) == theirs(prefix, v) == mine(prefix, v)  # the cache returns the same
    np.testing.assert_allclose(lm.FusionScorer(lm.ArpaLM.load(paths["bigram"]), ["a", "b"], alpha=2.0,
                                               beta=0.25)((), 0), 2.0 * (-0.3 * LN10) + 0.25)


@pytest.mark.parametrize("columns", ["labels", "labels+eos"])
@pytest.mark.parametrize("name", ["bigram", "trigram"])
def test_dense_table_bit_equal_to_jax(paths, name, columns):
    tokens = ["a", "b"]
    cols = tokens + (["</s>"] if columns == "labels+eos" else [])
    mine = lm.DenseFusionTable(lm.ArpaLM.load(paths[name]), tokens, cols, alpha=0.4, beta=0.15)
    theirs = jax_lm.DenseFusionTable(jax_lm.ArpaLM.load(paths[name]), tokens, cols, alpha=0.4, beta=0.15)
    assert mine.table.dtype == np.float32 and mine.table.shape == theirs.table.shape
    assert mine.table.tobytes() == theirs.table.tobytes()
    assert (mine.order, mine.num_context_ids, mine.bos_id) == (theirs.order, theirs.num_context_ids, theirs.bos_id)
    # the table equals the host scorer on every prefix (short ones BOS-filled)
    scorer = lm.FusionScorer(lm.ArpaLM.load(paths[name]), tokens, alpha=0.4, beta=0.15)
    n_ctx = mine.order - 1
    for plen in range(4):
        for prefix in product(range(2), repeat=plen):
            last = [mine.bos_id] * max(n_ctx - plen, 0) + list(prefix[-n_ctx:])
            row = int(mine.flat_context(np.asarray(last)[None, :])[0])
            for v in range(2):
                np.testing.assert_allclose(mine.table[row, v], scorer(prefix, v), rtol=1e-6, atol=1e-7)


def test_dense_table_rejects_explosive_orders():
    big = lm.ArpaLM(order=8, ngrams={("a",): -1.0}, backoffs={})
    with pytest.raises(ValueError, match="dense fusion table"):
        lm.DenseFusionTable(big, [str(i) for i in range(40)], [str(i) for i in range(40)])


@pytest.mark.parametrize("name", ["bigram", "trigram"])
def test_lm_extension_scores_match_jax(paths, name):
    table = lm.DenseFusionTable(lm.ArpaLM.load(paths[name]), ["a", "b"], ["a", "b"], alpha=1.0, beta=0.3)
    rng = np.random.default_rng(0)
    buf = rng.integers(0, 2, (3, 2, 6))
    counts = np.asarray([[0, 1], [2, 6], [3, 5]])
    want = np.asarray(jax_lm.lm_extension_scores(table, jnp.asarray(table.table), jnp.asarray(buf, jnp.int32),
                                                 jnp.asarray(counts, jnp.int32)))
    got = lm.lm_extension_scores(table, torch.from_numpy(table.table), torch.from_numpy(buf), torch.from_numpy(counts))
    assert got.shape == (3, 2, 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fusion_from_config(paths):
    coder = TextCoder(aurora4_normalizer)
    cols = list(coder.alphabet)
    assert lm.fusion_from_config({"beam_width": "4"}, coder, cols) is None
    with pytest.raises(ValueError, match="needs beam_width > 1"):
        lm.fusion_from_config({"lm_path": paths["bigram"]}, coder, cols)
    got = lm.fusion_from_config({"lm_path": paths["trigram"], "beam_width": "4", "lm_alpha": "0.3", "lm_beta": "0.1"},
                                coder, cols)
    want = jax_lm.fusion_from_config({"lm_path": paths["trigram"], "beam_width": "4", "lm_alpha": "0.3",
                                      "lm_beta": "0.1"}, JaxTextCoder(jax_aurora4_normalizer), cols)
    assert got.table.tobytes() == want.table.tobytes()
    # a beam width given by the caller (the streaming server's --beam-width) stands for [nnet] beam_width
    conf = {"lm_path": paths["trigram"], "lm_alpha": "0.3", "lm_beta": "0.1"}
    assert lm.fusion_from_config(conf, coder, cols, beam_width=4).table.tobytes() == want.table.tobytes()
    with pytest.raises(ValueError, match="needs beam_width > 1"):
        lm.fusion_from_config({**conf, "beam_width": "4"}, coder, cols, beam_width=1)


def test_ctc_scorer_from_config(paths):
    """The CTC beam's scorer from the same keys: over the alphabet and the
    blank, with ``lm_alpha`` and ``lm_beta``, and the same refusals."""
    coder = TextCoder(aurora4_normalizer)
    assert lm.ctc_scorer_from_config({"beam_width": "4"}, coder) is None
    with pytest.raises(ValueError, match="needs beam_width > 1"):
        lm.ctc_scorer_from_config({"lm_path": paths["trigram"]}, coder)
    conf = {"lm_path": paths["trigram"], "lm_alpha": "0.3", "lm_beta": "0.1"}
    got = lm.ctc_scorer_from_config(conf, coder, beam_width=4)
    want = lm.FusionScorer(lm.ArpaLM.load(paths["trigram"]), list(coder.alphabet) + ["<blank>"], alpha=0.3, beta=0.1)
    assert got.id_to_token == want.id_to_token and (got.alpha, got.beta) == (0.3, 0.1)
    for prefix in [(), (0,), (3, 1), (5, 2, 7)]:
        for v in range(coder.num_labels):
            assert got(prefix, v) == want(prefix, v)


def _log_probs(rng, t_len, v):
    logits = rng.standard_normal((t_len, v)) * 2
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("beam", [2, 4, 16])
@pytest.mark.parametrize("name", ["bigram", "trigram"])
def test_fused_python_beam_matches_jax(paths, name, beam):
    """Ids, label frames and posteriors of the fused beam equal JAX's."""
    rng = np.random.default_rng(beam)
    tokens = ["a", "b", "zzz", "<blank>"]  # one label the LM never saw
    for _ in range(5):
        log_probs = _log_probs(rng, int(rng.integers(5, 40)), 4)
        mine = lm.FusionScorer(lm.ArpaLM.load(paths[name]), tokens, alpha=0.9, beta=0.3)
        theirs = jax_lm.FusionScorer(jax_lm.ArpaLM.load(paths[name]), tokens, alpha=0.9, beta=0.3)
        want = jax_beam_py(log_probs, 3, beam, scorer=theirs, return_alignment=True)
        got = ctc_beam_search_py(log_probs, 3, beam, scorer=mine, return_alignment=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_fusion_changes_beam_outcome(tmp_path):
    """Acoustics alone pick label a; a strongly b-favouring LM flips the fused
    search to b (tests/test_lm.py:104-129)."""
    path = tmp_path / "uni.arpa"
    path.write_text("\\data\\\nngram 1=3\n\n\\1-grams:\n-3.0\ta\n-0.05\tb\n-2.0\t<s>\n\n\\end\\\n")
    lp = np.full((4, 3), -10.0)
    lp[:, 2], lp[:, 0], lp[:, 1] = -0.7, -1.2, -1.4
    lp = lp - np.log(np.exp(lp).sum(axis=1, keepdims=True))
    assert ctc_beam_search_py(lp, 2, beam_width=4).tolist() == [0]
    scorer = lm.FusionScorer(lm.ArpaLM.load(str(path)), ["a", "b", "<blank>"], alpha=1.0)
    assert ctc_beam_search_py(lp, 2, beam_width=4, scorer=scorer).tolist() == [1]


def test_ctc_decoder_fused_route(paths, monkeypatch):
    """With a scorer the decoder runs the Python beam (counted as ``fused``),
    never the native acoustic-only beam, and keeps the backtrace."""
    def boom(*args, **kwargs):
        raise AssertionError("the native beam must not run under fusion")

    monkeypatch.setattr(native_beam, "available", lambda: True)
    monkeypatch.setattr(native_beam, "ctc_beam_search_batch_native", boom)
    model = LSTM(RNNConfig(input_dim=4, num_labels=3, num_layers=1, hidden_units=8, bidirectional=False))
    scorer = lm.FusionScorer(lm.ArpaLM.load(paths["bigram"]), ["a", "b", "<blank>"], alpha=0.5)
    dec = ctc.CTCDecoder(model, None, 2, beam_width=4, fusion_scorer=scorer)
    ctc.beam_runs.update(native=0, python=0, fused=0)
    x = np.random.default_rng(0).standard_normal((2, 8, 4)).astype(np.float32)
    out = dec.decode_batch(x, np.asarray([8, 5], np.int32))
    assert len(out) == 2 and all(isinstance(o, np.ndarray) for o in out)
    assert ctc.beam_runs == {"native": 0, "python": 0, "fused": 1}
    assert [len(f) for f in dec.last_label_frames] == [len(o) for o in out]


# ---------------------------------------------------------------------------
# Nnet.decode_text with lm_path against the JAX fused CTCDecoder
# ---------------------------------------------------------------------------

FEAT_DIM, CONTEXT, HID = 8, 1, 16
NUM_LABELS = 35


def test_decode_text_with_lm_matches_jax(tmp_path):
    """A BiLSTM CTC model at beam 4 fused with a character trigram written by
    ``synthetic.write_char_arpa``: the port's ``text`` equals the JAX
    ``CTCDecoder``'s with the same ``FusionScorer`` settings, and differs
    from the unfused decode's somewhere (the LM is not inert)."""
    featdir, _, _ = make_featdir(tmp_path, num_speakers=2, utts_per_speaker=4, feat_dim=FEAT_DIM)
    params = synthetic.random_rnn_pytree(FEAT_DIM * (2 * CONTEXT + 1), HID, 2, NUM_LABELS + 1, gates=4, seed=3)
    params["out"]["w"] *= 3.0
    rng = np.random.default_rng(5)
    text = tmp_path / "train_text"
    text.write_text("".join(f"u{i} {synthetic.transcript(rng, 300)}\n" for i in range(40)))
    arpa = str(tmp_path / "char3.arpa")
    synthetic.write_char_arpa(arpa, [str(text)])
    args = (os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"), os.path.join(featdir, "utt2spk"),
            CONTEXT, 0)
    outs = {}
    for lm_path in ("", arpa):
        cfg = ConfigParser()
        cfg["directories"] = {"expdir": str(tmp_path / "exp")}
        cfg["nnet"] = {"name": "ctc", "loss": "ctc", "model": "lstm", "bidirectional": "True",
                       "num_hidden_units": str(HID), "num_hidden_layers": "2", "context_width": str(CONTEXT),
                       "beam_width": "4", "lm_path": lm_path, "lm_alpha": "1.5", "lm_beta": "0.5"}
        nnet = Nnet(cfg, FEAT_DIM, NUM_LABELS, device="cpu")
        save_checkpoint(nnet.savedir, rnn_from_jax(params))
        outs[lm_path] = str(tmp_path / f"port{bool(lm_path)}.txt")
        ctc.beam_runs.update(native=0, python=0, fused=0)
        reader = FeatureReader(*args)
        assert nnet.decode_text(reader, TextCoder(aurora4_normalizer), outs[lm_path]) == 8
        reader.close()
        assert ctc.beam_runs["fused"] == (1 if lm_path else 0)
    jcfg = JaxRNNConfig(input_dim=FEAT_DIM * (2 * CONTEXT + 1), num_labels=NUM_LABELS + 1, num_layers=2,
                        hidden_units=HID, bidirectional=True, compute_dtype=jnp.dtype("float32"), scan_unroll=1)
    coder = JaxTextCoder(jax_aurora4_normalizer)
    scorer = jax_lm.FusionScorer(jax_lm.ArpaLM.load(arpa), list(coder.alphabet) + ["<blank>"], alpha=1.5, beta=0.5)
    jdec = jax_ctc.CTCDecoder(JaxLSTM(jcfg), jax.tree.map(jnp.asarray, params), {}, coder, NUM_LABELS, beam_width=4,
                              fusion_scorer=scorer)
    want = str(tmp_path / "jax.txt")
    assert jdec.decode_to_file(JaxFeatureReader(*args), want) == 8
    assert open(outs[arpa]).read() == open(want).read()
    assert open(outs[arpa]).read() != open(outs[""]).read()


def test_write_char_arpa(tmp_path):
    """The writer covers the coder's alphabet and ``</s>``, each history's
    distribution sums to 1, and both packages read it alike."""
    rng = np.random.default_rng(1)
    text = tmp_path / "text"
    text.write_text("".join(f"u{i} {synthetic.transcript(rng, 400)}\n" for i in range(30)))
    path = str(tmp_path / "lm.arpa.gz")
    count = synthetic.write_char_arpa(path, [str(text)])
    mine, theirs = lm.ArpaLM.load(path), jax_lm.ArpaLM.load(path)
    assert mine.order == 3 and count == len(mine._ngrams)
    coder = TextCoder(aurora4_normalizer)
    vocab = list(coder.alphabet) + ["</s>"]
    assert all((w,) in mine._ngrams for w in vocab)
    for context in [(), ("<s>",), ("<s>", "t"), ("t", "h"), ("q", "<space>"), ("zzz", "a")]:
        assert abs(sum(math.exp(mine.score(context, w)) for w in vocab) - 1.0) < 1e-5, context
        assert all(mine.score(context, w) == theirs.score(context, w) for w in vocab)

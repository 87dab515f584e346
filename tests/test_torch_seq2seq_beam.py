"""The port's autoregressive attention beam against the JAX package, on the CPU.

At the tiny widths of tests/test_seq2seq.py (the helpers of
tests/test_torch_seq2seq.py: a 2-block conformer or one 8-unit recurrent
encoder, a 2-block decoder of width 12, 4 labels + SOS/EOS), from
JAX-initialised weights with non-zero heads carried over by
``convert.seq2seq_from_jax``, in f32:

- ``decode_step_cached`` position by position against JAX's and against the
  port's own teacher-forced grid, within 1e-5 of max|ref|
  (tests/test_seq2seq.py:375-418), with ``embed_dim != d_model`` too;
- ``Seq2SeqBeamDecoder.decode_batch_nbest``: every surviving hypothesis'
  ids identical to JAX's and its score within 1e-5 relative, for beam 1, 2
  and 4, with and without the GNMT ``length_penalty``, unfused and fused
  with a trigram ``DenseFusionTable`` (the same ARPA LM on both sides); the
  ``gru`` and the subsampled ``conformer`` encoders;
- the zero-fusion identity, the EOS-hungry LM and the table-width check of
  tests/test_seq2seq.py:329-372 on the port;
- beam 1 equals a greedy walk of the cached step; the ``seconds`` split and
  the step count; ``decode_to_file``;
- ``Nnet.load_text_decoder``'s rules for ``decode_mode = beam``.
"""

from configparser import ConfigParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_seq2seq import ENCODERS, _jax, _port, _synth, _weights
from tfkaldi_tpu.decode.lm import ArpaLM as JaxArpaLM
from tfkaldi_tpu.decode.lm import DenseFusionTable as JaxDenseFusionTable
from tfkaldi_tpu.decode.seq2seq import Seq2SeqBeamDecoder as JaxSeq2SeqBeamDecoder
from tfkaldi_tpu_torch.convert import save_checkpoint
from tfkaldi_tpu_torch.decode import seq2seq as seq2seq_decode
from tfkaldi_tpu_torch.decode.lm import ArpaLM, DenseFusionTable
from tfkaldi_tpu_torch.decode.seq2seq import CTCRescoreDecoder, Seq2SeqBeamDecoder
from tfkaldi_tpu_torch.nnet import Nnet

V = 4
TOL = 1e-5
_NEG = -1e30
TOKENS = ["a", "b", "c", "d"]  # the 4 labels as LM tokens; "</s>" is the EOS column

TRIGRAM_ARPA = """\\data\\
ngram 1=6
ngram 2=6
ngram 3=3

\\1-grams:
-0.6\ta\t-0.3
-0.7\tb\t-0.2
-0.9\tc\t-0.25
-1.1\td
-0.8\t</s>
-99\t<s>\t-0.3

\\2-grams:
-0.2\ta b\t-0.1
-0.9\tb a\t-0.15
-0.3\t<s> a\t-0.1
-0.6\t<s> c
-0.4\tc </s>
-0.5\tb </s>

\\3-grams:
-0.25\t<s> a b
-0.45\ta b a
-0.35\ta b </s>

\\end\\
"""


class _IdCoder:
    alphabet = TOKENS

    def decode(self, ids):
        return " ".join(str(i) for i in np.asarray(ids))


class _Fusion:
    """Hand-built fusion table over labels + EOS (the attention column
    layout), zeros by default (tests/test_seq2seq.py:316-326)."""

    def __init__(self, order=2):
        self.order = order
        self.num_context_ids = V + 1
        self.bos_id = V
        self.table = np.zeros(((V + 1) ** (order - 1), V + 1), np.float32)


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "tri.arpa"
    path.write_text(TRIGRAM_ARPA)
    return str(path)


def _models(enc="conformer", seed=0):
    over = {**ENCODERS[enc], "ctc_weight": 0.3}
    jm = _jax(**over)
    params, state = _weights(jm, seed)
    return jm, params, state, _port(params, state, **over)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("enc", ["conformer", "conformer_embed8", "lstm"])
def test_cached_step_matches_jax_and_grid(enc):
    """Each position's logits of the cached step equal JAX's cached step and
    the port's teacher-forced grid on the same prefixes and memory."""
    jm, params, state, model = _models(enc, seed=50)
    rng = np.random.default_rng(52)
    n, t, L = 3, 9, 5
    x = rng.standard_normal((n, t, 5)).astype(np.float32)
    xl = np.array([9, 6, 7], np.int32)
    tokens = np.concatenate([np.full((n, 1), V, np.int32), rng.integers(0, V, (n, L)).astype(np.int32)], axis=1)
    jp = _jnp(params)
    memory, _ = jm.encode(jp, _jnp(state), jnp.asarray(x), jnp.asarray(xl), train=False)
    jvalid = jnp.arange(memory.shape[1])[None, :] < jm.output_lengths(jnp.asarray(xl))[:, None]
    jk, jv = jm.cross_kv(jp, memory)
    jcache = jm.init_decode_cache(n, L)
    with torch.no_grad():
        mem = model.encode(torch.from_numpy(x), torch.from_numpy(xl))
        valid = model.memory_valid(mem, torch.from_numpy(xl))
        grid = model.decode_step_logits(torch.from_numpy(tokens), torch.ones(n, L + 1, dtype=torch.bool), mem, valid)
        ck, cv = model.cross_kv(mem)
        assert ck.shape == (2, n, mem.shape[1], 12) and ck.dtype == torch.float32
        np.testing.assert_allclose(ck.numpy(), np.asarray(jk), atol=TOL * float(np.abs(np.asarray(jk)).max()))
        cache = model.init_decode_cache(n, L)
        assert cache["k"].shape == (2, n, L + 1, 12)
        for s in range(L + 1):
            want, jcache = jm.decode_step_cached(jp, jnp.asarray(tokens[:, s]), jnp.asarray(s, jnp.int32), jcache,
                                                 jk, jv, jvalid)
            got, cache = model.decode_step_cached(torch.from_numpy(tokens[:, s]).long(), s, cache, ck, cv, valid)
            assert got.dtype == torch.float32
            assert _rel(got.numpy(), want) <= TOL, (s, _rel(got.numpy(), want))
            assert _rel(got.numpy(), grid[:, s].numpy()) <= TOL, (s, _rel(got.numpy(), grid[:, s].numpy()))
        np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), atol=1e-5)


def _compare_nbest(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row) > 0
        for (g_ids, g_score), (w_ids, w_score) in zip(g_row, w_row):
            np.testing.assert_array_equal(g_ids, w_ids)
            assert abs(g_score - w_score) <= TOL * max(abs(w_score), 1.0), (g_score, w_score)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
@pytest.mark.parametrize("beam", [1, 2, 4])
def test_beam_matches_jax(beam, length_penalty, fused, arpa):
    jm, params, state, model = _models(seed=beam)
    x, xl, _, _ = _synth(10 + beam, t=16)
    kw = dict(beam_width=beam, max_tokens=6, length_penalty=length_penalty)
    jtable = table = None
    if fused:
        jtable = JaxDenseFusionTable(JaxArpaLM.load(arpa), TOKENS, TOKENS + ["</s>"], alpha=0.7, beta=0.2)
        table = DenseFusionTable(ArpaLM.load(arpa), TOKENS, TOKENS + ["</s>"], alpha=0.7, beta=0.2)
    want = JaxSeq2SeqBeamDecoder(jm, _jnp(params), _jnp(state), _IdCoder(), fusion_table=jtable,
                                 **kw).decode_batch_nbest(x, xl)
    dec = Seq2SeqBeamDecoder(model, _IdCoder(), fusion_table=table, **kw)
    got = dec.decode_batch_nbest(x, xl)
    _compare_nbest(got, want)
    assert sum(len(ids) for row in got for ids, _ in row) > 0  # the search emits labels
    assert 1 <= dec.steps <= 6 and set(dec.seconds) == {"encoder", "steps", "close"}


@pytest.mark.parametrize("enc", ["gru", "conformer_s4"])
def test_encoder_families_match_jax(enc):
    jm, params, state, model = _models(enc, seed=11)
    x, xl, _, _ = _synth(12, t=20)
    want = JaxSeq2SeqBeamDecoder(jm, _jnp(params), _jnp(state), _IdCoder(), beam_width=3,
                                 max_tokens=5).decode_batch_nbest(x, xl)
    _compare_nbest(Seq2SeqBeamDecoder(model, _IdCoder(), beam_width=3, max_tokens=5).decode_batch_nbest(x, xl), want)


def test_zero_fusion_is_identity():
    _, _, _, model = _models(seed=40)
    x, xl, _, _ = _synth(41)
    base = Seq2SeqBeamDecoder(model, _IdCoder(), beam_width=3, max_tokens=5).decode_batch_nbest(x, xl)
    fused = Seq2SeqBeamDecoder(model, _IdCoder(), beam_width=3, max_tokens=5,
                               fusion_table=_Fusion()).decode_batch_nbest(x, xl)
    for a, b in zip(base, fused):
        assert len(a) == len(b)
        for (ai, asc), (bi, bsc) in zip(a, b):
            np.testing.assert_array_equal(ai, bi)
            assert asc == bsc


def test_eos_hungry_lm_empties_transcripts():
    """A table that rewards only </s> makes the empty hypothesis win at once."""
    _, _, _, model = _models(seed=42)
    x, xl, _, _ = _synth(43)
    f = _Fusion()
    f.table[:, :V] = -1e6  # labels despised
    f.table[:, V] = 10.0  # EOS adored
    for ids in Seq2SeqBeamDecoder(model, _IdCoder(), beam_width=3, max_tokens=5, fusion_table=f).decode_batch(x, xl):
        assert ids.size == 0


def test_fusion_table_width_checked():
    _, _, _, model = _models(seed=44)
    bad = _Fusion()
    bad.table = bad.table[:, :V]  # missing the EOS column
    with pytest.raises(ValueError, match="EOS"):
        Seq2SeqBeamDecoder(model, _IdCoder(), beam_width=2, fusion_table=bad)


def test_beam1_equals_greedy_walk():
    """Beam 1 gives the ids of a greedy walk of the same cached step (the
    argmax of the running score plus the step's log-softmax, the lower index
    on a tie; stop at EOS or at max_tokens labels)."""
    _, _, _, model = _models(seed=7)
    x, xl, _, _ = _synth(8, t=16)
    L = 8
    got = Seq2SeqBeamDecoder(model, _IdCoder(), beam_width=1, max_tokens=L).decode_batch(x, xl)
    with torch.no_grad():
        mem = model.encode(torch.from_numpy(x), torch.from_numpy(xl))
        valid = model.memory_valid(mem, torch.from_numpy(xl))
        ck, cv = model.cross_kv(mem)
        for row in range(len(xl)):
            cache, tok, ids, score = model.init_decode_cache(1, L), torch.tensor([V]), [], torch.zeros(1)
            for s in range(L):
                logits, cache = model.decode_step_cached(tok, s, cache, ck[:, row:row + 1], cv[:, row:row + 1],
                                                         valid[row:row + 1])
                total = score[:, None] + torch.log_softmax(logits, dim=-1)  # as the beam adds them
                tok = torch.argmax(total, dim=-1)
                score = total[:, int(tok)]
                if int(tok) == V:
                    break
                ids.append(int(tok))
            np.testing.assert_array_equal(got[row], ids)


def test_decode_to_file(tmp_path, monkeypatch):
    _, _, _, model = _models(seed=9)
    x, xl, _, _ = _synth(10)
    monkeypatch.setattr(seq2seq_decode, "pick_stream",
                        lambda reader: lambda reader, batch_size, bucket_multiple: iter([(["u1", "u2", "u3"], x, xl)]))
    dec = Seq2SeqBeamDecoder(model, _IdCoder(), beam_width=2, max_tokens=4)
    out = tmp_path / "text"
    assert dec.decode_to_file(None, str(out)) == 3
    want = [" ".join(["u"] + [str(i) for i in ids]).replace("u", f"u{k + 1}", 1)
            for k, ids in enumerate(dec.decode_batch(x, xl))]
    assert [line.rstrip() for line in out.read_text().splitlines()] == [w.rstrip() for w in want]


def test_nnet_decode_modes(tmp_path, arpa):
    """``decode_mode = beam`` (the default) gives the autoregressive beam,
    fused with ``lm_path``'s table over the alphabet and ``</s>``;
    ``rescoring`` ignores ``lm_path``; ``lm_path`` with ``beam_width 1``
    raises as the JAX package does."""
    def nnet(**over):
        cfg = ConfigParser()
        cfg.read_dict({"directories": {"expdir": str(tmp_path)},
                       "nnet": {"name": "s", "model": "seq2seq", "loss": "attention", "context_width": "0",
                                "enc_type": "lstm", "num_hidden_layers": "1", "num_hidden_units": "8",
                                "dec_blocks": "1", "d_model": "12", "num_heads": "2", "ffn_dim": "16",
                                "ctc_weight": "0.3", **over}})
        net = Nnet(cfg, 5, V, device="cpu")
        save_checkpoint(net.savedir, net.model.state_dict())
        return net

    dec = nnet().load_text_decoder(_IdCoder())
    assert isinstance(dec, Seq2SeqBeamDecoder) and dec.beam == 1 and dec.fusion is None and dec.max_tokens == 100
    dec = nnet(beam_width="4", lm_path=arpa, lm_alpha="0.3", max_decode_tokens="7",
               length_penalty="0.5").load_text_decoder(_IdCoder())
    assert isinstance(dec, Seq2SeqBeamDecoder) and (dec.beam, dec.max_tokens, dec.length_penalty) == (4, 7, 0.5)
    want = DenseFusionTable(ArpaLM.load(arpa), TOKENS, TOKENS + ["</s>"], alpha=0.3)
    np.testing.assert_array_equal(dec.fusion.table, want.table)
    assert dec._lm_table.device == next(dec.model.parameters()).device
    assert isinstance(nnet(decode_mode="rescoring", lm_path=arpa).load_text_decoder(_IdCoder()), CTCRescoreDecoder)
    with pytest.raises(ValueError, match="needs beam_width > 1"):
        nnet(lm_path=arpa).load_text_decoder(_IdCoder())

"""The port's streaming transcribers against the JAX package's, and against
the port's own offline decoders, on the CPU.

Twins of the CTC cases of tests/test_online.py, of tests/test_timestamps.py,
test_words_confidence.py and test_endpoint.py, and of the streaming cases of
test_transducer_beam.py, test_conformer_transducer.py, test_fused_frontend.py
and test_multistream_rows.py. Seeded JAX weights (``torch_parity.random_start``)
go through ``convert``; the models are small: a 1 x 16 unidirectional GRU
and a 2-block causal conformer (``d_model`` 32, ``subsample`` 2, left
context 8, ``conv_kernel`` 5) for the CTC; a 1 x 16 LSTM and the same
conformer encoder with a 1 x 16 predictor for the transducer; 35 characters
and the blank (the text coder's alphabet). Audio is seeded noise at 8 kHz
through a 10-filter fbank, CMVN from the offline features' stats.

- the port's ``StreamingTranscriber`` / ``StreamingTransducerTranscriber``
  against JAX's on the same audio and chunks: finals and timestamps
  identical, confidences and word confidences within CONF_TOL (1e-5), word
  spans identical; greedy and beam, without and with a character trigram
  (CTC: ``FusionScorer``; transducer: ``DenseFusionTable``);
- chunked == the port's offline decode at chunkings of 160 (CTC) or 700
  (transducer), 1000 (CTC) and the whole utterance: greedy ids, frames and
  posteriors of ``CTCDecoder`` /
  ``TransducerDecoder``; the beam's ``best_alignment`` of
  ``ctc_beam_search_py`` / ``TransducerBeamDecoder.decode_batch_aligned``;
- slots: a 3-row transcriber whose rows start and end at other chunks
  (``finish_rows`` / ``reset_rows``) gives each stream the batch-1 final and
  timestamps exactly and its confidences within CONF_TOL (a 3-row product
  may take another CPU kernel than a 1-row one);
- the fused front-end makes at most one call a push and the decoder one
  model call a push; ``stable_prefixes`` only grow;
- the copied ``Endpointer`` latches exactly as JAX's on random label streams
  at random chunkings, and the transcriber's endpoint wiring (an all-blank
  model fires, the default ``frame_shift`` scaled by the subsample factor).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.torch_parity import random_start
from tfkaldi_tpu.decode.endpoint import EndpointConfig as JaxEndpointConfig
from tfkaldi_tpu.decode.endpoint import Endpointer as JaxEndpointer
from tfkaldi_tpu.decode.endpoint import EndpointRule as JaxEndpointRule
from tfkaldi_tpu.decode.lm import ArpaLM as JaxArpaLM
from tfkaldi_tpu.decode.lm import DenseFusionTable as JaxDenseFusionTable
from tfkaldi_tpu.decode.lm import FusionScorer as JaxFusionScorer
from tfkaldi_tpu.decode.online import StreamingTranscriber as JaxStreamingTranscriber
from tfkaldi_tpu.decode.transducer import StreamingTransducerTranscriber as JaxStreamingTransducerTranscriber
from tfkaldi_tpu.frontend import FeatureExtractor as JaxFeatureExtractor
from tfkaldi_tpu.frontend import FeatureOpts as JaxFeatureOpts
from tfkaldi_tpu.frontend.online import FusedOnlineFeatureExtractor as JaxFused
from tfkaldi_tpu.models.rnn import GRU as JaxGRU
from tfkaldi_tpu.models.rnn import RNNConfig as JaxRNNConfig
from tfkaldi_tpu.models.transducer import Transducer as JaxTransducer
from tfkaldi_tpu.models.transducer import TransducerConfig as JaxTransducerConfig
from tfkaldi_tpu.models.transformer import Transformer as JaxTransformer
from tfkaldi_tpu.models.transformer import TransformerConfig as JaxTransformerConfig
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.convert import rnn_from_jax, transducer_from_jax, transformer_from_jax
from tfkaldi_tpu_torch.data.target_coder import TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
from tfkaldi_tpu_torch.decode.ctc import CTCDecoder
from tfkaldi_tpu_torch.decode.ctc_beam import ctc_beam_search_py
from tfkaldi_tpu_torch.decode.endpoint import EndpointConfig, Endpointer, EndpointRule
from tfkaldi_tpu_torch.decode.lm import ArpaLM, DenseFusionTable, FusionScorer
from tfkaldi_tpu_torch.decode.online import StreamingTranscriber
from tfkaldi_tpu_torch.decode.transducer import StreamingTransducerTranscriber, TransducerDecoder
from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn, cmvn_stats
from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
from tfkaldi_tpu_torch.frontend.online import FusedOnlineFeatureExtractor, OnlineFeatureExtractor
from tfkaldi_tpu_torch.models import GRU, RNNConfig, Transducer, TransducerConfig, Transformer, TransformerConfig

RATE = 8000
CONF_TOL = 1e-5
CODER = TextCoder(aurora4_normalizer)
BLANK = CODER.num_labels  # 35: the blank is the class past the alphabet
FEAT = dict(feature_type="fbank", dynamic="nodelta", nfilt=10, nfft=256)
CONFORMER = dict(num_blocks=2, d_model=32, num_heads=4, ffn_dim=32, conformer=True, conv_kernel=5, left_context=8,
                 right_context=0, causal_conv=True, subsample=2)
ENC_EXTRA = (("num_blocks", "2"), ("d_model", "32"), ("num_heads", "4"), ("ffn_dim", "32"), ("conv_kernel", "5"),
             ("subsample", "2"), ("attention_left_context", "8"), ("attention_right_context", "0"),
             ("causal_conv", "True"))


def _ext():
    return FeatureExtractor(FeatureOpts(**FEAT), RATE, "cpu")


def _jext():
    return JaxFeatureExtractor(JaxFeatureOpts(**FEAT), RATE, spectrum_precision="high")


def _audio(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 300).astype(np.float32) for n in lengths]


def _cmvn(audios):
    ext = _ext()
    feats = [ext.compute(a) for a in audios]
    return cmvn_stats(np.concatenate(feats))


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def ctc_model(kind: str, seed: int = 0):
    """(JAX model, params, state, port model) of a CTC model over the
    alphabet and the blank."""
    if kind == "gru":
        jm = JaxGRU(JaxRNNConfig(input_dim=10, num_labels=BLANK + 1, num_layers=1, hidden_units=16))
        params, state = random_start(jm, seed, scale=0.6)
        model = GRU(RNNConfig(input_dim=10, num_labels=BLANK + 1, num_layers=1, hidden_units=16, cell="gru"))
        model.load_state_dict(rnn_from_jax(params))
    else:
        jm = JaxTransformer(JaxTransformerConfig(input_dim=10, num_labels=BLANK + 1, **CONFORMER))
        params, state = random_start(jm, seed)
        model = Transformer(TransformerConfig(input_dim=10, num_labels=BLANK + 1, **CONFORMER))
        model.load_state_dict(transformer_from_jax(params, state))
    return jm, _jax_tree(params), _jax_tree(state), model.eval()


def transducer_model(enc: str, seed: int = 0):
    kw = dict(input_dim=10, num_labels=BLANK, enc_layers=1, enc_units=16, pred_layers=1, pred_units=16,
              embed_dim=6, joint_units=16)
    if enc == "conformer":
        kw.update(enc_type="conformer", enc_extra=ENC_EXTRA)
    jm = JaxTransducer(JaxTransducerConfig(**kw))
    params, _ = random_start(jm, seed, scale=0.5)
    state = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed))[1])
    model = Transducer(TransducerConfig(**kw))
    model.load_state_dict(transducer_from_jax(params, state))
    return jm, _jax_tree(params), _jax_tree(state), model.eval()


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    """A character trigram over the alphabet from seeded transcripts."""
    root = tmp_path_factory.mktemp("lm")
    rng = np.random.default_rng(0)
    text = os.path.join(root, "text")
    with open(text, "w") as f:
        for i in range(40):
            f.write(f"utt{i} {synthetic.transcript(rng, 120, 3)}\n")
    path = os.path.join(root, "char3.arpa")
    synthetic.write_char_arpa(path, [text], coder=CODER)
    return path


def _stream(tx, audios, chunk):
    """Push each stream of ``audios`` (rows of one batch, ragged) in chunks
    of ``chunk`` samples; finish; return the finals."""
    b = len(audios)
    tx.reset(b)
    total = max(len(a) for a in audios)
    for pos in range(0, total, chunk):
        c = np.zeros((b, chunk), np.float32)
        lens = np.zeros((b,), np.int64)
        for i, a in enumerate(audios):
            part = a[pos: pos + chunk]
            c[i, : len(part)] = part
            lens[i] = len(part)
        tx.push(c, lens)
    return tx.finish()


def _check_alignments(tx, jtx, b):
    for r in range(b):
        np.testing.assert_array_equal(tx.timestamps()[r], jtx.timestamps()[r])
        np.testing.assert_allclose(tx.confidences()[r], jtx.confidences()[r], rtol=0, atol=CONF_TOL)
        words, jwords = tx.words()[r], jtx.words()[r]
        assert [(w.word, w.start, w.end) for w in words] == [(w.word, w.start, w.end) for w in jwords]
        np.testing.assert_allclose([w.confidence for w in words], [w.confidence for w in jwords], rtol=0,
                                   atol=CONF_TOL)


@pytest.mark.parametrize("kind", ["gru", "conformer"])
@pytest.mark.parametrize("mode", ["greedy", "beam", "fused"])
def test_ctc_transcriber_matches_jax(kind, mode, arpa):
    """Port vs JAX ``StreamingTranscriber`` on the fused front-ends with
    CMVN: finals, timestamps, confidences and words."""
    jm, params, state, model = ctc_model(kind)
    audios = _audio(1, [7000, 5200])
    cmvn = _cmvn(audios)
    beam = 1 if mode == "greedy" else 4
    scorer = jscorer = None
    if mode == "fused":
        tokens = list(CODER.alphabet) + ["<blank>"]
        scorer = FusionScorer(ArpaLM.load(arpa), tokens, alpha=0.8, beta=0.5)
        jscorer = JaxFusionScorer(JaxArpaLM.load(arpa), tokens, alpha=0.8, beta=0.5)
    tx = StreamingTranscriber(FusedOnlineFeatureExtractor(_ext()), model, CODER, BLANK, cmvn=cmvn, beam_width=beam,
                              fusion_scorer=scorer)
    jtx = JaxStreamingTranscriber(JaxFused(_jext()), jm, params, state, CODER, BLANK, cmvn=cmvn, beam_width=beam,
                                  fusion_scorer=jscorer)
    finals = _stream(tx, audios, 1000)
    assert finals == _stream(jtx, audios, 1000)
    assert any(finals)
    _check_alignments(tx, jtx, 2)


@pytest.mark.parametrize("kind", ["gru", "conformer"])
@pytest.mark.parametrize("beam", [1, 4])
def test_ctc_chunked_equals_offline(kind, beam):
    """At chunkings 160, 1000 and whole, the streamed ids, frames and
    posteriors equal the port's offline decode of the offline features
    (the same f32 CMVN): ``CTCDecoder`` greedy, or ``ctc_beam_search_py``
    with its backtrace."""
    _, _, _, model = ctc_model(kind, seed=1)
    audios = _audio(2, [6400, 4100])
    cmvn = _cmvn(audios)
    ext = _ext()
    dec = CTCDecoder(model, CODER, BLANK)
    want = []
    for a in audios:
        feats = apply_cmvn(torch.from_numpy(ext.compute(a)), cmvn)[None]
        n = np.asarray([feats.shape[1]])
        if beam == 1:
            ids = dec.decode_batch(feats.numpy(), n)[0]
            want.append((ids, dec.last_label_frames[0], dec.last_label_confs[0]))
        else:
            out_len = int(np.asarray(getattr(model, "output_lengths", lambda x: x)(n))[0])
            lp = dec.log_probs(feats.numpy(), n)[0][:out_len]
            want.append(ctc_beam_search_py(lp, BLANK, beam, return_alignment=True))
    for chunk in (160, 1000, 7000):
        tx = StreamingTranscriber(OnlineFeatureExtractor(ext), model, CODER, BLANK, cmvn=cmvn, beam_width=beam)
        finals = _stream(tx, audios, chunk)
        for r, (ids, frames, confs) in enumerate(want):
            assert finals[r] == CODER.decode(ids)
            np.testing.assert_array_equal(np.asarray(tx._committed[r]), ids)
            np.testing.assert_array_equal(tx.timestamps()[r], frames * tx.frame_seconds)
            np.testing.assert_allclose(tx.confidences()[r], confs, rtol=0, atol=CONF_TOL)


def _slot_run(make_tx, audios, starts, chunk=800):
    """Each stream joins its slot at chunk ``starts[i]`` (``reset_rows``)
    and ends with ``finish_rows`` after its last chunk; returns each
    stream's (final, timestamps, confidences)."""
    b = len(audios)
    tx = make_tx()
    tx.reset(b)
    out = {}
    pos = [None] * b
    step = 0
    while len(out) < b:
        c = np.zeros((b, chunk), np.float32)
        lens = np.zeros((b,), np.int64)
        for i, a in enumerate(audios):
            if step == starts[i]:
                tx.reset_rows([i])
                pos[i] = 0
            if pos[i] is not None and i not in out:
                part = a[pos[i]: pos[i] + chunk]
                c[i, : len(part)] = part
                lens[i] = len(part)
                pos[i] += len(part)
        tx.push(c, lens)
        done = [i for i in range(b) if pos[i] is not None and i not in out and pos[i] >= len(audios[i])]
        if done:
            finals = tx.finish_rows(done)
            for i in done:
                out[i] = (finals[i], tx.timestamps()[i], tx.confidences()[i])
        step += 1
    return [out[i] for i in range(b)]


def _single(make_tx, audio, chunk=800):
    tx = make_tx()
    final = _stream(tx, [audio], chunk)[0]
    return final, tx.timestamps()[0], tx.confidences()[0]


@pytest.mark.parametrize("family", ["ctc_greedy", "ctc_beam", "rnnt_greedy", "rnnt_beam"])
def test_slots_match_single_stream(family):
    """A slot of a shared 3-row transcriber, its stream starting and ending
    at other chunks than its neighbours', gives exactly the batch-1 final,
    timestamps and confidences: idle rows ride along with length 0 and
    ``finish_rows`` / ``reset_rows`` leave the other rows as they were."""
    audios = _audio(3, [5200, 3100, 6000])
    cmvn = _cmvn(audios)
    beam = 4 if family.endswith("beam") else 1
    if family.startswith("ctc"):
        model = ctc_model("conformer", seed=2)[3]

        def make_tx():
            return StreamingTranscriber(FusedOnlineFeatureExtractor(_ext()), model, CODER, BLANK, cmvn=cmvn,
                                        beam_width=beam)
    else:
        model = transducer_model("conformer", seed=2)[3]

        def make_tx():
            return StreamingTransducerTranscriber(FusedOnlineFeatureExtractor(_ext()), model, CODER, cmvn=cmvn,
                                                  beam_width=beam, max_tokens=64)
    slots = _slot_run(make_tx, audios, starts=[0, 2, 1])
    for audio, (final, times, confs) in zip(audios, slots):
        want = _single(make_tx, audio)
        assert final == want[0]
        np.testing.assert_array_equal(times, want[1])
        # a product of 3 rows may take another CPU kernel than one of 1 row
        # (a GEMM against a GEMV), so the posteriors agree to rounding
        np.testing.assert_allclose(confs, want[2], rtol=0, atol=CONF_TOL)


@pytest.mark.parametrize("enc", ["lstm", "conformer"])
@pytest.mark.parametrize("mode", ["greedy", "beam", "fused"])
def test_transducer_transcriber_matches_jax(enc, mode, arpa):
    """Port vs JAX ``StreamingTransducerTranscriber`` on the fused
    front-ends with CMVN: finals, timestamps, confidences and words."""
    jm, params, state, model = transducer_model(enc)
    audios = _audio(4, [6000, 4400])
    cmvn = _cmvn(audios)
    beam = 1 if mode == "greedy" else 4
    table = jtable = None
    if mode == "fused":
        # a label bonus (beta) keeps the fused beam off the empty hypothesis
        table = DenseFusionTable(ArpaLM.load(arpa), list(CODER.alphabet), list(CODER.alphabet), alpha=0.5, beta=2.0)
        jtable = JaxDenseFusionTable(JaxArpaLM.load(arpa), list(CODER.alphabet), list(CODER.alphabet), alpha=0.5,
                                     beta=2.0)
    tx = StreamingTransducerTranscriber(FusedOnlineFeatureExtractor(_ext()), model, CODER, cmvn=cmvn,
                                        beam_width=beam, fusion_table=table, max_tokens=64)
    jtx = JaxStreamingTransducerTranscriber(JaxFused(_jext()), jm, params, state, CODER, cmvn=cmvn,
                                            beam_width=beam, fusion_table=jtable, max_tokens=64)
    finals = _stream(tx, audios, 1000)
    assert finals == _stream(jtx, audios, 1000)
    assert any(finals)
    _check_alignments(tx, jtx, 2)


@pytest.mark.parametrize("enc", ["lstm", "conformer"])
@pytest.mark.parametrize("beam", [1, 4])
def test_transducer_chunked_equals_offline(enc, beam):
    """At chunkings 700 and whole: the streamed ids, frames and
    posteriors equal ``TransducerDecoder`` / the best of
    ``TransducerBeamDecoder.decode_batch_aligned`` on the offline features."""
    _, _, _, model = transducer_model(enc, seed=1)
    audios = _audio(5, [5600, 3900])
    cmvn = _cmvn(audios)
    ext = _ext()
    want = []
    for a in audios:
        feats = apply_cmvn(torch.from_numpy(ext.compute(a)), cmvn)[None].numpy()
        n = np.asarray([feats.shape[1]])
        if beam == 1:
            dec = TransducerDecoder(model, CODER)
            ids = dec.decode_batch(feats, n)[0]
            want.append((ids, dec.last_label_frames[0], dec.last_label_confs[0]))
        else:
            want.append(TransducerBeamDecoder(model, CODER, beam_width=beam, max_tokens=64).decode_batch_aligned(
                feats, n)[0])
    for chunk in (700, 5600):
        tx = StreamingTransducerTranscriber(OnlineFeatureExtractor(ext), model, CODER, cmvn=cmvn, beam_width=beam,
                                            max_tokens=64)
        finals = _stream(tx, audios, chunk)
        for r, (ids, frames, confs) in enumerate(want):
            assert finals[r] == CODER.decode(ids)
            np.testing.assert_array_equal(tx.timestamps()[r], frames * tx.frame_seconds)
            np.testing.assert_allclose(tx.confidences()[r], confs, rtol=0, atol=CONF_TOL)


def test_push_is_one_frontend_call_and_one_model_call():
    """On the fused front-end a push costs one fused call and one model
    call, greedy and beam; ``stable_prefixes`` never shrink."""
    model = ctc_model("gru", seed=3)[3]
    audio = _audio(6, [7000])[0]
    calls = [0]
    orig = model.apply_stream

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    model.apply_stream = counted
    for beam in (1, 4):
        calls[0] = 0
        ext = FusedOnlineFeatureExtractor(_ext())
        tx = StreamingTranscriber(ext, model, CODER, BLANK, cmvn=_cmvn([audio]), beam_width=beam)
        tx.reset(1)
        pushes, last = 0, np.zeros((0,), np.int32)
        for pos in range(0, len(audio), 1000):
            c = audio[pos: pos + 1000][None, :]
            tx.push(c, np.asarray([c.shape[1]]))
            pushes += 1
            if beam > 1:
                stable = tx._dec.stable_prefixes()[0]
                np.testing.assert_array_equal(stable[: len(last)], last)
                last = stable
        tx.finish()
        assert ext.fused_calls <= pushes + 1
        assert calls[0] <= pushes + 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_endpointer_matches_jax(seed):
    """The copied ``Endpointer`` against JAX's: random blank / speech
    streams, padded chunks at random sizes, the default rule bank and a
    short one; every update's detections identical, latched until
    ``reset_rows``."""
    rng = np.random.default_rng(seed)
    b, blank = 3, 7
    for rules in (None, ((False, 0.3, 0.0), (True, 0.1, 0.5))):
        if rules is None:
            ep, jep = Endpointer(EndpointConfig(), blank), JaxEndpointer(JaxEndpointConfig(), blank)
        else:
            ep = Endpointer(EndpointConfig(tuple(EndpointRule(*r) for r in rules), 0.04), blank)
            jep = JaxEndpointer(JaxEndpointConfig(tuple(JaxEndpointRule(*r) for r in rules), 0.04), blank)
        ep.reset(b)
        jep.reset(b)
        for step in range(40):
            t = int(rng.integers(1, 9))
            labels = np.where(rng.random((b, t)) < 0.85, blank, rng.integers(0, blank, (b, t)))
            n = rng.integers(0, t + 1, b)
            np.testing.assert_array_equal(ep.update(labels, n), jep.update(labels, n))
            np.testing.assert_array_equal(ep.trailing_silence_seconds(), jep.trailing_silence_seconds())
            if step == 20:
                ep.reset_rows([1])
                jep.reset_rows([1])
    with pytest.raises(RuntimeError, match="reset"):
        Endpointer(EndpointConfig(), blank).update(np.zeros((1, 1)), [1])


def test_transcriber_endpointing_wiring():
    """An all-blank model with a short no-speech rule latches mid-stream and
    stays latched; ``reset`` clears it; without ``endpoint_config`` the
    query raises. The default ``frame_shift`` follows the subsample factor."""
    model = GRU(RNNConfig(input_dim=10, num_labels=BLANK + 1, num_layers=1, hidden_units=16, cell="gru"))
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.out.b[BLANK] = 10.0  # the zero output layer plus this bias: every frame is blank
    cfg = EndpointConfig((EndpointRule(False, 0.3, 0.0),), frame_shift=0.01)
    tx = StreamingTranscriber(OnlineFeatureExtractor(_ext()), model, CODER, BLANK, endpoint_config=cfg)
    tx.reset(1)
    rng = np.random.default_rng(1)
    fired_at = None
    for i in range(8):  # 0.1 s chunks; 0.3 s of blank frames is about 0.33 s of audio
        tx.push(rng.standard_normal((1, 800)).astype(np.float32) * 100, np.asarray([800]))
        if tx.endpointed()[0]:
            fired_at = i
            break
    assert fired_at is not None and 2 <= fired_at <= 4
    tx.push(rng.standard_normal((1, 800)).astype(np.float32), np.asarray([800]))
    assert tx.endpointed()[0]
    tx.reset(1)
    assert not tx.endpointed()[0]
    plain = StreamingTranscriber(OnlineFeatureExtractor(_ext()), model, CODER, BLANK)
    plain.reset(1)
    with pytest.raises(RuntimeError, match="endpoint_config"):
        plain.endpointed()
    sub = ctc_model("conformer")[3]
    default = StreamingTranscriber(OnlineFeatureExtractor(_ext()), sub, CODER, BLANK,
                                   endpoint_config=EndpointConfig())
    assert default._endpointer.config.frame_shift == pytest.approx(0.02)
    custom = StreamingTranscriber(OnlineFeatureExtractor(_ext()), sub, CODER, BLANK,
                                  endpoint_config=dataclasses.replace(EndpointConfig(), frame_shift=0.05))
    assert custom._endpointer.config.frame_shift == 0.05
    assert default.frame_seconds == pytest.approx(2 * 80 / RATE)


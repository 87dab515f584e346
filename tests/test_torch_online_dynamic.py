"""The port's streaming delta / double-delta front-end against its offline
extractor and the JAX package's ``OnlineDynamicExtractor``, on the CPU.

Twins of the delta cases of tests/test_online_features.py and of
tests/test_multistream_rows.py::test_ctc_transcriber_slots_delta_features.
Seeded int16-valued signals at 8 kHz:

- ``OnlineDynamicExtractor`` at chunks of 160, 1000 and 7777 samples (the
  last one chunk and the flush) against the port's offline
  ``FeatureExtractor`` on the whole utterance: the static columns bit for
  bit, the derivative columns within the JAX test's f64 bar (rtol 1e-7,
  atol 1e-10: the f64 statics of other batch shapes may round otherwise,
  and a derivative that cancels to about 0 shows it); against JAX's
  stream within FEAT_TOL in ``err / max(|ref|, 1)`` (the bound of
  tests/test_torch_online_features.py: XLA:CPU contracts the preemphasis
  into one FMA where the port rounds twice);
- an utterance shorter than the lookahead, emitted whole at the flush with
  the offline reflections; the guards;
- the CTC transcriber on the delta front-end: slots of a 3-row batch
  (``flush_rows`` / ``reset_rows``) give each stream its batch-1 final,
  which is JAX's ``StreamingTranscriber`` on the same weights and audio.
"""

import numpy as np
import pytest

from tests.test_torch_online_decode import BLANK, CODER, _slot_run, _single
from tests.test_torch_online_features import FEAT_TOL, _rel_err, _signals, _stream
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tests.torch_parity import random_start
from tfkaldi_tpu.decode.online import StreamingTranscriber as JaxStreamingTranscriber
from tfkaldi_tpu.frontend import FeatureExtractor as JaxFeatureExtractor
from tfkaldi_tpu.frontend import FeatureOpts as JaxFeatureOpts
from tfkaldi_tpu.frontend.online import OnlineDynamicExtractor as JaxDynamic
from tfkaldi_tpu.models.rnn import GRU as JaxGRU
from tfkaldi_tpu.models.rnn import RNNConfig as JaxRNNConfig
from tfkaldi_tpu_torch.convert import rnn_from_jax
from tfkaldi_tpu_torch.decode.online import StreamingTranscriber
from tfkaldi_tpu_torch.frontend.cmvn import cmvn_stats
from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
from tfkaldi_tpu_torch.frontend.online import FusedOnlineFeatureExtractor, OnlineDynamicExtractor, OnlineFeatureExtractor
from tfkaldi_tpu_torch.models import GRU, RNNConfig

RATE = 8000
DERIV_RTOL = 1e-7
DERIV_ATOL = 1e-10


def _pair(**kw):
    return (FeatureExtractor(FeatureOpts(**kw), RATE, "cpu"),
            JaxFeatureExtractor(JaxFeatureOpts(**kw), RATE, spectrum_precision="high"))


@pytest.mark.parametrize("dynamic", ["delta", "ddelta"])
@pytest.mark.parametrize("chunk", [160, 1000, 7777])
def test_dynamic_stream_matches_offline_and_jax(dynamic, chunk):
    ext, jext = _pair(feature_type="mfcc", dynamic=dynamic, nfilt=20, numcep=13, nfft=256)
    lengths = np.asarray([8000, 4987, 200])
    sig = _signals(np.random.default_rng(31), lengths, 8000)
    off, off_nf = ext(sig, lengths)
    off = off.numpy()
    online = OnlineDynamicExtractor(ext)
    assert online.dim == off.shape[2] == 13 * (2 if dynamic == "delta" else 3)
    assert online.lookahead == (2 if dynamic == "delta" else 4)
    sdim = online._static.dim
    got = _stream(online, sig, lengths, chunk)
    want_jax = _stream(JaxDynamic(jext), sig, lengths, chunk)
    for row in range(len(lengths)):
        want = off[row, : off_nf[row]]
        assert got[row].shape == want.shape
        np.testing.assert_array_equal(got[row][:, :sdim], want[:, :sdim])
        np.testing.assert_allclose(got[row][:, sdim:], want[:, sdim:], rtol=DERIV_RTOL, atol=DERIV_ATOL)
        assert _rel_err(got[row], want_jax[row]) <= FEAT_TOL


def test_dynamic_stream_short_utterance_and_guards():
    """Three frames, fewer than the ddelta lookahead of 4: all emitted at
    the flush with the offline start and end reflections."""
    ext, jext = _pair(feature_type="fbank", dynamic="ddelta", nfilt=8, nfft=256)
    lengths = np.asarray([360])
    sig = _signals(np.random.default_rng(33), lengths, 360)
    off, off_nf = ext(sig, lengths)
    assert off_nf[0] == 3
    online = OnlineDynamicExtractor(ext)
    online.reset(1)
    feats, n = online.step(sig, lengths)
    assert feats.shape[1] == 0 and n[0] == 0
    feats, n = online.flush()
    assert n[0] == 3
    want = off.numpy()[0, :3]
    np.testing.assert_array_equal(feats[0, :3, :8], want[:, :8])
    np.testing.assert_allclose(feats[0, :3], want, rtol=DERIV_RTOL, atol=DERIV_ATOL)
    assert _rel_err(feats[0, :3], _stream(JaxDynamic(jext), sig, lengths, 100)[0]) <= FEAT_TOL

    with pytest.raises(ValueError, match="nodelta"):
        OnlineDynamicExtractor(FeatureExtractor(FeatureOpts(dynamic="nodelta"), RATE, "cpu"))
    for cls in (OnlineFeatureExtractor, FusedOnlineFeatureExtractor):
        with pytest.raises(ValueError, match="OnlineDynamicExtractor"):
            cls(ext)
    online = OnlineDynamicExtractor(ext)
    for call in (lambda: online.step(np.zeros((1, 100), np.float32), np.asarray([100])), online.flush,
                 lambda: online.flush_rows([0]), lambda: online.reset_rows([0])):
        with pytest.raises(RuntimeError, match="reset"):
            call()


def test_dynamic_flush_rows_keeps_other_rows():
    """``flush_rows`` ends one row with its true end reflection while the
    other row streams on; ``reset_rows`` re-arms it for a new stream."""
    ext, _ = _pair(feature_type="fbank", dynamic="delta", nfilt=8, nfft=256)
    lengths = np.asarray([3000, 5000])
    sig = _signals(np.random.default_rng(34), lengths, 5000)
    off, off_nf = ext(sig, lengths)
    online = OnlineDynamicExtractor(ext)
    online.reset(2)
    got = [[], []]
    for pos in range(0, 5000, 1000):
        feats, n = online.step(sig[:, pos: pos + 1000], np.clip(lengths - pos, 0, 1000))
        for r in range(2):
            got[r].append(feats[r, : n[r]])
        if pos + 1000 == 3000:
            feats, n = online.flush_rows([0])
            assert n[1] == 0
            got[0].append(feats[0, : n[0]])
            online.reset_rows([0])
    feats, n = online.flush_rows([1])
    got[1].append(feats[1, : n[1]])
    for r in range(2):
        g, want = np.concatenate(got[r]), off.numpy()[r, : off_nf[r]]
        assert g.shape == want.shape
        np.testing.assert_allclose(g, want, rtol=DERIV_RTOL, atol=DERIV_ATOL)


def _delta_gru(seed=5):
    """A 1 x 16 CTC GRU over 10 fbanks with their deltas (20 inputs)."""
    cfg = dict(input_dim=20, num_labels=BLANK + 1, num_layers=1, hidden_units=16)
    jm = JaxGRU(JaxRNNConfig(**cfg))
    params, state = random_start(jm, seed, scale=0.6)
    model = GRU(RNNConfig(**cfg, cell="gru"))
    model.load_state_dict(rnn_from_jax(params))
    return jm, params, state, model.eval()


def test_delta_transcriber_slots_match_single_stream_and_jax():
    rng = np.random.default_rng(3)
    audios = [(rng.standard_normal(n) * 300).astype(np.float32) for n in (5200, 3100, 6000)]
    ext, jext = _pair(feature_type="fbank", dynamic="delta", nfilt=10, nfft=256)
    cmvn = cmvn_stats(np.concatenate([ext.compute(a) for a in audios]))
    jm, params, state, model = _delta_gru()

    def make_tx():
        return StreamingTranscriber(OnlineDynamicExtractor(ext), model, CODER, BLANK, cmvn=cmvn)

    def make_jtx():
        return JaxStreamingTranscriber(JaxDynamic(jext), jm, params, state, CODER, BLANK, cmvn=cmvn)

    slots = _slot_run(make_tx, audios, starts=[0, 2, 1])
    for audio, (final, times, _) in zip(audios, slots):
        want = _single(make_tx, audio)
        assert final == want[0]
        np.testing.assert_array_equal(times, want[1])
        jwant = _single(make_jtx, audio)
        assert final == jwant[0]
        np.testing.assert_array_equal(times, jwant[1])

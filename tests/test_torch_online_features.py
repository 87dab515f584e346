"""The port's streaming front-ends against its offline extractor and the
JAX package's online extractors, on the CPU.

Twins of the nodelta cases of tests/test_online_features.py and of
tests/test_fused_frontend.py. The same seeded int16-valued signals go
through:

- the port's ``OnlineFeatureExtractor`` and ``FusedOnlineFeatureExtractor``
  at several chunkings: their frames equal the port's offline
  ``FeatureExtractor`` on the whole utterance BIT FOR BIT (the same two
  preemphasis roundings as kernel 2's plain version, the same frames, the
  same ``_frames_to_feats``), and the fused stream equals the unfused one bit
  for bit with and without CMVN (both apply ``apply_cmvn``'s f32 ops);
- the JAX package's ``OnlineFeatureExtractor`` / ``FusedOnlineFeatureExtractor``
  (``spectrum_precision = "high"``): within FEAT_TOL in the repo's
  ``err / max(|ref|, 1)``, the bound of tests/test_torch_features.py. XLA:CPU
  contracts the JAX preemphasis into one FMA where the port rounds twice
  (tests/test_torch_frame_preemph.py), and both cast f64 to f32 at the end,
  so the two differ by about one f32 ulp; with CMVN the JAX fused call adds
  its own ~2 ulps (tests/test_fused_frontend.py), hence CMVN_TOL.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from tfkaldi_tpu.frontend import FeatureExtractor as JaxFeatureExtractor
from tfkaldi_tpu.frontend import FeatureOpts as JaxFeatureOpts
from tfkaldi_tpu.frontend.online import FusedOnlineFeatureExtractor as JaxFused
from tfkaldi_tpu.frontend.online import OnlineFeatureExtractor as JaxOnline
from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn, cmvn_stats
from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
from tfkaldi_tpu_torch.frontend.online import FusedOnlineFeatureExtractor, OnlineDynamicExtractor, OnlineFeatureExtractor

RATE = 16000
FEAT_TOL = 1e-6
CMVN_TOL = 2e-6


def _signals(rng, lengths, padded):
    sig = (rng.standard_normal((len(lengths), padded)) * 3000).astype(np.int16).astype(np.float32)
    for row, n in enumerate(lengths):
        sig[row, n:] = 0
    return sig


def _rel_err(got, ref):
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0), initial=0.0))


def _stream(online, sig, lengths, chunk, cmvn=None):
    """Stream ``sig`` through an online extractor; per-row trimmed frames
    (CMVN applied to the unfused output, folded into the fused call)."""
    b, padded = sig.shape
    online.reset(b)
    if cmvn is not None and hasattr(online, "fuse_cmvn"):
        online.fuse_cmvn(cmvn)
        cmvn = None
    got = [[] for _ in range(b)]

    def collect(feats, nnew):
        if cmvn is not None:
            feats = apply_cmvn(torch.as_tensor(np.asarray(feats)), cmvn)
        feats = np.asarray(feats)
        for row in range(b):
            got[row].append(feats[row, : nnew[row]])

    for pos in range(0, padded, chunk):
        c = sig[:, pos: pos + chunk]
        collect(*online.step(c, np.clip(lengths - pos, 0, c.shape[1])))
    collect(*online.flush())
    return [np.concatenate(g, axis=0) for g in got]


def _jax_stream(online, sig, lengths, chunk, cmvn=None):
    """The JAX twin of :func:`_stream` (JAX CMVN on the unfused output)."""
    from tfkaldi_tpu.frontend.cmvn import apply_cmvn

    b, padded = sig.shape
    online.reset(b)
    if cmvn is not None and hasattr(online, "fuse_cmvn"):
        online.fuse_cmvn(cmvn)
        cmvn = None
    got = [[] for _ in range(b)]

    def collect(feats, nnew):
        feats = np.asarray(feats)
        if cmvn is not None:
            feats = np.asarray(apply_cmvn(feats, cmvn))
        for row in range(b):
            got[row].append(feats[row, : nnew[row]])

    for pos in range(0, padded, chunk):
        c = sig[:, pos: pos + chunk]
        collect(*online.step(c, np.clip(lengths - pos, 0, c.shape[1])))
    collect(*online.flush())
    return [np.concatenate(g, axis=0) for g in got]


def _pair(**kw):
    return (FeatureExtractor(FeatureOpts(**kw), RATE, "cpu"),
            JaxFeatureExtractor(JaxFeatureOpts(**kw), RATE, spectrum_precision="high"))


@pytest.mark.parametrize("snip", [True, False])
@pytest.mark.parametrize("chunk", [160, 1000, 7777])
def test_stream_matches_offline_fbank(snip, chunk):
    """Chunked == the port's offline batch bit for bit, a short row and an
    empty row included; the JAX online stream within FEAT_TOL."""
    ext, jext = _pair(feature_type="fbank", dynamic="nodelta", snip_edges=snip, include_energy=True)
    lengths = np.asarray([16000, 9137, 300, 0])
    sig = _signals(np.random.default_rng(1), lengths, 16000)
    off, off_nf = ext(sig, lengths)
    off = off.numpy()
    got = _stream(OnlineFeatureExtractor(ext), sig, lengths, chunk)
    fused = _stream(FusedOnlineFeatureExtractor(ext), sig, lengths, chunk)
    want = _jax_stream(JaxOnline(jext), sig, lengths, chunk)
    for row in range(len(lengths)):
        assert got[row].shape == (off_nf[row], ext.opts.dim)
        np.testing.assert_array_equal(got[row], off[row, : off_nf[row]])
        np.testing.assert_array_equal(fused[row], got[row])
        assert want[row].shape == got[row].shape
        assert _rel_err(got[row], want[row]) <= FEAT_TOL


@pytest.mark.parametrize("ftype", ["mfcc", "ssc"])
def test_stream_matches_offline_other_types(ftype):
    ext, jext = _pair(feature_type=ftype, dynamic="nodelta", snip_edges=True)
    lengths = np.asarray([12000, 5000])
    sig = _signals(np.random.default_rng(2), lengths, 12000)
    off, off_nf = ext(sig, lengths)
    got = _stream(OnlineFeatureExtractor(ext), sig, lengths, 1600)
    want = _jax_stream(JaxOnline(jext), sig, lengths, 1600)
    for row in range(len(lengths)):
        np.testing.assert_array_equal(got[row], off.numpy()[row, : off_nf[row]])
        assert _rel_err(got[row], want[row]) <= FEAT_TOL


@pytest.mark.parametrize("fused", [False, True])
def test_stream_rows_advance_at_different_rates(fused):
    """Row 0 gets its whole signal in the first call, row 1 dribbles in
    250-sample pushes: both equal the offline batch."""
    ext, _ = _pair(feature_type="fbank", dynamic="nodelta")
    lengths = np.asarray([6000, 6000])
    sig = _signals(np.random.default_rng(4), lengths, 6000)
    off, off_nf = ext(sig, lengths)
    online = (FusedOnlineFeatureExtractor if fused else OnlineFeatureExtractor)(ext)
    online.reset(2)
    got = [[] for _ in range(2)]

    def collect(feats, nnew):
        feats = np.asarray(feats)
        for row in range(2):
            got[row].append(feats[row, : nnew[row]])

    collect(*online.step(np.stack([sig[0], np.pad(sig[1, :250], (0, 5750))]), np.asarray([6000, 250])))
    for pos in range(250, 6000, 250):
        c = np.zeros((2, 250), np.float32)
        c[1] = sig[1, pos: pos + 250]
        collect(*online.step(c, np.asarray([0, 250])))
    collect(*online.flush())
    for row in range(2):
        np.testing.assert_array_equal(np.concatenate(got[row]), off.numpy()[row, : off_nf[row]])


@pytest.mark.parametrize("cls", [OnlineFeatureExtractor, FusedOnlineFeatureExtractor])
def test_stream_requires_reset_and_nodelta(cls):
    """Both extractors need ``reset`` and stream static features only; a
    delta config is refused by name and streams through
    ``OnlineDynamicExtractor``, whose frames equal the offline ones
    (tests/test_torch_online_dynamic.py holds it at every chunking)."""
    ext = FeatureExtractor(FeatureOpts(dynamic="nodelta"), RATE, "cpu")
    online = cls(ext)
    with pytest.raises(RuntimeError, match="reset"):
        online.step(np.zeros((1, 100), np.float32), np.asarray([100]))
    with pytest.raises(RuntimeError, match="reset"):
        online.flush()
    ddelta = FeatureExtractor(FeatureOpts(dynamic="ddelta"), RATE, "cpu")
    with pytest.raises(ValueError, match="OnlineDynamicExtractor"):
        cls(ddelta)
    lengths = np.asarray([4000])
    sig = _signals(np.random.default_rng(5), lengths, 4000)
    off, off_nf = ddelta(sig, lengths)
    got = _stream(OnlineDynamicExtractor(ddelta), sig, lengths, 1000)[0]
    assert got.shape == (off_nf[0], 3 * ddelta.opts.base_dim)
    np.testing.assert_allclose(got, off.numpy()[0, : off_nf[0]], rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("cls", [OnlineFeatureExtractor, FusedOnlineFeatureExtractor])
def test_stream_flush_is_terminal(cls):
    online = cls(FeatureExtractor(FeatureOpts(dynamic="nodelta"), RATE, "cpu"))
    online.reset(1)
    online.step(np.zeros((1, 1000), np.float32), np.asarray([1000]))
    online.flush()
    with pytest.raises(RuntimeError, match="reset"):
        online.step(np.zeros((1, 100), np.float32), np.asarray([100]))


def _small_pair(snip=True):
    kw = dict(feature_type="fbank", dynamic="nodelta", nfilt=10, nfft=256, snip_edges=snip)
    return (FeatureExtractor(FeatureOpts(**kw), 8000, "cpu"),
            JaxFeatureExtractor(JaxFeatureOpts(**kw), 8000, spectrum_precision="high"))


@pytest.mark.parametrize("snip", [True, False])
@pytest.mark.parametrize("with_cmvn", [False, True])
def test_fused_frontend_bit_identical(snip, with_cmvn):
    """The fused stream == the unfused stream bit for bit (with CMVN too:
    the same f32 ops), == the offline batch without CMVN; the JAX fused
    stream within FEAT_TOL, or CMVN_TOL with CMVN. Its output stays on the
    extractor's device and it makes at most one fused call a push."""
    ext, jext = _small_pair(snip)
    rng = np.random.default_rng(3)
    audio = rng.standard_normal((2, 7000)).astype(np.float32)
    lens = np.asarray([7000, 5200])
    off, off_n = ext(audio, lens)
    off = off.numpy()
    cmvn = cmvn_stats(off, off_n) if with_cmvn else None
    for chunk in (1000, 333):
        un = _stream(OnlineFeatureExtractor(ext), audio, lens, chunk, cmvn)
        fused_ext = FusedOnlineFeatureExtractor(ext)
        fu = _stream(fused_ext, audio, lens, chunk, cmvn)
        assert fused_ext.fused_calls <= -(-7000 // chunk) + 1
        want = _jax_stream(JaxFused(jext), audio, lens, chunk, cmvn)
        for r in range(2):
            assert un[r].shape == fu[r].shape == (off_n[r], 10)
            np.testing.assert_array_equal(fu[r], un[r])
            if not with_cmvn:
                np.testing.assert_array_equal(fu[r], off[r, : off_n[r]])
            assert _rel_err(fu[r], want[r]) <= (CMVN_TOL if with_cmvn else FEAT_TOL)
    fused_ext.reset(1)
    feats, _ = fused_ext.step(audio[:1, :1000], np.asarray([1000]))
    assert isinstance(feats, torch.Tensor) and feats.device == ext.device


def test_fused_frontend_per_slot_lifecycle():
    """``flush_rows`` finishes one row's frames (equal to the unfused twin
    and to JAX's fused extractor), ``reset_rows`` re-arms it, and the other
    row streams on undisturbed."""
    ext, jext = _small_pair()
    audio = np.random.default_rng(11).standard_normal((2, 6000)).astype(np.float32)
    lens = np.asarray([3000, 6000])

    def run(ext_obj):
        ext_obj.reset(2)
        rows = [[] for _ in range(2)]

        def collect(feats, counts):
            feats = np.asarray(feats)
            for r in range(2):
                rows[r].append(feats[r, : int(counts[r])])

        for pos in range(0, 6000, 1000):
            collect(*ext_obj.step(audio[:, pos: pos + 1000], np.clip(lens - pos, 0, 1000)))
            if pos + 1000 == 3000:
                collect(*ext_obj.flush_rows([0]))
                ext_obj.reset_rows([0])
        collect(*ext_obj.flush_rows([1]))
        return [np.concatenate(r, axis=0) for r in rows]

    un = run(OnlineFeatureExtractor(ext))
    fu = run(FusedOnlineFeatureExtractor(ext))
    want = run(JaxFused(jext))
    for r in range(2):
        np.testing.assert_array_equal(fu[r], un[r])
        assert fu[r].shape == want[r].shape
        assert _rel_err(fu[r], want[r]) <= FEAT_TOL

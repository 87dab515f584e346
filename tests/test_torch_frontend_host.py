"""The port's host front-end copies (``frontend/sigproc.py``,
``functional.py``, ``perturb.py``), its torch ``apply_cmvn`` / ``splice``
and ``prepare_data`` with ``speed_perturb``, against the JAX package, on
the CPU.

Twins of tests/test_functional.py and tests/test_speed_perturb.py:

- ``sigproc`` and ``functional`` are numpy (and scipy) copies, the mel
  helpers from the port: bit for bit equal to JAX's on the same seeded
  signal; ``functional.mfcc`` against the port's batched extractor within
  the JAX test's bar (atol 2e-5, rtol 1e-4);
- ``perturb``: ``parse_factors`` / ``factor_prefix`` and their refusals,
  ``resample_signal`` bit for bit at 0.9, 1.0 (the input itself) and 1.1,
  ``expand_metadata``'s files byte for byte;
- ``apply_cmvn`` / ``splice`` on ``[T, D]`` and ``[B, T, D]``: CMVN within
  one f32 ulp of JAX's (both f32, XLA may fuse otherwise), splice exactly;
- ``prepare_data`` with ``speed_perturb = 0.9,1.0,1.1`` on a tiny corpus:
  the same utterance ids in the same order, metadata files and
  ``maxlength`` as JAX's, features within FEAT_TOL (err / max(|ref|, 1),
  the bound of tests/test_torch_features.py), the factor-1.0 copy byte for
  byte an unperturbed run's, ``wav.scp`` not copied, CMVN over the prefixed
  speakers.
"""

import os

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from tfkaldi_tpu.frontend import apply_cmvn as jax_apply_cmvn
from tfkaldi_tpu.frontend import functional as jax_functional
from tfkaldi_tpu.frontend import perturb as jax_perturb
from tfkaldi_tpu.frontend import sigproc as jax_sigproc
from tfkaldi_tpu.frontend import splice as jax_splice
from tfkaldi_tpu.frontend.prepare_data import prepare_data as jax_prepare_data
from tfkaldi_tpu_torch.frontend import FeatureExtractor, FeatureOpts, apply_cmvn, cmvn_stats, functional, perturb
from tfkaldi_tpu_torch.frontend import sigproc, splice
from tfkaldi_tpu_torch.frontend.prepare_data import compute_cmvn, prepare_data
from tfkaldi_tpu_torch.io import ArkReader

RATE = 16000
FEAT_TOL = 1e-6
CONF = {"type": "mfcc", "dynamic": "nodelta", "winlen": "0.025", "winstep": "0.01", "nfilt": "20", "nfft": "512",
        "lowfreq": "0", "highfreq": "-1", "preemph": "0.97", "include_energy": "False", "snip_edges": "False",
        "numcep": "13", "ceplifter": "22"}


@pytest.fixture(scope="module")
def sig():
    return np.random.default_rng(0).standard_normal(RATE // 2) * 1000


def test_sigproc_matches_jax(sig):
    np.testing.assert_array_equal(sigproc.preemphasis(sig, 0.97), jax_sigproc.preemphasis(sig, 0.97))
    frames = sigproc.framesig(sig, 0.025 * RATE, 0.01 * RATE)
    np.testing.assert_array_equal(frames, jax_sigproc.framesig(sig, 0.025 * RATE, 0.01 * RATE))
    hamming = np.hamming
    np.testing.assert_array_equal(sigproc.framesig(sig[:999], 400, 160, hamming),
                                  jax_sigproc.framesig(sig[:999], 400, 160, hamming))
    np.testing.assert_array_equal(sigproc.deframesig(frames, len(sig), 400, 160),
                                  jax_sigproc.deframesig(frames, len(sig), 400, 160))
    np.testing.assert_allclose(sigproc.deframesig(frames, len(sig), 400, 160), sig, rtol=1e-9)
    for fn in ("magspec", "powspec"):
        np.testing.assert_array_equal(getattr(sigproc, fn)(frames, 512), getattr(jax_sigproc, fn)(frames, 512))
    for norm in (False, True):
        np.testing.assert_array_equal(sigproc.logpowspec(frames, 512, norm), jax_sigproc.logpowspec(frames, 512, norm))
    zeros = np.zeros((2, 400))
    assert sigproc.logpowspec(zeros, 512, norm=False).min() == 10 * np.log10(1e-30)


@pytest.mark.parametrize("fn", ["fbank", "logfbank", "mfcc", "ssc"])
def test_functional_matches_jax(sig, fn):
    got, want = getattr(functional, fn)(sig, RATE, CONF), getattr(jax_functional, fn)(sig, RATE, CONF)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        np.testing.assert_array_equal(g, w)


def test_functional_derivatives_and_device_extractor(sig):
    feat = functional.logfbank(sig, RATE, CONF)
    for fn in ("deriv", "delta", "ddelta"):
        np.testing.assert_array_equal(getattr(functional, fn)(feat), getattr(jax_functional, fn)(feat))
    device = FeatureExtractor(FeatureOpts.from_config(CONF), RATE, "cpu").compute(sig)
    np.testing.assert_allclose(device, functional.mfcc(sig, RATE, CONF)[0], atol=2e-5, rtol=1e-4)


def test_perturb_matches_jax(tmp_path):
    for spec in ("0.9,1.0,1.1", " 1.1 , 0.9 "):
        assert perturb.parse_factors(spec) == jax_perturb.parse_factors(spec)
    for bad in ("0.9,0.9", "-1.0", " , ", "0.9,0.8999999999999"):
        with pytest.raises(ValueError):
            perturb.parse_factors(bad)
    for f in (0.9, 1.0, 1.1, 2.0):
        assert perturb.factor_prefix(f) == jax_perturb.factor_prefix(f)
    x = np.random.default_rng(1).standard_normal(3001).astype(np.float32) * 3000
    assert perturb.resample_signal(x, 1.0) is x
    for f in (0.9, 1.1):
        got = perturb.resample_signal(x, f)
        assert got.dtype == np.float32 and len(got) == round(len(x) / f)
        np.testing.assert_array_equal(got, jax_perturb.resample_signal(x, f))
    assert len(perturb.resample_signal(np.zeros(0, np.float32), 0.9)) == 0
    datadir = tmp_path / "data"
    datadir.mkdir()
    (datadir / "utt2spk").write_text("u1 s1\nu2 s1\nu3 s2\n")
    (datadir / "text").write_text("u1 hello\nu2 a b\nu3 c\n")
    for mod, name in ((perturb, "port"), (jax_perturb, "jax")):
        (tmp_path / name).mkdir()
        mod.expand_metadata(str(datadir), str(tmp_path / name), (0.9, 1.0, 1.1))
    for f in ("utt2spk", "spk2utt", "text"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


def test_apply_cmvn_and_splice_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32) * 3 + 1
    stats = cmvn_stats(x.reshape(-1, 5) * 1.1)
    for utt in (x[0], x):
        got = apply_cmvn(torch.from_numpy(utt), stats).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_apply_cmvn(utt, stats)), rtol=0, atol=2e-6)
        for c in (0, 1, 3):
            np.testing.assert_array_equal(splice(torch.from_numpy(utt), c).numpy(), np.asarray(jax_splice(utt, c)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four int16 wavs of 0.25-0.5 s, two speakers, with text."""
    tmp = tmp_path_factory.mktemp("sp_corpus")
    datadir = tmp / "data"
    datadir.mkdir()
    rng = np.random.default_rng(7)
    utts = {}
    for s in range(2):
        for u in range(2):
            utt = f"spk{s}_utt{u}"
            path = tmp / f"{utt}.wav"
            scipy.io.wavfile.write(path, RATE, (rng.standard_normal(int(rng.integers(RATE // 4, RATE // 2)))
                                                * 5000).astype(np.int16))
            utts[utt] = str(path)
    (datadir / "wav.scp").write_text("".join(f"{u} {p}\n" for u, p in utts.items()))
    (datadir / "utt2spk").write_text("".join(f"{u} {u.split('_')[0]}\n" for u in utts))
    (datadir / "spk2utt").write_text("".join(
        f"spk{s} {' '.join(u for u in utts if u.startswith(f'spk{s}'))}\n" for s in range(2)))
    (datadir / "text").write_text("".join(f"{u} hello world\n" for u in utts))
    return str(datadir), list(utts)


def _scp(featdir):
    with ArkReader(os.path.join(featdir, "feats.scp")) as reader:
        return {utt: reader.read_utt(utt) for utt in reader.utt_ids}


def test_prepare_data_speed_perturb_matches_jax(corpus, tmp_path):
    datadir, utt_ids = corpus
    conf = {"type": "fbank", "dynamic": "nodelta", "nfilt": "8", "nfft": "512", "include_energy": "False",
            "speed_perturb": "0.9,1.0,1.1"}
    sp, jsp, plain = (str(tmp_path / d) for d in ("sp", "jax_sp", "plain"))
    prepare_data(datadir, sp, conf, batch_size=3, device="cpu")
    jax_prepare_data(datadir, jsp, conf, batch_size=3)
    prepare_data(datadir, plain, {k: v for k, v in conf.items() if k != "speed_perturb"}, batch_size=3,
                 device="cpu")
    got, want, base = _scp(sp), _scp(jsp), _scp(plain)
    assert list(got) == list(want) == [pre + u for u in utt_ids for pre in ("sp0.9-", "", "sp1.1-")]
    for utt, m in got.items():
        assert m.shape == want[utt].shape
        assert float(np.max(np.abs(m - want[utt]) / np.maximum(np.abs(want[utt]), 1.0))) <= FEAT_TOL, utt
    for utt in utt_ids:
        np.testing.assert_array_equal(got[utt], base[utt])  # the factor-1.0 copy is an unperturbed run's
        assert got[f"sp0.9-{utt}"].shape[0] > base[utt].shape[0] > got[f"sp1.1-{utt}"].shape[0]
    for name in ("utt2spk", "spk2utt", "text", "maxlength"):
        with open(os.path.join(sp, name), "rb") as f, open(os.path.join(jsp, name), "rb") as g:
            assert f.read() == g.read(), name
    assert not os.path.exists(os.path.join(sp, "wav.scp"))
    compute_cmvn(sp)
    with ArkReader(os.path.join(sp, "cmvn.scp")) as reader:
        assert sorted(reader.utt_ids) == sorted(pre + f"spk{s}" for pre in ("sp0.9-", "", "sp1.1-") for s in range(2))

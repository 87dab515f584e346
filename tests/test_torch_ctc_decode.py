"""The port's CTC text decode against the JAX package, on the CPU.

- ``collapse_ctc_path(_aligned)`` against the JAX functions;
- the prefix beam search: the port's Python beam and its native beam (the
  port's copy of the C++ source, built into ``build/tfkaldi_tpu_torch/``)
  against the JAX Python beam on seeded log-probs, beam 1, 4 and 16; the
  native batch against the native single search (tests/test_ctc_beam.py's
  case);
- ``Nnet.decode_text`` on converted f32 BiLSTM weights against the JAX
  ``CTCDecoder`` on the same features: the same ``text`` file, greedy and
  beam 4, and the greedy alignment (label frames, posteriors within 1e-5).
"""

import os
from configparser import ConfigParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.synthetic import make_featdir
from tfkaldi_tpu.data.feature_reader import FeatureReader as JaxFeatureReader
from tfkaldi_tpu.data.target_coder import TextCoder as JaxTextCoder
from tfkaldi_tpu.data.target_normalizers import aurora4_normalizer as jax_aurora4_normalizer
from tfkaldi_tpu.decode import ctc as jax_ctc
from tfkaldi_tpu.decode.ctc_beam import ctc_beam_search_py as jax_beam_py
from tfkaldi_tpu.models import LSTM as JaxLSTM
from tfkaldi_tpu.models import RNNConfig as JaxRNNConfig
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.convert import rnn_from_jax, save_checkpoint
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.data.target_coder import TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
from tfkaldi_tpu_torch.decode import ctc, native_beam
from tfkaldi_tpu_torch.decode.ctc_beam import ctc_beam_search_py
from tfkaldi_tpu_torch.nnet import Nnet


def test_collapse_matches_jax():
    rng = np.random.default_rng(0)
    paths = [np.array([1, 1, 0, 1, 2, 2, 0, 0, 3]), np.array([], np.int64), np.zeros(5, np.int64)]
    paths += [rng.integers(0, 4, int(rng.integers(1, 40))) for _ in range(20)]
    for path in paths:
        for blank in (0, 3):
            np.testing.assert_array_equal(ctc.collapse_ctc_path(path, blank), jax_ctc.collapse_ctc_path(path, blank))
            for got, want in zip(ctc.collapse_ctc_path_aligned(path, blank),
                                 jax_ctc.collapse_ctc_path_aligned(path, blank)):
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype


def _log_probs(rng, t_len, v):
    logits = rng.standard_normal((t_len, v)) * 2
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("beam", [1, 4, 16])
def test_beams_match_jax_python_beam(beam):
    """The port's Python beam (with its backtrace) and native beam give the
    JAX Python beam's transcript on every trial."""
    assert native_beam.available()
    rng = np.random.default_rng(42 + beam)
    for trial in range(6):
        t_len, v = int(rng.integers(4, 40)), int(rng.integers(3, 37))
        log_probs = _log_probs(rng, t_len, v)
        blank = int(rng.integers(0, v))
        want, want_frames, want_confs = jax_beam_py(log_probs, blank, beam, return_alignment=True)
        got, frames, confs = ctc_beam_search_py(log_probs, blank, beam, return_alignment=True)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(frames, want_frames)
        np.testing.assert_array_equal(confs, want_confs)
        np.testing.assert_array_equal(native_beam.ctc_beam_search_native(log_probs, blank, beam), want)


def test_native_batch_matches_single():
    rng = np.random.default_rng(7)
    b, t_max, v = 5, 30, 12
    logits = rng.standard_normal((b, t_max, v)).astype(np.float32) * 2
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lengths = rng.integers(5, t_max + 1, b).astype(np.int32)
    batch = native_beam.ctc_beam_search_batch_native(log_probs, lengths, 0, 8)
    for i in range(b):
        np.testing.assert_array_equal(batch[i], native_beam.ctc_beam_search_native(log_probs[i, : lengths[i]], 0, 8))


# ---------------------------------------------------------------------------
# Nnet.decode_text against the JAX CTCDecoder
# ---------------------------------------------------------------------------

FEAT_DIM, CONTEXT, HID = 8, 1, 16
NUM_LABELS = 35  # the text coder's characters; the model emits a blank too


@pytest.fixture(scope="module")
def decode_setup(tmp_path_factory):
    """A featdir of 8 utterances of 20-60 frames, and seeded BiLSTM weights
    (2 x 16, 36 outputs, the output layer scaled so the frames' posteriors
    are peaked and the transcripts are not empty)."""
    tmp = tmp_path_factory.mktemp("ctc_decode")
    featdir, _, _ = make_featdir(tmp, num_speakers=2, utts_per_speaker=4, feat_dim=FEAT_DIM)
    params = synthetic.random_rnn_pytree(FEAT_DIM * (2 * CONTEXT + 1), HID, 2, NUM_LABELS + 1, gates=4, seed=3)
    params["out"]["w"] *= 6.0
    return tmp, featdir, params


def _reader_args(featdir):
    return (os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"), os.path.join(featdir, "utt2spk"),
            CONTEXT, 0)


def _jax_decoder(params, beam):
    cfg = JaxRNNConfig(input_dim=FEAT_DIM * (2 * CONTEXT + 1), num_labels=NUM_LABELS + 1, num_layers=2,
                       hidden_units=HID, bidirectional=True, compute_dtype=jnp.dtype("float32"), scan_unroll=1)
    return jax_ctc.CTCDecoder(JaxLSTM(cfg), jax.tree.map(jnp.asarray, params), {},
                              JaxTextCoder(jax_aurora4_normalizer), NUM_LABELS, beam_width=beam)


def _nnet(tmp, params, beam):
    cfg = ConfigParser()
    cfg["directories"] = {"expdir": str(tmp / f"exp{beam}")}
    cfg["nnet"] = {"name": "ctc", "loss": "ctc", "model": "lstm", "bidirectional": "True",
                   "num_hidden_units": str(HID), "num_hidden_layers": "2", "context_width": str(CONTEXT),
                   "beam_width": str(beam)}
    nnet = Nnet(cfg, FEAT_DIM, NUM_LABELS, device="cpu")
    save_checkpoint(nnet.savedir, rnn_from_jax(params))
    return nnet


@pytest.mark.parametrize("beam", [1, 4])
def test_decode_text_matches_jax(decode_setup, beam):
    tmp, featdir, params = decode_setup
    ctc.beam_runs.update(native=0, python=0, fused=0)
    got_path, want_path = str(tmp / f"port{beam}.txt"), str(tmp / f"jax{beam}.txt")
    reader = FeatureReader(*_reader_args(featdir))
    assert _nnet(tmp, params, beam).decode_text(reader, TextCoder(aurora4_normalizer), got_path) == 8
    reader.close()
    assert _jax_decoder(params, beam).decode_to_file(JaxFeatureReader(*_reader_args(featdir)), want_path) == 8
    got, want = open(got_path).read(), open(want_path).read()
    assert got == want
    assert sum(len(line.split()) - 1 for line in got.splitlines()) > 8  # not all empty
    assert ctc.beam_runs == {"native": 0 if beam == 1 else 1, "python": 0, "fused": 0}


def test_greedy_alignment_matches_jax(decode_setup):
    """The greedy decode's label frames equal and posteriors within 1e-5
    (``last_label_frames`` / ``last_label_confs``), on one padded batch."""
    tmp, featdir, params = decode_setup
    from tfkaldi_tpu_torch.decode.streaming import stream_padded_batches

    _, inputs, lengths = next(stream_padded_batches(FeatureReader(*_reader_args(featdir)), batch_size=8))
    mine = _nnet(tmp, params, 1).load_text_decoder(TextCoder(aurora4_normalizer))
    theirs = _jax_decoder(params, 1)
    for got, want in zip(mine.decode_batch(inputs, lengths), theirs.decode_batch(inputs, lengths)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(mine.last_label_frames, theirs.last_label_frames):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(mine.last_label_confs, theirs.last_label_confs):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

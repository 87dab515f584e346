"""The byte contract of the port's ark output with Kaldi's readers: the
port's ``ArkWriter`` writes the golden bytes of tests/test_ark.py, and the
likelihood ark its decoder hands to ``latgen-faster-mapped`` passes the
strict Kaldi consumer (``tfkaldi_tpu.io.kaldi_compat`` on
native/kaldi_consumer.cpp), as in tests/test_ark.py::test_copy_feats_interop.
The test imports the JAX package's consumer; the port itself does not."""

import struct

import numpy as np
import pytest

from tfkaldi_tpu.io import kaldi_compat
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.convert import dnn_from_jax
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.decode.decoder import Decoder
from tfkaldi_tpu_torch.io import ArkReader, ArkWriter
from tfkaldi_tpu_torch.models import DNN, DNNConfig


def test_ark_golden_bytes(tmp_path):
    """'key ' + \\0BFM + \\x04+rows + \\x04+cols + row-major float32, the scp
    offset at the post-key \\0 (tests/test_ark.py::test_ark_golden_bytes)."""
    mat = np.array([[1.5, -2.0], [0.25, 4.0], [0.0, -0.5]], dtype=np.float32)
    with ArkWriter(str(tmp_path / "g.scp"), str(tmp_path / "g.ark")) as w:
        w.write_next_utt("utt1", mat)
    raw = open(tmp_path / "g.ark", "rb").read()
    assert raw == b"utt1 " + b"\x00BFM " + struct.pack("<bi", 4, 3) + struct.pack("<bi", 4, 2) + mat.tobytes()
    path, offset = open(tmp_path / "g.scp").read().strip().split(" ")[1].rsplit(":", 1)
    assert int(offset) == len(b"utt1 ")  # the offset points at the \x00


@pytest.fixture
def likelihood_ark(tmp_path):
    """The port's likelihood ark of a seeded batchnorm DNN over a small
    featdir (12 utterances of 20-60 frames, ±1 splice), through the same
    ``Decoder.decode_to_writer`` that ``test_nnet`` runs."""
    from tests.synthetic import make_featdir

    featdir, _, info = make_featdir(tmp_path)
    input_dim = info["feat_dim"] * 3
    params, state = synthetic.random_dnn_pytree(input_dim, 16, 2, 7, seed=3)
    model = DNN(DNNConfig(input_dim=input_dim, num_labels=7, num_hidden_layers=2, num_hidden_units=16,
                          batch_norm=True))
    model.load_state_dict(dnn_from_jax(params, state))
    reader = FeatureReader(f"{featdir}/feats.scp", f"{featdir}/cmvn.scp", f"{featdir}/utt2spk", 1, 60)
    scp, ark = str(tmp_path / "likes.scp"), str(tmp_path / "likes.ark")
    with ArkWriter(scp, ark) as writer:
        count = Decoder(model, np.full(7, 1 / 7, np.float32)).decode_to_writer(reader, writer, batch_size=4)
    reader.close()
    assert count == 12
    with ArkReader(scp) as back:
        return scp, ark, {utt: m for utt, m in back}


def test_likelihood_ark_passes_the_strict_consumer(likelihood_ark, tmp_path):
    """Every record reads back sequentially and at its scp offset with the
    same bytes; ``copy-feats`` through the consumer gives the same matrices."""
    if not kaldi_compat.available():
        pytest.fail("the native Kaldi consumer is not available")
    scp, ark, mats = likelihood_ark
    assert kaldi_compat.validate_archive(scp) == len(mats) == kaldi_compat.count(ark)
    for i, (utt, mat) in enumerate(mats.items()):
        key, got = kaldi_compat.seq_read(ark, i)
        assert key == utt and got.dtype == np.float32
        np.testing.assert_array_equal(got, mat)
        assert np.isfinite(got).all() and got.shape[1] == 7
    out_ark, out_scp = str(tmp_path / "copied.ark"), str(tmp_path / "copied.scp")
    assert kaldi_compat.copy_feats(ark, out_ark, out_scp) == len(mats)
    with ArkReader(out_scp) as copied:
        for utt, mat in copied:
            np.testing.assert_array_equal(mat, mats[utt])

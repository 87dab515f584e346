"""The port's serving slice end to end vs the JAX package, on the CPU.

A tiny synthetic Kaldi data dir (6 wavs of 0.5-2 s, 2 speakers) and one
seeded 440 -> 2x64 -> 30 batchnorm DNN. The JAX side runs ``prepare_data``
+ ``compute_cmvn`` + ``Decoder.decode_to_writer``; the port runs
``cli.main --steps dnn_test_features,test_nnet --device cpu`` and
``cli.serve --once --device cpu`` on a spool job. Utterance ids, order and
shapes must be identical; ``feats.ark`` agrees to 1e-6 in the repo's
``err / max(|ref|, 1)`` (both sides are f64 cast to f32) and
``likelihoods.ark`` to 1e-4 (f32 sums in another order, on features that
may differ by an f32 ulp).
"""

import ast
import glob
import os
import shutil
import subprocess
import sys
from configparser import ConfigParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfkaldi_tpu.data.feature_reader import FeatureReader as JaxFeatureReader
from tfkaldi_tpu.decode import streaming as jax_streaming
from tfkaldi_tpu.decode.decoder import Decoder as JaxDecoder
from tfkaldi_tpu.frontend.prepare_data import compute_cmvn as jax_compute_cmvn
from tfkaldi_tpu.frontend.prepare_data import prepare_data as jax_prepare_data
from tfkaldi_tpu.io import ArkReader, ArkWriter
from tfkaldi_tpu.models.dnn import DNN as JaxDNN
from tfkaldi_tpu.models.dnn import DNNConfig as JaxDNNConfig
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.cli import serve as cli_serve
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.decode import streaming

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_PDFS, HIDDEN, LAYERS = 30, 64, 2


def _read(scp):
    with ArkReader(scp) as reader:
        return [(utt, mat) for utt, mat in reader]


def _rel_err(got, ref):
    return float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)))


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice"))
    cfg_path = synthetic.write_config(
        root, num_pdfs=NUM_PDFS,
        nnet={"num_hidden_units": HIDDEN, "num_hidden_layers": LAYERS},
    )
    config = ConfigParser()
    config.read(cfg_path)
    # one corpus serves as both train and test: test_nnet reads the input
    # dim from the train featdir
    for key in ("train_data", "train_features"):
        config.set("directories", key, config.get("directories", key.replace("train", "test")))
    with open(cfg_path, "w") as f:
        config.write(f)
    datadir = config.get("directories", "test_data")
    synthetic.make_wav_datadir(datadir, num_speakers=2, utts_per_speaker=3,
                               min_seconds=0.5, max_seconds=2.0, seed=0)
    context = config.getint("nnet", "context_width")
    input_dim = config.getint("dnn-features", "nfilt") * (2 * context + 1)
    params, state = synthetic.random_dnn_pytree(input_dim, HIDDEN, LAYERS, NUM_PDFS, seed=1)
    savedir = os.path.join(config.get("directories", "expdir"), config.get("nnet", "name"))
    synthetic.write_checkpoint(savedir, params, state, seed=2)

    # the port: features + likelihoods through the CLI, then the service
    assert cli_main.main(["--config", cfg_path, "--steps", "dnn_test_features,test_nnet",
                          "--device", "cpu"]) == 0
    featdir = os.path.join(config.get("directories", "test_features"),
                           config.get("dnn-features", "name"))
    spool_in, spool_out = os.path.join(root, "spool", "in"), os.path.join(root, "spool", "out")
    shutil.copytree(featdir, os.path.join(spool_in, "job0"))
    assert cli_serve.main(["--config", cfg_path, "--watch", spool_in, "--out", spool_out,
                           "--once", "--device", "cpu"]) == 0

    # the JAX package on the same wavs and weights
    jax_featdir = os.path.join(root, "jax_features")
    feat_conf = dict(config.items("dnn-features"))
    jax_prepare_data(datadir, jax_featdir, feat_conf, feat_conf["type"], feat_conf["dynamic"])
    jax_compute_cmvn(jax_featdir)
    model = JaxDNN(JaxDNNConfig(input_dim=input_dim, num_labels=NUM_PDFS, num_hidden_layers=LAYERS,
                                num_hidden_units=HIDDEN, batch_norm=True))
    decoder = JaxDecoder(model, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                         np.load(os.path.join(savedir, "prior.npy")))
    reader = JaxFeatureReader(os.path.join(jax_featdir, "feats.scp"),
                              os.path.join(jax_featdir, "cmvn.scp"),
                              os.path.join(jax_featdir, "utt2spk"), context, 0)
    jax_likes = os.path.join(root, "jax_decode", "feats.scp")
    with ArkWriter(jax_likes, os.path.join(root, "jax_decode", "likelihoods.ark")) as writer:
        assert decoder.decode_to_writer(reader, writer, batch_size=16) == 6
    return {
        "feats": (os.path.join(featdir, "feats.scp"), os.path.join(jax_featdir, "feats.scp")),
        "cmvn": (os.path.join(featdir, "cmvn.scp"), os.path.join(jax_featdir, "cmvn.scp")),
        "test_nnet": (os.path.join(savedir, "decode", "feats.scp"), jax_likes),
        "serve": (os.path.join(spool_out, "job0", "feats.scp"), jax_likes),
        "done": os.path.join(spool_out, "job0", "DONE"),
        "cfg": cfg_path,
        "featdir": featdir,
        "context": context,
    }


@pytest.mark.parametrize("what,tol", [("feats", 1e-6), ("cmvn", 1e-6), ("test_nnet", 1e-4), ("serve", 1e-4)])
def test_arks_match_jax(slice_run, what, tol):
    port, ref = (_read(p) for p in slice_run[what])
    assert [u for u, _ in port] == [u for u, _ in ref]
    assert len(port) == (2 if what == "cmvn" else 6)
    for (utt, got), (_, want) in zip(port, ref):
        assert got.shape == want.shape, utt
        assert np.isfinite(got).all()
        if what in ("feats", "cmvn"):
            assert _rel_err(got, want) <= tol, utt
        else:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=utt)


def test_decode_streams_are_byte_identical(slice_run):
    """The port's Python and native decode streams, and the JAX package's
    Python stream, give the same batches byte for byte."""
    from tfkaldi_tpu_torch.io import native

    assert native.available()
    featdir, context = slice_run["featdir"], slice_run["context"]

    def reader(cls):
        return cls(os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"),
                   os.path.join(featdir, "utt2spk"), context, 0)

    kw = dict(batch_size=4, bucket_multiple=128)
    streams = [
        list(streaming.stream_padded_batches(reader(FeatureReader), **kw)),
        list(streaming.stream_padded_batches_native(reader(FeatureReader), **kw)),
        list(jax_streaming.stream_padded_batches(reader(JaxFeatureReader), **kw)),
    ]
    assert [len(s) for s in streams] == [2, 2, 2]
    for batches in streams[1:]:
        for (ids, x, n), (ids0, x0, n0) in zip(batches, streams[0]):
            assert ids == ids0
            assert x.dtype == x0.dtype and x.shape == x0.shape and x.tobytes() == x0.tobytes()
            np.testing.assert_array_equal(n, n0)


def test_service_marks_job_done(slice_run):
    with open(slice_run["done"]) as f:
        assert f.read().strip() == "6"


def test_unported_steps_and_flags_name_the_jax_entry_point(slice_run):
    # every step of the JAX pipeline is in the port (tests/test_torch_cli_full_pipeline.py runs them
    # all); a step the pipeline does not have is refused before anything runs
    assert cli_main.main(["--config", slice_run["cfg"], "--steps", "train_mono,no_such_step", "--device", "cpu"]) == 1
    # --stream is ported; the hybrid recipe has no streaming transcriber, as in the JAX package
    with pytest.raises(ValueError, match="no streaming transcriber"):
        cli_serve.main(["--config", slice_run["cfg"], "--stream", "--device", "cpu"])


def test_default_device_without_card_raises(slice_run):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card error path is not reachable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_main.main(["--config", slice_run["cfg"], "--steps", "dnn_test_features"])


def test_port_imports_without_jax():
    """The port must not import JAX nor any module of the JAX package (run
    in a subprocess: this test process has JAX loaded by tests/conftest.py).
    The processes the port starts as ranks are held to the same rule by
    tests/test_torch_distributed_cli.py and tests/test_torch_dryrun.py,
    which run them with ``jax`` and ``tfkaldi_tpu`` blocked."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import tfkaldi_tpu_torch.cli.main, tfkaldi_tpu_torch.cli.serve, "
            "tfkaldi_tpu_torch.synthetic, tfkaldi_tpu_torch.profile_serve, "
            "tfkaldi_tpu_torch.nnet, tfkaldi_tpu_torch.train, tfkaldi_tpu_torch.convert, "
            "tfkaldi_tpu_torch.models.rnn, tfkaldi_tpu_torch.models.transformer, tfkaldi_tpu_torch.models.seq2seq, "
            "tfkaldi_tpu_torch.decode.seq2seq, tfkaldi_tpu_torch.ops.lstm_bidi, tfkaldi_tpu_torch.ops.gru_bidi, "
            "tfkaldi_tpu_torch.ops.rnn_bidi, tfkaldi_tpu_torch.train.ctc, tfkaldi_tpu_torch.decode.ctc, "
            "tfkaldi_tpu_torch.decode.ctc_beam, tfkaldi_tpu_torch.decode.native_beam, "
            "tfkaldi_tpu_torch.utils.wer, tfkaldi_tpu_torch.data.dispenser, tfkaldi_tpu_torch.ops.rnnt_loss, "
            "tfkaldi_tpu_torch.models.transducer, tfkaldi_tpu_torch.decode.transducer, "
            "tfkaldi_tpu_torch.decode.transducer_beam, tfkaldi_tpu_torch.models.tdnn, tfkaldi_tpu_torch.models.cnn, "
            "tfkaldi_tpu_torch.kaldi, tfkaldi_tpu_torch.kaldi.gmm, tfkaldi_tpu_torch.kaldi.decode_wfst, "
            "tfkaldi_tpu_torch.decode.lm, tfkaldi_tpu_torch.serve, tfkaldi_tpu_torch.frontend.online, "
            "tfkaldi_tpu_torch.decode.online, tfkaldi_tpu_torch.decode.endpoint, tfkaldi_tpu_torch.decode.words, "
            "tfkaldi_tpu_torch.frontend.perturb, tfkaldi_tpu_torch.frontend.sigproc, "
            "tfkaldi_tpu_torch.frontend.functional, tfkaldi_tpu_torch.frontend, tfkaldi_tpu_torch.decode, "
            "tfkaldi_tpu_torch.data.bulk_loader, tfkaldi_tpu_torch.utils.tb_events, "
            "tfkaldi_tpu_torch.utils.visualize, tfkaldi_tpu_torch.utils.profiling, "
            "tfkaldi_tpu_torch.io.kaldi_compat, tfkaldi_tpu_torch.parallel, tfkaldi_tpu_torch.parallel.mesh, "
            "tfkaldi_tpu_torch.parallel.multihost, tfkaldi_tpu_torch.parallel.comm, "
            "tfkaldi_tpu_torch.parallel.dryrun, tfkaldi_tpu_torch.data.sharding, tfkaldi_tpu_torch.heldout; "
            "print(' '.join(m for m in sys.modules if m.split('.')[0] == 'tfkaldi_tpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == []


def _imported_modules(path):
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


_PORT_SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, files in os.walk(os.path.join(ROOT, "tfkaldi_tpu_torch"))
    for f in files if f.endswith(".py")
) + ["chip_smoke.py", os.path.join("tests", "card_support.py")] + sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "tests", "test_torch_cuda_*.py")))


@pytest.mark.parametrize("path", _PORT_SOURCES)
def test_only_port_io_module_imports_jax_package(path):
    """No source file of the port, not chip_smoke.py and no card test file
    (``tests/test_torch_cuda_*.py`` and the ``tests/card_support.py`` they
    share, run with ``--noconftest`` where JAX is absent) imports JAX or any
    module of the JAX package."""
    reached = [m for m in _imported_modules(path) if m.split(".")[0] in ("jax", "tfkaldi_tpu")]
    assert reached == []
    if path == "chip_smoke.py":  # the walk covers the model families and the Kaldi layer too
        for module in ("models/tdnn.py", "models/cnn.py", "kaldi/__init__.py", "kaldi/gmm.py",
                       "kaldi/decode_wfst.py", "frontend/perturb.py", "frontend/sigproc.py",
                       "frontend/functional.py", "frontend/online.py", "decode/online.py",
                       "parallel/__init__.py", "parallel/mesh.py", "parallel/multihost.py", "parallel/comm.py",
                       "parallel/dryrun.py", "data/sharding.py"):
            assert os.path.join("tfkaldi_tpu_torch", module) in _PORT_SOURCES, module

"""The port's native bulk training loaders against the JAX package's and
against the port's Python dispensers, on the CPU (the cases of
tests/test_bulk_loader.py).

Every comparison is byte for byte (tolerance 0): the native CMVN + splice
performs the same f32 operations in the same order as the numpy path, and
the targets are integers. The controller's losses on the two loaders are
compared bit for bit.
"""

import gzip
import logging
import os
from configparser import ConfigParser

import numpy as np
import pytest
import torch

from tests.synthetic import cmvn_stats_f32, make_featdir
from tfkaldi_tpu.data import TextCoder as JaxTextCoder
from tfkaldi_tpu.data.bulk_loader import BulkAlignmentBatchSource as JaxBulkAlignment
from tfkaldi_tpu.data.bulk_loader import BulkTextBatchSource as JaxBulkText
from tfkaldi_tpu.data.target_normalizers import aurora4_normalizer as jax_aurora4
from tfkaldi_tpu.io import read_alignments as jax_read_alignments
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.data import bulk_loader
from tfkaldi_tpu_torch.data.batching import DeviceBatcher
from tfkaldi_tpu_torch.data.bulk_loader import BulkAlignmentBatchSource, BulkTextBatchSource
from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser, TextBatchDispenser
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder, TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer, identity_normalizer
from tfkaldi_tpu_torch.io import ArkWriter, native, read_alignments
from tfkaldi_tpu_torch.models import DNNConfig, RNNConfig
from tfkaldi_tpu_torch.train import NnetTrainOptions, Trainer, TrainerConfig, TrainingController

WORDS = ["HELLO WORLD", "SPEECH", "ON TPU", "A B C", "KALDI", "ARK IO"]
# get / skip / return / split interleaved, wrapping around the corpus
CURSOR_OPS = ["get", "get", "split", "get", "skip", "get", "return", "return", "get", "get", "get", "get"]


@pytest.fixture(autouse=True)
def _native():
    if not native.available():
        pytest.fail("the port's native ark loader did not build")


def _paths(featdir):
    return f"{featdir}/feats.scp", f"{featdir}/cmvn.scp", f"{featdir}/utt2spk"


def _write_text(featdir, utts):
    textfile = os.path.join(featdir, "text")
    with open(textfile, "w") as f:
        for i, utt in enumerate(utts):
            f.write(f"{utt} {WORDS[i % len(WORDS)]}\n")
    return textfile


def _sources(tmp_path, kind, context, batch=4, bucket=16, **featdir_kw):
    """(port bulk, JAX bulk, port Python dispenser) on one featdir."""
    featdir, alifile, info = make_featdir(tmp_path, num_speakers=2, utts_per_speaker=6, **featdir_kw)
    scp, cmvn, utt2spk = _paths(featdir)
    python_reader = FeatureReader(scp, cmvn, utt2spk, context, 60)
    if kind == "alignment":
        port = BulkAlignmentBatchSource(scp, cmvn, utt2spk, context, read_alignments(alifile), batch,
                                        bucket_multiple=bucket, num_labels=info["num_labels"])
        jax = JaxBulkAlignment(scp, cmvn, utt2spk, context, jax_read_alignments(alifile), batch,
                               bucket_multiple=bucket, num_labels=info["num_labels"])
        python = AlignmentBatchDispenser(python_reader, AlignmentCoder(identity_normalizer, info["num_labels"]),
                                         batch, alifile)
    else:
        textfile = _write_text(featdir, info["utts"])
        port = BulkTextBatchSource(scp, cmvn, utt2spk, context, TextCoder(aurora4_normalizer), textfile, batch,
                                   bucket_multiple=bucket)
        jax = JaxBulkText(scp, cmvn, utt2spk, context, JaxTextCoder(jax_aurora4), textfile, batch,
                          bucket_multiple=bucket)
        python = TextBatchDispenser(python_reader, TextCoder(aurora4_normalizer), batch, textfile)
    return port, jax, python, DeviceBatcher(bucket_multiple=bucket)


def _same(got, want):
    for name in ("inputs", "targets", "input_lengths", "target_lengths"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind,context", [("alignment", 2), ("text", 0), ("text", 2)])
def test_cursor_stream_matches_jax_and_python(tmp_path, kind, context):
    """The port's bulk source, the JAX package's and the port's Python
    dispenser + batcher serve the same batches through get / skip / return /
    split (resume fast-forward and validation rewind), the text source also
    with a spliced context."""
    port, jax, python, batcher = _sources(tmp_path, kind, context)
    assert port.num_utt == jax.num_utt == python.num_utt == 12
    assert port.max_target_length == jax.max_target_length == python.max_target_length
    before = dict(bulk_loader.batches)
    gets = 0
    for op in CURSOR_OPS:
        if op == "get":
            got = port.get_padded_batch(batcher)
            _same(got, jax.get_padded_batch(batcher))
            _same(got, python.get_padded_batch(batcher))
            gets += 1
        else:
            for source in (port, jax, python):
                getattr(source, {"skip": "skip_batch", "return": "return_batch", "split": "split"}[op])()
            assert port.num_utt == jax.num_utt == python.num_utt
    assert bulk_loader.batches[kind] - before[kind] == gets


@pytest.mark.parametrize("kind", ["alignment", "text"])
def test_get_padded_batch_honours_the_batcher(tmp_path, kind):
    """Pinned input (and target) lengths of the batcher, as the Python
    dispenser pads them."""
    port, jax, python, _ = _sources(tmp_path, kind, 1)
    fixed = DeviceBatcher(fixed_input_length=64, fixed_target_length=64 if kind == "alignment" else 32)
    got = port.get_padded_batch(fixed)
    assert got.inputs.shape[1] == 64 and got.targets.shape[1] == fixed.fixed_target_length
    _same(got, jax.get_padded_batch(fixed))
    _same(got, python.get_padded_batch(fixed))
    with pytest.raises(ValueError, match="longer than fixed"):
        port.get_padded_batch(DeviceBatcher(fixed_input_length=8))


@pytest.mark.parametrize("kind", ["alignment", "text"])
def test_prior_counts_match(tmp_path, kind):
    port, jax, python, _ = _sources(tmp_path, kind, 1)
    counts = port.compute_target_count()
    np.testing.assert_array_equal(counts, jax.compute_target_count())
    np.testing.assert_array_equal(counts, python.compute_target_count())
    assert port.num_labels == python.num_labels


def test_prior_sized_by_num_labels(tmp_path):
    """A label that never occurs still gets its prior slot."""
    featdir, alifile, info = make_featdir(tmp_path)
    alignments = {u: np.minimum(a, info["num_labels"] - 2) for u, a in read_alignments(alifile).items()}
    src = BulkAlignmentBatchSource(*_paths(featdir), 1, alignments, 4, num_labels=info["num_labels"])
    counts = src.compute_target_count()
    assert counts.shape == (info["num_labels"],) and counts[-1] == 0


def test_no_cmvn_identity(tmp_path):
    """``cmvnfile=None`` (``apply_cmvn = False``): raw spliced features,
    bit-exact against the Python reader without CMVN and the JAX source."""
    featdir, alifile, info = make_featdir(tmp_path, num_speakers=2, utts_per_speaker=6)
    scp, _, utt2spk = _paths(featdir)
    port = BulkAlignmentBatchSource(scp, None, utt2spk, 2, read_alignments(alifile), 4)
    jax = JaxBulkAlignment(scp, None, utt2spk, 2, jax_read_alignments(alifile), 4)
    python = AlignmentBatchDispenser(FeatureReader(scp, None, utt2spk, 2, 60),
                                     AlignmentCoder(identity_normalizer, info["num_labels"]), 4, alifile)
    batcher = DeviceBatcher(bucket_multiple=16)
    for _ in range(2):
        got = port.get_batch(bucket_multiple=16)
        _same(got, jax.get_batch(bucket_multiple=16))
        _same(got, python.get_padded_batch(batcher))


def test_multi_ark_scp(tmp_path):
    """One native call per ark file of a batch (per-job arks of a Kaldi
    data dir) gives the batch of the Python path and of the JAX source."""
    rng = np.random.default_rng(0)
    num_labels, dim = 6, 5
    utts = {f"utt{i}": rng.standard_normal((20 + i, dim)).astype(np.float32) for i in range(8)}
    with open(tmp_path / "feats.scp", "w") as scp:
        for half, names in enumerate([list(utts)[:4], list(utts)[4:]]):
            with ArkWriter(str(tmp_path / f"part{half}.scp"), str(tmp_path / f"feats.{half}.ark")) as w:
                for u in names:
                    w.write_next_utt(u, utts[u])
            scp.write(open(tmp_path / f"part{half}.scp").read())
    with ArkWriter(str(tmp_path / "cmvn.scp"), str(tmp_path / "cmvn.ark")) as w:
        w.write_next_utt("spk", cmvn_stats_f32(np.concatenate(list(utts.values()))))
    with open(tmp_path / "utt2spk", "w") as f:
        f.writelines(f"{u} spk\n" for u in utts)
    alignments = {u: rng.integers(0, num_labels, m.shape[0]).astype(np.int32) for u, m in utts.items()}
    with gzip.open(tmp_path / "ali.gz", "wt") as f:
        for u, a in alignments.items():
            f.write(u + " " + " ".join(map(str, a)) + "\n")
    paths = _paths(tmp_path)
    port = BulkAlignmentBatchSource(*paths, 1, alignments, 8, num_labels=num_labels)
    jax = JaxBulkAlignment(*paths, 1, alignments, 8, num_labels=num_labels)
    python = AlignmentBatchDispenser(FeatureReader(*paths, 1, 60), AlignmentCoder(identity_normalizer, num_labels),
                                     8, str(tmp_path / "ali.gz"))
    batcher = DeviceBatcher(bucket_multiple=128)
    got = port.get_padded_batch(batcher)
    assert got.inputs.shape[0] == 8
    _same(got, jax.get_padded_batch(batcher))
    _same(got, python.get_padded_batch(batcher))


def test_errors_match_the_jax_source(tmp_path):
    """Out-of-range labels, no usable utterance, and an alignment whose
    length is not the frame count are refused as the JAX source refuses
    them; too-short utterances are skipped with a warning."""
    featdir, alifile, info = make_featdir(tmp_path, min_frames=3, max_frames=30)
    paths = _paths(featdir)
    alignments = read_alignments(alifile)
    bad = dict(alignments)
    first = next(iter(bad))
    bad[first] = bad[first] + info["num_labels"]
    for cls in (BulkAlignmentBatchSource, JaxBulkAlignment):
        with pytest.raises(ValueError, match="outside"):
            cls(*paths, 1, bad, 4, num_labels=info["num_labels"])
    # context 30 needs 61 frames: nothing is long enough to splice
    for cls in (BulkAlignmentBatchSource, JaxBulkAlignment):
        src = cls(*paths, 30, alignments, 4)
        assert src.num_utt == len(alignments)
        with pytest.raises(RuntimeError, match="no usable utterances"):
            src.get_batch()
    # one alignment a frame short of its features
    short = {u: (a[:-1] if u == first else a) for u, a in alignments.items()}
    for cls in (BulkAlignmentBatchSource, JaxBulkAlignment):
        src = cls(*paths, 1, short, len(short))
        with pytest.raises(ValueError, match="alignment length"):
            src.get_batch()
    # the multi-process protocol: max_input_length only when given, num_batches capped by agreement
    src = BulkAlignmentBatchSource(*paths, 1, alignments, 4)
    with pytest.raises(AttributeError, match="max_input_length"):
        src.max_input_length
    src.limit_num_batches(2.5)
    assert src.num_batches == 2.5 and BulkAlignmentBatchSource(*paths, 1, alignments, 4,
                                                                max_input_length=30).max_input_length == 30
    # context 2 needs 5 frames: min_frames 3 leaves some too short; both skip the same
    port = BulkAlignmentBatchSource(*paths, 2, alignments, 4)
    jax = JaxBulkAlignment(*paths, 2, alignments, 4)
    assert [e[0] for e in port._entries] == [e[0] for e in jax._entries]
    for _ in range(3):
        _same(port.get_batch(), jax.get_batch())


def _controller_run(base, kind, loader):
    """Losses and final parameters of the port's controller trained on one
    loader, with a validation rollback (lr 20 for the DNN) firing."""
    featdir, alifile, info = make_featdir(base, num_speakers=2, utts_per_speaker=8, feat_dim=6, num_labels=5)
    paths = _paths(featdir)
    if kind == "alignment":
        source = (BulkAlignmentBatchSource(*paths, 1, read_alignments(alifile), 4, num_labels=5,
                                           max_input_length=60)
                  if loader == "native" else
                  AlignmentBatchDispenser(FeatureReader(*paths, 1, 60), AlignmentCoder(identity_normalizer, 5),
                                          4, alifile))
        model = DNNConfig(input_dim=18, num_labels=5, num_hidden_layers=2, num_hidden_units=8)
        tcfg = dict(init_learning_rate=20.0, micro_batches=2)
    else:
        textfile = _write_text(featdir, info["utts"])
        coder = TextCoder(aurora4_normalizer)
        source = (BulkTextBatchSource(*paths, 0, coder, textfile, 4, max_input_length=60)
                  if loader == "native" else
                  TextBatchDispenser(FeatureReader(*paths, 0, 60), coder, 4, textfile))
        model = RNNConfig(input_dim=6, num_labels=coder.num_labels + 1, num_layers=1, hidden_units=8,
                          bidirectional=True)
        tcfg = dict(init_learning_rate=0.05, loss_type="ctc", ctc_blank_id=coder.num_labels)
    trainer = Trainer(model, TrainerConfig(num_steps=int(source.num_batches * 2), **tcfg), device="cpu")
    opts = NnetTrainOptions(savedir=str(base / "save"), num_epochs=2, batch_size=4, valid_batches=1,
                            valid_frequency=2, valid_adapt=True, valid_retries=1, check_freq=2)
    losses = []
    controller = TrainingController(trainer, source, DeviceBatcher(bucket_multiple=16), opts,
                                    metrics_hook=lambda loss, **kw: losses.append(loss))
    state = controller.train()
    return losses, [p.detach().clone() for p in state.model.parameters()], state.lr_fact


@pytest.mark.parametrize("kind", ["alignment", "text"])
def test_controller_losses_bit_identical_on_both_loaders(tmp_path, kind):
    """The port's controller gives the same losses and final parameters,
    bit for bit, on the bulk source and on the Python dispenser."""
    (tmp_path / "python").mkdir()
    (tmp_path / "native").mkdir()
    py_losses, py_params, py_fact = _controller_run(tmp_path / "python", kind, "python")
    nat_losses, nat_params, nat_fact = _controller_run(tmp_path / "native", kind, "native")
    assert py_losses == nat_losses and len(py_losses) > 2
    assert py_fact == nat_fact
    if kind == "alignment":
        assert nat_fact < 1.0  # a rollback rewound the bulk source
    for a, b in zip(py_params, nat_params):
        assert torch.equal(a, b)


class _CapturingNnet:
    context_width = 1

    def train(self, dispenser):
        self.dispenser = dispenser


def _train_nnet_config(tmp_path, kind, native_loader):
    featdir, alifile, info = make_featdir(tmp_path)
    os.makedirs(tmp_path / "exp" / "gmm" / "ali")
    os.replace(alifile, tmp_path / "exp" / "gmm" / "ali" / "pdf.all.gz")
    if kind == "text":
        _write_text(featdir, info["utts"])
    config = ConfigParser()
    config["general"] = {"num_jobs": "1"}
    config["directories"] = {"train_features": str(tmp_path), "expdir": str(tmp_path / "exp")}
    config["dnn-features"] = {"name": os.path.basename(featdir)}
    config["nnet"] = {"starting_step": "0", "valid_batches": "1", "batch_size": "4", "gmm_name": "gmm",
                      **({} if native_loader is None else {"native_loader": native_loader})}
    return config, info


@pytest.mark.parametrize("kind", ["alignment", "text"])
@pytest.mark.parametrize("native_loader,available,want", [
    (None, True, "bulk"), ("True", True, "bulk"), ("False", True, "python"), (None, False, "python"),
])
def test_train_nnet_picks_the_loader(tmp_path, monkeypatch, caplog, kind, native_loader, available, want):
    """``cli.main``'s ``train_nnet`` takes the bulk source unless ``[nnet]
    native_loader = False`` or the native library does not load, and logs
    the JAX CLI's lines (tfkaldi_tpu/cli/main.py:299-365)."""
    config, info = _train_nnet_config(tmp_path, kind, native_loader)
    monkeypatch.setattr(native, "available", lambda: available)
    nnet = _CapturingNnet()
    with caplog.at_level(logging.INFO, logger="tfkaldi_tpu_torch"):
        cli_main.train_nnet(config, nnet, TextCoder(aurora4_normalizer) if kind == "text" else None,
                            info["num_labels"])
    classes = {("alignment", "bulk"): BulkAlignmentBatchSource, ("text", "bulk"): BulkTextBatchSource,
               ("alignment", "python"): AlignmentBatchDispenser, ("text", "python"): TextBatchDispenser}
    assert type(nnet.dispenser) is classes[kind, want]
    line = "using native bulk data loader" if want == "bulk" else "using Python data loader"
    assert any(r.getMessage().startswith(line) for r in caplog.records)
    assert nnet.dispenser.num_utt == 12

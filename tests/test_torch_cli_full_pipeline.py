"""The port's whole ``cli.main`` on the CPU, wav to WER, against the JAX
CLI on the same workspace (tests/test_cli_full_pipeline.py's pipeline):
features → (stub) GMM train, align and test → DNN training → likelihood
emission → (stub) WFST decode → best WER. Every external-Kaldi boundary
runs through real subprocesses against the stub egs of
``tfkaldi_tpu_torch.synthetic.write_stub_kaldi``, which record what they
were handed; the stubs are deterministic, so what the two CLIs leave there
must be equal."""

import glob
import gzip
import logging
import os
import shutil
from configparser import ConfigParser

import numpy as np
import pytest
import torch

from tfkaldi_tpu.cli import main as jax_cli
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.io import ArkReader

NUM_PDFS = 6
NNET = {"num_hidden_units": 16, "num_hidden_layers": 2, "batch_size": 3, "valid_batches": 1, "num_epochs": 2,
        "valid_frequency": 4, "check_freq": 4, "valid_retries": 1, "valid_adapt": "False",
        "initial_learning_rate": 0.005}


@pytest.fixture
def workspace(tmp_path, monkeypatch):
    """``config_AURORA4.cfg`` under ``tmp_path`` at a small width, 2 jobs,
    train and test sets of 6 wavs of 0.4-0.75 s over 2 speakers, and the
    stub egs; its ``fakebin/`` on PATH (``ali-to-pdf`` runs outside
    ``run.pl``)."""
    cfg_path = synthetic.write_config(str(tmp_path), num_pdfs=NUM_PDFS, nnet=NNET)
    config = ConfigParser()
    config.read(cfg_path)
    config.set("general", "num_jobs", "2")
    with open(cfg_path, "w") as f:
        config.write(f)
    for kind, seed in (("train", 1), ("test", 2)):
        synthetic.make_wav_datadir(config.get("directories", f"{kind}_data"), num_speakers=2, utts_per_speaker=3,
                                   min_seconds=0.4, max_seconds=0.75, seed=seed)
    monkeypatch.setenv("PATH", os.path.join(config.get("directories", "kaldi_egs"), "fakebin") + ":"
                       + os.environ["PATH"])
    return tmp_path, cfg_path, config


def _outputs(config) -> dict[str, bytes]:
    """What the pipeline left at the Kaldi boundary: the GMM expdirs (models,
    graphs, per-job pdf alignments, decode logs and scores), the merged
    training alignment and the hybrid decode dir's stub outputs (decode
    logs, lattices, job count, scores, the split scp), gzip files
    decompressed (their headers hold a time stamp)."""
    expdir = config.get("directories", "expdir")
    savedir = os.path.join(expdir, config.get("nnet", "name"))
    files = {}
    for gmm in ("mono_gmm", "tri_gmm", "lda_mllt_gmm"):
        files.update({p: None for p in glob.glob(os.path.join(expdir, gmm, "**", "*"), recursive=True)})
    decodedir = os.path.join(savedir, "decode")
    for pattern in ("kaldi_decode/**/*", "split*/**/*", "final.mdl", "graph/*", "text", "utt2spk"):
        files.update({p: None for p in glob.glob(os.path.join(decodedir, pattern), recursive=True)})
    out = {}
    for path in sorted(files):
        if os.path.isfile(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                out[os.path.relpath(path, expdir)] = f.read()
    return out


def _best_wer(caplog) -> list[str]:
    return [r.getMessage() for r in caplog.records if r.getMessage().startswith("best WER")]


def test_steps_all_wav_to_wer_matches_the_jax_cli(workspace, caplog):
    root, cfg_path, config = workspace
    caplog.set_level(logging.INFO)
    assert jax_cli.main(["--config", cfg_path, "--steps", "all"]) == 0
    jax_outputs, jax_wer = _outputs(config), _best_wer(caplog)
    # start again from the corpus and the config
    for key in ("expdir", "train_features", "test_features"):
        shutil.rmtree(config.get("directories", key))
    caplog.clear()

    assert cli_main.main(["--config", cfg_path, "--steps", "all", "--device", "cpu"]) == 0
    expdir = root / "expdir"
    # features of both kinds, both sets
    for kind in ("train", "test"):
        for name in ("13mfcc", "40fbank"):
            assert (root / f"{kind}_features" / name / "feats.scp").is_file(), (kind, name)
    # the whole mono -> tri -> lda chain, each trained, aligned and tested
    for gmm in ("mono_gmm", "tri_gmm", "lda_mllt_gmm"):
        assert (expdir / gmm / "final.mdl").is_file(), gmm
        assert (expdir / gmm / "ali" / "pdf.2.gz").is_file(), gmm
        assert (expdir / gmm / "decode" / "wer_10").is_file(), gmm
    # trained on the lda GMM's merged alignment: pdf ids of the stub's 6 pdfs
    with gzip.open(expdir / "lda_mllt_gmm" / "ali" / "pdf.all.gz", "rt") as f:
        ali = {line.split()[0]: np.asarray(line.split()[1:], int) for line in f}
    assert len(ali) == 6 and all(0 <= a.min() and a.max() < NUM_PDFS for a in ali.values())
    savedir = expdir / config.get("nnet", "name")
    assert (savedir / "final.pt").is_file()
    np.testing.assert_allclose(np.load(savedir / "prior.npy").sum(), 1.0, rtol=1e-5)
    decodedir = savedir / "decode"
    with ArkReader(str(decodedir / "feats.scp")) as reader:
        likes = {utt: m for utt, m in reader}
    assert len(likes) == 6 and all(m.shape[1] == NUM_PDFS and np.isfinite(m).all() for m in likes.values())
    # the WFST decode got the decode dir's split scp, the graph and the reference acoustic scale
    log1 = (decodedir / "kaldi_decode" / "log" / "decode.1.log").read_text()
    assert f"{decodedir}/split2/1/feats.scp (6 utterances)" in log1
    assert f"{decodedir}/graph/HCLG.fst" in log1 and "--acoustic-scale=0.1" in log1
    assert _best_wer(caplog) == [f"best WER: {synthetic.STUB_WERS['wer_10']} [wer_10]"]

    # what the port left at the Kaldi boundary is what the JAX CLI left
    outputs = _outputs(config)
    assert sorted(outputs) == sorted(jax_outputs)
    for name, data in outputs.items():
        assert data == jax_outputs[name], name
    assert _best_wer(caplog) == jax_wer


def test_steps_default_runs_the_reference_step_list(workspace, caplog):
    """``--steps default``: the reference's default-on steps, without the GMM
    test decodes and the GMM test features, through to the best WER."""
    root, cfg_path, config = workspace
    caplog.set_level(logging.INFO)
    assert cli_main.main(["--config", cfg_path, "--steps", "default", "--device", "cpu"]) == 0
    expdir = root / "expdir"
    for gmm in ("mono_gmm", "tri_gmm", "lda_mllt_gmm"):
        assert (expdir / gmm / "ali" / "pdf.1.gz").is_file(), gmm
        assert not (expdir / gmm / "decode").exists(), gmm
    assert not (root / "test_features" / "13mfcc").exists()
    assert (expdir / config.get("nnet", "name") / "decode" / "kaldi_decode" / "wer_11").is_file()
    assert _best_wer(caplog) == [f"best WER: {synthetic.STUB_WERS['wer_10']} [wer_10]"]


@pytest.mark.parametrize("family", ["tdnn", "cnn"])
def test_tdnn_and_cnn_train_and_decode_text_under_ctc(tmp_path, caplog, family):
    """bench.py's TDNN / CNN ``[nnet]`` (``synthetic.tdnn_nnet`` /
    ``cnn_nnet``, bf16) at a small width under ``loss = ctc``: trained on
    the workspace's transcripts through the CLI, the blank as the 36th
    class, a beam decode of every test utterance, CER and WER logged."""
    small = {"tdnn": {**synthetic.tdnn_nnet(), "num_hidden_layers": 2, "tdnn_context": "-1,0,1;-2,0,2"},
             "cnn": {**synthetic.cnn_nnet(), "num_hidden_layers": 1, "cnn_filters": "4,4", "context_width": 1}}
    nnet = {**small[family], "num_hidden_units": 16, "loss": "ctc", "normalizer": "aurora4", "beam_width": 2,
            "batch_size": 4, "valid_batches": 1, "num_epochs": 2, "valid_frequency": 2, "check_freq": 2}
    ws = synthetic.make_train_workspace(str(tmp_path), num_pdfs=20, hidden_units=16, hidden_layers=2, num_train=12,
                                        num_test=4, min_seconds=0.5, max_seconds=1.2, nnet=nnet)
    caplog.set_level(logging.INFO)
    steps = "dnn_train_features,dnn_test_features,train_nnet,test_nnet"
    assert cli_main.main(["--config", ws["cfg_path"], "--steps", steps, "--device", "cpu"]) == 0
    state = torch.load(os.path.join(ws["savedir"], "final.pt"), weights_only=True)
    assert state["out.w"].shape == (16, 36)  # 35 characters + the blank
    decoded = open(os.path.join(ws["savedir"], "decode", "text")).read().splitlines()
    with open(os.path.join(ws["test_featdir"], "text")) as f:
        assert [line.split()[0] for line in decoded] == [line.split()[0] for line in f]
    messages = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("CTC CER: %WER") for m in messages) and any(m.startswith("CTC WER") for m in messages)

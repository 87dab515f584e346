"""The port's training slice end to end, on the CPU.

- ``cli.main --steps dnn_train_features,dnn_test_features,train_nnet,
  test_nnet --device cpu`` on a synthetic training workspace
  (``tfkaldi_tpu_torch.synthetic.make_train_workspace``: wavs, a config
  derived from config_AURORA4.cfg at a small width, and the parent GMM's
  pdf alignment) writes ``final.pt``, ``prior.npy``, the training
  checkpoints and a likelihood ark of the right shapes.
- The port's twin of tests/test_heldout_accuracy.py::
  test_heldout_hybrid_framewise_accuracy: a small model trained through
  the port's ``Nnet`` facade reaches a held-out framewise accuracy of at
  least 0.85 on unseen speakers (chance is 0.2).
"""

import json
import math
import os
from configparser import ConfigParser

import numpy as np
import pytest
import torch

from tests.synthetic import make_class_signature_corpus
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
from tfkaldi_tpu_torch.io import ArkReader, ArkWriter
from tfkaldi_tpu_torch.nnet import Nnet

NUM_PDFS = 20
STEPS = "dnn_train_features,dnn_test_features,train_nnet,test_nnet"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_slice"))
    return synthetic.make_train_workspace(
        root, num_pdfs=NUM_PDFS, hidden_units=32, hidden_layers=2, num_train=24, num_test=6,
        min_seconds=0.5, max_seconds=1.5,
        nnet={"batch_size": 4, "valid_batches": 1, "num_epochs": 2, "valid_frequency": 2, "check_freq": 2},
    )


def _read(scp):
    with ArkReader(scp) as reader:
        return {utt: mat for utt, mat in reader}


def test_cli_trains_and_decodes(workspace):
    ws = workspace
    assert cli_main.main(["--config", ws["cfg_path"], "--steps", STEPS, "--device", "cpu"]) == 0
    savedir = ws["savedir"]
    # the alignment covers every frame the feature step produced
    feats = _read(os.path.join(ws["train_featdir"], "feats.scp"))
    assert {u: m.shape[0] for u, m in feats.items()} == {u: len(a) for u, a in ws["alignments"].items()}
    prior = np.load(os.path.join(savedir, "prior.npy"))
    assert prior.shape == (NUM_PDFS,) and np.isclose(prior.sum(), 1.0) and (prior > 0).all()
    state = torch.load(os.path.join(savedir, "final.pt"), weights_only=True)
    assert state["hidden.0.w"].shape == (440, 32) and state["out.w"].shape == (32, NUM_PDFS)
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    # 24 utts / batch 4 x 2 epochs = 12 steps; the output layer starts at 0
    assert len(steps) >= 12 and abs(steps[0]["loss"] - math.log(NUM_PDFS)) < 1e-5
    assert os.path.isfile(os.path.join(savedir, "training", "step12.pt"))
    assert os.path.isfile(os.path.join(savedir, "training", "validated.meta.json"))
    test_feats = _read(os.path.join(ws["test_featdir"], "feats.scp"))
    likes = _read(os.path.join(savedir, "decode", "feats.scp"))
    assert list(likes) == list(test_feats)
    for utt, m in likes.items():
        assert m.shape == (test_feats[utt].shape[0], NUM_PDFS) and np.isfinite(m).all()


def test_default_device_without_card_raises_for_train_nnet(workspace):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card error path is not reachable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_main.main(["--config", workspace["cfg_path"], "--steps", "train_nnet"])


def test_multi_process_training_raises(workspace, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(NotImplementedError, match="item 18"):
        cli_main.main(["--config", workspace["cfg_path"], "--steps", "train_nnet", "--device", "cpu"])


def _reader(featdir: str, max_length: int, context_width: int = 1) -> FeatureReader:
    return FeatureReader(f"{featdir}/feats.scp", f"{featdir}/cmvn.scp", f"{featdir}/utt2spk",
                         context_width, max_length)


def test_heldout_hybrid_framewise_accuracy(tmp_path):
    """The hybrid CE path generalizes: framewise state accuracy on unseen
    speakers well above the 20% chance level (the corpus, config and gate
    of the JAX test)."""
    train_dir, test_dir, info = make_class_signature_corpus(tmp_path, seed=11)
    num_labels = info["num_classes"]
    cfg = ConfigParser()
    cfg["directories"] = {"expdir": str(tmp_path / "exp")}
    cfg["nnet"] = {
        "name": "heldout_hybrid", "context_width": "1", "num_hidden_units": "64",
        "num_hidden_layers": "2", "add_layer_period": "0", "starting_step": "0",
        "nonlin": "relu", "l2_norm": "False", "dropout": "1", "batch_norm": "False",
        "num_epochs": "8", "initial_learning_rate": "0.01", "learning_rate_decay": "1",
        "batch_size": "8", "numutterances_per_minibatch": "-1", "valid_batches": "0",
        "valid_frequency": "1000", "valid_adapt": "False", "valid_retries": "0",
        "check_freq": "1000", "visualise": "False",
    }
    dispenser = AlignmentBatchDispenser(
        _reader(train_dir, info["train"]["max_length"]), AlignmentCoder(identity_normalizer, num_labels),
        8, info["train"]["alifile"],
    )
    net = Nnet(cfg, input_dim=info["feat_dim"], num_labels=num_labels, device="cpu")
    net.train(dispenser)

    out_scp = str(tmp_path / "likes.scp")
    n = net.decode(_reader(test_dir, info["test"]["max_length"]), ArkWriter(out_scp, str(tmp_path / "likes.ark")))
    assert n == len(info["test"]["alignments"])
    prior = np.load(os.path.join(net.savedir, "prior.npy"))
    likes = _read(out_scp)
    correct = total = 0
    for utt, truth in info["test"]["alignments"].items():
        assert likes[utt].shape == (len(truth), num_labels)
        pred = np.argmax(likes[utt] + np.log(prior)[None, :], axis=1)  # posterior argmax
        correct += int(np.sum(pred == truth))
        total += len(truth)
    assert correct / total >= 0.85, f"held-out framewise accuracy {correct / total:.3f} < 0.85"

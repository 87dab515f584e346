"""``python -m tfkaldi_tpu_torch.cli.main`` as two gloo ranks under
``torchrun`` (``python -m torch.distributed.run --standalone
--nproc_per_node 2 ... --device cpu``): the four scenarios of
tests/test_distributed_cli.py on the port, and a ``model_parallel = 2`` run
whose ``final.pt`` one process decodes.

The runs of one module fixture start together (the resumed run after the
run it resumes) on seeded featdirs with the GMM boundary files and stub
Kaldi of ``synthetic.write_config``; every subprocess has 300 s, and runs
with ``jax`` and ``tfkaldi_tpu`` blocked (a ``sitecustomize`` first on
``PYTHONPATH``), so no rank may load the JAX package. A rank's
per-step losses are its metrics file (``metrics.jsonl`` on rank 0,
``metrics.p1.jsonl`` on rank 1). The one-process port run these are held
against is itself held against the JAX CLI by
tests/test_torch_train_slice.py and tests/test_torch_controller.py.
"""

from __future__ import annotations

import concurrent.futures
import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from tfkaldi_tpu_torch import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_PDFS = 5
BASE_NNET = {
    "name": "dist_nnet", "context_width": 1, "num_hidden_units": 16, "num_hidden_layers": 2, "add_layer_period": 0,
    "starting_step": 0, "nonlin": "relu", "l2_norm": "False", "dropout": 1, "batch_norm": "False", "num_epochs": 2,
    "initial_learning_rate": 0.01, "learning_rate_decay": 1, "batch_size": 4, "numutterances_per_minibatch": -1,
    "valid_batches": 1, "valid_frequency": 100, "valid_adapt": "False", "valid_retries": 0, "check_freq": 100,
    "visualise": "False", "seed": 0,
}
ADAPT = {"initial_learning_rate": 0.9, "valid_adapt": "True", "valid_retries": 2, "valid_frequency": 2,
         "num_epochs": 4}
# scenario -> [(run tag, ranks, [nnet] overrides, steps)], run in order within a scenario
SCENARIOS = {
    "dual": [("dual", 2, {}, "train_nnet")],
    "single": [("single", 1, {}, "train_nnet")],
    "adapt_dual": [("adapt_dual", 2, ADAPT, "train_nnet")],
    "adapt_single": [("adapt_single", 1, ADAPT, "train_nnet")],
    "full": [("full", 2, {"check_freq": 2}, "train_nnet")],
    "resume": [("resume", 2, {"num_epochs": 1, "check_freq": 2}, "train_nnet"),
               ("resume", 2, {"check_freq": 2, "starting_step": 3}, "train_nnet")],
    "uneven": [("uneven", 2, {}, "train_nnet")],
    "tensor": [("tensor", 2, {"model_parallel": 2, "batch_norm": "True"}, "train_nnet,test_nnet")],
}


def _workspace(root: str, nnet: dict) -> str:
    """A featdir (train = test) of 12 utterances, its pdf alignments in the
    parent GMM's dir, the stub egs and the config; returns the config."""
    cfg = synthetic.write_config(root, num_pdfs=NUM_PDFS, nnet={**BASE_NNET, **nnet})
    from configparser import ConfigParser

    config = ConfigParser()
    config.read(cfg)
    featdir, alifile, _ = synthetic.make_featdir(os.path.join(root, "made"), num_speakers=2, utts_per_speaker=6,
                                                 feat_dim=6, num_labels=NUM_PDFS, learnable=True)
    for kind in ("train", "test"):
        dst = os.path.join(config.get("directories", f"{kind}_features"), config.get("dnn-features", "name"))
        shutil.copytree(featdir, dst)
        with open(os.path.join(featdir, "feats.scp")) as f:  # the scp points into the copy
            text = f.read().replace(featdir, dst)
        with open(os.path.join(dst, "feats.scp"), "w") as f:
            f.write(text)
        with open(os.path.join(dst, "text"), "w") as f:
            f.writelines(f"{line.split()[0]} A\n" for line in text.splitlines())
    ali = os.path.join(config.get("directories", "expdir"), config.get("nnet", "gmm_name"), "ali")
    os.makedirs(ali, exist_ok=True)
    shutil.copyfile(alifile, os.path.join(ali, "pdf.all.gz"))
    return cfg


def _gmm_name(cfg: str) -> str:
    from configparser import ConfigParser

    config = ConfigParser()
    config.read(cfg)
    return config.get("nnet", "gmm_name")


BLOCK_JAX = "import sys\nsys.modules['jax'] = None\nsys.modules['tfkaldi_tpu'] = None\n"


def blocked_env(tmp: str) -> dict:
    """The environment of a port subprocess: ``jax`` and ``tfkaldi_tpu``
    cannot be imported there, nor in any process it starts."""
    block = os.path.join(tmp, "no_jax")
    os.makedirs(block, exist_ok=True)
    with open(os.path.join(block, "sitecustomize.py"), "w") as f:
        f.write(BLOCK_JAX)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_")) and k != "PYTHONPATH"}
    env.update(PYTHONPATH=os.pathsep.join([block, ROOT]), OMP_NUM_THREADS="1")
    return env


def _run(cfg: str, ranks: int, steps: str, env: dict) -> list[str]:
    """One CLI run; returns each rank's output (torchrun's ``--tee`` lines
    split by their ``[default{r}]:`` prefix)."""
    cli = ["-m", "tfkaldi_tpu_torch.cli.main", "--config", cfg, "--steps", steps, "--device", "cpu"]
    if ranks == 1:
        cmd = [sys.executable, *cli]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(ranks),
               "--tee", "3", *cli]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-4000:]
    if ranks == 1:
        return [out]
    return ["\n".join(line.split(":", 1)[1] for line in out.splitlines() if line.startswith(f"[default{r}]:"))
            for r in range(ranks)]


def _losses(savedir: str, rank: int) -> list[tuple[int, float]]:
    name = "metrics.jsonl" if rank == 0 else f"metrics.p{rank}.jsonl"
    with open(os.path.join(savedir, name)) as f:
        return [(m["step"], m["loss"]) for m in map(json.loads, f)]


def _scenario(tmp: str, name: str) -> dict:
    root = os.path.join(tmp, name)
    outs, cfg = [], None
    for i, (tag, ranks, nnet, steps) in enumerate(SCENARIOS[name]):
        if i == 0:
            cfg = _workspace(root, nnet)
        else:  # the same expdir, the next run's keys
            from configparser import ConfigParser

            config = ConfigParser()
            config.read(cfg)
            for key, value in {**BASE_NNET, **nnet}.items():
                config.set("nnet", key, str(value))
            with open(cfg, "w") as f:
                config.write(f)
        if name == "uneven":  # one utterance has no alignment, as when Kaldi's aligner drops it
            ali = os.path.join(root, "expdir", _gmm_name(cfg), "ali", "pdf.all.gz")
            with gzip.open(ali, "rt") as f:
                lines = f.readlines()
            with gzip.open(ali, "wt") as f:
                f.writelines(lines[1:])
        savedir = os.path.join(root, "expdir", BASE_NNET["name"])
        before = [len(_losses(savedir, r)) if i else 0 for r in range(ranks)]  # the metrics files append
        run = _run(cfg, ranks, steps, blocked_env(tmp))
        outs.append({"out": run, "losses": [_losses(savedir, r)[before[r]:] for r in range(ranks)],
                     "savedir": savedir, "cfg": cfg})
    return {"runs": outs, "root": root}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_cli"))
    with concurrent.futures.ThreadPoolExecutor(len(SCENARIOS)) as pool:
        futures = {name: pool.submit(_scenario, tmp, name) for name in SCENARIOS}
        return {name: f.result() for name, f in futures.items()}


def test_two_ranks_match_one_process(runs):
    """Per-step losses equal bit for bit across the ranks and within 2e-4
    of one process on the same global batches (the strided shards hold
    the same utterances in another order); each rank trained on its shard."""
    dual, single = runs["dual"]["runs"][0], runs["single"]["runs"][0]
    assert dual["losses"][0] and dual["losses"][0] == dual["losses"][1]
    featdir = os.path.join(runs["dual"]["root"], "train_features")
    assert any(f.endswith("feats_shuffled.shard0of2.scp") for _, _, fs in os.walk(featdir) for f in fs)
    assert "process group up: rank 1 of 2, backend gloo" in dual["out"][1]
    assert [s for s, _ in single["losses"][0]] == [s for s, _ in dual["losses"][0]] == list(range(6))
    np.testing.assert_allclose([l for _, l in dual["losses"][0]], [l for _, l in single["losses"][0]], rtol=2e-4)


def test_two_ranks_validation_rollback(runs):
    """An aggressive learning rate worsens validation: both ranks take the
    rollback the same number of times (one global validation loss), replay
    the same steps, and follow one process's trajectory."""
    dual, single = runs["adapt_dual"]["runs"][0], runs["adapt_single"]["runs"][0]
    assert dual["losses"][0] == dual["losses"][1]
    rb = [out.count("returning to the previously validated model") for out in dual["out"]]
    assert rb[0] == rb[1] > 0, rb
    steps = [s for s, _ in dual["losses"][0]]
    assert len(set(steps)) < len(steps), steps
    assert single["out"][0].count("returning to the previously validated model") == rb[0]
    assert [s for s, _ in single["losses"][0]] == steps
    np.testing.assert_allclose([l for _, l in dual["losses"][0]], [l for _, l in single["losses"][0]], rtol=2e-4)


def test_two_ranks_checkpoint_resume(runs):
    """Two epochs at once, against one epoch and a second run resuming at
    starting_step 3 (rounded down to the step-2 checkpoint): the resumed
    tail equals the uninterrupted run within 1e-6."""
    ref = runs["full"]["runs"][0]["losses"]
    assert ref[0] == ref[1] and len(ref[0]) == 6
    first, second = runs["resume"]["runs"]
    assert len(first["losses"][0]) == 3
    tail = second["losses"]
    assert tail[0] == tail[1]
    assert [s for s, _ in tail[0]] == [2, 3, 4, 5]
    np.testing.assert_allclose([l for _, l in tail[0]], [l for _, l in ref[0][2:]], rtol=1e-6)


def test_two_ranks_uneven_target_coverage(runs):
    """One utterance without an alignment: the shards hold 6 and 5 targeted
    utterances (3.0 and 2.5 batches of 2), and the agreed minimum gives
    int(2.5 x 2) = 5 steps on both ranks."""
    losses = runs["uneven"]["runs"][0]["losses"]
    assert losses[0] == losses[1] and len(losses[0]) == 5, losses


def test_tensor_split_checkpoint_decodes_in_one_process(runs):
    """``model_parallel = 2`` on two ranks (a 1x2 grid, batchnorm on):
    ``final.pt`` is the whole model, which one process's
    ``Nnet.load_decoder`` reads and decodes to rank 0's ark on rank 0's
    test shard; rank 0 merged the shards' scp and ran the WFST step."""
    import torch
    from configparser import ConfigParser

    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.io import ArkReader, ArkWriter
    from tfkaldi_tpu_torch.nnet import Nnet

    run = runs["tensor"]["runs"][0]
    assert run["losses"][0] == run["losses"][1] and len(run["losses"][0]) == 6
    assert "training on a 1x2 grid of ranks" in run["out"][0]
    assert "best WER: %WER 5.55" in run["out"][0]
    saved = torch.load(os.path.join(run["savedir"], "final.pt"), weights_only=True)
    assert saved["hidden.0.w"].shape == (18, 16) and saved["bn_mean"].shape == (2, 16)
    config = ConfigParser()
    config.read(run["cfg"])
    decodedir = os.path.join(run["savedir"], "decode")
    test_featdir = os.path.join(config.get("directories", "test_features"), config.get("dnn-features", "name"))
    shard = os.path.join(test_featdir, "feats.shard0of2.scp")
    decoder = Nnet(config, 6, NUM_PDFS, device="cpu").load_decoder()
    reader = FeatureReader(shard, os.path.join(test_featdir, "cmvn.scp"), os.path.join(test_featdir, "utt2spk"),
                           1, 0)
    out = os.path.join(runs["tensor"]["root"], "one_process")
    with ArkWriter(out + ".scp", out + ".ark") as writer:
        decoder.decode_to_writer(reader, writer, batch_size=16)
    reader.close()
    with ArkReader(out + ".scp") as mine, ArkReader(os.path.join(decodedir, "feats.p0.scp")) as theirs:
        want = dict(theirs)
        got = dict(mine)
    assert list(got) == list(want) and len(got) == 6
    for utt, m in got.items():
        np.testing.assert_allclose(m, want[utt], rtol=0, atol=1e-5, err_msg=utt)
    with ArkReader(os.path.join(decodedir, "feats.scp")) as merged, \
            ArkReader(os.path.join(test_featdir, "feats.scp")) as feats:
        assert sorted(u for u, _ in merged) == sorted(u for u, _ in feats)

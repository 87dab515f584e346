"""The recipes of ``config/`` on the card at full width, through
``cli.main`` and ``cli.serve`` as users start them, with the hand kernels
counted and held to their plain versions on the paths' own outputs.

One test a phase; each runs alone with ``-k`` (its session fixtures build
what it needs from ``tfkaldi_tpu_torch.synthetic`` under
``build/card_suite``: the served workspace, the training workspace with
its f32 DNN, and each trained recipe that a later phase reads):

- ``test_served_path``: features, ``test_nnet`` and a 3-job spool at
  440 -> 6x2048 -> 2000 with batchnorm;
- ``test_dnn_training_path``: the recipe's DNN in f32 and in bench.py's
  bf16 (800 wavs of 2-5.1 s, batch 128 x T_pad 512, 6 steps), launch
  counts by route, the step-0 loss, and the validation pass and one step
  from the step-2 checkpoint against the plain versions;
- ``test_knobs_path``: SpecAugment, ``visualise`` and ``profile_steps``,
  the bulk and Python loaders side by side;
- ``test_recurrent_path``: the BiLSTM and BiGRU under frame CE;
- ``test_ctc_path``, ``test_attention_path``, ``test_transducer_path``:
  the text recipes as written;
- ``test_text_decode_path``: their offline decode as the JAX package runs
  it, LM fusion and the text spool;
- ``test_streaming_path``: ``cli.serve --stream`` over the socket;
- ``test_hybrid_family_path``: bench.py's TDNN and CNN;
- ``test_hybrid_streaming_path``: the hybrid emitters, the delta
  front-end and its server, speed-perturbed ``prepare_data``;
- ``test_multiprocess_path``: ``torchrun`` on NCCL, one rank a card, and
  (four cards or more) ``model_parallel = 2`` on the 2x2 grid.

Every hybrid ``test_nnet`` reaches the stub Kaldi egs' WFST decode
(``check_wfst``); every CLI training run reads its batches from the native
bulk loader (``check_loader``). Only the three recipe keys num_epochs,
valid_frequency and check_freq are lowered. The workspaces and the
``cli.main`` runs are ``tests/card_support.py``'s, which chip_smoke.py
shares: it runs this suite and then times the models these runs trained.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips (inside the ``card`` fixture) when ``torch.cuda.is_available()`` is
false. The file imports no JAX:

    python -m pytest tests/test_torch_cuda_recipes.py --noconftest -q -m cuda -s [-k ctc]
"""

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
from configparser import ConfigParser

import numpy as np
import pytest
import torch

from tests.card_support import (CTC_CLASSES, HIDDEN_LAYERS, HIDDEN_UNITS, NUM_PDFS, ROOT, Run, STREAM_CHUNK,
                                 TRAIN_UTTS, TRAIN_WORK, WORK, alifile_of, attention_featdirs, cli_run, counters,
                                 eval_reader, log, recipe_nnet, reset_counts, served_workspace, stream_clients,
                                 stream_server, train_batch, train_workspace, variant_config)

pytestmark = pytest.mark.cuda

# bench.py's DNN: the same [nnet] in bf16 (bench.py:48), in its own savedir
BF16_DNN_NNET = {"compute_dtype": "bfloat16", "name": "dnn_bf16"}
# the training knobs on the f32 DNN: the trace covers steps 2-3 (profile_start 2)
KNOBS_PROFILE_STEPS = 2
KNOBS_NNET = {"name": "dnn_knobs", "specaugment": "True", "visualise": "True",
              "profile_steps": str(KNOBS_PROFILE_STEPS)}
KNOBS_LOADER_BATCHES = 8  # batches of each loader compared byte for byte
SPEC_DRAWS = 200  # SpecAugment draws whose masked share is held to its expectation
# the multi-process path: at most 4 ranks; the losses against the single-process CLI, equal at one
# rank (every all-reduce returns its input); with more, a global batch holds the single process's
# rows in another order (strided shards): tests/test_distributed_cli.py's bound
MP_NNET = {"name": "dnn_mp"}
MP2_NNET = {"name": "dnn_mp2", "model_parallel": "2"}
MP_LOSS_RTOL = {1: 1e-6, "more": 2e-4}
MP_TIMEOUT_S = 600

LIKE_TOL = 1e-3
# the validation pass and one training step, kernels vs plain versions (check_train_step)
STEP_LOSS_TOL = 1e-5
BF16_STEP_TOL = 2e-2
STEP_GRAD_TOL = 1e-4
BN_BIAS_NOISE = 1e-2
RNN_LAYERS = 2
# the bf16 rule (tests/test_torch_cuda_rnn.py): the kernels' distance from the plain f32 result
# within RNN_BF16_RATIO of the plain bf16 version's, plus RNN_F32_TOL
RNN_F32_TOL = 1e-5
RNN_BF16_RATIO = 2.0
RNN_LOSS_TOL = 1e-4
# the character-CTC recipe: the step-0 loss against the uniform-posterior value (relative); the CTC
# loss's F.ctc_loss route against its plain recursion
CTC_STEP0_TOL = 1e-4
CTC_LOSS_TOL = 1e-5
# the joint CTC-attention recipe's output classes (the step-0 loss: ln of them a position)
ATT_CLASSES = 36
# the transducer: a full-width band against the dense loss, and the banded NLL's shortfall below it
RNNT_TOL = 1e-5
# utterances of the first attention decode batch whose beam the CPU replays
REPLAY_ROWS = 8
# the CNN's f32 conv stack on the card against the CPU (TF32 would give about 1e-3)
CONV_F32_TOL = 1e-4
# streaming
STREAM_SLOTS = 16  # MultiStreamServer.DEFAULT_SLOTS: the rows of every server tick
STREAM_CEILING_SLOTS = (32, 64)  # --slots of the transducer runs past the default
STREAM_FEAT_TOL = 1e-6  # the fused front-end against the offline extractor, err/max(|ref|, 1)
# a seeded CTC model's output layer: N(0, 1)/sqrt(H) * gain, and a blank bias
CTC_OUT_GAIN = 8.0
CTC_BLANK_BIAS = 6.0
# the hybrid recipe's streaming
HYBRID_STREAM_UTTS = 8  # test utterances a streamed check runs, at batch 1 and as 8 ragged rows
HYBRID_CHUNKS = (4, 16, 64)  # frames a feature chunk: 40, 160 and 640 ms (bench.py:1013)
HYBRID_WINDOWED_CHUNK = 16
DELTA_RTOL, DELTA_ATOL = 1e-7, 1e-10  # derivative columns; static columns bit for bit
HYBRID_WAVS = 8
DELTA_SERVE_CLIENTS = 4
DELTA_TIE_MARGIN = 1e-4
PERTURB_FEAT_TOL = 1e-6


@pytest.fixture(scope="session")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tfkaldi_tpu_torch.device import resolve_device
    from tfkaldi_tpu_torch.ops import _build

    resolve_device("cuda")
    _build.load()
    return torch.cuda.get_device_name(0)


# ---------------------------------------------------------------------------
# counters, rules and checks the phases share
# ---------------------------------------------------------------------------

def bf16_close(mine: float, theirs: float) -> bool:
    """The bf16 rule: within RNN_BF16_RATIO of the plain bf16 version's
    distance from the f32 result, plus RNN_F32_TOL for an output the bf16
    rounding hardly moves."""
    return mine <= RNN_BF16_RATIO * theirs + RNN_F32_TOL


def bf16_rounds(mine: float, theirs: float) -> bool:
    """Its other side, against the plain version in f32 on the
    bf16-rounded weights: at least 1/RNN_BF16_RATIO of the plain bf16
    version's distance, less RNN_F32_TOL (a kernel that skipped the
    roundings would sit near zero)."""
    return mine >= theirs / RNN_BF16_RATIO - RNN_F32_TOL


def seven(counts: dict) -> dict:
    """The seven kernels' launch counters of a :func:`counters` reading."""
    return {k: v for k, v in counts.items() if not isinstance(v, dict)}


@contextlib.contextmanager
def plain_versions():
    """Route the paths' kernel call sites to their plain versions."""
    from tfkaldi_tpu_torch.frontend import features
    from tfkaldi_tpu_torch.models import dnn
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp, gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.ops import frame_preemph as fp

    saved = (features.frame_preemph, dnn.fused_ffn_block, bn_fused_bwd.bn_dgrad)
    features.frame_preemph = fp.frame_preemph_ref
    dnn.fused_ffn_block = fused_mlp.fused_ffn_block_ref
    bn_fused_bwd.bn_dgrad = bn_fused_bwd.bn_dgrad_ref
    cells = (lstm_bidi.CELL, gru_bidi.CELL)
    for c in cells:  # instance attributes over the Cell's methods
        c.fwd, c.bwd = c.fwd_ref, c.bwd_ref
    try:
        yield
    finally:
        features.frame_preemph, dnn.fused_ffn_block, bn_fused_bwd.bn_dgrad = saved
        for c in cells:
            del c.fwd, c.bwd


def read_ark(scp: str) -> dict:
    from tfkaldi_tpu_torch.io import ArkReader

    with ArkReader(scp) as reader:
        return {utt: mat for utt, mat in reader}



def check_loader(tag: str, kind: str, run: Run) -> None:
    """A CLI training run's batches all came from the native bulk loader of
    ``kind`` (``alignment`` or ``text``): at least the validation batches
    and one a step (the prefetcher reads up to 2 ahead, a rollback reads
    again), the other source none."""
    want = run.config.getint("nnet", "valid_batches") + len(run.steps)
    other = "text" if kind == "alignment" else "alignment"
    served = run.counts["bulk"]
    assert served[kind] >= want and served[other] == 0, f"{tag}: bulk loader batches {served}, want {kind} >= {want}"


def check_split_routes(tag: str, run: Run) -> None:
    """A bf16 training path put its products on the tensor cores and
    launched the split kernel (their backward's)."""
    log(f"{tag}: split kernel launches by route {run.counts['split']}; layers.product {run.counts['product']}")
    assert sum(run.counts["split"].values()) > 0 and run.counts["product"]["tensor_core"] > 0, tag


def check_dnn_routes(tag: str, run: Run) -> None:
    """Kernel 1 (validation, decode) on the TMA route at the recipe's
    batches (split-K only for a short batch the plan splits), never SIMT;
    kernel 3 once per hidden layer a step, layers 1-5 on the TMA route and
    layer 0 on the dz pass alone."""
    ffn, bn, steps = run.counts["ffn_routes"], run.counts["bn_routes"], len(run.steps)
    log(f"{tag} launches by route: fused_ffn {ffn}, bn_dgrad {bn} ({steps} train steps)")
    assert ffn["tma"] > 0 and ffn["simt"] == 0, f"{tag}: fused_ffn routes {ffn}"
    assert bn == {"tma": (HIDDEN_LAYERS - 1) * steps, "dz": steps, "simt": 0}, f"{tag}: bn_dgrad routes {bn}"


def check_frame_routes(tag: str, routes: dict) -> None:
    """A feature path pads to whole seconds: every kernel-2 launch on the bulk route."""
    assert routes["bulk"] > 0 and routes["edge"] == 0, f"{tag}: frame_preemph routes {routes}"


def validate_arks(tag: str, scps: list) -> None:
    """Each ark passes the port's strict Kaldi consumer: every record read
    sequentially and at its scp offset with the same bytes."""
    from tfkaldi_tpu_torch.io import kaldi_compat

    counts = {os.path.relpath(scp, ROOT): kaldi_compat.validate_archive(scp) for scp in scps}
    assert all(counts.values()), f"{tag}: an ark validated no record: {counts}"


def check_wfst(tag: str, config, savedir: str) -> None:
    """A hybrid ``test_nnet``'s WFST step reached the stub Kaldi egs: each
    of the ``num_jobs`` stub ``latgen-faster-mapped`` runs got the decode
    dir's split ``feats.scp`` (every test utterance), the ``HCLG.fst``
    copied from the parent GMM and ``--acoustic-scale=0.1``; ``best WER``
    parsed the stub scorer's lowest ``wer_*``."""
    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.kaldi import best_wer

    decodedir = os.path.join(savedir, "decode")
    nj = config.getint("general", "num_jobs")
    with open(os.path.join(decodedir, "feats.scp")) as f:
        n = sum(1 for line in f if line.strip())
    for j in range(1, nj + 1):
        with open(os.path.join(decodedir, "kaldi_decode", "log", f"decode.{j}.log")) as f:
            text = f.read()
        for want in (f"{decodedir}/split{nj}/{j}/feats.scp ({n} utterances)", f"{decodedir}/graph/HCLG.fst",
                     "--acoustic-scale=0.1"):
            assert want in text, f"{tag} WFST step, job {j}: the stub latgen-faster-mapped log lacks {want!r}"
    assert best_wer(os.path.join(decodedir, "kaldi_decode")) == f"{synthetic.STUB_WERS['wer_10']} [wer_10]", tag


def check_cli_run(tag: str, ws: dict, run: Run) -> None:
    """What a hybrid ``train_nnet,test_nnet`` run must leave: a step-0 loss
    of ln 2000 (the output layer starts at zero), the prior and the
    checkpoints, a likelihood ark that covers the test set with finite
    values of the right shape, and the WFST step."""
    loss0 = run.steps[0]["loss"]
    log(f"{tag} losses {[round(st['loss'], 6) for st in run.steps]}")
    assert abs(loss0 - math.log(NUM_PDFS)) <= 1e-4, f"{tag}: step-0 loss {loss0} is not ln {NUM_PDFS}"
    prior = np.load(os.path.join(run.savedir, "prior.npy"))
    assert prior.shape == (NUM_PDFS,) and abs(float(prior.sum()) - 1.0) <= 1e-5, tag
    for name in ("final.pt", os.path.join("training", "step2.pt"), os.path.join("training", "validated.pt")):
        assert os.path.isfile(os.path.join(run.savedir, name)), f"{tag}: training wrote no {name}"
    feats = read_ark(os.path.join(ws["test_featdir"], "feats.scp"))
    likes = read_ark(os.path.join(run.savedir, "decode", "feats.scp"))
    assert list(likes) == list(feats), f"{tag} test_nnet: the likelihood ark does not cover the test set"
    for utt, m in likes.items():
        assert m.shape == (feats[utt].shape[0], NUM_PDFS) and np.isfinite(m).all(), f"{tag} {utt}: {m.shape}"
    check_wfst(tag, run.config, run.savedir)


def check_text_decode(tag: str, run: Run, test_featdir: str) -> None:
    """A text recipe's ``test_nnet`` wrote one ``text`` line per test
    utterance; CER and WER printed (noise data: not gated)."""
    from tfkaldi_tpu_torch.utils.wer import char_tokens_to_words, score_text_files

    with open(os.path.join(test_featdir, "text")) as f:
        test_utts = [line.split()[0] for line in f if line.strip()]
    decode_dir = os.path.join(run.savedir, "decode")
    with open(os.path.join(decode_dir, "text")) as f:
        decoded = [line.split() for line in f]
    assert [d[0] for d in decoded] == test_utts, f"{tag}: {len(decoded)} lines for {len(test_utts)} utterances"
    norm, out = os.path.join(decode_dir, "text.ref_normalized"), os.path.join(decode_dir, "text")
    log(f"{tag} decode of {len(decoded)} test utterances: CER {score_text_files(norm, out)}; WER "
        f"{score_text_files(norm, out, transform=char_tokens_to_words)}")


def log_num_alignments(labels, frames: int) -> float:
    """ln of the number of CTC alignments of ``labels`` in ``frames``
    frames, counted on the host in f64 log space."""
    labels = np.asarray(labels)
    n = 2 * len(labels) + 1
    skip = np.zeros(n, bool)  # s-2 -> s allowed: a label unlike the label before it
    skip[3::2] = labels[1:] != labels[:-1]
    alpha = np.full(n, -np.inf)
    alpha[: min(2, n)] = 0.0
    for _ in range(frames - 1):
        nxt = np.logaddexp(alpha, np.concatenate([[-np.inf], alpha[:-1]]))
        nxt[skip] = np.logaddexp(nxt[skip], alpha[np.flatnonzero(skip) - 2])
        alpha = nxt
    return float(np.logaddexp(alpha[-1], alpha[-2]) if n > 1 else alpha[-1])






@pytest.fixture(scope="session")
def served(card):
    return served_workspace()


@pytest.fixture(scope="session")
def dnn(card):
    return train_workspace()


@pytest.fixture(scope="session")
def train_ws(dnn):
    return dnn[0]


@pytest.fixture(scope="session")
def dnn_bf16(train_ws):
    return cli_run(train_ws, "dnn_bf16", BF16_DNN_NNET)


@pytest.fixture(scope="session")
def att_dirs(train_ws):
    return attention_featdirs(train_ws)


@pytest.fixture(scope="session")
def ctc_run(train_ws):
    return cli_run(train_ws, "ctc", recipe_nnet("ctc"))


@pytest.fixture(scope="session")
def attention_run(train_ws, att_dirs):
    return cli_run(train_ws, "attention", recipe_nnet("attention"), att_dirs)


@pytest.fixture(scope="session")
def transducer_run(train_ws, att_dirs):
    return cli_run(train_ws, "transducer", recipe_nnet("transducer"), att_dirs)


@pytest.fixture(scope="session")
def families(train_ws):
    return {family: cli_run(train_ws, family, recipe_nnet(family)) for family in ("tdnn", "cnn")}


@pytest.fixture(scope="session")
def char_lm(train_ws, att_dirs):
    """A character trigram ARPA estimated from the CTC and attention
    featdirs' training transcripts."""
    from tfkaldi_tpu_torch import synthetic

    path = os.path.join(TRAIN_WORK, "char3.arpa")
    synthetic.write_char_arpa(path, [os.path.join(train_ws["train_featdir"], "text"),
                                     os.path.join(att_dirs["train"], "text")])
    return path


# ---------------------------------------------------------------------------
# the served path and the DNN's training
# ---------------------------------------------------------------------------

def test_served_path(served):
    """Kernels 1 and 2 launched (kernel 2 all on the bulk route); the
    features finite, 40 wide, against the reference's numpy oracle (1e-4 of
    max(|ref|, 1), 4 utterances) and bit-equal to the plain framing's; the
    likelihoods of ``test_nnet`` and of the 3 spool jobs (``DONE`` each)
    finite, of the right shape, within LIKE_TOL of the plain versions'."""
    from tests import reference_port
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.frontend.prepare_data import prepare_data
    from tfkaldi_tpu_torch.io import ArkWriter, read_wav, read_wavfiles
    from tfkaldi_tpu_torch.nnet import Nnet

    counts, config = served["counts"], served["config"]
    log(f"served path launches: fused_ffn {counts['fused_ffn']}, frame_preemph {counts['frame_routes']}")
    assert counts["fused_ffn"] > 0 and counts["frame_preemph"] > 0
    check_frame_routes("served path", counts["frame_routes"])
    check_wfst("served path", config, served["savedir"])
    feats = {kind: read_ark(os.path.join(served[f"{kind}_featdir"], "feats.scp")) for kind in ("train", "test")}
    for kind, arks in feats.items():
        assert len(arks) == 32, kind
        for utt, m in arks.items():
            assert m.ndim == 2 and m.shape[1] == 40 and np.isfinite(m).all(), (kind, utt, m.shape)
    feat_conf = dict(config.items("dnn-features"))
    wavs = read_wavfiles(os.path.join(config.get("directories", "test_data"), "wav.scp"))
    for utt in list(wavs)[:4]:
        rate, sig = read_wav(wavs[utt])
        golden = reference_port.compute(sig.astype(np.float64), rate, feat_conf)
        got = feats["test"][utt]
        assert got.shape == golden.shape, utt
        assert np.max(np.abs(got - golden) / np.maximum(np.abs(golden), 1)) <= 1e-4, utt
    plain_featdir = os.path.join(WORK, "plain", "features")
    with plain_versions():  # same batches as the cli run (batch 32)
        prepare_data(config.get("directories", "test_data"), plain_featdir, feat_conf, batch_size=32, device="cuda")
    for utt, m in read_ark(os.path.join(plain_featdir, "feats.scp")).items():
        assert np.array_equal(m, feats["test"][utt]), utt
    decoder = Nnet(config, 40, NUM_PDFS, device="cuda").load_decoder()
    jobs = served["jobs"]
    outputs = {"test_nnet": os.path.join(served["savedir"], "decode", "feats.scp"),
               **{name: os.path.join(served["spool_out"], name, "feats.scp") for name in jobs}}
    sources = {"test_nnet": served["test_featdir"], **jobs}
    for name, scp in outputs.items():
        assert name not in jobs or os.path.isfile(os.path.join(served["spool_out"], name, "DONE")), name
        likes = read_ark(scp)
        ref_feats = feats["test" if sources[name] == served["test_featdir"] else "train"]
        assert list(likes) == list(ref_feats), name
        for utt, m in likes.items():
            assert m.shape == (ref_feats[utt].shape[0], NUM_PDFS) and np.isfinite(m).all(), (name, utt)
        reader = FeatureReader(*(os.path.join(sources[name], f) for f in ("feats.scp", "cmvn.scp", "utt2spk")),
                               served["context"], 0)
        plain_scp = os.path.join(WORK, "plain", name, "feats.scp")
        with plain_versions(), ArkWriter(plain_scp, os.path.join(WORK, "plain", name, "likes.ark")) as w:
            decoder.decode_to_writer(reader, w, batch_size=16)
        reader.close()
        err = max(float(np.abs(m - likes[utt]).max()) for utt, m in read_ark(plain_scp).items())
        log(f"served path {name}: likelihoods, kernels vs plain versions max|diff| {err!r} (tol {LIKE_TOL})")
        assert err <= LIKE_TOL, name


def check_train_step(tag: str, ws: dict, run: Run) -> None:
    """From the run's step-2 checkpoint, with the kernels and through
    ``plain_versions()``: the validation pass over the run's validation
    batches (the loss that decides a rollback; six kernel-1 launches a
    65,536-row batch against cuBLAS) within 1e-5 relative and the first
    batch's eval logits within LIKE_TOL; one full-width training step on
    the first training batch: the loss within 1e-5 relative (the same
    forward), every gradient within 1e-4 of its max|ref| (dh = dz @ wᵀ in
    another order through six layers), the BN layers' bias gradients
    (exactly 0 in exact arithmetic) below BN_BIAS_NOISE of the layer's beta
    gradient on both sides. In bf16 an output rounded one bf16 step apart
    carries through the layers: the validation loss, the logits (relative
    to their max) and every gradient within BF16_STEP_TOL."""
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.models.dnn import DNNConfig
    from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp
    from tfkaldi_tpu_torch.train import checkpoint as ckpt
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

    config, featdir = run.config, ws["train_featdir"]
    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    reader = FeatureReader(os.path.join(featdir, "feats_shuffled.scp"), os.path.join(featdir, "cmvn.scp"),
                           os.path.join(featdir, "utt2spk"), ws["context"], max_length)
    dispenser = AlignmentBatchDispenser(reader, AlignmentCoder(identity_normalizer, NUM_PDFS),
                                        config.getint("nnet", "batch_size"), alifile_of(config))
    val_batches = [dispenser.get_padded_batch(DeviceBatcher()).to("cuda")
                   for _ in range(config.getint("nnet", "valid_batches"))]
    batch = dispenser.get_padded_batch(DeviceBatcher()).to("cuda")
    reader.close()
    dcfg = DNNConfig.from_config(run.conf, 440, NUM_PDFS)
    bf16 = dcfg.compute_dtype == torch.bfloat16
    loss_tol, grad_tol = (BF16_STEP_TOL, BF16_STEP_TOL) if bf16 else (STEP_LOSS_TOL, STEP_GRAD_TOL)
    trainer = Trainer(dcfg, TrainerConfig(num_steps=6), device="cuda")
    state = ckpt.restore_state(os.path.join(run.savedir, "training", "step2.pt"), trainer.init_state(0))

    before = fused_mlp.launches
    val_loss = trainer.evaluate(state, val_batches)
    with torch.inference_mode():
        logits = state.model(val_batches[0].inputs)
    with plain_versions():
        val_loss0 = trainer.evaluate(state, val_batches)
        with torch.inference_mode():
            logits0 = state.model(val_batches[0].inputs)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + HIDDEN_LAYERS * (len(val_batches) + 1)
    val_rel = abs(val_loss - val_loss0) / abs(val_loss0)
    logit_err = (logits - logits0).abs().max().item() / (logits0.abs().max().item() if bf16 else 1.0)
    log(f"{tag} validation pass, kernels vs plain: loss rel {val_rel!r} (tol {loss_tol}), eval logits "
        f"{logit_err!r} (tol {BF16_STEP_TOL if bf16 else LIKE_TOL})")
    assert val_rel <= loss_tol and logit_err <= (BF16_STEP_TOL if bf16 else LIKE_TOL)
    del logits, logits0

    before = bn_fused_bwd.launches
    grads, loss, _ = trainer.gradients(ckpt.device_snapshot(state), batch)
    with plain_versions():
        grads0, loss0, _ = trainer.gradients(ckpt.device_snapshot(state), batch)
    torch.cuda.synchronize()
    assert bn_fused_bwd.launches == before + HIDDEN_LAYERS
    loss_rel = abs(loss.item() - loss0.item()) / abs(loss0.item())
    bias_noise = {l: max(grads[f"hidden.{l}.b"].abs().max(), grads0[f"hidden.{l}.b"].abs().max()).item()
                  / grads0[f"hidden.{l}.beta"].abs().max().item() for l in range(HIDDEN_LAYERS)}
    errs = {name: ((grads[name] - g0).abs().max() / g0.abs().max().clamp(min=1e-30)).item()
            for name, g0 in grads0.items() if not (name.startswith("hidden.") and name.endswith(".b"))}
    worst = max(errs, key=errs.get)
    log(f"{tag} one step from the step-2 checkpoint, kernels vs plain: loss rel {loss_rel!r}; gradients worst "
        f"{worst} {errs[worst]!r} (tol {grad_tol}); BN-layer bias gradients / max|dbeta| {bias_noise!r}")
    assert loss_rel <= STEP_LOSS_TOL and errs[worst] <= grad_tol
    assert bf16 or max(bias_noise.values()) <= BN_BIAS_NOISE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dnn_training_path(request, dtype):
    """The recipe's DNN at full width through the CLI (f32: the training
    workspace's own run, features included; bf16: bench.py's
    configuration on the same features, its own savedir): kernel 3 six
    launches a step on its routes, kernel 1 on the TMA route, kernel 2 all
    on the bulk route (f32), the products of bf16 on the tensor cores and
    their backward's split kernel (bf16), every batch from the bulk loader,
    what ``check_cli_run`` asks, then ``check_train_step``."""
    ws, run = request.getfixturevalue("dnn")
    if dtype == "bfloat16":
        run = request.getfixturevalue("dnn_bf16")
    tag = f"{dtype} DNN path"
    counts, steps = run.counts, len(run.steps)
    log(f"{tag}: {steps} train steps, launches {[counts[k] for k in ('fused_ffn', 'frame_preemph', 'bn_dgrad')]}")
    assert counts["fused_ffn"] > 0 and counts["bn_dgrad"] == HIDDEN_LAYERS * steps
    if dtype == "float32":
        assert counts["frame_preemph"] > 0
        check_frame_routes(tag, counts["frame_routes"])
    else:
        check_split_routes(tag, run)
    check_loader(tag, "alignment", run)
    check_dnn_routes(tag, run)
    check_cli_run(tag, ws, run)
    check_train_step(tag, ws, run)


def trace_steps(trace: dict, span: str = "train_step") -> dict:
    """From a torch.profiler Chrome trace: the ``span`` ranges and the
    device's busy time inside them (the union of kernel, memcpy and memset
    events, clipped to the spans)."""
    events = trace["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == span and e.get("cat") == "user_annotation")
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    busy = 0.0
    for lo, hi in spans:
        end = lo
        for a, b in sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in device
                           if e["ts"] < hi and e["ts"] + e["dur"] > lo):
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
    wall = sum(hi - lo for lo, hi in spans)
    return {"steps": len(spans), "idle_share": 1.0 - busy / wall if wall else None}


def spec_masked_fraction(lengths, raw: int, cfg) -> float:
    """The expected share of the real frames' inputs that SpecAugment
    zeroes, from the draw's distribution (``spec_augment_draw``: width
    uniform on [0, W], start uniform on [0, max(limit − w, 1)), the masks
    independent): an element is kept when no time band covers its frame and
    no frequency band its raw column, and P(index i covered by one band) =
    Σ_w P(w)·#{s: s ≤ i < s + w} / span_w."""
    def covered(n_masks, max_width, limit):
        idx = np.arange(limit)
        one = np.zeros(limit)
        for w in range(max_width + 1):
            span = max(limit - w, 1)
            lo, hi = np.maximum(idx - w + 1, 0), np.minimum(idx, span - 1)
            one += np.clip(hi - lo + 1, 0, None) / span / (max_width + 1)
        return 1.0 - (1.0 - one) ** n_masks

    kept_f = 1.0 - covered(cfg.spec_freq_masks, cfg.spec_freq_width, raw).mean()
    total = sum(int(n) for n in lengths)
    masked = sum(int(n) * (1.0 - (1.0 - covered(cfg.spec_time_masks, cfg.spec_time_width, int(n)).mean()) * kept_f)
                 for n in lengths)
    return masked / total


def test_knobs_path(train_ws):
    """The training knobs on the f32 DNN at full width: ``cli.main --steps
    train_nnet,test_nnet`` with ``specaugment``, ``visualise`` and
    ``profile_steps = 2``: kernel 3 six launches a step, kernel 1 in
    ``test_nnet``, every batch from the bulk loader, what
    ``check_cli_run`` asks; the event file read back (a ``train/loss`` a
    step equal as f32 to metrics.jsonl's, ``valid/loss`` at each
    validation, one histogram a parameter under its JAX pytree path); the
    Chrome trace naming kernel 3's CUDA kernel and holding the two profiled
    ``train_step`` spans; the ark through the port's strict Kaldi consumer.
    Then the first KNOBS_LOADER_BATCHES batches of the bulk and the Python
    loaders byte-identical, and SpecAugment on a full-width batch: card and
    CPU identical on the same bands, one ``(seed, step)`` drawn twice
    identical, the masked share over SPEC_DRAWS draws within 4 sigma of
    ``spec_masked_fraction``."""
    import glob
    import types

    from tfkaldi_tpu_torch.convert import jax_param_path
    from tfkaldi_tpu_torch.data.batching import DeviceBatcher
    from tfkaldi_tpu_torch.data.bulk_loader import BulkAlignmentBatchSource
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.io import read_alignments
    from tfkaldi_tpu_torch.models import DNNConfig
    from tfkaldi_tpu_torch.nnet import Nnet
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig, spec_augment_apply, spec_augment_draw
    from tfkaldi_tpu_torch.utils.tb_events import read_events

    run = cli_run(train_ws, "dnn_knobs", KNOBS_NNET)
    steps = run.steps
    assert run.counts["bn_dgrad"] == HIDDEN_LAYERS * len(steps) and run.in_decode > 0
    check_loader("training knobs", "alignment", run)
    check_dnn_routes("training knobs", run)
    check_cli_run("training knobs", train_ws, run)

    (events_path,) = glob.glob(os.path.join(run.savedir, "logdir", "events.out.tfevents.*"))
    events = read_events(events_path)
    losses = [(step, vals["train/loss"]) for step, vals in events if "train/loss" in vals]
    assert losses == [(m["step"], float(np.float32(m["loss"]))) for m in steps]
    every = run.config.getint("nnet", "valid_frequency")
    assert [step for step, vals in events if "valid/loss" in vals] == [m["step"] + 1 for m in steps
                                                                         if (m["step"] + 1) % every == 0]
    hist = sorted(tag for _, vals in events for tag, v in vals.items() if v == "histogram")
    model = Nnet(run.config, 40, NUM_PDFS, device="cpu").model
    assert hist == sorted("params" + jax_param_path(name) for name, _ in model.named_parameters())

    (trace_path,) = glob.glob(os.path.join(run.savedir, "profile", "*.pt.trace.json"))
    with open(trace_path) as f:
        trace = json.load(f)
    kernel_names = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "kernel"}
    split = trace_steps(trace)
    log(f"training knobs trace: {len(kernel_names)} distinct kernels, profiled steps {split}")
    assert any("bn_dz_kernel" in name for name in kernel_names)
    assert split["steps"] == KNOBS_PROFILE_STEPS and split["idle_share"] is not None
    validate_arks("training knobs test_nnet", [os.path.join(run.savedir, "decode", "feats.scp")])

    # the loaders side by side on the workspace's shuffled scp, CMVN and pdf alignments
    config, featdir = train_ws["config"], train_ws["train_featdir"]
    paths = [os.path.join(featdir, name) for name in ("feats_shuffled.scp", "cmvn.scp", "utt2spk")]
    batch_size = config.getint("nnet", "batch_size")
    with open(os.path.join(featdir, "maxlength")) as f:
        max_length = int(f.read())
    bulk = BulkAlignmentBatchSource(*paths, train_ws["context"], read_alignments(alifile_of(config)), batch_size,
                                    num_labels=NUM_PDFS, max_input_length=max_length)
    reader = FeatureReader(*paths, train_ws["context"], max_length)
    python = AlignmentBatchDispenser(reader, AlignmentCoder(identity_normalizer, NUM_PDFS), batch_size,
                                     alifile_of(config))
    out = {name: [source.get_padded_batch(DeviceBatcher()) for _ in range(KNOBS_LOADER_BATCHES)]
           for name, source in (("bulk", bulk), ("python", python))}
    reader.close()
    for i, (a, b) in enumerate(zip(out["bulk"], out["python"])):
        for x, y in zip(a.fields(), b.fields()):
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), i

    # SpecAugment at the recipe's defaults on a full-width batch
    host_batch, raw = out["bulk"][0], 40
    cfg = TrainerConfig(spec_augment=True, spec_raw_dim=raw)
    trainer = Trainer(DNNConfig(input_dim=host_batch.inputs.shape[2], num_labels=NUM_PDFS), cfg, device="cuda")
    batch = host_batch.to("cuda")
    b, t, d = batch.inputs.shape
    gen = torch.Generator(device="cuda").manual_seed(1234)
    time_bands = spec_augment_draw(gen, b, cfg.spec_time_masks, cfg.spec_time_width, batch.input_lengths)
    freq_bands = spec_augment_draw(gen, b, cfg.spec_freq_masks, cfg.spec_freq_width,
                                   torch.full((b,), raw, device="cuda"))
    card_out = spec_augment_apply(batch, time_bands, freq_bands, raw).inputs.cpu()
    cpu_out = spec_augment_apply(host_batch.to("cpu"), tuple(x.cpu() for x in time_bands),
                                 tuple(x.cpu() for x in freq_bands), raw).inputs
    assert torch.equal(card_out, cpu_out)
    state = types.SimpleNamespace(seed=0, step=5, mesh=None)
    assert torch.equal(trainer.spec_augment(state, batch).inputs, trainer.spec_augment(state, batch).inputs)
    ones = dataclasses.replace(batch, inputs=torch.ones_like(batch.inputs))
    real = (torch.arange(t, device="cuda")[None, :] < batch.input_lengths[:, None].long())[:, :, None]
    denom = float(batch.input_lengths.sum()) * d
    fractions = [float(((trainer.spec_augment(types.SimpleNamespace(seed=0, step=step, mesh=None), ones).inputs == 0)
                        & real).sum()) / denom for step in range(SPEC_DRAWS)]
    mean, want = float(np.mean(fractions)), float(spec_masked_fraction(batch.input_lengths.cpu().numpy(), raw, cfg))
    sigma = float(np.std(fractions, ddof=1)) / math.sqrt(SPEC_DRAWS)
    log(f"SpecAugment masked share over {SPEC_DRAWS} draws: {mean!r} (expected {want!r}, sigma {sigma!r})")
    assert abs(mean - want) <= 4 * sigma


# the multi-process path's rank: brings the NCCL group up itself, runs the CLI, prints one JSON line
MP_WORKER = """import json, os, sys
sys.path.insert(0, {root!r})
import torch.distributed as dist
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.ops import bn_fused_bwd, fused_mlp
from tfkaldi_tpu_torch.parallel import multihost

device, _ = multihost.initialize("cuda")
rc = cli_main.main(["--config", {cfg!r}, "--steps", "train_nnet,test_nnet"])
print("MP_RANK " + json.dumps({{
    "rank": dist.get_rank(), "rc": rc, "backend": dist.get_backend(), "world": dist.get_world_size(),
    "fused_ffn": dict(fused_mlp.launches_by_route), "bn_dgrad": dict(bn_fused_bwd.launches_by_route)}}),
    flush=True)
multihost.shutdown()
sys.exit(rc)
"""


@pytest.mark.parametrize("grid", ["data", "model_parallel"])
def test_multiprocess_path(dnn, grid):
    """``torchrun`` over ``min(cards, 4)`` ranks (``data``: a ``ranks x 1``
    grid, world size 1 included) or, with four cards or more, four ranks
    with ``[nnet] model_parallel = 2`` (the 2x2 grid: the dense layers split
    over two ranks), ``cli.main --steps train_nnet,test_nnet`` on the
    training workspace (its own savedir): every rank on NCCL at the world
    size, kernels 3 and 1 launched in every child, the trainer's grid as
    asked, every per-step loss within MP_LOSS_RTOL of the single-process
    run's, and the merged likelihood ark within LIKE_TOL of the
    single-process ark (one rank) or of one process's decode of the run's
    own ``final.pt`` (more ranks: another rounding of the same training)."""
    from tfkaldi_tpu_torch.io import ArkWriter
    from tfkaldi_tpu_torch.nnet import Nnet

    ws, single_run = dnn
    cards = torch.cuda.device_count()
    if grid == "model_parallel" and cards < 4:
        pytest.skip(f"the 2x2 grid needs four cards, {cards} visible")
    nproc, nnet, want_grid = ((min(cards, 4), MP_NNET, (min(cards, 4), 1)) if grid == "data"
                              else (4, MP2_NNET, (2, 2)))
    cfg_path = variant_config(ws["cfg_path"], os.path.join(TRAIN_WORK, f"config_{nnet['name']}.cfg"), nnet)
    config = ConfigParser()
    config.read(cfg_path)
    savedir = os.path.join(config.get("directories", "expdir"), nnet["name"])
    shutil.rmtree(savedir, ignore_errors=True)
    worker = os.path.join(TRAIN_WORK, "mp_worker.py")
    with open(worker, "w") as f:
        f.write(MP_WORKER.format(root=ROOT, cfg=cfg_path))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc),
           "--tee", "3", worker]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MP_TIMEOUT_S, cwd=ROOT)
    out = proc.stdout + proc.stderr
    with open(os.path.join(TRAIN_WORK, f"{nnet['name']}_run.log"), "w") as f:
        f.write(out)
    assert proc.returncode == 0, out[-6000:]
    ranks = [json.loads(line.split("MP_RANK ", 1)[1]) for line in out.splitlines() if "MP_RANK " in line]
    log(f"multi-process path children: {json.dumps(ranks)}")
    assert sorted(r["rank"] for r in ranks) == list(range(nproc))
    for r in ranks:
        assert (r["backend"], r["world"], r["rc"]) == ("nccl", nproc, 0), r
        assert sum(r["bn_dgrad"].values()) > 0 and sum(r["fused_ffn"].values()) > 0, r
    found = re.search(r"training on a (\d+)x(\d+) grid of ranks", out)
    assert found and (int(found.group(1)), int(found.group(2))) == want_grid
    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        multi = [json.loads(line) for line in f]
    single = single_run.steps
    assert len(multi) == len(single)
    loss_err = max(abs(m["loss"] - s["loss"]) / abs(s["loss"]) for m, s in zip(multi, single))
    log(f"multi-process per-step losses vs the single-process CLI: max rel diff {loss_err!r}")
    assert loss_err <= (MP_LOSS_RTOL[1] if nproc == 1 else MP_LOSS_RTOL["more"])
    likes = read_ark(os.path.join(savedir, "decode", "feats.scp"))
    if nproc == 1:  # the same model: the single-process run's ark
        want = read_ark(os.path.join(ws["savedir"], "decode", "feats.scp"))
    else:  # another model: one process decodes the run's own final.pt
        reader = eval_reader(ws["test_featdir"], config.getint("nnet", "context_width"))
        scp = os.path.join(TRAIN_WORK, f"{nnet['name']}_one_process")
        with ArkWriter(scp + ".scp", scp + ".ark") as writer:
            Nnet(config, 40, NUM_PDFS, device="cuda").load_decoder().decode_to_writer(reader, writer, batch_size=16)
        reader.close()
        want = read_ark(scp + ".scp")
    assert sorted(likes) == sorted(want)
    like_err = max(float(np.abs(likes[u] - m).max()) for u, m in want.items())
    log(f"multi-process merged likelihood ark: max|diff| {like_err!r} (tol {LIKE_TOL})")
    assert like_err <= LIKE_TOL


# ---------------------------------------------------------------------------
# the recurrent and text recipes
# ---------------------------------------------------------------------------

def check_recurrent_launches(tag: str, run: Run, cell: str) -> None:
    """Kernel 5 or 7 once per layer in each train step, kernel 4 or 6 on the
    persistent route more than layers x steps times (validation and decode
    launch it too), the step route never; no other kernel."""
    n = len(run.steps)
    c = run.counts
    fwd = {"persistent": c[f"{cell}_fwd_persistent"], "step": c[f"{cell}_fwd"]}
    bwd = {"persistent": c[f"{cell}_bwd_persistent"], "step": c[f"{cell}_bwd"]}
    log(f"{tag}: {cell} forward by route {fwd}, backward {bwd}; {n} train steps")
    assert bwd == {"persistent": RNN_LAYERS * n, "step": 0}, tag
    assert fwd["step"] == 0 and fwd["persistent"] > RNN_LAYERS * n, tag
    other = {k: v for k, v in seven(c).items() if not k.startswith(cell)}
    assert not any(other.values()), f"{tag} launched another path's kernels: {other}"


def compare_rnn_step(tag: str, rcfg, tcfg, path: str, batch, cell: str = "lstm"):
    """One full-width training step of a recurrent model from the checkpoint
    ``path`` on ``batch``, with the same dropout masks, through the kernels
    and the plain versions (and, in bf16, the plain versions in f32
    compute): the backward kernel once per layer on the persistent route;
    every gradient by the bf16 rule (f32: within RNN_F32_TOL of max|ref|),
    the loss within RNN_LOSS_TOL (relative) of the plain version's.
    Returns the kernels' trainer and state."""
    from tfkaldi_tpu_torch.ops import gru_bidi, lstm_bidi
    from tfkaldi_tpu_torch.train import checkpoint as ckpt
    from tfkaldi_tpu_torch.train.trainer import Trainer

    c = lstm_bidi.CELL if cell == "lstm" else gru_bidi.CELL
    bf16 = rcfg.compute_dtype == torch.bfloat16
    trainer = Trainer(rcfg, tcfg, device="cuda")
    trainer32 = Trainer(dataclasses.replace(rcfg, compute_dtype=torch.float32), tcfg, device="cuda")
    state = ckpt.restore_state(path, trainer.init_state(0))
    state32 = ckpt.restore_state(path, trainer32.init_state(0))

    def gradients(tr, st, plain_path):
        s = ckpt.device_snapshot(st)
        with plain_versions() if plain_path else contextlib.nullcontext():
            grads, loss, _ = tr.gradients(s, batch, tr.dropout_generator(s))  # the same masks each time
        return grads, loss.item()

    before = (c.bwd_persistent_launches, c.bwd_launches)
    g_k, loss_k = gradients(trainer, state, False)
    assert (c.bwd_persistent_launches, c.bwd_launches) == (before[0] + RNN_LAYERS, before[1]), tag
    g_p, loss_p = gradients(trainer, state, True)
    g_32, _ = gradients(trainer32, state32, True) if bf16 else (g_p, loss_p)
    torch.cuda.synchronize()

    def rel(a, ref):
        return ((a - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()

    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    if bf16:
        e_k, e_p = {n: rel(g_k[n], g_32[n]) for n in g_32}, {n: rel(g_p[n], g_32[n]) for n in g_32}
        bad = [n for n in e_k if not bf16_close(e_k[n], e_p[n])]
    else:
        e_k = {n: rel(g_k[n], g_p[n]) for n in g_p}
        bad = [n for n in e_k if not e_k[n] <= RNN_F32_TOL]
    log(f"{tag} one step from the step-2 checkpoint: loss rel {loss_rel!r} (tol {RNN_LOSS_TOL}); gradients {e_k!r}")
    assert not bad and loss_rel <= RNN_LOSS_TOL, (tag, bad, loss_rel)
    return trainer, state


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_recurrent_path(train_ws, cell):
    """The BiLSTM (kernels 4, 5) or BiGRU (6, 7) hybrid path at full width:
    ``cli.main --steps train_nnet,test_nnet`` with the ``[nnet]`` of
    config_AURORA4_ctc.cfg under frame CE (2 x 512 bidirectional, context
    2, bf16, batch 128, dropout 0.8): ``check_recurrent_launches``, every
    batch from the bulk loader, what ``check_cli_run`` asks; the likelihood
    ark against the plain versions' decode of ``final.pt`` by the bf16 rule
    (against the plain decode in f32 compute; f32: within LIKE_TOL); one
    step from the step-2 checkpoint by ``compare_rnn_step``."""
    from tfkaldi_tpu_torch.convert import load_checkpoint
    from tfkaldi_tpu_torch.decode.decoder import Decoder
    from tfkaldi_tpu_torch.io import ArkWriter
    from tfkaldi_tpu_torch.models import RNNConfig, build_model
    from tfkaldi_tpu_torch.train.trainer import TrainerConfig

    run = cli_run(train_ws, cell, recipe_nnet(cell))
    tag = f"bi{cell} path"
    check_recurrent_launches(tag, run, cell)
    check_loader(tag, "alignment", run)
    check_cli_run(tag, train_ws, run)

    conf = run.conf
    context = int(conf["context_width"])
    rcfg = RNNConfig.from_config(conf, 40 * (2 * context + 1), NUM_PDFS)
    prior = np.load(os.path.join(run.savedir, "prior.npy"))
    final = load_checkpoint(run.savedir)

    def decode(cfg, name):
        model = build_model(cfg)
        model.load_state_dict(final)
        reader = eval_reader(train_ws["test_featdir"], context)
        scp = os.path.join(TRAIN_WORK, f"plain_{cell}_{name}", "feats.scp")
        with plain_versions(), ArkWriter(scp, os.path.join(os.path.dirname(scp), "likes.ark")) as w:
            Decoder(model.to("cuda"), prior).decode_to_writer(reader, w, batch_size=int(conf.get("decode_batch_size", 16)))
        reader.close()
        return read_ark(scp)

    def dist(a, b):
        return max(float(np.abs(a[u] - b[u]).max()) for u in b)

    likes = read_ark(os.path.join(run.savedir, "decode", "feats.scp"))
    plain = decode(rcfg, "cd")
    if rcfg.compute_dtype == torch.bfloat16:
        ref32 = decode(dataclasses.replace(rcfg, compute_dtype=torch.float32), "f32")
        d_k, d_p = dist(likes, ref32), dist(plain, ref32)
        log(f"{tag} likelihoods from the plain f32-compute decode: kernels {d_k!r}, plain bf16 {d_p!r}")
        assert bf16_close(d_k, d_p)
    else:
        assert dist(likes, plain) <= LIKE_TOL
    batch = train_batch(train_ws["train_featdir"], conf, text=False, context=context,
                        alifile=alifile_of(run.config)).to("cuda")
    compare_rnn_step(tag, rcfg, TrainerConfig(num_steps=6), os.path.join(run.savedir, "training", "step2.pt"),
                     batch, cell)


def test_ctc_path(train_ws, ctc_run):
    """The character-CTC recipe as written (loss ctc, beam 16, the 2 x 512
    BiLSTM in bf16): ``check_recurrent_launches``, the CTC loss on its
    F.ctc_loss route on every batch and the plain recursion never, the beam
    on the native beam, every batch from the bulk text loader, the test
    featdir's arks through the strict Kaldi consumer; the step-0 loss is
    the uniform-posterior value over 36 classes ``sum_i (T_i ln 36 - ln
    N_i) / sum_i T_i``; one ``text`` line per test utterance. Then, kernels
    against the plain versions on ``final.pt``: the test set's
    log-posteriors by the bf16 rule and the greedy transcripts on every
    utterance whose every frame's top-two margin exceeds twice their
    distance; one step from the step-2 checkpoint (``compare_rnn_step``);
    and at that step's logits the CTC loss's F.ctc_loss route against the
    plain recursion (per-row loss relative, logit gradient absolute, within
    CTC_LOSS_TOL)."""
    from tfkaldi_tpu_torch.convert import load_checkpoint
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode import ctc as ctc_decode
    from tfkaldi_tpu_torch.decode.streaming import stream_padded_batches
    from tfkaldi_tpu_torch.models import RNNConfig, build_model
    from tfkaldi_tpu_torch.ops import lstm_bidi
    from tfkaldi_tpu_torch.train import ctc
    from tfkaldi_tpu_torch.train.trainer import TrainerConfig

    run, tag = ctc_run, "CTC path"
    check_recurrent_launches(tag, run, "lstm")
    loss_routes, beams, steps = run.counts["ctc_loss"], run.counts["beams"], run.steps
    assert loss_routes["library"] >= len(steps) and loss_routes["plain"] == 0, loss_routes
    assert beams["native"] > 0 and beams["python"] == 0, beams
    check_loader(tag, "text", run)
    validate_arks(tag, [os.path.join(train_ws["test_featdir"], name) for name in ("feats.scp", "cmvn.scp")])
    conf = run.conf
    context = int(conf["context_width"])
    inputs, targets = train_batch(train_ws["train_featdir"], conf, text=True, context=context, lists=True)
    frames = [x.shape[0] for x in inputs]
    want = sum(t * math.log(CTC_CLASSES) - log_num_alignments(y, t) for t, y in zip(frames, targets)) / sum(frames)
    log(f"{tag} step-0 loss {steps[0]['loss']!r} vs the uniform-posterior value {want!r}")
    assert abs(steps[0]["loss"] - want) / want <= CTC_STEP0_TOL
    check_text_decode(tag, run, train_ws["test_featdir"])

    c, blank = lstm_bidi.CELL, CTC_CLASSES - 1
    rcfg = RNNConfig.from_config(conf, 40 * (2 * context + 1), CTC_CLASSES)
    coder = TextCoder(aurora4_normalizer)
    final = load_checkpoint(run.savedir)

    def decoder(cfg):
        model = build_model(cfg)
        model.load_state_dict(final)
        return ctc_decode.CTCDecoder(model.to("cuda"), coder, blank, beam_width=1)

    reader = eval_reader(train_ws["test_featdir"], context)
    batches = list(stream_padded_batches(reader, batch_size=int(conf.get("decode_batch_size", 16))))
    reader.close()

    def posteriors(d, plain):
        with plain_versions() if plain else contextlib.nullcontext():
            lps = [d.log_probs(x, l) for _, x, l in batches]
            paths = [p for _, x, l in batches for p in d.decode_batch(x, l)]
        return [lp[i, :n] for lp, (_, _, l) in zip(lps, batches) for i, n in enumerate(l)], paths

    dec = decoder(rcfg)
    before = c.fwd_persistent_launches
    lp_k, paths_k = posteriors(dec, False)
    assert c.fwd_persistent_launches == before + 2 * RNN_LAYERS * len(batches)
    lp_p, paths_p = posteriors(dec, True)
    lp_32, _ = posteriors(decoder(dataclasses.replace(rcfg, compute_dtype=torch.float32)), True)

    def dist(a, b):
        return max(float(np.abs(x - y).max()) for x, y in zip(a, b))

    d_k, d_p, d_kp = dist(lp_k, lp_32), dist(lp_p, lp_32), dist(lp_k, lp_p)
    margins = [float(np.diff(np.sort(lp, axis=-1)[:, -2:], axis=-1).min()) for lp in lp_p]
    clear = [i for i, m in enumerate(margins) if m > 2 * d_kp]
    same = [i for i in clear if np.array_equal(paths_k[i], paths_p[i])]
    log(f"{tag} log-posteriors from the plain f32-compute decode: kernels {d_k!r}, plain bf16 {d_p!r}; greedy "
        f"transcripts identical on {len(same)} of the {len(clear)} utterances the margins decide")
    assert bf16_close(d_k, d_p)
    assert same == clear, sorted(set(clear) - set(same))

    batch = train_batch(train_ws["train_featdir"], conf, text=True, context=context).to("cuda")
    tcfg = TrainerConfig(num_steps=6, loss_type="ctc", ctc_blank_id=blank)
    trainer, state = compare_rnn_step("CTC BiLSTM", rcfg, tcfg, os.path.join(run.savedir, "training", "step2.pt"),
                                      batch)
    with torch.no_grad():
        logits = state.model(batch.inputs, batch.input_lengths, train=True,
                             generator=trainer.dropout_generator(state)).float()
    lengths_h = ctc.host(batch.input_lengths)
    targets_h, tgt_h = ctc.host(batch.targets), ctc.host(batch.target_lengths)

    def loss_and_grad(route):
        x = logits.clone().requires_grad_(True)
        loss = ctc.ctc_loss(x, lengths_h, targets_h, tgt_h, blank, route=route)
        loss.sum().backward()
        return loss.detach(), x.grad

    ctc.reset_counts()
    loss_l, grad_l = loss_and_grad(None)
    assert ctc.launches_by_route == {"library": 1, "plain": 0}
    loss_p, grad_p = loss_and_grad("plain")
    loss_rel = ((loss_l - loss_p).abs() / loss_p.abs()).max().item()
    grad_err = (grad_l - grad_p).abs().max().item()
    log(f"CTC loss at {list(logits.shape)}: F.ctc_loss route vs plain recursion (f64): loss rel {loss_rel!r}, "
        f"gradient {grad_err!r} (tol {CTC_LOSS_TOL})")
    assert loss_rel <= CTC_LOSS_TOL and grad_err <= CTC_LOSS_TOL


def test_attention_path(attention_run, att_dirs):
    """The joint CTC-attention recipe as written (12 x 256 conformer-s4, 4
    decoder blocks, ctc_weight 0.3, bf16, rescoring decode with beam 10) on
    transcripts of at most T/8 labels: no hand kernel launched, the CTC loss
    on its F.ctc_loss route on every batch, the products on the tensor
    cores with the split kernel, every batch from the bulk text loader,
    pass 2 of the rescoring once a decode batch; the step-0 loss is the
    uniform-posterior value of both heads ``[(1-w)·sum_i (U_i+1) ln 36 +
    w·sum_i (T'_i ln 36 - ln N_i)] / sum_i T_i``; one ``text`` line per test
    utterance. Then the test set through ``final.pt`` in decode batches of
    16: the encoder memory, the CTC log-posteriors and pass 2's attention
    scores (of the CPU bf16 run's n-best) on the card against the CPU in
    bf16 and in f32 compute by the bf16 rule (both sides); the transcripts
    identical on every utterance whose n-best lists agree and whose top-two
    final scores lie further apart than twice the runs' largest score
    difference."""
    from tfkaldi_tpu_torch.convert import load_checkpoint
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode.seq2seq import CTCRescoreDecoder
    from tfkaldi_tpu_torch.decode.streaming import stream_padded_batches
    from tfkaldi_tpu_torch.models import AttentionSeq2Seq, Seq2SeqConfig

    run, tag = attention_run, "attention path"
    loss_routes, rescored, steps, conf = run.counts["ctc_loss"], run.counts["rescored"], run.steps, run.conf
    log(f"{tag}: the seven kernels {seven(run.counts)}; CTC loss {loss_routes}; rescoring {rescored}")
    assert not any(seven(run.counts).values())
    assert loss_routes["library"] >= len(steps) and loss_routes["plain"] == 0
    check_split_routes(tag, run)
    check_loader(tag, "text", run)
    inputs, targets = train_batch(att_dirs["train"], conf, text=True, context=int(conf["context_width"]), lists=True)
    w, s = float(conf["ctc_weight"]), int(conf["subsample"])
    frames = [x.shape[0] for x in inputs]
    ln_v = math.log(ATT_CLASSES)
    att = sum(len(y) + 1 for y in targets) * ln_v
    ctc_part = sum(-(-t // s) * ln_v - log_num_alignments(y, -(-t // s)) for t, y in zip(frames, targets))
    want = ((1 - w) * att + w * ctc_part) / sum(frames)
    log(f"{tag} step-0 loss {steps[0]['loss']!r} vs the uniform-posterior value {want!r}")
    assert abs(steps[0]["loss"] - want) / want <= CTC_STEP0_TOL
    check_text_decode(tag, run, att_dirs["test"])
    with open(os.path.join(att_dirs["test"], "text")) as f:
        utts = sum(1 for line in f if line.strip())
    assert rescored["batches"] == -(-utts // int(conf.get("decode_batch_size", 16)))
    assert rescored["hypotheses"] >= utts

    coder = TextCoder(aurora4_normalizer)
    cfg = Seq2SeqConfig.from_config(conf, 40, coder.num_labels)
    final = load_checkpoint(run.savedir)
    weight = float(conf["rescore_weight"])

    def decoder(c, device):
        model = AttentionSeq2Seq(c)
        model.load_state_dict(final)
        return CTCRescoreDecoder(model.to(device), coder, beam_width=int(conf["beam_width"]), rescore_weight=weight,
                                 max_tokens=int(conf["max_decode_tokens"]))

    reader = eval_reader(att_dirs["test"])
    batches = list(stream_padded_batches(reader, batch_size=int(conf.get("decode_batch_size", 16))))
    reader.close()
    runs = {"card": decoder(cfg, "cuda"), "cpu": decoder(cfg, "cpu"),
            "cpu_f32": decoder(dataclasses.replace(cfg, compute_dtype=torch.float32), "cpu")}
    dist = {name: {"memory": 0.0, "ctc_logp": 0.0, "att": 0.0} for name in ("card", "cpu")}
    out = {"card": [], "cpu": []}
    clear, same = [], []
    for _, x, lengths in batches:
        got, memories = {}, {}
        for name, d in runs.items():
            memories[name], logp = d.first_pass(x, lengths)
            got[name] = {"memory": memories[name].float().cpu(), "ctc_logp": logp.cpu()}
        nbest = {}
        for name in ("card", "cpu"):  # the decode, with each side's own n-best
            d = runs[name]
            out[name] += d.decode_batch(x, lengths)
            nbest[name] = (d.last_tokens, d.last_hyp_lens, d.last_ctc_scores, d.last_att_scores)
        tokens, hyp_lens, ctc_p, att_p = nbest["cpu"]
        filled = np.isfinite(ctc_p)
        for name, d in runs.items():  # pass 2 on the CPU bf16 run's n-best, on every side
            got[name]["att"] = d.attention_scores(memories[name], lengths, tokens, hyp_lens)[filled]
        t_out = runs["cpu"].model.output_lengths(np.asarray(lengths))
        for name in ("card", "cpu"):
            for part in ("memory", "ctc_logp"):
                ref, mine = got["cpu_f32"][part], got[name][part]
                dist[name][part] = max(dist[name][part], max(float((mine[i, :n] - ref[i, :n]).abs().max())
                                                             for i, n in enumerate(t_out)))
            dist[name]["att"] = max(dist[name]["att"], float(np.abs(got[name]["att"] - got["cpu_f32"]["att"]).max()))
        tokens_k, _, ctc_k, att_k = nbest["card"]
        for i in range(len(lengths)):
            if tokens_k.shape != tokens.shape or not np.array_equal(tokens_k[i], tokens[i]):
                continue
            final_p = weight * ctc_p[i] + (1 - weight) * att_p[i]
            final_k = weight * ctc_k[i] + (1 - weight) * att_k[i]
            ok = filled[i]
            top = np.sort(final_p[ok])
            if len(top) < 2 or top[-1] - top[-2] > 2 * float(np.abs(final_k[ok] - final_p[ok]).max()):
                index = len(out["cpu"]) - len(lengths) + i
                clear.append(index)
                if np.array_equal(out["card"][index], out["cpu"][index]):
                    same.append(index)
    log(f"{tag} test set from final.pt, max|diff| from the CPU f32-compute run: card {dist['card']!r}, CPU bf16 "
        f"{dist['cpu']!r}; transcripts identical on {len(same)} of the {len(clear)} utterances the margins decide")
    for part in dist["card"]:
        assert bf16_close(dist["card"][part], dist["cpu"][part]), part
        assert bf16_rounds(dist["card"][part], dist["cpu"][part]), part
    assert same == clear, sorted(set(clear) - set(same))


def test_transducer_path(transducer_run, att_dirs):
    """The conformer-transducer recipe as written (12 x 256 conformer-s4, a
    1 x 320 LSTM predictor, joint 320, the banded loss at S 16, bf16, beam
    8) on the attention featdirs, against the controller's schedule: the
    banded loss on every train and validation batch and the dense route
    never, kernel 4 once a loss call and kernel 5 once a train step, both
    persistent (22 and 6 without a rollback), the other kernels none, the
    products on the tensor cores with the split kernel, every batch from
    the bulk text loader, finite positive losses, one ``text`` line per
    test utterance. Then, on the first training batch with the step-0
    parameters in f32 compute, a full-width band gives the dense loss
    (each row within RNNT_TOL relative) and the S 16 banded NLL is at
    least the dense NLL on every row; on the first 16 test utterances
    through ``final.pt``, the encoder, the band scores and the per-row
    banded loss on the card against the CPU in bf16 and f32 compute by the
    bf16 rule (both sides), the band starts equal, and the greedy and
    beam-8 transcripts of the card against the CPU's, identical where the
    margins decide (greedy: the smallest top-two logit gap at a deciding
    step above 4x the joint's card-CPU difference at the start token; beam:
    the same n-best and a top-two gap above twice the score difference)."""
    from tfkaldi_tpu_torch.convert import load_checkpoint
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode.transducer import TransducerDecoder
    from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
    from tfkaldi_tpu_torch.models import Transducer, TransducerConfig
    from tfkaldi_tpu_torch.ops import rnnt_loss
    from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

    run, tag = transducer_run, "transducer path"
    conf, counts, n, v = run.conf, run.counts, len(run.steps), len(run.validations)
    valid_batches = int(conf["valid_batches"])
    plan_steps = TRAIN_UTTS // int(conf["batch_size"]) * int(conf["num_epochs"])
    plan_valid = 1 + plan_steps // int(conf["valid_frequency"])
    plan = {"lstm_fwd_persistent": plan_steps + plan_valid * valid_batches, "lstm_bwd_persistent": plan_steps}
    log(f"{tag}: schedule {plan_steps} steps, {plan_valid} validations ({plan}); ran {n} steps, validations at "
        f"{run.validations}; the seven kernels {seven(counts)}; RNN-T loss {counts['rnnt']}")
    banded = n + v * valid_batches
    assert counts["rnnt"] == {"banded": banded, "dense": 0}
    assert (counts["lstm_fwd_persistent"], counts["lstm_fwd"]) == (banded, 0)
    assert (counts["lstm_bwd_persistent"], counts["lstm_bwd"]) == (n, 0)
    if (n, v) == (plan_steps, plan_valid):
        assert {k: counts[k] for k in plan} == plan
    assert not any(x for k, x in seven(counts).items() if not k.startswith("lstm"))
    check_split_routes(tag, run)
    check_loader(tag, "text", run)
    assert all(math.isfinite(st["loss"]) and st["loss"] > 0 for st in run.steps)
    check_text_decode(tag, run, att_dirs["test"])

    coder = TextCoder(aurora4_normalizer)
    cfg = TransducerConfig.from_config(conf, 40, coder.num_labels)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    final = load_checkpoint(run.savedir)
    beam, max_symbols = int(conf["beam_width"]), int(conf["max_symbols_per_frame"])

    def model_on(c, device, sd=final):
        m = Transducer(c)
        m.load_state_dict(sd)
        return m.to(device).eval()

    def band_losses(model, batch):
        args = (batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths)
        with torch.no_grad():
            lpb, lpl, starts = model.lattice_scores_pruned(*args)
            loss = rnnt_loss.rnnt_alpha_loss_banded(lpb, lpl, starts, model.output_lengths(batch.input_lengths),
                                                    batch.target_lengths)
        return loss.float().cpu(), lpb.float().cpu(), lpl.float().cpu(), starts.cpu()

    def dense_losses(model, batch):
        args = (batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths)
        with torch.no_grad():
            lpb, lpl = model.lattice_scores(*args)
            return rnnt_loss.rnnt_alpha_loss(lpb, rnnt_loss.mask_label_scores(lpl, batch.target_lengths),
                                             model.output_lengths(batch.input_lengths),
                                             batch.target_lengths).float().cpu()

    # the lattice at full width, step-0 parameters, f32 compute
    first = train_batch(att_dirs["train"], conf, text=True).to("cuda")
    u_pad = first.targets.shape[1]
    init = Trainer(cfg, TrainerConfig(loss_type="rnnt"), device="cpu").init_state(0).model.state_dict()
    dense = dense_losses(model_on(cfg32, "cuda", init), first)
    full = band_losses(model_on(dataclasses.replace(cfg32, prune_s=u_pad + 1), "cuda", init), first)[0]
    band = band_losses(model_on(cfg32, "cuda", init), first)[0]
    full_rel = float(((full - dense).abs() / dense.abs()).max())
    below = float(((dense - band) / dense.abs()).max())
    log(f"{tag} lattice, U_pad {u_pad}: full-width band vs dense max rel {full_rel!r}; S {cfg.prune_s} band's "
        f"largest shortfall below the dense NLL {below!r} (tol {RNNT_TOL} each)")
    assert full_rel <= RNNT_TOL and below <= RNNT_TOL

    # the card against the CPU on final.pt
    test_batch = train_batch(att_dirs["test"], {"batch_size": 16, "valid_batches": 0}, text=True)
    outs, models = {}, {}
    for name, (c, device) in {"card": (cfg, "cuda"), "cpu": (cfg, "cpu"), "cpu_f32": (cfg32, "cpu")}.items():
        models[name] = model_on(c, device)
        b_ = test_batch.to(device)
        with torch.no_grad():
            enc = models[name].encode(b_.inputs, b_.input_lengths).float().cpu()
        outs[name] = (enc, *band_losses(models[name], b_))
    t_out = torch.as_tensor(models["cpu"].output_lengths(test_batch.input_lengths))
    dist = {}
    for name in ("card", "cpu"):
        enc, loss, lpb, lpl, starts = outs[name]
        ref = outs["cpu_f32"]
        assert torch.equal(starts, ref[4]), name
        ok = torch.arange(lpb.shape[1])[None, :] < t_out[:, None]
        dist[name] = {"encoder": max(float((enc[i, :n] - ref[0][i, :n]).abs().max()) for i, n in enumerate(t_out)),
                      "blank scores": float((lpb - ref[2])[ok].abs().max()),
                      "label scores": float(torch.where(ref[3] > -1e8, lpl - ref[3], 0.0)[ok].abs().max()),
                      "loss": float(((loss - ref[1]).abs() / ref[1].abs()).max())}
    x, lengths = test_batch.inputs, test_batch.input_lengths  # numpy on the host
    calls = []
    joint_step = models["cpu"].joint_step

    def recording(enc_frames, pred_proj):
        logits = joint_step(enc_frames, pred_proj)
        calls.append(logits.float())
        return logits

    greedy = {"card": TransducerDecoder(models["card"], coder, max_symbols_per_frame=max_symbols).decode_batch(
        x, lengths)}
    models["cpu"].joint_step = recording
    greedy["cpu"] = TransducerDecoder(models["cpu"], coder, max_symbols_per_frame=max_symbols).decode_batch(
        x, lengths)
    del models["cpu"].joint_step
    # the search calls the joint max_symbols times a frame: the steps that decide an
    # emission are a valid frame's first, and each one after an emission in that frame
    steps = torch.stack(calls).reshape(-1, max_symbols, len(lengths), calls[0].shape[-1])  # [T', S, B, V]
    top = torch.topk(steps, 2, dim=-1).values
    emits = steps.argmax(dim=-1) != models["cpu"].blank_id
    active = [torch.arange(steps.shape[0])[:, None] < t_out[None, :]]
    for k in range(1, max_symbols):
        active.append(active[-1] & emits[:, k - 1])
    gap = torch.where(torch.stack(active, dim=1), top[..., 0] - top[..., 1], torch.inf).amin(dim=(0, 1))
    with torch.no_grad():  # the joint's noise: every frame at the start token on both sides
        start_logits = {}
        for name in ("card", "cpu"):
            m = models[name]
            dev = m.embed.device
            proj, _ = m.predict_step(torch.full((x.shape[0],), m.blank_id, device=dev),
                                     torch.ones(x.shape[0], dtype=torch.bool, device=dev),
                                     m.init_pred_carry(x.shape[0]))
            enc = outs[name][0].to(dev)
            start_logits[name] = m.joint_step(enc, proj[:, None, :].expand_as(enc)).float().cpu()
    noise = max(float((start_logits["card"][i, :n] - start_logits["cpu"][i, :n]).abs().max())
                for i, n in enumerate(t_out))
    decided = [i for i in range(len(lengths)) if float(gap[i]) > 4 * noise]
    same = [i for i in decided if np.array_equal(greedy["card"][i], greedy["cpu"][i])]
    nbest = {name: TransducerBeamDecoder(models[name], coder, beam_width=beam, max_symbols_per_frame=max_symbols)
             .decode_batch_nbest(x, lengths) for name in ("card", "cpu")}
    beam_decided, beam_same = [], []
    for i, (hk, hc) in enumerate(zip(nbest["card"], nbest["cpu"])):
        if len(hk) != len(hc) or not all(np.array_equal(a[0], b_[0]) for a, b_ in zip(hk, hc)):
            continue
        diff = max(abs(a[1] - b_[1]) for a, b_ in zip(hk, hc))
        if len(hc) < 2 or hc[0][1] - hc[1][1] > 2 * diff:
            beam_decided.append(i)
            if np.array_equal(hk[0][0], hc[0][0]):
                beam_same.append(i)
    log(f"{tag} card vs CPU on final.pt, max|diff| from the CPU f32-compute run: card {dist['card']!r}, CPU bf16 "
        f"{dist['cpu']!r}; greedy identical on {len(same)} of the {len(decided)} decided, beam-{beam} on "
        f"{len(beam_same)} of {len(beam_decided)}")
    for part in dist["card"]:
        assert bf16_close(dist["card"][part], dist["cpu"][part]), part
        assert bf16_rounds(dist["card"][part], dist["cpu"][part]), part
    assert same == decided and beam_same == beam_decided


def greedy_walk(model, x, lengths, max_tokens: int) -> list:
    """Greedy decode of a padded batch by the cached step alone: each row
    takes the argmax of its running score plus the step's log-posteriors (the
    lower index on a tie, as the beam's stable sort) until EOS or
    ``max_tokens`` labels. Returns the label ids per row."""
    dev = model.embed.device
    with torch.inference_mode():
        lengths = torch.as_tensor(lengths, dtype=torch.int32)
        memory = model.encode(torch.as_tensor(x).to(dev), lengths)
        valid = model.memory_valid(memory, lengths)
        cross_k, cross_v = model.cross_kv(memory)
        n = memory.shape[0]
        cache = model.init_decode_cache(n, max_tokens)
        tok = torch.full((n,), model.sos_eos_id, dtype=torch.long, device=dev)
        score = torch.zeros(n, device=dev)
        ids, done = [[] for _ in range(n)], [False] * n
        for step in range(max_tokens):
            logits, cache = model.decode_step_cached(tok, step, cache, cross_k, cross_v, valid)
            total = score[:, None] + torch.log_softmax(logits, dim=-1)
            tok = torch.argmax(total, dim=-1)
            score = total.gather(1, tok[:, None])[:, 0]
            for i, t in enumerate(tok.tolist()):
                done[i] = done[i] or t == model.sos_eos_id
                if not done[i]:
                    ids[i].append(t)
            if all(done):
                break
    return ids


def beam_replay(card_dec, cpu_dec, x, lengths) -> dict:
    """The card's attention beam step by step with the CPU replaying the
    card's choices: at each step both compute the candidate scores of the
    same hypotheses; wherever the CPU's top-K set differs from the card's,
    the card's choice must be a near tie on the CPU (the CPU's best
    candidate the card left out at most twice the row's largest card-CPU
    candidate difference above the card's worst pick). The replayed run
    must equal the card decoder's own n-best. Returns the counts."""
    neg = -1e30 / 2
    steps = flips = 0
    with torch.inference_mode():
        card, cpu = card_dec.begin(x, lengths), cpu_dec.begin(x, lengths)
        while card_dec.live(card):
            ck, cc = card_dec.candidates(card), cpu_dec.candidates(cpu)
            flat = card_dec.select(ck)
            flat_cpu, ckc, fk = cpu_dec.select(cc), ck.cpu(), flat.cpu()
            noise = torch.where((ckc > neg) & (cc > neg), (ckc - cc).abs(), 0.0).amax(dim=1)
            for row, (mine, theirs) in enumerate(zip(fk.tolist(), flat_cpu.tolist())):
                picked, left = sorted(set(mine) - set(theirs)), sorted(set(theirs) - set(mine))
                if picked:
                    excess = float(cc[row, left].max() - cc[row, picked].min())
                    assert excess <= 2 * float(noise[row]), (card.step, row, picked, excess, float(noise[row]))
                    flips += 1
            card_dec.advance(card, ck, flat)
            cpu_dec.advance(cpu, cc, fk)
            steps += 1
        replayed = [t.cpu() for t in card_dec.close(card)]
    mine = card_dec.decode_batch_nbest(x, lengths)
    buf, counts, scores, ranked = (t.numpy() for t in replayed)
    for row, hyps in enumerate(mine):
        order = [k for k in sorted(range(buf.shape[1]), key=lambda k: -ranked[row, k]) if scores[row, k] > neg]
        want = [(buf[row, k, :counts[row, k]].tolist(), float(scores[row, k])) for k in order]
        assert [(ids.tolist(), score) for ids, score in hyps] == want, row
    return {"steps": steps, "near_ties": flips}


def test_text_decode_path(train_ws, att_dirs, ctc_run, attention_run, transducer_run, char_lm):
    """The text recipes' offline decode as the JAX package runs it, on the
    models the CTC, attention and transducer phases trained, with a
    character trigram from the training transcripts:

    - attention, ``decode_mode = beam`` (beam 10, at most 200 tokens)
      through ``Nnet.load_text_decoder``: the card's beam on the first
      decode batch's first REPLAY_ROWS utterances replayed on the CPU
      (``beam_replay``); beam 1 equal to a greedy walk of the cached step;
      the LM-fused decoder's table over the alphabet and </s>;
    - transducer, beam 8 with ``lm_path``: a zero-weight table gives the
      unfused n-best exactly on the first decode batch;
    - CTC, beam 16 with ``lm_path``: the fused route on every decode batch,
      kernel 4 once per layer and batch;
    - ``cli.serve --once`` on one job per recipe: its ``text`` equals
      ``Nnet.decode_text``'s and ``DONE`` holds the utterance count.

    The phase launches no hand kernel but kernel 4 (the fused CTC decode
    and the CTC spool job)."""
    from tfkaldi_tpu_torch.cli import serve as cli_serve
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode import ctc as ctc_decode
    from tfkaldi_tpu_torch.decode.seq2seq import Seq2SeqBeamDecoder
    from tfkaldi_tpu_torch.decode.streaming import stream_padded_batches
    from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
    from tfkaldi_tpu_torch.nnet import Nnet

    root = os.path.join(TRAIN_WORK, "text_decode")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    coder = TextCoder(aurora4_normalizer)

    def variant(run: Run, tag: str, **keys) -> str:
        return variant_config(run.cfg_path, os.path.join(root, f"config_{tag}.cfg"), keys)

    def nnet(cfg_path: str, dev: str = "cuda"):
        config = ConfigParser()
        config.read(cfg_path)
        return Nnet(config, 40, coder.num_labels, device=dev)

    def decode(decoder, featdir: str, context: int, out: str) -> int:
        reader = eval_reader(featdir, context)
        count = decoder.decode_to_file(reader, out)
        reader.close()
        return count

    reset_counts()
    # attention: the autoregressive beam, JAX's default decode mode
    beam_cfg = variant(attention_run, "attention_beam", decode_mode="beam")
    fused_cfg = variant(attention_run, "attention_beam_lm", decode_mode="beam", lm_path=char_lm, lm_alpha=0.5)
    dec = nnet(beam_cfg).load_text_decoder(coder)
    assert isinstance(dec, Seq2SeqBeamDecoder) and (dec.beam, dec.max_tokens, dec.fusion) == (10, 200, None)
    _, x, lengths = next(iter(stream_padded_batches(eval_reader(att_dirs["test"]), batch_size=16)))
    replay = beam_replay(dec, nnet(beam_cfg, "cpu").load_text_decoder(coder), x[:REPLAY_ROWS], lengths[:REPLAY_ROWS])
    log(f"attention beam 10, card against CPU on {REPLAY_ROWS} utterances: {replay}")
    beam1 = Seq2SeqBeamDecoder(dec.model, coder, beam_width=1, max_tokens=dec.max_tokens).decode_batch(x, lengths)
    walk = greedy_walk(dec.model, x, lengths, dec.max_tokens)
    assert [i for i, (a, b) in enumerate(zip(beam1, walk)) if not np.array_equal(a, b)] == []
    fused = nnet(fused_cfg).load_text_decoder(coder)
    assert fused.fusion is not None and fused.fusion.table.shape[1] == coder.num_labels + 1
    att_text = os.path.join(root, "attention_beam10_lm.txt")
    decode(fused, att_dirs["test"], 0, att_text)
    del dec, fused

    # transducer: beam 8 with the LM, and the zero-weight table
    rnnt_cfg = variant(transducer_run, "transducer_lm", lm_path=char_lm, lm_alpha=0.5)
    zero_cfg = variant(transducer_run, "transducer_lm0", lm_path=char_lm, lm_alpha=0, lm_beta=0)
    fused = nnet(rnnt_cfg).load_text_decoder(coder)
    assert isinstance(fused, TransducerBeamDecoder) and fused.beam == 8 and fused.fusion is not None
    rnnt_text = os.path.join(root, "transducer_beam8_lm.txt")
    decode(fused, att_dirs["test"], 0, rnnt_text)
    zero = nnet(zero_cfg).load_text_decoder(coder)
    assert not zero.fusion.table.any()
    plain = TransducerBeamDecoder(zero.model, coder, beam_width=zero.beam, max_symbols_per_frame=zero.max_symbols)
    a, b = zero.decode_batch_nbest(x, lengths), plain.decode_batch_nbest(x, lengths)
    assert [[(i.tolist(), s) for i, s in r] for r in a] == [[(i.tolist(), s) for i, s in r] for r in b]
    del fused, zero, plain

    # CTC: beam 16 with the FusionScorer (the Python beam)
    ctc_nnet = nnet(variant(ctc_run, "ctc_lm", lm_path=char_lm, lm_alpha=0.5))
    dec = ctc_nnet.load_text_decoder(coder)
    assert dec.fusion_scorer is not None and dec.beam_width == 16
    runs0, fwd0 = dict(ctc_decode.beam_runs), seven(counters())["lstm_fwd_persistent"]
    count = decode(dec, train_ws["test_featdir"], ctc_nnet.context_width, os.path.join(root, "ctc_beam16_lm.txt"))
    batches = -(-count // 16)
    assert {k: ctc_decode.beam_runs[k] - runs0[k] for k in runs0} == {"native": 0, "python": 0, "fused": batches}
    assert seven(counters())["lstm_fwd_persistent"] - fwd0 == RNN_LAYERS * batches
    del dec

    # the spool server for text models
    ctc_text = os.path.join(ctc_run.savedir, "decode", "text")  # the CTC phase's decode_text, no LM
    for kind, cfg_path, featdir, want in (("ctc", ctc_run.cfg_path, train_ws["test_featdir"], ctc_text),
                                          ("attention", fused_cfg, att_dirs["test"], att_text),
                                          ("rnnt", rnnt_cfg, att_dirs["test"], rnnt_text)):
        spool_in, spool_out = os.path.join(root, f"spool_{kind}", "in"), os.path.join(root, f"spool_{kind}", "out")
        shutil.copytree(featdir, os.path.join(spool_in, "job0"))
        assert cli_serve.main(["--config", cfg_path, "--watch", spool_in, "--out", spool_out, "--once",
                               "--device", "cuda"]) == 0, kind
        with open(os.path.join(spool_out, "job0", "text")) as f:
            got = f.read()
        with open(want) as f:
            expected = f.read()
        with open(os.path.join(spool_out, "job0", "DONE")) as f:
            done = f.read()
        assert got == expected and done == f"{len(expected.splitlines())}\n", kind
    launches = seven(counters())
    log(f"text decode path launches of the seven kernels {launches}")
    assert launches["lstm_fwd_persistent"] == RNN_LAYERS * 2 * batches
    assert not any(v for k, v in launches.items() if k != "lstm_fwd_persistent")


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

def stream_replay(ext, wavs: list, encode, cmvn=None, slots: int = STREAM_SLOTS) -> list:
    """The wavs through the fused front-end and ``encode`` as the server's
    slots run them: ``slots`` rows a batch (a wav a row, empty rows to
    fill it), STREAM_CHUNK-sample pushes from each row's start, length 0
    once a row's audio ends, then the flush of every row. Each push's
    frames are CMVN'd by ``apply_cmvn`` (when given; frames past a row's
    count zero, as the fused call leaves them) and go to ``encode(feats,
    counts, carry) -> (per-row outputs, carry)``; the flush calls
    ``encode(None, None, carry)``. Every call has the shapes a server tick
    has, and every op of the path works row by row, so a row's numbers are
    its slot's. Returns per wav ``(frames before CMVN, outputs)``,
    concatenated."""
    from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn
    from tfkaldi_tpu_torch.frontend.online import FusedOnlineFeatureExtractor

    out = []
    for g in range(0, len(wavs), slots):
        group = wavs[g: g + slots]
        online = FusedOnlineFeatureExtractor(ext)
        online.reset(slots)
        frames = [[] for _ in group]
        outs = [[] for _ in group]
        carry = None
        longest = max(len(w) for w in group)
        with torch.inference_mode():
            for p in [*range(0, longest, STREAM_CHUNK), None]:
                if p is not None:
                    chunk = np.zeros((slots, STREAM_CHUNK), np.float32)
                    lens = np.zeros((slots,), np.int64)
                    for r, w in enumerate(group):
                        part = w[p: p + STREAM_CHUNK]
                        chunk[r, : len(part)] = part
                        lens[r] = len(part)
                    f, k = online.step(chunk, lens)
                else:
                    f, k = online.flush()
                if not f.shape[1]:
                    continue
                for r in range(len(group)):
                    frames[r].append(f[r, : int(k[r])])
                if cmvn is not None:
                    f = apply_cmvn(f, cmvn)
                    past = torch.arange(f.shape[1], device=f.device)[None, :] >= torch.as_tensor(k, device=f.device)[:, None]
                    f[past] = 0.0
                ys, carry = encode(f, k, carry)
                for r in range(len(group)):
                    outs[r].append(ys[r])
            ys, carry = encode(None, None, carry)
            for r in range(len(group)):
                outs[r].append(ys[r])
        out += [(torch.cat(fr), torch.cat(o)) for fr, o in zip(frames, outs)]
    return out


def greedy_node(model, e_off, e32, ids_off, fr_off, ids_rep, fr_rep):
    """Where two greedy transducer searches part: the first emission
    ``(label, frame)`` that differs, at the node they share (the frame, and
    the labels emitted before it). Its decision is a near tie when the
    offline log-prob margin of its choice over the other's is within twice
    the bf16 noise there, the max|log-prob difference| between the offline
    encoder's output and the f32-compute encoder's under the same joint and
    prediction network (independent of the other search): ``(margin,
    noise)``, else None."""
    blank = model.blank_id
    k = 0
    while k < min(len(ids_off), len(ids_rep)) and (ids_off[k], fr_off[k]) == (ids_rep[k], fr_rep[k]):
        k += 1
    frames = [f[k] for f in (fr_off, fr_rep) if k < len(f)]
    t = min(frames)
    choice_off = int(ids_off[k]) if k < len(ids_off) and fr_off[k] == t else blank
    choice_rep = int(ids_rep[k]) if k < len(ids_rep) and fr_rep[k] == t else blank
    dev = e_off.device
    with torch.inference_mode():
        proj, carry = model.predict_step(torch.full((1,), blank, device=dev),
                                         torch.ones(1, dtype=torch.bool, device=dev), model.init_pred_carry(1))
        for label in ids_off[:k]:
            proj, carry = model.predict_step(torch.full((1,), int(label), device=dev),
                                             torch.ones(1, dtype=torch.bool, device=dev), carry)
        lo = torch.log_softmax(model.joint_step(e_off[t: t + 1], proj).float(), -1)[0]
        l32 = torch.log_softmax(model.joint_step(e32[t: t + 1], proj).float(), -1)[0]
    margin, noise = float(lo[choice_off] - lo[choice_rep]), float((l32 - lo).abs().max())
    return (margin, noise) if margin <= 2 * noise else None


def nbest_tie(hyp: str, off: list, ref: list):
    """The beam rule: ``off`` / ``ref`` are ``[(text, score)]`` n-bests
    (best first) of the offline search and of the same search on the
    f32-compute model's numbers. A replayed best ``hyp`` that is not the
    offline best is a near tie when it is in the offline n-best and its
    offline score is within twice the bf16 noise, the largest score
    difference of the hypotheses both ``off`` and ``ref`` hold: ``(gap,
    noise)``, else None."""
    off_s, ref_s = dict(off), dict(ref)
    noise = max((abs(off_s[h] - ref_s[h]) for h in off_s if h in ref_s), default=0.0)
    if hyp not in off_s:
        return None
    gap = off[0][1] - off_s[hyp]
    return (gap, noise) if gap <= 2 * noise else None


def test_streaming_path(train_ws, att_dirs, ctc_run, transducer_run, char_lm):
    """``cli.serve --stream`` on the card as users start it, on the 32 test
    wavs of the training workspace in STREAM_CHUNK chunks:

    - the transducer recipe as written on its trained ``final.pt`` (beam 8,
      16 slots), 16 concurrent clients; then 4 and 1 at a time;
      ``--beam-width 1``; the character trigram as ``lm_path``; and
      ``--slots`` 32 and 64 with as many streams;
    - the CTC recipe with ``bidirectional = False`` and ``context_width =
      0`` on a seeded ``final.pt``: greedy, beam 16 with the trigram,
      greedy with ``--endpoint``, and greedy with every client reading back
      its timestamps, confidences and words.

    ``stream_replay`` runs the wavs through the same front-end and model
    calls in the slots' batch shapes, so each served final must equal the
    search on its replayed numbers exactly. Against the card's offline
    decoder on the offline extractor's features (kernel 2) with the same
    CMVN, a final is identical, or the first decision where the replayed
    and the offline numbers part is a near tie: its offline margin within
    twice the offline model's own bf16 noise (its distance from the same
    model in f32 compute). The replayed encoder output and CTC
    log-posteriors are held to the bf16 rule against the f32-compute
    offline forward, the fused front-end's frames to the offline
    extractor's within STREAM_FEAT_TOL. The path itself launches no hand
    kernel: only the offline references' kernels 2 and 4 count."""
    from tfkaldi_tpu_torch.convert import save_checkpoint
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode.ctc_beam import beam_step, initial_beams, nbest_prefixes
    from tfkaldi_tpu_torch.decode.lm import ArpaLM, DenseFusionTable, FusionScorer
    from tfkaldi_tpu_torch.decode.transducer import TransducerDecoder
    from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
    from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn
    from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
    from tfkaldi_tpu_torch.io import read_wav, read_wavfiles
    from tfkaldi_tpu_torch.models import Transducer
    from tfkaldi_tpu_torch.nnet import Nnet
    from tfkaldi_tpu_torch.ops import rnn_bidi
    from tfkaldi_tpu_torch.serve import MultiStreamServer, global_cmvn

    root = os.path.join(TRAIN_WORK, "streaming")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    arpa, device = char_lm, "cuda"
    coder = TextCoder(aurora4_normalizer)
    blank = coder.num_labels
    base = ConfigParser()
    base.read(train_ws["cfg_path"])
    wav_scp = read_wavfiles(os.path.join(base.get("directories", "test_data"), "wav.scp"))
    rates, audio = set(), []
    for utt in wav_scp:
        rate, sig = read_wav(wav_scp[utt])
        rates.add(rate)
        audio.append(np.asarray(sig, np.float32))
    assert rates == {16000} and len(audio) == 32
    rate = 16000
    all32 = list(range(32))
    dev = torch.device(device)
    assert MultiStreamServer.DEFAULT_SLOTS == STREAM_SLOTS

    def variant(src: str, tag: str, **keys) -> str:
        return variant_config(src, os.path.join(root, f"config_{tag}.cfg"), keys)

    def offline_feats(wavs):  # padded to whole seconds, as prepare_data pads (kernel 2's bulk route)
        batch = np.zeros((len(wavs), -(-max(len(w) for w in wavs) // rate) * rate), np.float32)
        for i, w in enumerate(wavs):
            batch[i, : len(w)] = w
        with torch.inference_mode():
            return ext(batch, np.asarray([len(w) for w in wavs]))

    def padded(rows: list):
        """Per-row ``[T_i, J]`` tensors → ``([B, T_max, J], valid [B, T_max])``."""
        t_max = max(max(r.shape[0] for r in rows), 1)
        x = torch.zeros(len(rows), t_max, rows[0].shape[-1], device=dev)
        for i, r in enumerate(rows):
            x[i, : r.shape[0]] = r
        lens = torch.as_tensor([r.shape[0] for r in rows], device=dev)
        return x, torch.arange(t_max, device=dev)[None, :] < lens[:, None]

    reset_counts()
    frame_calls = 0

    # ---- offline features (kernel 2) against the slots' front-end ----
    ext = FeatureExtractor(FeatureOpts.from_config(dict(base.items("dnn-features"))), rate, dev)
    raw, nframes = offline_feats(audio)
    frame_calls += 1
    empty = [torch.zeros(0, device=dev)] * STREAM_SLOTS
    feat_err, feat_exact = 0.0, 0
    for i, (f, _) in enumerate(stream_replay(ext, audio, lambda f, k, carry: (empty, carry))):
        ref = raw[i, : nframes[i]]
        assert f.shape == ref.shape, i
        feat_err = max(feat_err, float(((f - ref).abs() / ref.abs().clamp(min=1.0)).max()))
        feat_exact += bool(torch.equal(f, ref))
    log(f"streaming: the fused front-end against the offline extractor: bit-identical on {feat_exact} of 32 wavs, "
        f"max err/max(|ref|,1) {feat_err!r} (tol {STREAM_FEAT_TOL})")
    assert feat_err <= STREAM_FEAT_TOL

    def served(cfg: str, flags: tuple, runs: list, slots: int = STREAM_SLOTS) -> list:
        """One server of ``slots`` slots; each run ``(tag, wav indices,
        concurrency, requests)`` a batch of clients; returns each run's
        results."""
        out = []
        with stream_server(cfg, "--device", device, *flags) as (host, port, server):
            assert (server.num_slots, server.chunk_size) == (slots, STREAM_CHUNK)
            for tag, idx, conc, requests in runs:
                res = stream_clients(host, port, [audio[i] for i in idx], conc, requests)
                res.update(tag=tag, idx=idx)
                out.append(res)
        return out

    def judge(tag: str, res: dict, replay: list, offline: list, explain) -> dict:
        """Each served final: equal to the search on its slot's replayed
        numbers, else the run fails; against the offline decode identical,
        or ``explain(i)`` a near tie ``(margin, noise)`` (its margin within
        twice the offline model's own bf16 noise), else it fails."""
        same, ties = 0, []
        for j, i in enumerate(res["idx"]):
            got = res["results"][j]["final"]
            assert got == replay[i], f"{tag}: wav {i} served {got!r}, its slot's replay {replay[i]!r}"
            if got == offline[i]:
                same += 1
                continue
            tie = explain(i)
            assert tie is not None, f"{tag}: wav {i} served {got!r}, offline {offline[i]!r}, no near tie"
            ties.append((i, *[float(v) for v in tie]))
        log(f"streaming {tag}: finals identical to the card's offline decode on {same} of {len(res['idx'])} wavs "
            f"(and each equal to its slot's replay); near ties {len(ties)} (wav, offline margin, offline bf16 noise "
            f"against the f32-compute model; a tie needs margin <= 2 x noise): {ties}")
        return {"identical": same, "near_ties": len(ties)}

    verdicts = {}

    # ---- the transducer recipe as written ----
    rnnt_cfg = transducer_run.cfg_path
    rconf = ConfigParser()
    rconf.read(rnnt_cfg)
    model = Nnet(rconf, 40, coder.num_labels, device=dev)._load_model().eval()
    beam = int(rconf.get("nnet", "beam_width"))
    max_sym = int(rconf.get("nnet", "max_symbols_per_frame", fallback="4"))
    cmvn = global_cmvn(att_dirs["train"])
    x = apply_cmvn(raw, cmvn)
    n_t = torch.as_tensor(nframes, device=dev)
    m32 = Transducer(dataclasses.replace(model.config, compute_dtype=torch.float32)).to(dev).eval()
    m32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        enc_off, enc32 = model.encode(x, n_t), m32.encode(x, n_t)
    del m32
    t_out = model.output_lengths(n_t).tolist()
    valid_off = torch.arange(enc_off.shape[1], device=dev)[None, :] < torch.as_tensor(t_out, device=dev)[:, None]

    def rnnt_encode(f, k, carry):
        carry = model.enc.init_stream_carry(f.shape[0], dev) if carry is None else carry
        if f is None:
            y, m, carry = model.encode_stream_flush(carry)
        else:
            y, m, carry = model.encode_stream(f, torch.as_tensor(np.asarray(k), device=dev), carry)
        return [y[r, : int(c)] for r, c in enumerate(m.tolist())], carry

    def rnnt_replay(slots: int) -> list:
        """The 32 wavs' encoder outputs as ``slots`` server slots compute
        them, each held to the bf16 rule against the f32-compute encode."""
        enc_rep = [e for _, e in stream_replay(ext, audio, rnnt_encode, cmvn, slots)]
        d_rep = d_off = d_ro = 0.0
        bad = []
        for i, e in enumerate(enc_rep):
            assert e.shape[0] == t_out[i], i
            ref = enc32[i, : t_out[i]]
            a, b = float((e - ref).abs().max()), float((enc_off[i, : t_out[i]] - ref).abs().max())
            d_rep, d_off = max(d_rep, a), max(d_off, b)
            d_ro = max(d_ro, float((e - enc_off[i, : t_out[i]]).abs().max()))
            if not bf16_close(a, b):
                bad.append((i, a, b))
        log(f"streaming transducer encoder (bf16), replayed in the shapes of {slots} slots against the offline encode "
            f"of the batch: max|replay - offline| {d_ro!r}; from the f32-compute encode: replay {d_rep!r}, offline "
            f"{d_off!r} (bf16 rule per wav: within {RNN_BF16_RATIO}x + {RNN_F32_TOL})")
        assert not bad, f"the streamed encoder ({slots} slots) is outside the bf16 rule on wavs {bad}"
        return enc_rep

    def searched(dec, rows: list, slots: int = STREAM_SLOTS) -> list:
        """``dec.search`` over per-row encoder outputs in batches of the
        slots' row count (each row on its own in a batch of the server's
        size); the host copies, row by row."""
        out = []
        for g in range(0, len(rows), slots):
            group = rows[g: g + slots]
            enc, valid = padded(group + [group[0][:0]] * (slots - len(group)))
            res = [t.cpu().numpy() for t in dec.search(enc, valid)]
            out += [[t[r] for t in res] for r in range(len(group))]
        return out

    def whole(dec, enc=None):  # the offline decode: the 32 rows of the offline batch together
        res = [t.cpu().numpy() for t in dec.search(enc_off if enc is None else enc, valid_off)]
        return [[t[r] for t in res] for r in range(32)]

    def nbest(rows):
        out = []
        for buf, _, _, counts, scores in rows:
            order = np.argsort(-scores, kind="stable")
            out.append([(coder.decode(buf[k, : counts[k]]), float(scores[k])) for k in order if scores[k] > -1e29])
        return out

    enc_rep = rnnt_replay(STREAM_SLOTS)
    greedy = TransducerDecoder(model, coder, max_symbols_per_frame=max_sym)
    g_off, g_rep = whole(greedy), searched(greedy, enc_rep)
    ali = {side: [(r[0][: r[3]].tolist(), r[1][: r[3]].tolist()) for r in rows]
           for side, rows in (("off", g_off), ("rep", g_rep))}
    table = DenseFusionTable(ArpaLM.load(arpa), list(coder.alphabet), list(coder.alphabet), alpha=0.5, beta=0.0)
    beams = {}
    for tag, fusion in (("beam", None), ("beam_lm", table)):
        dec = TransducerBeamDecoder(model, coder, beam_width=beam, max_symbols_per_frame=max_sym, fusion_table=fusion)
        beams[tag] = (dec, nbest(whole(dec)), nbest(whole(dec, enc32)), nbest(searched(dec, enc_rep)))

    def beam_verdict(tag: str, res: dict, key: str, rep=None) -> dict:
        _, off, ref, rep16 = beams[key]
        rep = rep16 if rep is None else rep
        return judge(tag, res, [rep[i][0][0] for i in range(32)], [h[0][0] for h in off],
                     lambda i: nbest_tie(rep[i][0][0], off[i], ref[i]))

    runs = served(rnnt_cfg, (), [("transducer beam 8, 16 streams", all32, 16, False),
                                 ("transducer beam 8, 4 streams", all32[:4], 4, False),
                                 ("transducer beam 8, 1 stream", all32[:1], 1, False)])
    for res in runs:
        verdicts[res["tag"]] = beam_verdict(res["tag"], res, "beam")
    (res,) = served(rnnt_cfg, ("--beam-width", "1"), [("transducer greedy, 16 streams", all32, 16, False)])
    verdicts[res["tag"]] = judge(
        res["tag"], res, [coder.decode(ids) for ids, _ in ali["rep"]], [coder.decode(ids) for ids, _ in ali["off"]],
        lambda i: greedy_node(model, enc_off[i, : t_out[i]], enc32[i, : t_out[i]], *ali["off"][i], *ali["rep"][i]))
    fused_cfg = variant(rnnt_cfg, "transducer_lm", lm_path=arpa, lm_alpha=0.5)
    (res,) = served(fused_cfg, (), [("transducer beam 8 + trigram, 16 streams", all32, 16, False)])
    verdicts[res["tag"]] = beam_verdict(res["tag"], res, "beam_lm")
    # the slots' ceiling: as many streams as slots (the 32 wavs twice for 64), every final still held
    for slots in STREAM_CEILING_SLOTS:
        rep = nbest(searched(beams["beam"][0], rnnt_replay(slots), slots))
        idx = (all32 * (slots // 32 + 1))[:slots]
        (res,) = served(rnnt_cfg, ("--slots", str(slots)),
                        [(f"transducer beam 8, {slots} slots, {slots} streams", idx, slots, False)], slots)
        verdicts[res["tag"]] = beam_verdict(res["tag"], res, "beam", rep)
    del model, enc_off, enc_rep, enc32, beams

    # ---- the CTC recipe, unidirectional, seeded ----
    ctc_cfg = variant(ctc_run.cfg_path, "ctc_uni", bidirectional="False", context_width=0, name="ctc_unilstm_512_2")
    cconf = ConfigParser()
    cconf.read(ctc_cfg)
    cnet = Nnet(cconf, 40, coder.num_labels, device=dev)
    gen = torch.Generator().manual_seed(13)
    cnet.model.reset_parameters(gen)
    with torch.no_grad():
        w = cnet.model.out.w
        w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w.shape[0]) * CTC_OUT_GAIN)
        cnet.model.out.b[blank] = CTC_BLANK_BIAS
    save_checkpoint(cnet.savedir, cnet.model.state_dict())
    cmodel = cnet._load_model().eval()
    c32 = type(cmodel)(dataclasses.replace(cmodel.config, compute_dtype=torch.float32)).to(dev).eval()
    c32.load_state_dict(cmodel.state_dict())
    ccmvn = global_cmvn(train_ws["train_featdir"])
    width = int(cconf.get("nnet", "beam_width"))
    lstm_want = {"lstm_fwd_persistent": 0, "lstm_fwd": 0}

    def offline_lp(raw_feats, counts):
        """Per wav the offline forward's log-posteriors (kernel 4, one
        direction), bf16 as configured and f32-compute on the same
        weights: ``(bf16 list, f32 list)``."""
        x = apply_cmvn(raw_feats, ccmvn)
        out = []
        for m in (cmodel, c32):
            with torch.inference_mode():
                lp = torch.log_softmax(m(x, torch.as_tensor(counts, device=dev)).float(), -1).cpu().numpy()
            cfg = m.config
            plan = rnn_bidi.fwd_plan(len(counts), cfg.hidden_units, m.GATES, cfg.compute_dtype, 1)
            persistent = plan.route == "persistent"
            lstm_want["lstm_fwd_persistent" if persistent else "lstm_fwd"] += cfg.num_layers * (
                1 if persistent else x.shape[1])
            out.append([lp[i, : counts[i]] for i in range(len(counts))])
        return tuple(out)

    def ctc_encode(f, k, carry):
        carry = cmodel.init_stream_carry(STREAM_SLOTS, dev) if carry is None else carry
        if f is None:
            return [torch.zeros(0, blank + 1, device=dev)] * STREAM_SLOTS, carry
        y, carry = cmodel.apply_stream(f, torch.as_tensor(np.asarray(k), device=dev), carry)
        lp = torch.log_softmax(y.float(), -1)
        return [lp[r, : int(c)] for r, c in enumerate(k)], carry

    def replay_lp(wavs):
        return [lp.cpu().numpy() for _, lp in stream_replay(ext, wavs, ctc_encode, ccmvn)]

    def held(lp_off, lp32, lp_rep, what: str) -> list:
        """The replayed log-posteriors held to the bf16 rule per wav against
        the f32-compute offline forward; returns each wav's bf16 noise, the
        offline forward's max|bf16 - f32| (the scale a near tie is judged
        by, independent of the stream)."""
        noise = [float(np.abs(o - r).max()) for o, r in zip(lp_off, lp32)]
        d_rep = [float(np.abs(p - r).max()) for p, r in zip(lp_rep, lp32)]
        d_ro = max(float(np.abs(p - o).max()) for p, o in zip(lp_rep, lp_off))
        bad = [(i, a, b) for i, (a, b) in enumerate(zip(d_rep, noise)) if not bf16_close(a, b)]
        log(f"streaming CTC (2 x 512 unidirectional LSTM, bf16, seeded), {what}: log-posteriors replayed in the "
            f"slots' shapes against the offline forward (kernel 4, one direction): max|diff| {d_ro!r}; from the "
            f"f32-compute offline forward: replay {max(d_rep)!r}, offline {max(noise)!r} (bf16 rule per wav: within "
            f"{RNN_BF16_RATIO}x + {RNN_F32_TOL})")
        assert not bad, f"the streamed CTC log-posteriors ({what}) are outside the bf16 rule on wavs {bad}"
        return noise

    (lp_off, lp32), lp_rep = offline_lp(raw, nframes), replay_lp(audio)
    noise = held(lp_off, lp32, lp_rep, "the 32 wavs")

    def greedy_text(lp):
        path = lp.argmax(-1)
        keep = np.ones(len(path), bool)
        keep[1:] = path[1:] != path[:-1]
        ids = path[keep]
        return coder.decode(ids[ids != blank])

    def frame_flip(a, b, noise_i):
        """The first frame whose argmax the offline ``a`` and replayed ``b``
        log-posteriors part on: a near tie ``(margin of a's pick over b's
        under a, the wav's bf16 noise)`` when the margin is within twice
        the noise, else None."""
        flips = np.flatnonzero(a.argmax(-1) != b.argmax(-1))
        if not len(flips):
            return None
        t = flips[0]
        margin = float(a[t].max() - a[t, b[t].argmax()])
        return (margin, noise_i) if margin <= 2 * noise_i else None

    scorer = FusionScorer(ArpaLM.load(arpa), list(coder.alphabet) + ["<blank>"], alpha=0.5, beta=0.0)

    def ctc_nbest(lp):
        beams_ = initial_beams()
        for t in range(lp.shape[0]):
            beams_ = beam_step(beams_, lp[t].astype(np.float64), blank, width, scorer)
        return [(coder.decode(np.asarray(p, np.int32)), s) for p, s in nbest_prefixes(beams_, width)]

    def beam_divergence(lp_a, lp_b, lp_c):
        """The prefix beams of the offline ``a``, the replay ``b`` and the
        f32-compute offline ``c`` log-posteriors, frame by frame: at the
        first frame the kept prefixes of ``a`` and ``b`` differ, ``a``'s
        margin for keeping its own over ``b``'s (the best score ``a`` kept
        that ``b`` dropped less the least ``a`` gives one ``b`` kept, scored
        by a 4x-wide step of the same beams), against the bf16 noise, the
        largest score difference of the prefixes both the wide steps of
        ``a`` and ``c`` hold; at the end, if the kept sets never parted, the
        offline gap between the two bests against the same noise of the
        final beams. ``(margin, noise)`` when the margin is within twice the
        noise, else None."""
        ba, bb, bc = initial_beams(), initial_beams(), initial_beams()

        def totals(beams_):
            return dict(nbest_prefixes(beams_, len(beams_)))

        def noise_of(sa, sc):
            return max((abs(sa[p] - sc[p]) for p in sa if p in sc), default=0.0)

        for t in range(lp_a.shape[0]):
            fa, fb, fc = (lp[t].astype(np.float64) for lp in (lp_a, lp_b, lp_c))
            na, nb = beam_step(ba, fa, blank, width, scorer), beam_step(bb, fb, blank, width, scorer)
            if set(na) != set(nb):
                wa = totals(beam_step(ba, fa, blank, 4 * width, scorer))
                noise_t = noise_of(wa, totals(beam_step(bc, fc, blank, 4 * width, scorer)))
                margin = (max(wa[p] for p in set(na) - set(nb))
                          - min(wa.get(q, -math.inf) for q in set(nb) - set(na)))
                return (margin, noise_t) if margin <= 2 * noise_t else None
            ba, bb, bc = na, nb, beam_step(bc, fc, blank, width, scorer)
        sa, sb = totals(ba), totals(bb)
        best_a, best_b = max(sa, key=sa.get), max(sb, key=sb.get)
        noise_t = noise_of(sa, totals(bc))
        margin = sa[best_a] - sa[best_b]
        return (margin, noise_t) if margin <= 2 * noise_t else None

    want_off = [greedy_text(lp) for lp in lp_off]
    want_rep = [greedy_text(lp) for lp in lp_rep]
    (cg,) = served(ctc_cfg, ("--beam-width", "1"), [("CTC greedy, 16 streams", all32, 16, False)])
    verdicts[cg["tag"]] = judge(cg["tag"], cg, want_rep, want_off,
                                lambda i: frame_flip(lp_off[i], lp_rep[i], noise[i]))
    ctc_lm_cfg = variant(ctc_cfg, "ctc_uni_lm", lm_path=arpa, lm_alpha=0.5)
    (cb,) = served(ctc_lm_cfg, (), [("CTC beam 16 + trigram, 16 streams", all32, 16, False)])
    nb_off, nb_rep = [ctc_nbest(lp) for lp in lp_off], [ctc_nbest(lp) for lp in lp_rep]
    verdicts[cb["tag"]] = judge(cb["tag"], cb, [h[0][0] for h in nb_rep], [h[0][0] for h in nb_off],
                                lambda i: beam_divergence(lp_off[i], lp_rep[i], lp32[i]))
    (ce,) = served(ctc_cfg, ("--beam-width", "1", "--endpoint"), [("CTC greedy --endpoint, 16 streams", all32, 16,
                                                                   False)])
    early = [i for i, r in enumerate(ce["results"]) if r["early"]]
    ep_off, ep_rep, ep_noise = list(lp_off), list(lp_rep), list(noise)
    if early:  # an early final is the decode of the audio pushed until the endpoint
        cut = [audio[i][: (ce["results"][i]["partials"] + 1) * STREAM_CHUNK] for i in early]
        raw_cut, n_cut = offline_feats(cut)
        frame_calls += 1
        (off_cut, f32_cut), rep_cut = offline_lp(raw_cut, n_cut), replay_lp(cut)
        for i, off, rep, nz in zip(early, off_cut, rep_cut, held(off_cut, f32_cut, rep_cut, "the endpointed cuts")):
            ep_off[i], ep_rep[i], ep_noise[i] = off, rep, nz
    verdicts[ce["tag"]] = judge(ce["tag"], ce, [greedy_text(lp) for lp in ep_rep], [greedy_text(lp) for lp in ep_off],
                                lambda i: frame_flip(ep_off[i], ep_rep[i], ep_noise[i]))
    log(f"streaming CTC --endpoint (the default rules: no speech and 5 s of blanks, speech and 1 s of blanks, 20 s): "
        f"{len(early)} early finals of 32 (wavs {early}), each the decode of the audio pushed until it")
    (ca,) = served(ctc_cfg, ("--beam-width", "1"), [("CTC greedy + alignment requests, 16 streams", all32, 16, True)])
    verdicts[ca["tag"]] = judge(ca["tag"], ca, want_rep, want_off,
                                lambda i: frame_flip(lp_off[i], lp_rep[i], noise[i]))
    frame_s = ext.frame_step / rate
    for i, r in enumerate(ca["results"]):
        n_labels = len(r["final"].split())
        path = lp_rep[i].argmax(-1)
        keep = np.ones(len(path), bool)
        keep[1:] = path[1:] != path[:-1]
        frames = np.flatnonzero(keep)[path[keep] != blank]
        assert len(r["times"]) == len(r["confs"]) == n_labels == len(frames), i
        assert np.array_equal(r["times"], frames * frame_s) and np.all((r["confs"] >= 0) & (r["confs"] <= 1)), i
        assert all(set(w) == {"word", "start", "end", "confidence"} and w["start"] <= w["end"]
                   for w in r["words"]) and len(r["words"]) <= n_labels, i
    del cmodel, c32, cnet

    launches = seven(counters())
    want = {"frame_preemph": frame_calls, **lstm_want}
    log(f"streaming path launches of the seven kernels {launches} (the offline references: kernel 2 {frame_calls} "
        f"feature calls, kernel 4 by route {lstm_want} from the bf16 and f32-compute CTC forwards of "
        f"{RNN_LAYERS} layers; the streaming path itself runs none)")
    assert all(v == want.get(k, 0) for k, v in launches.items()), (launches, want)
    check_frame_routes("streaming path", counters()["frame_routes"])
    log(f"streaming verdicts: {json.dumps(verdicts)}")


# ---------------------------------------------------------------------------
# bench.py's TDNN and CNN, and the hybrid recipe's streaming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["tdnn", "cnn"])
def test_hybrid_family_path(train_ws, families, family):
    """bench.py's TDNN (5 x 1024, Kaldi's sub-sampled context) or CNN (64 /
    128 9x3 / 3x3 convs with frequency pools 3 / 1, 4 x 1024 dense) on the
    hybrid recipe at full width (raw 40 fbanks, batchnorm, bf16, 2000
    pdfs): no hand kernel launched; every batch from the bulk loader; the
    controller validated at step 0 and after every train step that ends a
    ``valid_frequency`` period, every rollback back to a validated step;
    what ``check_cli_run`` asks. Then the eval logits of ``final.pt`` on the
    first 16 test utterances on the card (bf16) against the CPU in bf16 and
    in f32 compute by the bf16 rule (both sides); the CNN: TF32 pinned off
    and its conv stack in f32 on the card against the CPU within
    CONV_F32_TOL."""
    from tfkaldi_tpu_torch.convert import load_checkpoint
    from tfkaldi_tpu_torch.decode.streaming import stream_padded_batches
    from tfkaldi_tpu_torch.models import build_model
    from tfkaldi_tpu_torch.nnet import Nnet

    run, tag = families[family], f"{family} path"
    every = run.config.getint("nnet", "valid_frequency")
    order = [st["step"] for st in run.steps]
    rollbacks = [b for a, b in zip(order, order[1:]) if b != a + 1]
    log(f"{tag}: the seven kernels {seven(run.counts)}; steps {order}, validations at {run.validations}")
    assert not any(seven(run.counts).values())
    assert run.validations == [0] + [s + 1 for s in order if (s + 1) % every == 0]
    assert not any(b % every for b in rollbacks)
    check_loader(tag, "alignment", run)
    check_cli_run(tag, train_ws, run)

    cfg = Nnet(run.config, 40, NUM_PDFS, device="cpu").model.config
    final = load_checkpoint(run.savedir)

    def model_on(c, device):
        model = build_model(c)
        model.load_state_dict(final)
        return model.to(device).eval()

    reader = eval_reader(train_ws["test_featdir"])
    _, x, lengths = next(iter(stream_padded_batches(reader, batch_size=16)))
    reader.close()
    x, lengths = torch.as_tensor(x), torch.as_tensor(lengths)
    real = torch.arange(x.shape[1])[None, :] < lengths[:, None]
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    logits = {}
    for name, c, device in (("card", cfg, "cuda"), ("cpu", cfg, "cpu"), ("cpu_f32", cfg32, "cpu")):
        with torch.inference_mode():
            logits[name] = model_on(c, device)(x.to(device), lengths).float().cpu()[real]
    ref = logits["cpu_f32"]
    dist = {name: float((logits[name] - ref).abs().max() / ref.abs().max()) for name in ("card", "cpu")}
    log(f"{tag} eval logits from the CPU f32-compute run: card {dist['card']!r}, CPU bf16 {dist['cpu']!r}")
    assert bf16_close(dist["card"], dist["cpu"]) and bf16_rounds(dist["card"], dist["cpu"])
    if family == "cnn":
        assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
        stacks = {}
        for name, device in (("card", "cuda"), ("cpu", "cpu")):
            with torch.inference_mode():
                stacks[name] = model_on(cfg32, device).conv_stack(x.to(device), lengths).float().cpu()
        conv_rel = float((stacks["card"] - stacks["cpu"]).abs().max() / stacks["cpu"].abs().max())
        log(f"CNN conv stack in f32, card vs CPU: {conv_rel!r} (tol {CONV_F32_TOL})")
        assert conv_rel <= CONV_F32_TOL


def streamed_ffn_routes(dtype, calls: int, rows) -> dict:
    """Kernel 1's launches by route that ``calls`` emitting calls of the
    streamed DNN may make: layer 0 at K 440 and layers 1-5 at K 2048, each
    at one of ``rows`` (the B x T_pad it can be given), on the route the
    plan gives aligned operands there. ``{route: (least, most)}``: a
    layer's launches count towards ``least`` where every row count plans
    the same route for its K."""
    from tfkaldi_tpu_torch.ops.gemm_plan import plan_uncached

    want = {}
    for k, layers in ((440, 1), (HIDDEN_UNITS, HIDDEN_LAYERS - 1)):
        routes = {plan_uncached(n, k, HIDDEN_UNITS, dtype, "mn", True).route for n in rows}
        for r in routes:
            lo, hi = want.get(r, (0, 0))
            want[r] = (lo + (layers * calls if len(routes) == 1 else 0), hi + layers * calls)
    return want


def test_hybrid_streaming_path(served, train_ws, dnn_bf16, families, ctc_run):
    """The hybrid recipe's streaming, on the card:

    - the flagship DNN (the served path's f32 ``final.pt``, 440 -> 6 x 2048
      -> 2000, context 5) and bench.py's bf16 DNN (its path's ``final.pt``)
      through ``OnlineSplicedDecoder`` on their test featdirs' first
      HYBRID_STREAM_UTTS utterances, in chunks of HYBRID_CHUNKS frames, at
      batch 1 and as ragged rows of one batch; every emitted frame against
      the offline ``Decoder`` on offline-spliced features: f32 within
      LIKE_TOL, bf16 by the bf16 rule against the f32-compute offline
      decode. Kernel 1: 6 launches an emitting call, each on the route its
      plan names for the rows it can be given (``streamed_ffn_routes``),
      none on the SIMT route;
    - bench.py's ``lstm_hybrid`` (2 x LSTM-512, unidirectional, bf16, 2000
      pdfs, seeded) through ``OnlineRecurrentDecoder`` at chunk 16, and the
      TDNN and CNN ``final.pt`` through ``OnlineWindowedDecoder`` at chunk
      HYBRID_WINDOWED_CHUNK, each by the bf16 rule against its offline
      decode;
    - ``OnlineDynamicExtractor`` at delta and ddelta against the offline
      extractor (kernel 2) on the same wavs: static columns bit for bit,
      derivative columns within (DELTA_RTOL, DELTA_ATOL);
    - ``cli.serve --stream`` of a delta CTC config (unidirectional, context
      0, f32 compute, a seeded ``final.pt``, the CMVN of a delta featdir
      written by ``prepare_data``) with DELTA_SERVE_CLIENTS clients: each
      final equal to the offline greedy decode of the offline delta
      features, or a near tie (DELTA_TIE_MARGIN);
    - ``prepare_data`` with ``speed_perturb = 0.9,1.0,1.1`` on 8 test wavs
      on the card (kernel 2 launched, all on the bulk route) against
      ``--device cpu`` within PERTURB_FEAT_TOL."""
    from tfkaldi_tpu_torch.convert import save_checkpoint
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import TextCoder
    from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
    from tfkaldi_tpu_torch.decode.decoder import Decoder
    from tfkaldi_tpu_torch.decode.online import OnlineRecurrentDecoder, OnlineSplicedDecoder, OnlineWindowedDecoder
    from tfkaldi_tpu_torch.frontend.cmvn import apply_cmvn, splice
    from tfkaldi_tpu_torch.frontend.features import FeatureExtractor, FeatureOpts
    from tfkaldi_tpu_torch.frontend.online import OnlineDynamicExtractor
    from tfkaldi_tpu_torch.frontend.prepare_data import compute_cmvn, prepare_data
    from tfkaldi_tpu_torch.io import read_wav, read_wavfiles
    from tfkaldi_tpu_torch.models import LSTM, RNNConfig, build_model
    from tfkaldi_tpu_torch.nnet import Nnet
    from tfkaldi_tpu_torch.ops import fused_mlp
    from tfkaldi_tpu_torch.ops import frame_preemph as fp
    from tfkaldi_tpu_torch.serve import global_cmvn

    root = os.path.join(TRAIN_WORK, "hybrid_streaming")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    device = "cuda"
    dev = torch.device(device)

    def test_feats(featdir: str) -> list:
        """The featdir's first HYBRID_STREAM_UTTS utterances, CMVN'd, unspliced."""
        reader = FeatureReader(os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"),
                               os.path.join(featdir, "utt2spk"), 0, 0)
        out = [reader.get_utt()[1].astype(np.float32) for _ in range(HYBRID_STREAM_UTTS)]
        reader.close()
        return out

    def padded(feats: list) -> tuple:
        x = np.zeros((len(feats), max(f.shape[0] for f in feats), feats[0].shape[1]), np.float32)
        for i, f in enumerate(feats):
            x[i, : f.shape[0]] = f
        return x, np.asarray([f.shape[0] for f in feats], np.int64)

    def offline(model, prior, feats: list, c: int) -> list:
        """The offline ``Decoder`` on the utterances as one padded batch,
        spliced offline; per utterance its frames."""
        x, lengths = padded(feats)
        likes = Decoder(model, prior).compute_batch(splice(torch.from_numpy(x).to(dev), c), lengths).cpu().numpy()
        return [likes[i, :n] for i, n in enumerate(lengths)]

    def streamed(dec, feats: list, chunk: int) -> tuple[list, int]:
        """``feats`` as the rows of one batch through a windowed or spliced
        emitter in ``chunk``-frame pushes, then the flush; per row its
        frames, and the emitting calls (those that ran the model)."""
        b, longest = len(feats), max(f.shape[0] for f in feats)
        dec.reset(b)
        got, calls = [[] for _ in feats], 0
        for pos in [*range(0, longest, chunk), None]:
            if pos is None:
                likes, n = dec.flush()
            else:
                x = np.zeros((b, chunk, feats[0].shape[1]), np.float32)
                for i, f in enumerate(feats):
                    part = f[pos: pos + chunk]
                    x[i, : part.shape[0]] = part
                likes, n = dec.step(x, np.clip([f.shape[0] - pos for f in feats], 0, chunk))
            calls += int(n.max(initial=0) > 0)
            for i in range(b):
                got[i].append(likes[i, : n[i]])
        return [np.concatenate(g) for g in got], calls

    def f32_twin(model):
        twin = build_model(dataclasses.replace(model.config, compute_dtype=torch.float32)).to(dev).eval()
        twin.load_state_dict(model.state_dict())
        return twin

    def held(tag: str, got: list, off: list, off32: list | None) -> float:
        """Per utterance: f32 (``off32`` None) within LIKE_TOL of the
        offline frames; bf16 by the bf16 rule against the f32-compute
        offline ``off32``. Returns max|got - off|."""
        d = max(float(np.abs(g - o).max()) for g, o in zip(got, off))
        for i, (g, o) in enumerate(zip(got, off)):
            assert g.shape == o.shape and np.isfinite(g).all(), (tag, i)
        if off32 is None:
            ok, rule = d <= LIKE_TOL, f"tol {LIKE_TOL}"
        else:
            dist = [(float(np.abs(g - r).max()), float(np.abs(o - r).max())) for g, o, r in zip(got, off, off32)]
            ok = all(bf16_close(a, b) for a, b in dist)
            rule = (f"bf16 rule per utterance: from the f32-compute offline decode, streamed "
                    f"{max(a for a, _ in dist)!r}, offline {max(b for _, b in dist)!r}, within {RNN_BF16_RATIO}x + "
                    f"{RNN_F32_TOL}")
        log(f"hybrid streaming {tag}: {len(got)} utterances, {sum(g.shape[0] for g in got)} frames, max|streamed - "
            f"offline| {d!r} ({rule})")
        assert ok, f"hybrid streaming {tag}: the streamed likelihoods differ from the offline decode"
        return d

    # ---- the flagship DNN, f32 and bf16, through OnlineSplicedDecoder (kernel 1) ----
    dnn_runs = (("float32", served["config"], served["test_featdir"]),
                ("bfloat16", dnn_bf16.config, train_ws["test_featdir"]))
    for name, config, featdir in dnn_runs:
        decoder = Nnet(config, 40, NUM_PDFS, device=dev).load_decoder()
        model, prior = decoder.model, decoder.prior.cpu().numpy()
        c = int(config.get("nnet", "context_width"))
        feats = test_feats(featdir)
        off = offline(model, prior, feats, c)
        off32 = None if name == "float32" else offline(f32_twin(model), prior, feats, c)
        torch.cuda.synchronize()
        reset_counts()
        calls = 0
        for chunk in HYBRID_CHUNKS:
            rows = [streamed(OnlineSplicedDecoder(model, prior, c), [f], chunk) for f in feats]
            calls += sum(n for _, n in rows)
            held(f"{name} DNN, batch 1, chunk {chunk}", [g for (g,), _ in rows], off, off32)
            got, n = streamed(OnlineSplicedDecoder(model, prior, c), feats, chunk)
            calls += n
            held(f"{name} DNN, {len(feats)} ragged rows, chunk {chunk}", got, off, off32)
        torch.cuda.synchronize()
        routes = dict(fused_mlp.launches_by_route)
        # B x T_pad: batch 1 or the ragged rows, T_pad a multiple of 8 up to
        # the largest chunk and both contexts
        rows = sorted({b * t for b in (1, len(feats)) for t in range(8, max(HYBRID_CHUNKS) + 2 * c + 8, 8)})
        want = streamed_ffn_routes(getattr(torch, name), calls, rows)
        log(f"hybrid streaming {name} DNN (context {c}): {calls} emitting calls, kernel 1 launches {fused_mlp.launches} "
            f"by route {routes} (want {HIDDEN_LAYERS} a call; by route, at {rows[0]}..{rows[-1]} rows: {want})")
        assert fused_mlp.launches == HIDDEN_LAYERS * calls > 0 and routes["simt"] == 0
        assert all(lo <= routes.get(r, 0) <= hi for r, (lo, hi) in want.items())
        assert set(routes) - set(want) <= {"simt"}

    # ---- bench.py's lstm_hybrid, and the TDNN and CNN ----
    gen = torch.Generator().manual_seed(1)
    lstm = LSTM(RNNConfig(input_dim=40, num_labels=NUM_PDFS, num_layers=2, hidden_units=512, bidirectional=False,
                          compute_dtype=torch.bfloat16))
    lstm.reset_parameters(gen)
    with torch.no_grad():  # the init's output layer is zero: draw it, so that the likelihoods vary
        lstm.out.w.copy_(torch.randn(lstm.out.w.shape, generator=gen) / math.sqrt(lstm.out.w.shape[0]) * 4.0)
    lstm = lstm.to(dev).eval()
    uniform = np.full((NUM_PDFS,), 1.0 / NUM_PDFS, np.float32)
    feats = test_feats(train_ws["test_featdir"])
    x, lengths = padded(feats)
    off, off32 = (Decoder(m, uniform).compute_batch(x, lengths).cpu().numpy() for m in (lstm, f32_twin(lstm)))
    dec = OnlineRecurrentDecoder(lstm, uniform)
    got = []
    for f in feats:
        dec.reset(1)
        got.append(np.concatenate([dec.step(f[None, p: p + 16], [min(16, f.shape[0] - p)])[0]
                                   for p in range(0, f.shape[0], 16)]))
    held("lstm_hybrid (2 x 512 unidirectional, bf16, seeded), batch 1, chunk 16", got,
                                        [off[i, :n] for i, n in enumerate(lengths)],
                                        [off32[i, :n] for i, n in enumerate(lengths)])
    for family, run in families.items():
        model = Nnet(run.config, 40, NUM_PDFS, device=dev).load_decoder().model
        prior = np.load(os.path.join(run.savedir, "prior.npy"))
        c = int(run.config.get("nnet", "context_width"))
        o, o32 = offline(model, prior, feats, c), offline(f32_twin(model), prior, feats, c)
        got, _ = streamed(OnlineWindowedDecoder(model, prior, c), feats, HYBRID_WINDOWED_CHUNK)
        held(
            f"{family} (receptive field {model.left_receptive} + {model.right_receptive}), {len(feats)} rows, chunk "
            f"{HYBRID_WINDOWED_CHUNK}", got, o, o32)

    # ---- the delta front-end on the card ----
    base = ConfigParser()
    base.read(train_ws["cfg_path"])
    test_data = base.get("directories", "test_data")
    wav_scp = read_wavfiles(os.path.join(test_data, "wav.scp"))
    audio = [np.asarray(read_wav(p)[1], np.float32) for p in list(wav_scp.values())[:HYBRID_WAVS]]
    rate = 16000
    feat_conf = dict(base.items("dnn-features"))
    for dynamic in ("delta", "ddelta"):
        ext = FeatureExtractor(FeatureOpts.from_config({**feat_conf, "dynamic": dynamic}), rate, dev)
        batch = np.zeros((len(audio), -(-max(len(a) for a in audio) // rate) * rate), np.float32)
        for i, a in enumerate(audio):
            batch[i, : len(a)] = a
        with torch.inference_mode():
            ref, nf = ext(batch, np.asarray([len(a) for a in audio]))
        ref = ref.cpu().numpy()
        online = OnlineDynamicExtractor(ext)
        sdim, static_exact, worst = ext.opts.base_dim, 0, 0.0
        for i, a in enumerate(audio):
            online.reset(1)
            parts = [online.step(a[None, p: p + STREAM_CHUNK], [len(a[p: p + STREAM_CHUNK])])
                     for p in range(0, len(a), STREAM_CHUNK)] + [online.flush()]
            got = np.concatenate([f[0, : n[0]] for f, n in parts])
            want = ref[i, : nf[i]]
            assert got.shape == want.shape and np.array_equal(got[:, :sdim], want[:, :sdim]), (dynamic, i)
            static_exact += 1
            worst = max(worst, float(np.max(np.abs(got[:, sdim:] - want[:, sdim:])
                                            / (DELTA_ATOL + DELTA_RTOL * np.abs(want[:, sdim:])))))
        log(f"hybrid streaming: OnlineDynamicExtractor {dynamic} ({STREAM_CHUNK}-sample pushes) against the offline "
            f"extractor (kernel 2) on {len(audio)} wavs: static columns bit-identical on {static_exact}, derivative "
            f"columns at {worst!r} of the (rtol {DELTA_RTOL}, atol {DELTA_ATOL}) bar")
        assert worst <= 1.0, f"{dynamic} stream: derivative columns outside the bar ({worst})"

    # ---- cli.serve --stream on a delta CTC config ----
    coder = TextCoder(aurora4_normalizer)
    blank = coder.num_labels
    config = ConfigParser()
    config.read(ctc_run.cfg_path)
    delta_name = f"{config.get('dnn-features', 'name')}_delta"
    config.set("dnn-features", "dynamic", "delta")
    config.set("dnn-features", "name", delta_name)
    config.set("directories", "train_features", os.path.join(root, "features"))
    for key, value in (("bidirectional", "False"), ("context_width", "0"), ("compute_dtype", "float32"),
                       ("name", "ctc_delta_unilstm")):
        config.set("nnet", key, value)
    delta_cfg = os.path.join(root, "config_ctc_delta.cfg")
    with open(delta_cfg, "w") as f:
        config.write(f)
    featdir = os.path.join(root, "features", delta_name)
    reset_counts()
    prepare_data(test_data, featdir, dict(config.items("dnn-features")), device=device)
    compute_cmvn(featdir)
    check_frame_routes("hybrid streaming, the delta featdir", dict(fp.launches_by_route))
    cnet = Nnet(config, 80, coder.num_labels, device=dev)
    gen = torch.Generator().manual_seed(17)
    cnet.model.reset_parameters(gen)
    with torch.no_grad():
        w = cnet.model.out.w
        w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w.shape[0]) * CTC_OUT_GAIN)
        cnet.model.out.b[blank] = CTC_BLANK_BIAS
    save_checkpoint(cnet.savedir, cnet.model.state_dict())
    cmodel = cnet._load_model().eval()
    stats = global_cmvn(featdir)
    reader = FeatureReader(os.path.join(featdir, "feats.scp"), None, os.path.join(featdir, "utt2spk"), 0, 0)
    offline_feats = [reader.get_utt()[1] for _ in range(HYBRID_WAVS)]
    reader.close()
    x, lengths = padded(offline_feats)
    with torch.inference_mode():
        lp = torch.log_softmax(cmodel(apply_cmvn(torch.from_numpy(x).to(dev), stats),
                                      torch.as_tensor(lengths, device=dev)).float(), -1).cpu().numpy()

    def greedy(lp_i):
        path = lp_i.argmax(-1)
        keep = np.ones(len(path), bool)
        keep[1:] = path[1:] != path[:-1]
        ids = path[keep]
        return coder.decode(ids[ids != blank])

    want = [greedy(lp[i, :n]) for i, n in enumerate(lengths)]
    with stream_server(delta_cfg, "--device", device, "--beam-width", "1") as (host, port, server):
        res = stream_clients(host, port, audio, DELTA_SERVE_CLIENTS)
    ties = []
    for i, r in enumerate(res["results"]):
        if r["final"] != want[i]:
            top2 = np.sort(lp[i, : lengths[i]], axis=-1)[:, -2:]
            margin = float((top2[:, 1] - top2[:, 0]).min())
            assert margin <= DELTA_TIE_MARGIN, (i, r["final"], want[i], margin)
            ties.append((i, margin))
    log(f"hybrid streaming: cli.serve --stream on a delta CTC config (2 x 512 unidirectional LSTM, f32, seeded, "
        f"80 inputs), {DELTA_SERVE_CLIENTS} concurrent clients on {len(audio)} wavs: {len(audio) - len(ties)} finals "
        f"identical to the offline greedy decode of the offline delta features, near ties {ties}")
    del cmodel, cnet

    # ---- prepare_data with speed_perturb (kernel 2) against --device cpu ----
    small = os.path.join(root, "sp_data")
    os.makedirs(small)
    keep = list(wav_scp)[:HYBRID_WAVS]
    for name in ("wav.scp", "utt2spk", "text"):
        src = os.path.join(test_data, name)
        if os.path.isfile(src):
            with open(src) as f, open(os.path.join(small, name), "w") as g:
                g.writelines(line for line in f if line.split(" ", 1)[0] in keep)
    spk = {}
    with open(os.path.join(small, "utt2spk")) as f:
        for line in f:
            utt, s = line.split()
            spk.setdefault(s, []).append(utt)
    with open(os.path.join(small, "spk2utt"), "w") as f:
        f.writelines(f"{s} {' '.join(u)}\n" for s, u in spk.items())
    sp_conf = {**feat_conf, "speed_perturb": "0.9,1.0,1.1"}
    dirs = {d: os.path.join(root, f"sp_{d}") for d in (device, "cpu")}
    reset_counts()
    prepare_data(small, dirs[device], sp_conf, device=device)
    torch.cuda.synchronize()
    sp_launches = fp.launches
    check_frame_routes("hybrid streaming, speed_perturb", dict(fp.launches_by_route))
    prepare_data(small, dirs["cpu"], sp_conf, device="cpu")
    card_feats, cpu_feats = read_ark(os.path.join(dirs[device], "feats.scp")), read_ark(
        os.path.join(dirs["cpu"], "feats.scp"))
    want_ids = [pre + u for u in keep for pre in ("sp0.9-", "", "sp1.1-")]
    assert list(card_feats) == want_ids and list(cpu_feats) == want_ids
    err = max(float(np.max(np.abs(card_feats[u] - cpu_feats[u]) / np.maximum(np.abs(cpu_feats[u]), 1.0)))
              for u in want_ids)
    log(f"hybrid streaming: prepare_data with speed_perturb 0.9,1.0,1.1 on {len(keep)} wavs -> {len(want_ids)} "
        f"utterances, kernel 2 launches {sp_launches}; card against --device cpu: max err/max(|ref|,1) {err!r} (tol "
        f"{PERTURB_FEAT_TOL})")
    assert sp_launches > 0 and err <= PERTURB_FEAT_TOL

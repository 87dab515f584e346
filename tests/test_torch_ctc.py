"""The port's character-CTC training path against the JAX package, on the CPU.

- the loss (``train/ctc.py``) against ``optax.ctc_loss`` and ``jax.grad``
  of it: varied lengths, padded frames, repeated labels, blank = the last
  class, and one infeasible row, on both routes (the planned one, which
  sends feasible rows to ``F.ctc_loss``, and the plain recursion alone);
- the ``Trainer`` with ``loss_type = ctc``: 5-step trajectories of a small
  f32 BiLSTM and a small DNN against the JAX ``Trainer`` from one converted
  state, and the validation loss;
- the text targets: ``TextCoder`` / ``aurora4_normalizer`` and the
  ``TextBatchDispenser`` against the JAX ones;
- scoring: ``utils/wer.py`` against the JAX copy on the cases of
  tests/test_wer.py;
- the CLI: ``train_nnet,test_nnet`` with ``loss = ctc`` on a tiny workspace.

Tolerances: per-row loss 1e-5 relative and gradient 1e-5 absolute (f32 sums
in another order). On the infeasible row the alphas sit near -1e5, where an
f32 step is 0.008, so optax's f32 gradient there is itself about 2e-3 from
its f64 value; the port computes both routes in f64 (train/ctc.py) and is
held to optax's f64 result at 1e-5 there.
"""

import dataclasses
import logging
import os
from configparser import ConfigParser

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfkaldi_tpu.data.batching import PaddedBatch as JaxPaddedBatch
from tfkaldi_tpu.data.batching import DeviceBatcher as JaxDeviceBatcher
from tfkaldi_tpu.data.dispenser import TextBatchDispenser as JaxTextBatchDispenser
from tfkaldi_tpu.data.feature_reader import FeatureReader as JaxFeatureReader
from tfkaldi_tpu.data.target_coder import TextCoder as JaxTextCoder
from tfkaldi_tpu.data.target_normalizers import aurora4_normalizer as jax_aurora4_normalizer
from tfkaldi_tpu.models import DNN as JaxDNN
from tfkaldi_tpu.models import LSTM as JaxLSTM
from tfkaldi_tpu.models import DNNConfig as JaxDNNConfig
from tfkaldi_tpu.models import RNNConfig as JaxRNNConfig
from tfkaldi_tpu.train import Trainer as JaxTrainer
from tfkaldi_tpu.train import TrainerConfig as JaxTrainerConfig
from tfkaldi_tpu.utils import wer as jax_wer
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.convert import save_checkpoint, train_state_from_jax
from tfkaldi_tpu_torch.data.batching import DeviceBatcher, PaddedBatch
from tfkaldi_tpu_torch.data.dispenser import TextBatchDispenser
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.data.target_coder import TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
from tfkaldi_tpu_torch.models import DNNConfig, RNNConfig
from tfkaldi_tpu_torch.nnet import Nnet
from tfkaldi_tpu_torch.train import ctc
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig
from tfkaldi_tpu_torch.utils import wer

TOL = 1e-5


def _ctc_problem(seed=0):
    """B 6, T 20, V 8 (blank 7): lengths 20/14/9/20/5/17 with garbage in the
    padded frames; rows with repeated labels, an empty target, and row 4
    infeasible (4 labels with 2 adjacent repeats in 5 frames)."""
    rng = np.random.default_rng(seed)
    b, t, v, n = 6, 20, 8, 9
    logits = (rng.standard_normal((b, t, v)) * 2).astype(np.float32)
    out_len = np.array([20, 14, 9, 20, 5, 17], np.int32)
    for i, m in enumerate(out_len):
        logits[i, m:] = 50.0
    rows = [[1, 1, 2, 0, 6], [0, 1, 0, 3, 3, 3, 2], [2, 2, 5], [], [4, 4, 4, 1], [6, 5, 4, 3, 2, 1, 0, 6, 6]]
    targets = np.zeros((b, n), np.int32)
    for i, r in enumerate(rows):
        targets[i, : len(r)] = r
    return logits, out_len, targets, np.array([len(r) for r in rows], np.int32), v - 1


def _optax(logits, out_len, targets, tgt_len, blank):
    t, n = logits.shape[1], targets.shape[1]

    def per_row(lg):
        lm = (jnp.arange(t)[None] >= out_len[:, None]).astype(lg.dtype)
        lab = (jnp.arange(n)[None] >= tgt_len[:, None]).astype(lg.dtype)
        return optax.ctc_loss(lg, lm, targets, lab, blank_id=blank)

    lg = jnp.asarray(logits)
    return np.asarray(per_row(lg)), np.asarray(jax.grad(lambda x: per_row(x).sum())(lg))


def test_plan_finds_the_infeasible_row():
    _, out_len, targets, tgt_len, _ = _ctc_problem()
    np.testing.assert_array_equal(ctc.feasible_rows(targets, tgt_len, out_len), [1, 1, 1, 1, 0, 1])
    # exactly T = L + repeats is feasible, one frame less is not
    assert ctc.feasible_rows(np.array([[3, 3, 1]]), np.array([3]), np.array([4]))[0]
    assert not ctc.feasible_rows(np.array([[3, 3, 1]]), np.array([3]), np.array([3]))[0]
    # a repeat that crosses into the padding does not count
    assert ctc.feasible_rows(np.array([[2, 0, 0]]), np.array([2]), np.array([2]))[0]


@pytest.mark.parametrize("route", ["planned", "plain"])
def test_loss_and_gradient_match_optax(route):
    logits, out_len, targets, tgt_len, blank = _ctc_problem()
    want, want_grad = _optax(logits, out_len, targets, tgt_len, blank)
    with jax.enable_x64(True):
        _, want_grad64 = _optax(logits.astype(np.float64), out_len, targets, tgt_len, blank)
    ctc.reset_counts()
    x = torch.tensor(logits, requires_grad=True)
    got = ctc.ctc_loss(x, torch.from_numpy(out_len), torch.from_numpy(targets), torch.from_numpy(tgt_len), blank,
                       route=None if route == "planned" else "plain")
    got.sum().backward()
    assert ctc.launches_by_route == ({"library": 1, "plain": 1} if route == "planned" else
                                     {"library": 0, "plain": 1})
    got, grad = got.detach().numpy(), x.grad.numpy()
    assert np.isfinite(got).all() and np.isfinite(grad).all()
    assert 1e5 < got[4] < 2e5  # optax's finite stand-in for an impossible row
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    feasible = [0, 1, 2, 3, 5]
    assert np.abs(grad[feasible] - want_grad[feasible]).max() <= TOL
    # the infeasible row: the f64 value of optax's recursion, which its own
    # f32 gradient misses by far more than the tolerance
    assert np.abs(grad[4] - want_grad64[4]).max() <= TOL
    assert np.abs(want_grad[4] - want_grad64[4]).max() > 10 * TOL
    assert np.all(grad[0, 20:] == 0) and np.all(grad[4, 5:] == 0)  # padded frames


def test_library_route_is_torch_ctc_on_feasible_rows():
    """The planned route's feasible rows are F.ctc_loss's own values, on the
    f32 log_softmax widened to f64."""
    logits, out_len, targets, tgt_len, blank = _ctc_problem(1)
    keep = [0, 1, 2, 3, 5]
    lp = torch.log_softmax(torch.from_numpy(logits[keep]), -1).double().transpose(0, 1)
    want = torch.nn.functional.ctc_loss(lp, torch.from_numpy(targets[keep]).long(), torch.from_numpy(out_len[keep]),
                                        torch.from_numpy(tgt_len[keep]), blank=blank, reduction="none").float()
    got = ctc.ctc_loss(torch.from_numpy(logits), out_len, targets, tgt_len, blank)
    assert torch.equal(got[keep], want)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

IN, V = 12, 8  # 7 labels + the blank
BLANK = V - 1


def _text_batch(rng, b=4, t=16):
    """Padded inputs and feasible label rows (repeats included)."""
    lengths = rng.integers(10, t + 1, b).astype(np.int32)
    inputs = rng.standard_normal((b, t, IN)).astype(np.float32)
    tl = rng.integers(2, 6, b).astype(np.int32)
    targets = np.zeros((b, 6), np.int32)
    for i in range(b):
        inputs[i, lengths[i]:] = 0
        targets[i, : tl[i]] = rng.integers(0, BLANK, tl[i])
    targets[0, :2] = 3  # a repeat
    assert ctc.feasible_rows(targets, tl, lengths).all()
    return inputs, targets, lengths, tl


def _models(kind):
    if kind == "bilstm":
        kw = dict(input_dim=IN, num_labels=V, num_layers=1, hidden_units=16, bidirectional=True)
        jax_model = JaxLSTM(JaxRNNConfig(compute_dtype=jnp.dtype("float32"), scan_unroll=1, **kw))
        return jax_model, RNNConfig(compute_dtype=torch.float32, cell="lstm", **kw)
    kw = dict(input_dim=IN, num_labels=V, num_hidden_layers=2, num_hidden_units=16, nonlin="relu")
    return JaxDNN(JaxDNNConfig(**kw)), DNNConfig(**kw)


def _start(kind, lr=1e-3):
    jax_model, cfg = _models(kind)
    jtrainer = JaxTrainer(jax_model, JaxTrainerConfig(init_learning_rate=lr, num_steps=50, loss_type="ctc",
                                                      ctc_blank_id=BLANK))
    jstate = jtrainer.init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jstate.params)
    # a non-zero output layer: the posteriors are not all uniform
    params["out"]["w"] = (np.random.default_rng(1).standard_normal(params["out"]["w"].shape) * 0.3).astype(np.float32)
    jstate = dataclasses.replace(jstate, params=jax.tree.map(jnp.asarray, params))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    trainer = Trainer(cfg, TrainerConfig(init_learning_rate=lr, num_steps=50, loss_type="ctc",
                                         ctc_blank_id=BLANK), device="cpu")
    return jtrainer, jstate, trainer, state, cfg


@pytest.mark.parametrize("kind", ["bilstm", "dnn"])
def test_five_step_ctc_trajectory_matches_jax(kind):
    """Five CTC steps from one converted state (dropout 1, f32): the step
    losses (summed CTC over the batch's input frames) within 1e-5 relative,
    the parameters within 2e-5 absolute (a step moves them by about lr =
    1e-3), as the frame-CE trajectories of tests/test_torch_trainer.py."""
    jtrainer, jstate, trainer, state, cfg = _start(kind)
    rng = np.random.default_rng(5)
    for step in range(5):
        arrays = _text_batch(rng)
        jstate, jloss = jtrainer.update(jstate, JaxPaddedBatch(*arrays))
        state, loss = trainer.update(state, PaddedBatch(*(torch.from_numpy(a) for a in arrays)))
        assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss)), (step, loss.item(), float(jloss))
    want = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    want_params = dict(want.model.named_parameters())
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].detach().numpy(), atol=2e-5, err_msg=name)


def test_validation_loss_matches_jax():
    """``evaluate``: summed CTC over the batches, divided by their input
    frames (trainer.py:301-304), as the JAX ``Trainer`` computes it."""
    jtrainer, jstate, trainer, state, _ = _start("bilstm")
    rng = np.random.default_rng(8)
    batches = [_text_batch(rng) for _ in range(2)]
    want = jtrainer.evaluate(jstate, [JaxPaddedBatch(*a) for a in batches])
    got = trainer.evaluate(state, [PaddedBatch(*(torch.from_numpy(a) for a in arr)) for arr in batches])
    assert abs(got - want) <= TOL * abs(want)
    # the divisor is the input frames, not the target lengths
    with torch.no_grad():
        total = sum(float(ctc.ctc_loss(state.model(torch.from_numpy(a[0]), torch.from_numpy(a[2])), a[2], a[1], a[3],
                                       BLANK).sum()) for a in batches)
    assert abs(got - total / sum(int(a[2].sum()) for a in batches)) <= TOL * abs(got)


# ---------------------------------------------------------------------------
# text targets and scoring
# ---------------------------------------------------------------------------

TRANSCRIPTS = [
    "THE MARKET ,COMMA SAID O'BRIEN .PERIOD",
    "X-RAY B2B \"DOUBLE-QUOTE <NOISE> ?QUESTION-MARK",
    "ÜBER 42 {LEFT-BRACE ;SEMI-COLON ...ELLIPSIS",
    "",
]


def test_text_coder_matches_jax():
    mine, theirs = TextCoder(aurora4_normalizer), JaxTextCoder(jax_aurora4_normalizer)
    assert mine.alphabet == theirs.alphabet and mine.num_labels == theirs.num_labels == 35
    for text in TRANSCRIPTS:
        assert aurora4_normalizer(text, mine.alphabet) == jax_aurora4_normalizer(text, theirs.alphabet)
        ids = mine.encode(text)
        np.testing.assert_array_equal(ids, theirs.encode(text))
        assert mine.decode(ids) == theirs.decode(ids)
    assert mine.lookup["<unk>"] in mine.encode(TRANSCRIPTS[2])


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def test_wer_matches_jax(tmp_path):
    """The cases of tests/test_wer.py, through both scorers."""
    for ref, hyp in ((list("abc"), list("axc")), (list("kitten"), list("sitting")), ([], list("ab")),
                     (list("abc"), [])):
        assert wer.edit_distance(ref, hyp) == jax_wer.edit_distance(ref, hyp)
    cases = [
        ("u1 the cat sat\nu2 hello world\nu3 gone\n", "u1 the cat sat\nu2 hello word extra\n", None),
        ("u1 <sos> h i <space> y o u <eos>\n", "u1 h i <space> y o l\n", "words"),
        ("u1 <sos> h i <space> y o u <eos>\n", "u1 h i <space> y o l\n", None),
    ]
    for i, (ref, hyp, level) in enumerate(cases):
        r, h = _write(tmp_path / f"ref{i}", ref), _write(tmp_path / f"hyp{i}", hyp)
        got = wer.score_text_files(r, h, transform=wer.char_tokens_to_words if level else None)
        want = jax_wer.score_text_files(r, h, transform=jax_wer.char_tokens_to_words if level else None)
        assert dataclasses.asdict(got) == dataclasses.asdict(want) and str(got) == str(want)
    toks = "<sos> h i <space> t h e r e <eos>".split()
    assert wer.char_tokens_to_words(toks) == jax_wer.char_tokens_to_words(toks) == ["hi", "there"]


# ---------------------------------------------------------------------------
# the CLI on a tiny workspace
# ---------------------------------------------------------------------------

STEPS = "dnn_train_features,dnn_test_features,train_nnet,test_nnet"


@pytest.fixture(scope="module")
def ctc_workspace(tmp_path_factory):
    """config_AURORA4_ctc.cfg's [nnet] as written (synthetic.ctc_nnet) at 16
    units and batch 4, beam 4, on a tiny workspace of seeded transcripts,
    trained and decoded through the CLI on the CPU."""
    root = str(tmp_path_factory.mktemp("ctc"))
    nnet = {**synthetic.ctc_nnet(), "num_hidden_units": 16, "batch_size": 4, "valid_batches": 1,
            "num_epochs": 2, "valid_frequency": 2, "check_freq": 2, "beam_width": 4}
    ws = synthetic.make_train_workspace(root, num_pdfs=20, hidden_units=16, hidden_layers=2,
                                        num_train=16, num_test=4, min_seconds=0.5, max_seconds=1.5, nnet=nnet)
    logger = logging.getLogger("tfkaldi_tpu_torch")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        assert cli_main.main(["--config", ws["cfg_path"], "--steps", STEPS, "--device", "cpu"]) == 0
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return ws, [r.getMessage() for r in records]


def test_cli_trains_and_decodes_ctc_text(ctc_workspace):
    ws, messages = ctc_workspace
    savedir = ws["savedir"]
    assert os.path.basename(savedir) == "ctc_bilstm_512_2"
    state = torch.load(os.path.join(savedir, "final.pt"), weights_only=True)
    assert state["out.w"].shape == (32, 36)  # 35 characters + the blank
    decoded = open(os.path.join(savedir, "decode", "text")).read().splitlines()
    test_utts = [line.split()[0] for line in open(os.path.join(ws["test_featdir"], "text"))]
    assert [line.split()[0] for line in decoded] == test_utts
    alphabet = set(TextCoder(aurora4_normalizer).alphabet)
    assert all(set(line.split()[1:]) <= alphabet for line in decoded)
    refs = open(os.path.join(savedir, "decode", "text.ref_normalized")).read().splitlines()
    assert [line.split()[0] for line in refs] == test_utts and all(" <sos> " in line for line in refs)
    assert any(m.startswith("CTC CER: %WER") for m in messages)
    assert any(m.startswith("CTC WER: %WER") for m in messages)
    import json

    with open(os.path.join(savedir, "metrics.jsonl")) as f:
        steps = [json.loads(line) for line in f]
    assert len(steps) == 8 and all(np.isfinite(s["loss"]) for s in steps)


def test_text_dispenser_matches_jax(ctc_workspace):
    """The training featdir's ``text`` through both dispensers: the same
    padded batches, the same target counts (the prior)."""
    ws = ctc_workspace[0]
    featdir = ws["train_featdir"]
    args = (os.path.join(featdir, "feats_shuffled.scp"), os.path.join(featdir, "cmvn.scp"),
            os.path.join(featdir, "utt2spk"), 2, 0)
    mine = TextBatchDispenser(FeatureReader(*args), TextCoder(aurora4_normalizer), 4, os.path.join(featdir, "text"))
    theirs = JaxTextBatchDispenser(JaxFeatureReader(*args), JaxTextCoder(jax_aurora4_normalizer), 4,
                                   os.path.join(featdir, "text"))
    assert mine.num_batches == theirs.num_batches and mine.max_target_length == theirs.max_target_length
    np.testing.assert_array_equal(mine.compute_target_count(), theirs.compute_target_count())
    for _ in range(2):
        got = mine.get_padded_batch(DeviceBatcher())
        want = theirs.get_padded_batch(JaxDeviceBatcher())
        for a, b in zip(got.fields(), (want.inputs, want.targets, want.input_lengths, want.target_lengths)):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert ctc.feasible_rows(got.targets, got.target_lengths, got.input_lengths).all()


def test_default_device_without_card_raises_for_ctc(ctc_workspace):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card error path is not reachable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_main.main(["--config", ctc_workspace[0]["cfg_path"], "--steps", "test_nnet"])


def test_unported_text_losses_and_lm_fusion_raise(tmp_path):
    def config(**over):
        cfg = ConfigParser()
        cfg["directories"] = {"expdir": str(tmp_path)}
        cfg["nnet"] = {"name": "net", "num_hidden_units": "8", "num_hidden_layers": "1", **over}
        return cfg

    net = Nnet(config(loss="ctc", model="lstm"), 4, 35, device="cpu")
    assert net.blank_id == 35 and net.model.config.num_labels == 36
    assert Nnet(config(loss="ctc"), 4, 35, device="cpu").model.config.num_labels == 36
    with pytest.raises(ValueError, match="model = transducer and loss = rnnt"):  # ported: it pairs with transducer
        Nnet(config(loss="rnnt"), 4, 35, device="cpu")
    with pytest.raises(ValueError, match="model = seq2seq and loss = attention"):  # ported: it pairs with seq2seq
        Nnet(config(loss="attention"), 4, 35, device="cpu")
    # LM fusion follows the JAX package's rules (nnet.py:446-460)
    text = tmp_path / "text"
    text.write_text("u1 THE MARKET\nu2 SHARES OF THE BANK\n")
    arpa = str(tmp_path / "char3.arpa")
    synthetic.write_char_arpa(arpa, [str(text)])
    coder = TextCoder(aurora4_normalizer)
    with pytest.raises(ValueError, match="needs beam_width > 1"):
        Nnet(config(loss="ctc", lm_path=arpa), 4, 35, device="cpu").load_text_decoder(coder)
    net = Nnet(config(loss="ctc", lm_path=arpa, beam_width="4", lm_alpha="0.7", lm_beta="0.2"), 4, 35, device="cpu")
    save_checkpoint(net.savedir, net.model.state_dict())
    dec = net.load_text_decoder(coder)
    assert dec.beam_width == 4 and dec.fusion_scorer.id_to_token == list(coder.alphabet) + ["<blank>"]
    assert (dec.fusion_scorer.alpha, dec.fusion_scorer.beta) == (0.7, 0.2)
    assert net.load_text_decoder(coder, ctc_lm=False).fusion_scorer is None  # the decode service's CTC decoder

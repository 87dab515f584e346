"""The port's recurrent models (``models.rnn``: LSTM, GRU) against the JAX
package's, on the CPU.

Weights cross over through ``convert.rnn_from_jax`` and
``convert.train_state_from_jax``; inputs are made with numpy. On CPU
tensors the recurrences run the plain versions of kernels 4-7; the JAX
models run their XLA scans (``lstm_scan``/``gru_scan``), which
tests/test_torch_rnn_bidi.py ties to the Pallas kernels. Tolerances: f32
1e-5 of max|ref| (f32 sums in another order). bf16: ``h`` and the gate
cotangents are rounded to bf16 at every step, and the gradients of ``wx``
and ``out.w`` are bf16 values themselves (their cotangent passes the cast
to the compute dtype, on both sides); a last-bit difference between two
f32 sums can move one of those roundings by a bf16 step, which then travels
on through two layers and the loss. The yardstick is the bf16 rounding
itself: the port's bf16 result, against the JAX package's f32 result, must
lie within BF16_RATIO (2x) of the JAX bf16 result's own distance from it,
the rule the card tests hold the kernels to (tests/test_torch_cuda_rnn.py).
"""

import dataclasses
import os
from configparser import ConfigParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_lstm_scan import TOL, rel
from tfkaldi_tpu.data.batching import PaddedBatch as JaxPaddedBatch
from tfkaldi_tpu.data.feature_reader import FeatureReader as JaxFeatureReader
from tfkaldi_tpu.decode.decoder import Decoder as JaxDecoder
from tfkaldi_tpu.io import ArkReader, ArkWriter
from tfkaldi_tpu.models import GRU as JaxGRU
from tfkaldi_tpu.models import LSTM as JaxLSTM
from tfkaldi_tpu.models import RNNConfig as JaxRNNConfig
from tfkaldi_tpu.train import Trainer as JaxTrainer
from tfkaldi_tpu.train import TrainerConfig as JaxTrainerConfig
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.cli import main as cli_main
from tfkaldi_tpu_torch.convert import rnn_from_jax, save_checkpoint, train_state_from_jax
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.models import CNN, GRU, LSTM, TDNN, RNNConfig, Transformer, build_model
from tfkaldi_tpu_torch.nnet import Nnet
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

IN, HID, OUT, LAYERS = 12, 16, 7, 2
GATES = {"lstm": 4, "gru": 3}
BF16_RATIO = 2.0


def assert_close(got, want, cd, want_f32=None, what=""):
    """f32: ``got`` within 1e-5 of max|want|. bf16: ``got``'s distance from
    the f32 result within BF16_RATIO of ``want``'s (+ 1e-5 for an output
    the rounding leaves as it is)."""
    if cd == "float32":
        assert rel(got, want) <= TOL[cd], (what, rel(got, want))
    else:
        mine, theirs = rel(got, want_f32), rel(want, want_f32)
        print(f"bf16 {what}: port {mine!r}, JAX {theirs!r} from the f32 result")  # shown with -s
        assert mine <= BF16_RATIO * theirs + TOL["float32"], (what, mine, theirs)


def _configs(cell, cd="float32", bidirectional=True, **over):
    kw = dict(input_dim=IN, num_labels=OUT, num_layers=LAYERS, hidden_units=HID, bidirectional=bidirectional,
              **over)
    jax_cfg = JaxRNNConfig(compute_dtype=jnp.dtype(cd), scan_unroll=1, **kw)
    return jax_cfg, RNNConfig(compute_dtype=getattr(torch, cd), cell=cell, **kw)


def _models(cell, cd="float32", bidirectional=True, seed=0):
    """The JAX model in ``cd`` and in f32, their params, and the port's
    model in ``cd`` with the same weights."""
    jax_cfg, cfg = _configs(cell, cd, bidirectional)
    params = synthetic.random_rnn_pytree(IN, HID, LAYERS, OUT, gates=GATES[cell],
                                         bidirectional=bidirectional, seed=seed)
    model = build_model(cfg)
    model.load_state_dict(rnn_from_jax(params))
    cls = JaxLSTM if cell == "lstm" else JaxGRU
    jax32 = cls(dataclasses.replace(jax_cfg, compute_dtype=jnp.dtype("float32")))
    return cls(jax_cfg), jax32, jax.tree.map(jnp.asarray, params), model


def _inputs(seed=0, b=4, t=10, lengths=(10, 7, 3, 9)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, IN)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    for i, n in enumerate(lengths):
        x[i, n:] = 7.7  # garbage in the padding
    targets = rng.integers(0, OUT, (b, t)).astype(np.int32)
    return x, targets, lengths


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_eval_logits_match_jax(cell, bidirectional, cd):
    jax_model, jax32, params, model = _models(cell, cd, bidirectional)
    x, _, lengths = _inputs()
    want, _ = jax_model.apply(params, {}, jnp.asarray(x), jnp.asarray(lengths), train=False)
    want32, _ = jax32.apply(params, {}, jnp.asarray(x), jnp.asarray(lengths), train=False)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and got.shape == (4, 10, OUT)
    assert_close(got.numpy(), np.asarray(want), cd, np.asarray(want32), "logits")


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_ce_gradients_match_jax(cell, cd):
    """Frame-summed CE over real frames (dropout 1): the gradient of every
    parameter, named as in the port."""
    jax_model, jax32, params, model = _models(cell, cd, seed=1)
    x, targets, lengths = _inputs(seed=1)
    mask = np.arange(10)[None, :] < lengths[:, None]

    def loss(m):
        def fn(p):
            logits, _ = m.apply(p, {}, jnp.asarray(x), jnp.asarray(lengths), train=True)
            logp = jax.nn.log_softmax(logits, axis=-1)
            ce = -jnp.take_along_axis(logp, jnp.asarray(targets)[..., None], axis=-1)[..., 0]
            return jnp.sum(ce * mask)
        return fn

    want_loss, want = jax.value_and_grad(loss(jax_model))(params)
    loss32, want32 = jax.value_and_grad(loss(jax32))(params)
    want, want32 = (rnn_from_jax(jax.tree.map(np.asarray, g)) for g in (want, want32))
    batch = PaddedBatch(*(torch.from_numpy(a) for a in (x, targets, lengths, lengths)))
    got_loss, _ = Trainer.loss_sum(model, batch, train=True)
    got_loss.backward()
    assert_close(np.float64(got_loss.item()), np.float64(want_loss), cd, np.float64(loss32), "loss")
    for name, p in model.named_parameters():
        assert_close(p.grad.numpy(), want[name].numpy(), cd, want32[name].numpy(), name)


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_padding_invariance(cell, bidirectional):
    """Logits at real frames do not change when garbage padding is
    appended: the carry freeze makes even the backward direction immune
    (tests/test_rnn.py::test_padding_invariance, 1e-5 absolute)."""
    _, _, _, model = _models(cell, bidirectional=bidirectional, seed=2)
    x, _, lengths = _inputs(seed=2)
    x_pad = np.concatenate([x, np.full((4, 5, IN), 7.7, np.float32)], axis=1)
    with torch.inference_mode():
        short = model(torch.from_numpy(x), torch.from_numpy(lengths))
        long = model(torch.from_numpy(x_pad), torch.from_numpy(lengths))
    for i, n in enumerate(lengths):
        torch.testing.assert_close(short[i, :n], long[i, :n], rtol=0, atol=1e-5)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_init_and_output_layer(cell):
    """The JAX ``init``: N(0, 1/sqrt(fan_in)) weights, the LSTM's forget-gate
    bias 1.0 (zero elsewhere, and everywhere for the GRU), a zero output
    layer that ``reinit_output_layer`` restores; the JAX parameter names."""
    _, cfg = _configs(cell)
    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    names = {n for n, _ in model.named_parameters()}
    assert names == {f"layers.{l}.{d}.{k}" for l in range(LAYERS) for d in range(2) for k in ("wx", "wh", "b")} | {
        "out.w", "out.b"}
    want_b = torch.zeros(GATES[cell] * HID)
    if cell == "lstm":
        want_b[HID: 2 * HID] = 1.0
    for dirs in model.layers:
        for d in dirs:
            assert torch.equal(d.b, want_b)
            assert abs(d.wh.std().item() * HID ** 0.5 - 1.0) < 0.1
    assert d.wx.shape == (2 * HID, GATES[cell] * HID)
    assert not model.out.w.any() and not model.out.b.any()
    with torch.no_grad():
        model.out.w.fill_(1.0)
    model.reinit_output_layer()
    assert not model.out.w.any()


def test_config_reads_the_jax_keys():
    conf = {"model": "gru", "num_hidden_layers": "3", "num_hidden_units": "32", "bidirectional": "True",
            "dropout": "0.8", "compute_dtype": "bfloat16", "scan_unroll": "4", "scan_impl": "xla"}
    cfg = RNNConfig.from_config(conf, 200, 2000)
    assert cfg == RNNConfig(input_dim=200, num_labels=2000, num_layers=3, hidden_units=32, bidirectional=True,
                            dropout=0.8, compute_dtype=torch.bfloat16, cell="gru")
    assert isinstance(build_model(cfg), GRU)
    assert type(build_model(dataclasses.replace(cfg, cell="lstm"))) is LSTM


# ---------------------------------------------------------------------------
# trainer trajectory against the JAX Trainer
# ---------------------------------------------------------------------------


def test_bilstm_four_step_trajectory_matches_jax():
    """Four steps of a 2-layer BiLSTM from one converted JAX ``TrainState``
    (dropout 1, f32): the step losses within 1e-5 relative, parameters
    within 2e-5 absolute (a step moves them by about lr = 1e-3) and the
    Adam slots within 1e-4 of each leaf's max|value| (the bounds of
    tests/test_torch_trainer.py's DNN trajectory)."""
    jax_cfg, cfg = _configs("lstm")
    jtrainer = JaxTrainer(JaxLSTM(jax_cfg), JaxTrainerConfig(init_learning_rate=1e-3, num_steps=50))
    jstate = jtrainer.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, jstate.params)
    params["out"]["w"] = (rng.standard_normal(params["out"]["w"].shape) * 0.3).astype(np.float32)
    jstate = dataclasses.replace(jstate, params=jax.tree.map(jnp.asarray, params))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    trainer = Trainer(cfg, TrainerConfig(init_learning_rate=1e-3, num_steps=50), device="cpu")
    for step in range(4):
        x, targets, lengths = _inputs(seed=10 + step, lengths=rng.integers(3, 11, 4))
        targets[np.arange(10)[None, :] >= lengths[:, None]] = 0
        jstate, jloss = jtrainer.update(jstate, JaxPaddedBatch(x, targets, lengths, lengths))
        state, loss = trainer.update(state, PaddedBatch(*(torch.from_numpy(a) for a in (x, targets, lengths, lengths))))
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss)), step
    assert state.step == int(jstate.step) == 4 and state.adam_t == int(jstate.adam_t) == 4
    want = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg)
    want_params = dict(want.model.named_parameters())
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].detach().numpy(), atol=2e-5, err_msg=name)
        for slot in ("adam_m", "adam_v"):
            a, b = getattr(state, slot)[name].numpy(), getattr(want, slot)[name].numpy()
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), (slot, name)


# ---------------------------------------------------------------------------
# the hybrid pipeline with a recurrent model
# ---------------------------------------------------------------------------

NUM_PDFS = 20
STEPS = "dnn_train_features,dnn_test_features,train_nnet,test_nnet"


def _read(scp):
    with ArkReader(scp) as reader:
        return {utt: mat for utt, mat in reader}


@pytest.fixture(scope="module", params=["lstm", "gru"])
def rnn_workspace(request, tmp_path_factory):
    """The recipe's recurrent ``[nnet]`` (synthetic.recurrent_nnet: 2-layer
    bidirectional, context 2, bf16, dropout 0.8) at 16 units on a tiny
    training workspace, trained and decoded through the CLI on the CPU."""
    cell = request.param
    root = str(tmp_path_factory.mktemp(f"bi{cell}"))
    nnet = {**synthetic.recurrent_nnet(cell), "num_hidden_units": 16, "batch_size": 4, "valid_batches": 1,
            "num_epochs": 2, "valid_frequency": 2, "check_freq": 2}
    ws = synthetic.make_train_workspace(root, num_pdfs=NUM_PDFS, hidden_units=16, hidden_layers=2,
                                        num_train=16, num_test=4, min_seconds=0.5, max_seconds=1.5, nnet=nnet)
    assert cli_main.main(["--config", ws["cfg_path"], "--steps", STEPS, "--device", "cpu"]) == 0
    return cell, ws


def test_cli_trains_and_decodes_a_recurrent_model(rnn_workspace):
    cell, ws = rnn_workspace
    savedir = ws["savedir"]
    assert os.path.basename(savedir) == f"bi{cell}_512_2_ce"
    state = torch.load(os.path.join(savedir, "final.pt"), weights_only=True)
    assert state["layers.0.0.wx"].shape == (200, GATES[cell] * 16)  # 40 fbank x (2*2+1)
    assert state["layers.1.1.wx"].shape == (32, GATES[cell] * 16) and state["out.w"].shape == (32, NUM_PDFS)
    for name in ("prior.npy", os.path.join("training", "step8.pt"), os.path.join("training", "validated.pt")):
        assert os.path.isfile(os.path.join(savedir, name)), name
    test_feats = _read(os.path.join(ws["test_featdir"], "feats.scp"))
    likes = _read(os.path.join(savedir, "decode", "feats.scp"))
    assert list(likes) == list(test_feats)
    for utt, m in likes.items():
        assert m.shape == (test_feats[utt].shape[0], NUM_PDFS) and np.isfinite(m).all()


def test_default_device_without_card_raises_for_a_recurrent_model(rnn_workspace):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-card error path is not reachable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli_main.main(["--config", rnn_workspace[1]["cfg_path"], "--steps", "test_nnet"])


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_likelihood_ark_matches_jax_decoder(rnn_workspace, tmp_path, cd):
    """``test_nnet`` on converted seeded weights against the JAX package's
    ``Decoder`` on the same features: the same utterances in the same order
    and shapes; f32 log-likelihoods within 1e-4 absolute (f32 sums in
    another order, as tests/test_torch_slice.py), bf16 by the rule of
    ``assert_close`` against the JAX f32 decode."""
    cell, ws = rnn_workspace
    config = ConfigParser()
    config.read(ws["cfg_path"])
    config.set("nnet", "compute_dtype", cd)
    config.set("directories", "expdir", str(tmp_path / "exp"))
    cfg_path = str(tmp_path / "config.cfg")
    with open(cfg_path, "w") as f:
        config.write(f)
    synthetic.write_parent_gmm(os.path.join(str(tmp_path / "exp"), config.get("nnet", "gmm_name")), NUM_PDFS)
    params = synthetic.random_rnn_pytree(200, 16, 2, NUM_PDFS, gates=GATES[cell], seed=5)
    savedir = os.path.join(str(tmp_path / "exp"), config.get("nnet", "name"))
    save_checkpoint(savedir, rnn_from_jax(params))
    prior = np.random.default_rng(6).uniform(0.5, 1.5, NUM_PDFS)
    np.save(os.path.join(savedir, "prior.npy"), (prior / prior.sum()).astype(np.float32))
    assert cli_main.main(["--config", cfg_path, "--steps", "test_nnet", "--device", "cpu"]) == 0
    got = _read(os.path.join(savedir, "decode", "feats.scp"))

    def jax_decode(dtype):
        cfg = JaxRNNConfig(input_dim=200, num_labels=NUM_PDFS, num_layers=2, hidden_units=16, bidirectional=True,
                           compute_dtype=jnp.dtype(dtype), scan_unroll=1)
        model = (JaxLSTM if cell == "lstm" else JaxGRU)(cfg)
        decoder = JaxDecoder(model, jax.tree.map(jnp.asarray, params), {}, np.load(os.path.join(savedir, "prior.npy")))
        featdir = ws["test_featdir"]
        reader = JaxFeatureReader(os.path.join(featdir, "feats.scp"), os.path.join(featdir, "cmvn.scp"),
                                  os.path.join(featdir, "utt2spk"), 2, 0)
        scp = str(tmp_path / f"jax_{dtype}" / "feats.scp")
        with ArkWriter(scp, os.path.join(os.path.dirname(scp), "likes.ark")) as writer:
            decoder.decode_to_writer(reader, writer, batch_size=16)
        return _read(scp)

    want = jax_decode(cd)
    assert list(got) == list(want) and len(got) == 4
    for utt in want:
        assert got[utt].shape == want[utt].shape
    if cd == "float32":
        for utt in want:
            np.testing.assert_allclose(got[utt], want[utt], rtol=0, atol=1e-4, err_msg=utt)
    else:
        want32 = jax_decode("float32")
        stack = [np.concatenate([arks[u] for u in want]) for arks in (got, want, want32)]
        assert_close(*stack[:2], cd, stack[2], "log-likelihoods")


def test_nnet_model_selector(tmp_path):
    def config(**over):
        cfg = ConfigParser()
        cfg["directories"] = {"expdir": str(tmp_path)}
        cfg["nnet"] = {"name": "net", "num_hidden_units": "8", "num_hidden_layers": "1", **over}
        return cfg

    assert isinstance(Nnet(config(model="lstm", bidirectional="True"), 4, 5, device="cpu").model, LSTM)
    assert isinstance(Nnet(config(model="gru"), 4, 5, device="cpu").model, GRU)
    with pytest.raises(ValueError, match="add_layer_period"):
        Nnet(config(model="lstm", add_layer_period="5"), 4, 5, device="cpu")
    # the TDNN and the CNN; the CNN takes the splice copies as its input channels
    assert isinstance(Nnet(config(model="tdnn"), 4, 5, device="cpu").model, TDNN)
    cnn = Nnet(config(model="cnn", context_width="1", cnn_filters="4", cnn_kernels="3x3", cnn_pool="1"), 4, 5,
               device="cpu").model
    assert isinstance(cnn, CNN) and cnn.config.num_channels == 3 and cnn.config.freq_dim == 4
    with pytest.raises(ValueError, match="model = transducer and loss = rnnt"):  # ported: it pairs with rnnt
        Nnet(config(model="transducer"), 4, 5, device="cpu")
    # ported in slices 4 and 6: model = conformer turns the conformer blocks on
    small = dict(num_blocks="1", d_model="8", num_heads="2", ffn_dim="8", conv_kernel="3")
    for model in ("transformer", "conformer"):
        net = Nnet(config(model=model, **small), 4, 5, device="cpu")
        assert isinstance(net.model, Transformer) and net.model.config.conformer == (model == "conformer")
    with pytest.raises(ValueError, match="model = seq2seq and loss = attention"):
        Nnet(config(model="seq2seq"), 4, 5, device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        Nnet(config(model="mlp"), 4, 5, device="cpu")

"""The port's TDNN (tfkaldi_tpu_torch/models/tdnn.py) against the contract
of tests/test_tdnn.py and against the JAX ``TDNN.apply`` and ``Trainer``, on
the CPU (tests/torch_parity.py holds the shared checks and tolerances)."""

from configparser import ConfigParser

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity
from tfkaldi_tpu.models import TDNN as JaxTDNN
from tfkaldi_tpu.models import TDNNConfig as JaxTDNNConfig
from tfkaldi_tpu_torch.convert import tdnn_from_jax
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.models import TDNN, TDNNConfig
from tfkaldi_tpu_torch.models.tdnn import _shift, parse_context
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

SMALL = dict(input_dim=8, num_labels=5, num_hidden_layers=3, num_hidden_units=16,
             context="-2,-1,0,1,2;-1,0,1;-3,0,3")


def _model(**over):
    return TDNN(TDNNConfig(**{**SMALL, **over}))


def _randomise_head(model, seed):
    """Break the zero-init output layer, so the logits show the hidden stack."""
    with torch.no_grad():
        model.out.w.copy_(torch.randn(model.out.w.shape, generator=torch.Generator().manual_seed(seed)) * 0.1)


def test_parse_context():
    assert parse_context("-2,-1,0,1,2;-1,0,1;0", 3) == ((-2, -1, 0, 1, 2), (-1, 0, 1), (0,))
    # short specs repeat the last group; a single group applies everywhere
    assert parse_context("-1,0,1", 3) == ((-1, 0, 1),) * 3
    assert parse_context("-3,0,3;0", 4) == ((-3, 0, 3), (0,), (0,), (0,))
    with pytest.raises(ValueError):
        parse_context("", 2)


def test_shift_zero_fill():
    x = torch.arange(2 * 4 * 1, dtype=torch.float32).reshape(2, 4, 1)
    np.testing.assert_array_equal(_shift(x, 1)[0, :, 0].numpy(), [1, 2, 3, 0])
    np.testing.assert_array_equal(_shift(x, -2)[0, :, 0].numpy(), [0, 0, 0, 1])


def test_shapes_and_state():
    model = _model()
    model.reset_parameters(torch.Generator().manual_seed(0))
    # layer input widths follow the per-layer offset counts
    assert model.hidden[0].w.shape == (8 * 5, 16)
    assert model.hidden[1].w.shape == (16 * 3, 16)
    assert model.hidden[2].w.shape == (16 * 3, 16)
    logits = model(torch.zeros(2, 12, 8), torch.tensor([12, 7]), train=True)
    assert logits.shape == (2, 12, 5) and torch.all(logits == 0)  # zero-init output layer
    assert model.bn_mean.shape == (3, 16)
    # the receptive field: (-2..2) + (-1..1) + (-3,0,3)
    assert (model.left_receptive, model.right_receptive) == (6, 6)


def test_padding_invariance():
    """Garbage in the padding region must not change real-frame logits
    (input masking + masked BN + re-masking between layers + zero-fill
    shifts), with a randomised output head: a zero one would hide a leak."""
    model = _model()
    model.reset_parameters(torch.Generator().manual_seed(1))
    _randomise_head(model, 9)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 20, 8)).astype(np.float32))
    lengths = torch.tensor([20, 11, 5])
    frame_ok = (torch.arange(20)[None, :] < lengths[:, None])[..., None]
    la = model(torch.where(frame_ok, x, 0.0), lengths, train=True)
    lb = model(torch.where(frame_ok, x, 1e3), lengths, train=True)
    mask = frame_ok[..., 0]
    np.testing.assert_allclose(la[mask].detach().numpy(), lb[mask].detach().numpy(), atol=1e-5)


def test_receptive_field_uses_context():
    """A frame's logits depend on its neighbours within the summed offsets
    (+-6 frames here) and on nothing beyond."""
    model = _model(batch_norm=False)
    model.reset_parameters(torch.Generator().manual_seed(2))
    _randomise_head(model, 3)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 16, 8)).astype(np.float32))
    lengths = torch.tensor([16])
    with torch.inference_mode():
        la = model(x, lengths)
        x2 = x.clone()
        x2[0, 4] += 1.0  # perturb frame 4 only
        lb = model(x2, lengths)
    diff = (la - lb).abs()[0].amax(dim=1).numpy()
    assert diff[4] > 0
    assert diff[2] > 0 and diff[6] > 0, "context frames unaffected: no splicing?"
    assert diff[11] == 0 and diff[12] == 0 and diff[15] == 0


def test_trains_on_learnable_synthetic():
    trainer = Trainer(TDNNConfig(**SMALL), TrainerConfig(init_learning_rate=0.02, num_steps=50), device="cpu")
    state = trainer.init_state(0)
    rng = np.random.default_rng(3)
    label_map = rng.standard_normal((8, 5))
    x = rng.standard_normal((8, 30, 8)).astype(np.float32)
    y = np.argmax(x @ label_map, axis=-1).astype(np.int32)
    lengths = torch.full((8,), 30, dtype=torch.int32)
    batch = PaddedBatch(torch.from_numpy(x), torch.from_numpy(y), lengths, lengths)
    losses = []
    for _ in range(25):
        state, loss = trainer.update(state, batch)
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.8, losses[:: max(len(losses) // 5, 1)]


def _nnet_config(tmp_path, **over):
    cfg = ConfigParser()
    cfg["directories"] = {"expdir": str(tmp_path / "exp")}
    cfg["nnet"] = {
        "name": "tdnnnet", "model": "tdnn", "context_width": "0",
        "num_hidden_units": "16", "num_hidden_layers": "3",
        "tdnn_context": "-2,-1,0,1,2;-1,0,1;-3,0,3",
        "add_layer_period": "0", "starting_step": "0", "nonlin": "relu",
        "l2_norm": "False", "dropout": "1", "batch_norm": "True",
        "num_epochs": "2", "initial_learning_rate": "0.01",
        "learning_rate_decay": "1", "batch_size": "4",
        "numutterances_per_minibatch": "-1", "valid_batches": "1",
        "valid_frequency": "4", "valid_adapt": "False", "valid_retries": "0",
        "check_freq": "10", "visualise": "False", **over,
    }
    return cfg


def test_nnet_selector_and_full_train_decode(tmp_path):
    """``model = tdnn`` drives the whole pipeline through the port's
    ``Nnet``: controller training, prior, batched likelihood decode to ark;
    under ``loss = ctc`` it emits the blank as the extra class."""
    from tests.synthetic import make_featdir
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.io import ArkReader, ArkWriter
    from tfkaldi_tpu_torch.nnet import Nnet

    featdir, alifile, info = make_featdir(tmp_path, learnable=True)

    def reader():
        return FeatureReader(f"{featdir}/feats.scp", f"{featdir}/cmvn.scp", f"{featdir}/utt2spk", 0, 60)

    coder = AlignmentCoder(identity_normalizer, info["num_labels"])
    disp = AlignmentBatchDispenser(reader(), coder, 4, alifile)
    net = Nnet(_nnet_config(tmp_path), input_dim=info["feat_dim"], num_labels=info["num_labels"], device="cpu")
    assert isinstance(net.model, TDNN)
    net.train(disp)
    writer = ArkWriter(str(tmp_path / "likes.scp"), str(tmp_path / "likes.ark"))
    assert net.decode(reader(), writer) == 12
    with ArkReader(str(tmp_path / "likes.scp")) as back:
        _, mat, _ = back.read_next_utt()
    assert mat.shape[1] == info["num_labels"] and np.isfinite(mat).all()
    ctc = Nnet(_nnet_config(tmp_path, loss="ctc"), input_dim=8, num_labels=5, device="cpu")
    assert ctc.model.config.num_labels == 6 and ctc.blank_id == 5


def test_layerwise_init_rejected(tmp_path):
    from tfkaldi_tpu_torch.nnet import Nnet

    with pytest.raises(ValueError, match="layerwise"):
        Nnet(_nnet_config(tmp_path, add_layer_period="5"), input_dim=8, num_labels=5, device="cpu")


# ---------------------------------------------------------------------------
# parity with the JAX TDNN
# ---------------------------------------------------------------------------

def _pair(cd="float32", **over):
    kw = {**SMALL, **over}
    return JaxTDNN(JaxTDNNConfig(**kw, compute_dtype=jnp.dtype(cd))), TDNNConfig(**kw, compute_dtype=getattr(torch, cd))


@pytest.mark.parametrize("train", [True, False])
def test_forward_state_and_gradients_match_jax(train):
    """f32 logits and moving stats within 1e-5, gradients within 1e-4, in
    training and in eval, on ragged lengths with garbage in the padding."""
    jax_model, cfg = _pair()
    params, state = torch_parity.random_start(jax_model, seed=4)
    x, lengths = torch_parity.batch(np.random.default_rng(4), 3, 20, 8, [20, 13, 6])
    torch_parity.check_f32(jax_model, cfg, tdnn_from_jax, params, state, x, lengths, train=train)


def test_bf16_matches_jax_by_the_2x_rule():
    """bench.py's compute dtype: logits and gradients in training within 2x
    of the JAX bf16 run's distance from the JAX f32 run."""
    jax_bf16, cfg = _pair("bfloat16")
    jax_f32, _ = _pair()
    params, state = torch_parity.random_start(jax_f32, seed=5)
    x, lengths = torch_parity.batch(np.random.default_rng(5), 3, 20, 8, [20, 13, 6])
    torch_parity.check_bf16(jax_bf16, jax_f32, cfg, tdnn_from_jax, params, state, x, lengths, train=True)


def test_four_step_trajectory_matches_jax():
    jax_model, cfg = _pair()
    params, state = torch_parity.random_start(jax_model, seed=6)
    torch_parity.check_trajectory(jax_model, cfg, params, state, steps=4, f=8, seed=6)

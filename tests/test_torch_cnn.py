"""The port's CNN (tfkaldi_tpu_torch/models/cnn.py) against the contract of
tests/test_cnn.py and against the JAX ``CNN.apply`` and ``Trainer``, on the
CPU (tests/torch_parity.py holds the shared checks and tolerances). The
parity cases pin what a single-channel, odd-kernel model would not: an even
time kernel (XLA's SAME padding puts the extra zero high), three splice
channels over more than one frequency band (the flatten order before the
dense stack), a max-pool tie (its gradient split evenly) and the bf16
weight gradient (rounded to bf16, as ``lax.conv``'s VJP returns it)."""

from configparser import ConfigParser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity
from tfkaldi_tpu.models import CNN as JaxCNN
from tfkaldi_tpu.models import CNNConfig as JaxCNNConfig
from tfkaldi_tpu_torch.convert import cnn_from_jax
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.models import CNN, CNNConfig
from tfkaldi_tpu_torch.models.cnn import _parse_kernels
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

SMALL = dict(input_dim=16, num_labels=5, filters="8,12", kernels="5x3;3x3", pool="2,1", num_channels=1,
             num_hidden_layers=2, num_hidden_units=16)
# an even time and frequency kernel, three splice channels over 16 bands
PARITY = dict(SMALL, input_dim=3 * 16, num_channels=3, kernels="4x3;3x2")


def _model(**over):
    return CNN(CNNConfig(**{**SMALL, **over}))


def _randomise_head(model, seed):
    with torch.no_grad():
        model.out.w.copy_(torch.randn(model.out.w.shape, generator=torch.Generator().manual_seed(seed)) * 0.1)


def test_parse_kernels():
    assert _parse_kernels("9x3;3x3", 2) == ((9, 3), (3, 3))
    # short specs repeat the last entry
    assert _parse_kernels("3x3", 3) == ((3, 3),) * 3
    with pytest.raises(ValueError):
        _parse_kernels("9", 1)
    with pytest.raises(ValueError):
        _parse_kernels("", 1)


def test_shapes_and_state():
    model = _model()
    model.reset_parameters(torch.Generator().manual_seed(0))
    assert model.conv[0].w.shape == (8, 1, 5, 3)  # OIHW
    assert model.conv[1].w.shape == (12, 8, 3, 3)
    # freq 16 → pool 2 → 8, pool 1 → 8; flattened conv out = 8*12
    assert model.config.conv_output_dim() == 8 * 12
    assert model.hidden[0].w.shape == (8 * 12, 16)
    logits = model(torch.zeros(2, 12, 16), torch.tensor([12, 7]), train=True)
    assert logits.shape == (2, 12, 5)
    assert model.bn_conv_mean[0].shape == (8,) and model.bn_mean.shape == (2, 16)
    assert (model.left_receptive, model.right_receptive) == (3, 3)
    assert (_model(kernels="4x3;3x3").left_receptive, _model(kernels="4x3;3x3").right_receptive) == (2, 3)


def test_splice_channels_reshape():
    """context_width splices become conv channels: input [B,T,S*F] with S
    copies must reach the conv as S channels of the raw F bands."""
    model = _model(input_dim=3 * 16, num_channels=3, filters="4", kernels="1x1", pool="1", num_hidden_layers=0,
                   batch_norm=False)
    w = torch.zeros(4, 3, 1, 1)
    w[0, 0, 0, 0] = 1.0  # filter 0 reads channel 0 (the t-1 splice copy)
    w[1, 2, 0, 0] = 1.0  # filter 1 reads channel 2 (the t+1 splice copy)
    with torch.no_grad():
        model.conv[0].w.copy_(w)
        model.conv[0].b.zero_()
        model.out.w.copy_(torch.eye(16 * 4, 5))
        model.out.b.zero_()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 6, 3, 16)).astype(np.float32)  # [B,T,S,F]
    with torch.inference_mode():
        logits = model(torch.from_numpy(x.reshape(1, 6, 48)), torch.tensor([6])).numpy()
    # h after the conv is [B,T,F,C] flattened [F*C]; out.w = eye picks band 0's four channels
    np.testing.assert_allclose(logits[0, :, 0], np.maximum(x[0, :, 0, 0], 0.0), rtol=1e-5)
    np.testing.assert_allclose(logits[0, :, 1], np.maximum(x[0, :, 2, 0], 0.0), rtol=1e-5)


@pytest.mark.parametrize("kernel", [(3, 3), (4, 2)])
def test_conv_oracle_numpy(kernel):
    """One conv layer against a direct numpy SAME conv (XLA's padding:
    (k-1)//2 low, k//2 high), an odd and an even kernel."""
    kt, kf = kernel
    model = _model(filters="6", kernels=f"{kt}x{kf}", pool="1", num_hidden_layers=0, batch_norm=False)
    model.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.out.w.copy_(torch.eye(16 * 6, 5))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 16)).astype(np.float32)
    with torch.inference_mode():
        logits = model(torch.from_numpy(x), torch.tensor([8])).numpy()
    w = model.conv[0].w.detach().numpy()  # [6, 1, kt, kf]
    xp = np.pad(x[0], (((kt - 1) // 2, kt // 2), ((kf - 1) // 2, kf // 2)))
    out = np.zeros((8, 16, 6), np.float32)
    for t in range(8):
        for f in range(16):
            out[t, f] = np.einsum("tf,otf->o", xp[t: t + kt, f: f + kf], w[:, 0])
    out = np.maximum(out, 0.0).reshape(8, -1)
    np.testing.assert_allclose(logits[0], out[:, :5], rtol=2e-5, atol=2e-5)


def test_padding_invariance():
    """Garbage in the padding region must not change real-frame logits
    (input masking, masked BN, re-masking, zero-fill SAME time padding)."""
    model = _model()
    model.reset_parameters(torch.Generator().manual_seed(1))
    _randomise_head(model, 9)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 20, 16)).astype(np.float32))
    lengths = torch.tensor([20, 11, 5])
    frame_ok = (torch.arange(20)[None, :] < lengths[:, None])[..., None]
    la = model(torch.where(frame_ok, x, 0.0), lengths, train=True)
    lb = model(torch.where(frame_ok, x, 1e3), lengths, train=True)
    mask = frame_ok[..., 0]
    np.testing.assert_allclose(la[mask].detach().numpy(), lb[mask].detach().numpy(), atol=1e-5)


def test_receptive_field_time_kernel():
    """A frame's logits depend on neighbours within the conv time kernels
    (5x3 then 3x3: radius 3) and on nothing beyond."""
    model = _model(batch_norm=False)
    model.reset_parameters(torch.Generator().manual_seed(2))
    _randomise_head(model, 3)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 16, 16)).astype(np.float32))
    lengths = torch.tensor([16])
    with torch.inference_mode():
        la = model(x, lengths)
        x2 = x.clone()
        x2[0, 4] += 1.0
        lb = model(x2, lengths)
    diff = (la - lb).abs()[0].amax(dim=1).numpy()
    assert diff[4] > 0
    assert diff[3] > 0 and diff[5] > 0, "neighbour frames unaffected: no time conv?"
    assert diff[0] == 0 and diff[8] == 0 and diff[15] == 0


def test_trains_on_learnable_synthetic():
    trainer = Trainer(CNNConfig(**SMALL), TrainerConfig(init_learning_rate=0.02, num_steps=50), device="cpu")
    state = trainer.init_state(0)
    rng = np.random.default_rng(3)
    label_map = rng.standard_normal((16, 5))
    x = rng.standard_normal((8, 30, 16)).astype(np.float32)
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
        "name": "cnnnet", "model": "cnn", "context_width": "1",
        "cnn_filters": "8,8", "cnn_kernels": "5x3;3x3", "cnn_pool": "2,1",
        "num_hidden_units": "16", "num_hidden_layers": "2",
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
    """``model = cnn`` drives the whole pipeline through the port's ``Nnet``
    with splice channels; under ``loss = ctc`` it emits the blank too."""
    from tests.synthetic import make_featdir
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
    from tfkaldi_tpu_torch.io import ArkReader, ArkWriter
    from tfkaldi_tpu_torch.nnet import Nnet

    featdir, alifile, info = make_featdir(tmp_path, learnable=True)

    def reader():
        return FeatureReader(f"{featdir}/feats.scp", f"{featdir}/cmvn.scp", f"{featdir}/utt2spk", 1, 60)

    coder = AlignmentCoder(identity_normalizer, info["num_labels"])
    disp = AlignmentBatchDispenser(reader(), coder, 4, alifile)
    net = Nnet(_nnet_config(tmp_path), input_dim=info["feat_dim"], num_labels=info["num_labels"], device="cpu")
    # splice copies became channels: 3 channels of the raw feat dim
    assert net.model.config.num_channels == 3
    assert net.model.config.freq_dim == info["feat_dim"]
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
        Nnet(_nnet_config(tmp_path, context_width="0", add_layer_period="5"), input_dim=8, num_labels=5,
             device="cpu")


# ---------------------------------------------------------------------------
# parity with the JAX CNN
# ---------------------------------------------------------------------------

def _pair(cd="float32", **over):
    kw = {**PARITY, **over}
    return JaxCNN(JaxCNNConfig(**kw, compute_dtype=jnp.dtype(cd))), CNNConfig(**kw, compute_dtype=getattr(torch, cd))


@pytest.mark.parametrize("train", [True, False])
def test_forward_state_and_gradients_match_jax(train):
    """f32 logits and moving stats (per conv channel and per dense unit)
    within 1e-5, gradients within 1e-4, in training and in eval, with three
    splice channels, even kernels and garbage in the padding."""
    jax_model, cfg = _pair()
    params, state = torch_parity.random_start(jax_model, seed=4)
    x, lengths = torch_parity.batch(np.random.default_rng(4), 3, 20, 48, [20, 13, 6])
    torch_parity.check_f32(jax_model, cfg, cnn_from_jax, params, state, x, lengths, train=train)


def test_bf16_matches_jax_and_rounds_the_weight_gradient():
    """bench.py's compute dtype: logits and gradients in training within 2x
    of the JAX bf16 run's distance from the JAX f32 run; each conv's weight
    gradient holds only bf16 values, as the JAX one does."""
    jax_bf16, cfg = _pair("bfloat16")
    jax_f32, _ = _pair()
    params, state = torch_parity.random_start(jax_f32, seed=5)
    x, lengths = torch_parity.batch(np.random.default_rng(5), 3, 20, 48, [20, 13, 6])
    grads, jax_grads = torch_parity.check_bf16(jax_bf16, jax_f32, cfg, cnn_from_jax, params, state, x, lengths,
                                               train=True)
    for l in range(2):
        for g in (torch.from_numpy(grads[f"conv.{l}.w"]), torch.from_numpy(jax_grads[f"conv.{l}.w"])):
            assert g.abs().max() > 0 and torch.equal(g, g.to(torch.bfloat16).float()), l


def test_max_pool_tie_splits_the_gradient_as_jax():
    """Equal values in a pooling window: the gradient goes half to each, in
    the port as in JAX (``amax``; ``max(dim).values`` would send all of it to
    one element). Input gradients through a 1x1 identity conv, pool 2."""
    kw = dict(input_dim=4, num_labels=3, filters="1", kernels="1x1", pool="2", num_hidden_layers=0,
              batch_norm=False)
    jax_model = JaxCNN(JaxCNNConfig(**kw))
    params, state = jax_model.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    params["conv"][0]["w"] = np.ones((1, 1, 1, 1), np.float32)
    params["out"]["w"] = np.asarray([[1.0, 0.0, 2.0], [0.0, 1.0, 3.0]], np.float32)
    x = np.asarray([[[0.5, 0.5, 2.0, 1.0], [1.5, 1.5, 0.25, 0.25]]], np.float32)  # ties in bands (0,1), (2,3)
    lengths = np.asarray([2], np.int32)

    def jloss(xj):
        logits, _ = jax_model.apply(jax.tree.map(jnp.asarray, params), state, xj, jnp.asarray(lengths), train=False)
        return jnp.sum(logits)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    model = torch_parity.port_model(CNNConfig(**kw), cnn_from_jax(params, {"depth": np.int32(0)}))
    xt = torch.from_numpy(x).requires_grad_()
    model(xt, torch.from_numpy(lengths)).sum().backward()
    got = xt.grad.numpy()
    np.testing.assert_allclose(got, want, atol=0)
    np.testing.assert_allclose(got[0, 0, :2], [1.5, 1.5])  # (1 + 0 + 2) / 2 to each tied band
    np.testing.assert_allclose(got[0, 1, 2:], [2.0, 2.0])  # (0 + 1 + 3) / 2


def test_four_step_trajectory_matches_jax():
    jax_model, cfg = _pair()
    params, state = torch_parity.random_start(jax_model, seed=6)
    torch_parity.check_trajectory(jax_model, cfg, params, state, steps=4, f=48, seed=6)

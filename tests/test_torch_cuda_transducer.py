"""The transducer recipe's model on the card against the port on the CPU, and
kernels 4 and 5 at the prediction network's one-direction shape.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips (inside the ``cuda`` fixture) when ``torch.cuda.is_available()`` is
false. The file imports no JAX:

    python -m pytest tests/test_torch_cuda_transducer.py --noconftest -q -m cuda

Tolerances: f32 card against CPU (TF32 off on both; sums in another
order), the loss within 1e-5 relative, the scores within 1e-5 of max|CPU|
and the gradients within 1e-4 of each max|CPU| (the attention key biases,
0 in exact arithmetic, within 1e-4 of the key weights' gradient); kernels
against their plain versions: f32 within 1e-5, bf16 by the 2x rule of
tests/test_torch_cuda_rnn.py (the kernels' distance from the plain f32 run
within 2x the plain bf16 run's + 1e-5, and at least half of it - 1e-5
against the plain f32 run on the bf16-rounded weights).
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from tests.test_torch_cuda_seq2seq import char_lm, check_nbest
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.decode.transducer import TransducerDecoder
from tfkaldi_tpu_torch.decode.transducer_beam import TransducerBeamDecoder
from tfkaldi_tpu_torch.models import TransducerConfig
from tfkaldi_tpu_torch.ops import gru_bidi, lstm_bidi, rnn_bidi
from tfkaldi_tpu_torch.ops.lstm_scan import weight_grad
from tfkaldi_tpu_torch.train import checkpoint as ckpt
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.cuda

V, IN = 35, 40  # the recipe's 35 characters (+ the blank) and 40 fbanks
CONFORMER = (("num_blocks", "2"), ("d_model", "64"), ("num_heads", "4"), ("ffn_dim", "128"), ("conv_kernel", "15"),
             ("subsample", "4"), ("attention_left_context", "64"), ("attention_right_context", "0"),
             ("causal_conv", "True"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tfkaldi_tpu_torch.device import resolve_device

    return resolve_device("cuda")


class _IdCoder:
    def decode(self, ids):
        return " ".join(str(i) for i in np.asarray(ids))


def _config(cd=torch.float32, enc_type="conformer", **kw):
    extra = CONFORMER if enc_type == "conformer" else ()
    return TransducerConfig(input_dim=IN, num_labels=V, enc_type=enc_type, enc_layers=1, enc_units=64,
                            enc_extra=extra, pred_units=320, embed_dim=128, joint_units=320, compute_dtype=cd,
                            **{"prune_s": 8, "prune_band": "diagonal", **kw})


def _batch(seed, b=8, t=96, u=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, IN)).astype(np.float32)
    xl = rng.integers(t // 2, t + 1, b).astype(np.int32)
    xl[0] = t
    for i, n in enumerate(xl):
        x[i, n:] = rng.standard_normal((t - n, IN)) * 5
    yl = rng.integers(1, u + 1, b).astype(np.int32)
    y = rng.integers(0, V, (b, u)).astype(np.int32)
    return PaddedBatch(*map(torch.from_numpy, (x, y, xl, yl)))


def _rel(a, b) -> float:
    return ((a.float().cpu() - b.float().cpu()).abs().max() / b.float().cpu().abs().max().clamp(min=1e-30)).item()


def _to(state, device):
    s = ckpt.device_snapshot(state)
    s.model.to(device)
    s.adam_m = {k: v.to(device) for k, v in s.adam_m.items()}
    s.adam_v = {k: v.to(device) for k, v in s.adam_v.items()}
    return s


def _grads(trainer, state, batch):
    grads, loss, _ = trainer.gradients(state, batch.to(trainer.device))
    return {n: g.cpu() for n, g in grads.items()}, loss.item()


def _check_grads(got, want, tol):
    for name, g in want.items():
        if name.endswith(".bk"):
            scale = want[name[:-2] + "wk"].abs().max().item()
            assert max(got[name].abs().max().item(), g.abs().max().item()) <= 1e-4 * scale, name
        else:
            assert _rel(got[name], g) <= tol, (name, _rel(got[name], g))


@pytest.mark.parametrize("prune_s", [8, 0], ids=["banded", "dense"])
def test_transducer_on_card_matches_cpu(cuda, prune_s):
    """Scores, the summed lattice loss and every gradient of the
    conformer-s4 transducer (f32), the card against the CPU, on both
    routes; the predictor's forward and backward launch kernels 4 and 5
    once each on the persistent route."""
    cfg = _config(prune_s=prune_s)
    trainer_cpu = Trainer(cfg, TrainerConfig(loss_type="rnnt"), device="cpu")
    trainer = Trainer(cfg, TrainerConfig(loss_type="rnnt"), device=cuda)
    state = trainer_cpu.init_state(2)
    batch = _batch(3)
    want, loss_cpu = _grads(trainer_cpu, state, batch)
    c = lstm_bidi.CELL
    c.reset_counts()
    got, loss = _grads(trainer, _to(state, cuda), batch)
    torch.cuda.synchronize()
    assert (c.fwd_persistent_launches, c.fwd_launches, c.bwd_persistent_launches, c.bwd_launches) == (1, 0, 1, 0)
    assert abs(loss - loss_cpu) <= 1e-5 * abs(loss_cpu), (loss, loss_cpu)
    _check_grads(got, want, 1e-4)
    args = (batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths)
    model = _to(state, cuda).model
    fn = "lattice_scores_pruned" if prune_s else "lattice_scores"
    with torch.no_grad():
        want_s = getattr(state.model, fn)(*args)
        got_s = getattr(model, fn)(*(a.to(cuda) for a in args))
    for g, w in zip(got_s, want_s):
        if w.dtype == torch.int32:
            assert torch.equal(g.cpu(), w)
        else:
            assert _rel(g, w) <= 1e-5


def _chain(gxs, whs, mask, dys, cd, kernel):
    c = lstm_bidi.CELL
    whs_cd = [w.to(cd) for w in whs]
    outs = (c.fwd if kernel else c.fwd_ref)(gxs, whs_cd, mask, residuals=True)
    res = [r for _, r in outs]
    grads = (c.bwd if kernel else c.bwd_ref)(dys, res, mask, whs_cd)
    flat = {"ys": [y for y, _ in outs], "dgx": [g for g, _ in grads]}
    for i in range(len(res[0])):
        flat[f"res{i}"] = [r[i] for r in res]
    flat["dW_h"] = [weight_grad(r[2], g, cd) for r, (_, g) in zip(res, grads)]
    return flat


def _rel_list(a, b):
    return max(_rel(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("t,b", [(129, 128), (17, 8)])
def test_kernels_at_the_predictor_shape(cuda, t, b):
    """Kernels 4 and 5 with one direction at H 320 (the recipe's prediction
    network; T = U_pad + 1 = 129, B 128): the persistent route both ways
    (40 CTAs at B 128: 20 unit tiles x 2 row CTAs), the smem of the plan,
    and every output against the plain versions."""
    c, h = lstm_bidi.CELL, 320
    fplan = rnn_bidi.fwd_plan(b, h, c.gates, torch.bfloat16, 1)
    bplan = rnn_bidi.bwd_plan(b, h, c.gates, torch.bfloat16, 1)
    assert (fplan.route, bplan.route) == ("persistent", "persistent")
    assert (fplan.smem_bytes, bplan.smem_bytes) == (119_808, 173_376)
    if b == 128:
        assert fplan.ctas == bplan.ctas == 40
    g = torch.Generator().manual_seed(t + b)
    lengths = torch.randint(1, t + 1, (b,), generator=g)
    lengths[0] = t
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[:, :, None].to(cuda)
    gxs = [torch.randn(t, b, 4 * h, generator=g).to(cuda)]
    gxs[0][mask[:, :, 0] == 0] = 7.7
    whs = [(torch.randn(h, 4 * h, generator=g) / h ** 0.5).to(cuda)]
    dys = [torch.randn(t, b, h, generator=g).to(cuda)]
    ref32 = _chain(gxs, whs, mask, dys, torch.float32, kernel=False)
    c.reset_counts()
    got32 = _chain(gxs, whs, mask, dys, torch.float32, kernel=True)
    torch.cuda.synchronize()
    assert (c.fwd_persistent_launches, c.bwd_persistent_launches, c.fwd_launches, c.bwd_launches) == (1, 1, 0, 0)
    for name in ref32:
        assert _rel_list(got32[name], ref32[name]) <= 1e-5, name
    got = _chain(gxs, whs, mask, dys, torch.bfloat16, kernel=True)
    plain = _chain(gxs, whs, mask, dys, torch.bfloat16, kernel=False)
    unrounded = _chain(gxs, [w.bfloat16().float() for w in whs], mask, dys, torch.float32, kernel=False)
    torch.cuda.synchronize()
    for name in ref32:
        mine, theirs = _rel_list(got[name], ref32[name]), _rel_list(plain[name], ref32[name])
        assert mine <= 2.0 * theirs + 1e-5, (name, mine, theirs)
        mine, theirs = _rel_list(got[name], unrounded[name]), _rel_list(plain[name], unrounded[name])
        assert mine >= theirs / 2.0 - 1e-5, (name, mine, theirs)


@contextlib.contextmanager
def _plain_recurrences():
    cells = (lstm_bidi.CELL, gru_bidi.CELL)
    for c in cells:
        c.fwd, c.bwd = c.fwd_ref, c.bwd_ref
    try:
        yield
    finally:
        for c in cells:
            del c.fwd, c.bwd


@pytest.mark.parametrize("enc_type", ["lstm", "gru"])
def test_rnn_encoders_run_the_kernels(cuda, enc_type):
    """``enc_type = lstm`` / ``gru``: the encoder's recurrence and the
    predictor's each launch their forward and backward once a step on the
    persistent route, and the loss and gradients match the same model on
    the plain versions on the card (f32)."""
    cfg = _config(enc_type=enc_type)
    trainer = Trainer(cfg, TrainerConfig(loss_type="rnnt"), device=cuda)
    state = trainer.init_state(8)
    batch = _batch(9, b=8, t=48)
    for c in (lstm_bidi.CELL, gru_bidi.CELL):
        c.reset_counts()
    got, loss = _grads(trainer, state, batch)
    torch.cuda.synchronize()
    lstm, gru = lstm_bidi.CELL, gru_bidi.CELL
    want_lstm = 2 if enc_type == "lstm" else 1
    assert (lstm.fwd_persistent_launches, lstm.bwd_persistent_launches) == (want_lstm, want_lstm)
    assert (gru.fwd_persistent_launches, gru.bwd_persistent_launches) == (2 - want_lstm,) * 2
    assert lstm.fwd_launches == lstm.bwd_launches == gru.fwd_launches == gru.bwd_launches == 0
    with _plain_recurrences():
        want, loss_plain = _grads(trainer, state, batch)
    assert abs(loss - loss_plain) <= 1e-5 * abs(loss_plain)
    _check_grads(got, want, 1e-4)


@pytest.mark.parametrize("beam", [1, 4])
def test_decode_on_card_matches_cpu(cuda, beam):
    """Greedy and beam-4 decode of the same model on the card and on the
    CPU (f32): identical transcripts."""
    model = Trainer(_config(), TrainerConfig(loss_type="rnnt"), device="cpu").init_state(6).model
    batch = _batch(7, b=6, t=128)
    x, xl = batch.inputs.numpy(), batch.input_lengths.numpy()
    make = (lambda m: TransducerDecoder(m, _IdCoder())) if beam == 1 else (
        lambda m: TransducerBeamDecoder(m, _IdCoder(), beam_width=beam))
    want = make(model).decode_batch(x, xl)
    got = make(copy.deepcopy(model).to(cuda)).decode_batch(x, xl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_fused_beam_on_card_matches_cpu(cuda, tmp_path):
    """Beam 4 fused with a character trigram over the alphabet (alpha 0.5,
    beta 0.5) on the card and on the CPU (f32), by the n-best rule of
    tests/test_torch_cuda_seq2seq.py; a zero-weight table gives the unfused
    n-best exactly on the card."""
    model = Trainer(_config(), TrainerConfig(loss_type="rnnt"), device="cpu").init_state(8).model
    batch = _batch(9, b=6, t=128)
    x, xl = batch.inputs.numpy(), batch.input_lengths.numpy()
    table = char_lm(tmp_path, list)
    want = TransducerBeamDecoder(model, _IdCoder(), beam_width=4, fusion_table=table).decode_batch_nbest(x, xl)
    card = copy.deepcopy(model).to(cuda)
    got = TransducerBeamDecoder(card, _IdCoder(), beam_width=4, fusion_table=table).decode_batch_nbest(x, xl)
    check_nbest(got, want)
    table.table[:] = 0.0
    zero = TransducerBeamDecoder(card, _IdCoder(), beam_width=4, fusion_table=table).decode_batch_nbest(x, xl)
    base = TransducerBeamDecoder(card, _IdCoder(), beam_width=4).decode_batch_nbest(x, xl)
    assert [[(i.tolist(), s) for i, s in row] for row in zero] == [[(i.tolist(), s) for i, s in row] for row in base]

"""Kernels 4-7 (``ops/csrc/lstm_bidi.cu``, ``ops/csrc/gru_bidi.cu``) on the
card, against their plain versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips (inside the ``cuda`` fixture) when ``torch.cuda.is_available()`` is
false. The file imports no JAX:

    python -m pytest tests/test_torch_cuda_rnn.py --noconftest -q -m cuda

Tolerances: f32 1e-5 of max|ref| (the kernels and the plain versions
differ only in the summation order of the recurrent products). bf16: the
distance of the kernels' result from the plain version run in f32 within
2x of the plain bf16 version's own distance from it (one bf16 rounding of
``h`` or of the gate cotangents may land a step apart and travel on), and,
against the plain version run in f32 on the bf16-rounded weights, at least
half of the plain bf16 version's distance: a kernel that skipped the
rounding of ``h`` or of the gate cotangents before its products would sit
near zero there. The backward alone, on the plain forward's residuals (so
kernel 5 or 7 sees the plain version's inputs), is held to the same rules.
"""

import numpy as np
import pytest
import torch

from tfkaldi_tpu_torch.ops import gru_bidi, lstm_bidi, rnn_bidi
from tfkaldi_tpu_torch.ops.lstm_scan import weight_grad

pytestmark = pytest.mark.cuda

CELLS = {"lstm": lstm_bidi.CELL, "gru": gru_bidi.CELL}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tfkaldi_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _case(gates, t, b, h, dirs, device, seed):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(max(1, t * 2 // 5), t + 1, (b,), generator=g)
    lengths[0] = t
    mask = (torch.arange(t)[:, None] < lengths[None, :]).float()[:, :, None]
    gxs = [torch.randn(t, b, gates * h, generator=g) for _ in range(dirs)]
    for gx in gxs:
        gx[mask[:, :, 0] == 0] = 7.7
    whs = [torch.randn(h, gates * h, generator=g) / h ** 0.5 for _ in range(dirs)]
    dys = [torch.randn(t, b, h, generator=g) for _ in range(dirs)]
    return [x.to(device) for x in gxs], [w.to(device) for w in whs], mask.to(device), [d.to(device) for d in dys]


def _chain(cell, gxs, whs, mask, dys, cd, kernel, res=None):
    """Forward with residuals, backward and dW_h of every direction; with
    ``res`` given, the backward alone on them. Every output by name, the
    residuals under ``_res``."""
    c = CELLS[cell]
    whs_cd = [w.to(cd) for w in whs]
    flat = {}
    if res is None:
        outs = (c.fwd if kernel else c.fwd_ref)(gxs, whs_cd, mask, residuals=True)
        res = [r for _, r in outs]
        flat["ys"] = [y for y, _ in outs]
        for i in range(len(res[0])):
            flat[f"res{i}"] = [r[i] for r in res]
    grads = (c.bwd if kernel else c.bwd_ref)(dys, res, mask, whs_cd)
    flat["_res"] = res
    flat["dgx"] = [g for g, _ in grads]
    flat["dg_w"] = [g for _, g in grads]
    flat["dW_h"] = [weight_grad(r[2], g, cd) for r, (_, g) in zip(res, grads)]
    return flat


def _rel(a, b):
    return max(((x.float() - y.float()).abs().max() / y.float().abs().max().clamp(min=1e-30)).item()
               for x, y in zip(a, b))


def _outputs(flat):
    return [name for name in flat if not name.startswith("_")]


def _counts(c):
    return c.fwd_persistent_launches, c.fwd_launches, c.bwd_persistent_launches, c.bwd_launches


def _launched(plan, t):
    """(persistent, step) launches of one call on ``plan``'s route."""
    return (1, 0) if plan.route == "persistent" else (0, t)


# (512, 128, 512, 2): one layer of the recipe's BiLSTM / BiGRU (T_pad,
# batch, hidden); (129, 128, 320, 1): the transducer's prediction network
# (T = U_pad + 1); the held-out gates' layers at the dispenser's 16
# utterances padded to the 128-frame bucket: (128, 16, 64, 2) the CTC
# BiLSTM, (128, 16, 64, 1) the RNN-T encoder, (128, 16, 48, 2) the attention
# BiLSTM encoder, (129, 16, 32, 1) the transducers' predictor. (6, 300,
# 512, 2): B beyond the grid's 2 row CTAs, so each CTA loops over 3 row
# tiles; (1, 8, 128, 2): T 1; (5, 6, 720, 2): the LSTM's f32 forward and
# backward take the step route (their W_h slices do not fit); (7, 5, 33, 2)
# and (9, 37, 70, 1): dgates rows that are not whole 16-byte pieces send
# some backwards to the step route
PERSISTENT_BOTH_WAYS = {(512, 128, 512, 2), (16, 8, 128, 2), (129, 128, 320, 1), (128, 16, 64, 2), (128, 16, 64, 1),
                        (128, 16, 48, 2), (129, 16, 32, 1)}


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("t,b,h,dirs", [(16, 8, 128, 2), (7, 5, 33, 2), (9, 37, 70, 1), (512, 128, 512, 2),
                                        (6, 300, 512, 2), (1, 8, 128, 2), (12, 70, 256, 1), (5, 6, 720, 2),
                                        (129, 128, 320, 1), (128, 16, 64, 2), (128, 16, 64, 1), (128, 16, 48, 2),
                                        (129, 16, 32, 1)])
def test_kernels_match_plain(cuda, cell, t, b, h, dirs):
    c = CELLS[cell]
    gxs, whs, mask, dys = _case(c.gates, t, b, h, dirs, cuda, seed=t + b + h)
    ref32 = _chain(cell, gxs, whs, mask, dys, torch.float32, kernel=False)
    for cd in (torch.float32, torch.bfloat16):
        routes = (rnn_bidi.fwd_plan(b, h, c.gates, cd, dirs).route, rnn_bidi.bwd_plan(b, h, c.gates, cd, dirs).route)
        if (t, b, h, dirs) in PERSISTENT_BOTH_WAYS:
            assert routes == ("persistent", "persistent"), (cd, routes)
    fplan = rnn_bidi.fwd_plan(b, h, c.gates, torch.float32, dirs)
    bplan = rnn_bidi.bwd_plan(b, h, c.gates, torch.float32, dirs)
    before = _counts(c)
    got32 = _chain(cell, gxs, whs, mask, dys, torch.float32, kernel=True)
    torch.cuda.synchronize()
    # one persistent launch per call, or one step launch per time step, each way
    want = (*_launched(fplan, t), *_launched(bplan, t))
    assert _counts(c) == tuple(x + y for x, y in zip(before, want)), (fplan, bplan)
    alone = _chain(cell, gxs, whs, mask, dys, torch.float32, kernel=True, res=ref32["_res"])
    for name in _outputs(ref32):
        assert _rel(got32[name], ref32[name]) <= 1e-5, name
    for name in _outputs(alone):
        assert _rel(alone[name], ref32[name]) <= 1e-5, ("backward alone", name)
    before = _counts(c)
    got = _chain(cell, gxs, whs, mask, dys, torch.bfloat16, kernel=True)
    torch.cuda.synchronize()
    want = (*_launched(rnn_bidi.fwd_plan(b, h, c.gates, torch.bfloat16, dirs), t),
            *_launched(rnn_bidi.bwd_plan(b, h, c.gates, torch.bfloat16, dirs), t))
    assert _counts(c) == tuple(x + y for x, y in zip(before, want))
    plain = _chain(cell, gxs, whs, mask, dys, torch.bfloat16, kernel=False)
    # the same bf16 weights in f32: only the roundings of h and dgates are missing
    rounded = [w.bfloat16().float() for w in whs]
    unrounded = _chain(cell, gxs, rounded, mask, dys, torch.float32, kernel=False)
    alone = _chain(cell, gxs, whs, mask, dys, torch.bfloat16, kernel=True, res=plain["_res"])
    alone_unrounded = _chain(cell, gxs, rounded, mask, dys, torch.float32, kernel=False, res=plain["_res"])
    torch.cuda.synchronize()
    for name in _outputs(ref32):
        mine, theirs = _rel(got[name], ref32[name]), _rel(plain[name], ref32[name])
        assert mine <= 2.0 * theirs + 1e-5, (name, mine, theirs)
        mine, theirs = _rel(got[name], unrounded[name]), _rel(plain[name], unrounded[name])
        assert mine >= theirs / 2.0 - 1e-5, (name, mine, theirs)
    for name in _outputs(alone):
        mine, theirs = _rel(alone[name], ref32[name]), _rel(plain[name], ref32[name])
        assert mine <= 2.0 * theirs + 1e-5, ("backward alone", name, mine, theirs)
        mine, theirs = _rel(alone[name], alone_unrounded[name]), _rel(plain[name], alone_unrounded[name])
        assert mine >= theirs / 2.0 - 1e-5, ("backward alone", name, mine, theirs)
    for ys in got["ys"]:
        assert torch.all(ys[mask[:, :, 0] == 0] == 0)  # the padding emits zeros, garbage or not


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_persistent_forward_repeats(cuda, cell, cd):
    """The same persistent call twice gives identical results (each call
    starts its barrier counters at zero), and the eval variant (no
    residuals, h exchanged through two slots) gives the same ys."""
    c = CELLS[cell]
    gxs, whs, mask, _ = _case(c.gates, 64, 128, 512, 2, cuda, seed=11)
    whs_cd = [w.to(cd) for w in whs]
    assert rnn_bidi.fwd_plan(128, 512, c.gates, cd, 2).route == "persistent"
    before = _counts(c)
    first = c.fwd(gxs, whs_cd, mask, residuals=True)
    second = c.fwd(gxs, whs_cd, mask, residuals=True)
    evals = c.fwd(gxs, whs_cd, mask, residuals=False)
    torch.cuda.synchronize()
    assert _counts(c) == (before[0] + 3, *before[1:])
    for (ys1, res1), (ys2, res2), (ys3, res3) in zip(first, second, evals):
        assert res3 is None
        assert torch.equal(ys1, ys2) and torch.equal(ys1, ys3)
        for a, b in zip(res1, res2):
            assert torch.equal(a, b)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_persistent_backward_repeats(cuda, cell, cd):
    """The same persistent backward twice gives identical results (each call
    starts its barrier counters at zero and writes every exchange slot it
    reads), counted once per call; the step route on the same inputs agrees
    with it (f32: within the summation-order tolerance; bf16: both within
    2x of each other's distance from the f32 chain)."""
    c = CELLS[cell]
    t, b, h = 64, 128, 512
    gxs, whs, mask, dys = _case(c.gates, t, b, h, 2, cuda, seed=12)
    whs_cd = [w.to(cd) for w in whs]
    res = [r for _, r in c.fwd(gxs, whs_cd, mask, residuals=True)]
    assert rnn_bidi.bwd_plan(b, h, c.gates, cd, 2).route == "persistent"
    before = _counts(c)
    first = c.bwd(dys, res, mask, whs_cd)
    second = c.bwd(dys, res, mask, whs_cd)
    torch.cuda.synchronize()
    assert _counts(c) == (*before[:2], before[2] + 2, before[3])
    step = c.bwd(dys, res, mask, whs_cd, plan=rnn_bidi.STEP_BWD)
    torch.cuda.synchronize()
    assert _counts(c) == (*before[:2], before[2] + 2, before[3] + t)
    ref32 = c.bwd_ref(dys, res, mask, [w.float() for w in whs_cd]) if cd == torch.bfloat16 else None
    for (g1, w1), (g2, w2), (g3, w3), ref in zip(first, second, step, ref32 or [None] * 2):
        assert torch.equal(g1, g2) and torch.equal(w1, w2)
        if cd == torch.float32:
            assert _rel([g1, w1], [g3, w3]) <= 1e-5
        else:
            mine, theirs = _rel([g1, w1], list(ref)), _rel([g3, w3], list(ref))
            assert mine <= 2.0 * theirs + 1e-5 and theirs <= 2.0 * mine + 1e-5, (mine, theirs)


@pytest.mark.parametrize("h", [33, 512, 704, 1056])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gates", [3, 4])
def test_plan_smem_matches_kernel_library(cuda, gates, cd, h):
    """The wrapper's launch plan sizes shared memory as the C side does."""
    from tfkaldi_tpu_torch.ops import _build

    lib = _build.load()
    assert rnn_bidi.persistent_smem(gates, h, cd) == lib.tk_rnn_fwd_smem(gates, h, int(cd == torch.bfloat16))
    assert rnn_bidi.persistent_bwd_smem(gates, h, cd) == lib.tk_rnn_bwd_smem(gates, h, int(cd == torch.bfloat16))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_autograd_on_card_matches_cpu(cuda, cell):
    """``lstm_scan_bidi``/``gru_scan_bidi`` on the card (kernels) and on the
    CPU (plain versions): values and all four gradients, f32."""
    fn = lstm_bidi.lstm_scan_bidi if cell == "lstm" else gru_bidi.gru_scan_bidi
    gxs, whs, mask, dys = _case(CELLS[cell].gates, 24, 16, 64, 2, "cpu", seed=3)
    results = []
    for device in ("cpu", cuda):
        args = [x.detach().to(device).requires_grad_() for x in (*gxs, *whs)]
        ysf, ysb = fn(*args, mask.to(device), torch.float32)
        ((ysf * dys[0].to(device)).sum() + (ysb * dys[1].to(device)).sum()).backward()
        results.append([y.detach().cpu() for y in (ysf, ysb)] + [a.grad.cpu() for a in args])
    for i, (a, b) in enumerate(zip(*results)):
        assert _rel([b], [a]) <= 1e-5, i


def test_model_on_card_matches_cpu(cuda):
    """A BiLSTM's eval logits on the card (kernel 4) and on the CPU."""
    from tfkaldi_tpu_torch.models import RNNConfig, build_model

    model = build_model(RNNConfig(input_dim=20, num_labels=9, num_layers=2, hidden_units=64, bidirectional=True))
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.out.w.normal_(0, 0.3)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 30, 20)).astype(np.float32))
    lengths = torch.tensor([30, 12, 29, 5])
    with torch.inference_mode():
        want = model(x, lengths)
        got = model.to(cuda)(x.to(cuda), lengths).cpu()
    assert _rel([got], [want]) <= 1e-5


def test_kernels_reject_mixed_dtypes(cuda):
    gxs, whs, mask, _ = _case(4, 4, 2, 8, 2, cuda, seed=0)
    with pytest.raises(ValueError):
        lstm_bidi.CELL.fwd(gxs, [whs[0].bfloat16(), whs[1]], mask)
    with pytest.raises(ValueError):
        lstm_bidi.CELL.fwd([gxs[0].double(), gxs[1]], whs, mask)

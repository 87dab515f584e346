"""The CTC path on the card: the CTC loss's routes, and the text decode with
kernels 4 and 5 against their plain versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips (inside the ``cuda`` fixture) when ``torch.cuda.is_available()`` is
false. The file imports no JAX:

    python -m pytest tests/test_torch_cuda_ctc.py --noconftest -q -m cuda

Tolerances: the loss's ``F.ctc_loss`` route against the plain recursion,
per-row loss 1e-5 relative and logit gradient 1e-5 absolute (torch's CUDA
CTC against the recursion, both in f64 on the f32 log-posteriors). The
decode, kernels against the plain versions in f32: log-posteriors within 1e-4 absolute (the summation
order of the recurrent products), and the transcripts identical on every
utterance whose frames all have a top-two log-posterior margin above that.
"""

import contextlib

import numpy as np
import pytest
import torch

from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.convert import rnn_from_jax
from tfkaldi_tpu_torch.data.target_coder import TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
from tfkaldi_tpu_torch.decode import ctc as ctc_decode
from tfkaldi_tpu_torch.models import RNNConfig, build_model
from tfkaldi_tpu_torch.ops import lstm_bidi
from tfkaldi_tpu_torch.train import ctc

pytestmark = pytest.mark.cuda

B, T, V = 128, 512, 36  # the CTC recipe's batch, padded length and classes (35 characters + blank)
BLANK = V - 1
LOG_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from tfkaldi_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _labels(rng, b, t_max, out_len):
    """Label rows of up to a third of each row's frames, with repeats."""
    tgt_len = np.array([rng.integers(1, n // 3 + 1) for n in out_len], np.int32)
    targets = rng.integers(0, BLANK, (b, t_max // 3)).astype(np.int32)
    targets[:, 1] = targets[:, 0]  # a repeat in every row
    return targets, tgt_len


def test_ctc_loss_library_route_matches_plain(cuda):
    rng = np.random.default_rng(0)
    out_len = rng.integers(204, T + 1, B).astype(np.int32)
    out_len[0] = T
    targets, tgt_len = _labels(rng, B, T, out_len)
    tgt_len[1], out_len[1] = 40, 30  # one infeasible row: the plain recursion takes it
    logits = torch.tensor(rng.standard_normal((B, T, V)) * 3, dtype=torch.float32, device=cuda)
    plan = ctc.feasible_rows(targets, tgt_len, out_len)
    assert plan.sum() == B - 1 and not plan[1]

    def run(route):
        x = logits.clone().requires_grad_(True)
        loss = ctc.ctc_loss(x, out_len, targets, tgt_len, BLANK, route=route)
        loss.sum().backward()
        return loss.detach(), x.grad

    ctc.reset_counts()
    got, g_got = run(None)
    assert ctc.launches_by_route == {"library": 1, "plain": 1}
    want, g_want = run("plain")
    assert torch.isfinite(got).all() and torch.isfinite(g_got).all()
    rel = ((got - want).abs() / want.abs()).max().item()
    err = (g_got - g_want).abs().max().item()
    print(f"CTC loss [{B},{T},{V}]: F.ctc_loss route vs plain, per-row rel {rel!r}, gradient max|diff| {err!r}")
    assert rel <= 1e-5 and err <= 1e-5


@contextlib.contextmanager
def plain_lstm():
    cell = lstm_bidi.CELL
    cell.fwd, cell.bwd = cell.fwd_ref, cell.bwd_ref  # instance attributes over the Cell's methods
    try:
        yield
    finally:
        del cell.fwd, cell.bwd


@pytest.mark.parametrize("beam", [1, 16])
def test_text_decode_kernels_match_plain(cuda, beam):
    """One decode batch of the recipe's 2 x 512 BiLSTM (f32, seeded weights,
    16 utterances of 204-512 frames) with kernel 4 and with its plain
    version; beam 16 on the native beam."""
    input_dim, b = 200, 16
    params = synthetic.random_rnn_pytree(input_dim, 512, 2, V, gates=4, seed=3)
    params["out"]["w"] *= 4.0
    model = build_model(RNNConfig(input_dim=input_dim, num_labels=V, num_layers=2, hidden_units=512,
                                  bidirectional=True, compute_dtype=torch.float32, cell="lstm"))
    model.load_state_dict(rnn_from_jax(params))
    decoder = ctc_decode.CTCDecoder(model.to(cuda), TextCoder(aurora4_normalizer), BLANK, beam_width=beam)
    rng = np.random.default_rng(1)
    lengths = rng.integers(204, T + 1, b).astype(np.int32)
    inputs = rng.standard_normal((b, T, input_dim)).astype(np.float32)
    before = lstm_bidi.CELL.fwd_persistent_launches
    got_lp = decoder.log_probs(inputs, lengths)
    got = decoder.decode_batch(inputs, lengths)
    assert lstm_bidi.CELL.fwd_persistent_launches == before + 4  # 2 layers, 2 calls
    with plain_lstm():
        want_lp = decoder.log_probs(inputs, lengths)
        want = decoder.decode_batch(inputs, lengths)
    err = max(float(np.abs(got_lp[i, :n] - want_lp[i, :n]).max()) for i, n in enumerate(lengths))
    top2 = np.sort(want_lp, axis=-1)[..., -2:]
    clear = [i for i, n in enumerate(lengths) if (top2[i, :n, 1] - top2[i, :n, 0] > LOG_TOL).all()]
    print(f"decode beam {beam}: log-posteriors max|diff| {err!r}; {len(clear)} of {b} utterances with clear margins")
    assert err <= LOG_TOL
    assert len(clear) >= b // 2
    for i in clear:
        np.testing.assert_array_equal(got[i], want[i])
    if beam > 1:
        assert ctc_decode.beam_runs["python"] == 0 and ctc_decode.beam_runs["native"] >= 2


def test_fused_beam_route_counts(cuda, tmp_path):
    """The recipe's 2 x 512 BiLSTM (f32, seeded weights) at beam 16 fused with
    a character trigram: the fused route runs (``beam_runs["fused"]`` once a
    batch, the native beam never), kernel 4 launches once per layer and call
    on the persistent route, and the transcripts equal those of the plain
    version's log-posteriors through the same fused beam where the margins
    are clear."""
    from tfkaldi_tpu_torch.decode.lm import ArpaLM, FusionScorer

    input_dim, b = 200, 8
    params = synthetic.random_rnn_pytree(input_dim, 512, 2, V, gates=4, seed=4)
    params["out"]["w"] *= 4.0
    model = build_model(RNNConfig(input_dim=input_dim, num_labels=V, num_layers=2, hidden_units=512,
                                  bidirectional=True, compute_dtype=torch.float32, cell="lstm"))
    model.load_state_dict(rnn_from_jax(params))
    rng = np.random.default_rng(2)
    text = tmp_path / "text"
    text.write_text("".join(f"u{i} {synthetic.transcript(rng, 300)}\n" for i in range(40)))
    synthetic.write_char_arpa(str(tmp_path / "char3.arpa"), [str(text)])
    coder = TextCoder(aurora4_normalizer)
    scorer = FusionScorer(ArpaLM.load(str(tmp_path / "char3.arpa")), list(coder.alphabet) + ["<blank>"], alpha=0.5)
    decoder = ctc_decode.CTCDecoder(model.to(cuda), coder, BLANK, beam_width=16, fusion_scorer=scorer)
    lengths = rng.integers(204, T + 1, b).astype(np.int32)
    inputs = rng.standard_normal((b, T, input_dim)).astype(np.float32)
    ctc_decode.beam_runs.update(native=0, python=0, fused=0)
    before = lstm_bidi.CELL.fwd_persistent_launches
    got = decoder.decode_batch(inputs, lengths)
    assert lstm_bidi.CELL.fwd_persistent_launches == before + 2  # 2 layers, 1 call
    assert ctc_decode.beam_runs == {"native": 0, "python": 0, "fused": 1}
    assert [len(f) for f in decoder.last_label_frames] == [len(g) for g in got]
    with plain_lstm():
        want = decoder.decode_batch(inputs, lengths)
        want_lp = decoder.log_probs(inputs, lengths)
    top2 = np.sort(want_lp, axis=-1)[..., -2:]
    clear = [i for i, n in enumerate(lengths) if (top2[i, :n, 1] - top2[i, :n, 0] > LOG_TOL).all()]
    assert len(clear) >= b // 2
    for i in clear:
        np.testing.assert_array_equal(got[i], want[i])

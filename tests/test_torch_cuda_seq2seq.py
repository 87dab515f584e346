"""The attention recipe's model on the card against the port on the CPU, and
its BiLSTM-encoder route through kernels 4 and 5.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips (inside the ``cuda`` fixture) when ``torch.cuda.is_available()`` is
false. The file imports no JAX:

    python -m pytest tests/test_torch_cuda_seq2seq.py --noconftest -q -m cuda

Tolerances: f32 card against CPU (TF32 off on both; sums in another order),
logits within 1e-5 of max|CPU| and gradients within 1e-4 of each max|CPU|;
bf16, the card's distance from the CPU f32 result within 2x the CPU bf16
result's (+ 1e-5). The key biases' gradients are 0 in exact arithmetic
(the softmax ignores a shift of a whole row), so they are rounding noise on
both sides and are held below 1e-4 of the key weights' gradient instead.
The autoregressive beam (unfused, and fused with a character trigram
written by ``synthetic.write_char_arpa``): the card's n-best against the
CPU's, scores within 1e-4 where the n-best lists agree (at least half the
rows), the best hypothesis identical wherever the top two scores lie
further apart than twice the runs' score difference; beam 1 equals a
greedy walk of the cached step on the card.
The BiLSTM encoder's kernels against their plain versions on the card: the
rule of tests/test_torch_cuda_rnn.py (f32 within 1e-5, bf16 by the 2x rule),
carried through the encoder and the decoder on top (1e-4 for gradients).
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.data.batching import PaddedBatch
from tfkaldi_tpu_torch.data.target_coder import TextCoder
from tfkaldi_tpu_torch.data.target_normalizers import aurora4_normalizer
from tfkaldi_tpu_torch.decode.lm import ArpaLM, DenseFusionTable
from tfkaldi_tpu_torch.decode.seq2seq import CTCRescoreDecoder, Seq2SeqBeamDecoder
from tfkaldi_tpu_torch.models import Seq2SeqConfig
from tfkaldi_tpu_torch.ops import lstm_bidi, rnn_bidi
from tfkaldi_tpu_torch.train import checkpoint as ckpt
from tfkaldi_tpu_torch.train.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.cuda

V, IN = 35, 40  # the recipe's 35 characters (+ SOS/EOS) and 40 fbanks
CONFORMER = (("num_blocks", "2"), ("d_model", "64"), ("num_heads", "4"), ("ffn_dim", "128"), ("conv_kernel", "15"),
             ("subsample", "4"))


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
    return Seq2SeqConfig(input_dim=IN, num_labels=V, enc_type=enc_type, enc_layers=1, enc_units=128,
                         enc_extra=extra, dec_blocks=2, d_model=64, num_heads=4, ffn_dim=128, ctc_weight=0.3,
                         compute_dtype=cd, **kw)


def _state(trainer, seed):
    """A seeded state with non-zero decoder and CTC heads."""
    state = trainer.init_state(seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for head in (state.model.out, state.model.ctc_head):
            head.w.copy_(torch.randn(head.w.shape, generator=g) * 0.3)
    return state


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


def _grads(trainer, state, batch, device):
    grads, loss, _ = trainer.gradients(ckpt.device_snapshot(state), batch.to(device))
    return {n: g.cpu() for n, g in grads.items()}, loss.item()


def _check_grads(got, want, tol):
    for name, g in want.items():
        if name.endswith(".bk"):
            scale = want[name[:-2] + "wk"].abs().max().item()
            assert max(got[name].abs().max().item(), g.abs().max().item()) <= 1e-4 * scale, name
        else:
            assert _rel(got[name], g) <= tol, (name, _rel(got[name], g))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_conformer_on_card_matches_cpu(cuda, train):
    """The conformer-s4 encoder and the decoder (``apply_joint``) on the
    card against the CPU, f32."""
    cfg = _config()
    cpu = _state(Trainer(cfg, TrainerConfig(loss_type="attention"), device="cpu"), 0).model
    model = copy.deepcopy(cpu).to(cuda)
    batch = _batch(1)
    args = (batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths)
    with torch.no_grad():
        want = cpu.apply_joint(*args, train=train)
        got = model.apply_joint(*(a.to(cuda) for a in args), train=train)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5, _rel(g, w)
    if train:  # the moving statistics moved alike
        assert _rel(model.enc.bn_conv_var, cpu.enc.bn_conv_var) <= 1e-5


def test_joint_gradients_on_card_match_cpu(cuda):
    cfg = _config()
    trainer_cpu = Trainer(cfg, TrainerConfig(loss_type="attention"), device="cpu")
    trainer = Trainer(cfg, TrainerConfig(loss_type="attention"), device=cuda)
    state = _state(trainer_cpu, 2)
    batch = _batch(3)
    want, loss_cpu = _grads(trainer_cpu, state, batch, "cpu")
    state_card = ckpt.device_snapshot(state)
    state_card.model.to(cuda)
    state_card.adam_m = {k: v.to(cuda) for k, v in state_card.adam_m.items()}
    state_card.adam_v = {k: v.to(cuda) for k, v in state_card.adam_v.items()}
    got, loss = _grads(trainer, state_card, batch, cuda)
    assert abs(loss - loss_cpu) <= 1e-5 * abs(loss_cpu)
    _check_grads(got, want, 1e-4)


def test_bf16_conformer_on_card_by_the_rule(cuda):
    """bf16 on the card: its distance from the CPU f32 result within 2x the
    CPU bf16 result's."""
    batch = _batch(4)
    args = (batch.inputs, batch.input_lengths, batch.targets, batch.target_lengths)
    models = {}
    for name, cd in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        models[name] = _state(Trainer(_config(cd), TrainerConfig(loss_type="attention"), device="cpu"), 5).model
    card = copy.deepcopy(models["bf16"]).to(cuda)
    with torch.no_grad():
        ref = models["f32"].apply_joint(*args)
        cpu = models["bf16"].apply_joint(*args)
        got = card.apply_joint(*(a.to(cuda) for a in args))
    for g, c, r in zip(got, cpu, ref):
        mine, theirs = _rel(g, r), _rel(c, r)
        print(f"bf16 card {mine!r}, CPU {theirs!r} from the CPU f32 result")  # shown with -s
        assert theirs > 0 and mine <= 2.0 * theirs + 1e-5, (mine, theirs)


def test_rescoring_on_card_matches_cpu(cuda):
    """The two-pass decode: CTC and attention scores of the same n-best
    within 1e-4, the transcripts identical wherever the top two final
    scores are further apart than that."""
    cfg = _config()
    model = _state(Trainer(cfg, TrainerConfig(loss_type="attention"), device="cpu"), 6).model
    batch = _batch(7, b=6, t=128)
    x, xl = batch.inputs.numpy(), batch.input_lengths.numpy()
    dec_cpu = CTCRescoreDecoder(model, _IdCoder(), beam_width=10)
    want = dec_cpu.decode_batch(x, xl)
    dec = CTCRescoreDecoder(copy.deepcopy(model).to(cuda), _IdCoder(), beam_width=10)
    got = dec.decode_batch(x, xl)
    same_nbest = [np.array_equal(dec.last_tokens[i], dec_cpu.last_tokens[i]) for i in range(len(xl))]
    for i, same in enumerate(same_nbest):
        if not same:
            continue
        filled = np.isfinite(dec_cpu.last_ctc_scores[i])
        assert np.abs(dec.last_ctc_scores[i][filled] - dec_cpu.last_ctc_scores[i][filled]).max() <= 1e-4
        assert np.abs(dec.last_att_scores[i][filled] - dec_cpu.last_att_scores[i][filled]).max() <= 1e-4
        final = np.sort(0.5 * dec_cpu.last_ctc_scores[i][filled] + 0.5 * dec_cpu.last_att_scores[i][filled])
        if len(final) < 2 or final[-1] - final[-2] > 1e-3:
            np.testing.assert_array_equal(got[i], want[i])
    assert sum(same_nbest) >= len(xl) // 2, same_nbest


def char_lm(tmp_path, columns):
    """A character trigram over the recipe's alphabet from seeded transcripts,
    as a dense fusion table with ``columns``."""
    rng = np.random.default_rng(5)
    text = tmp_path / "text"
    text.write_text("".join(f"u{i} {synthetic.transcript(rng, 300)}\n" for i in range(40)))
    synthetic.write_char_arpa(str(tmp_path / "char3.arpa"), [str(text)])
    alphabet = TextCoder(aurora4_normalizer).alphabet
    return DenseFusionTable(ArpaLM.load(str(tmp_path / "char3.arpa")), alphabet, columns(alphabet), alpha=0.5,
                            beta=0.5)


def check_nbest(got, want, tol=1e-4):
    """The rule of the transducer's card test: n-best lists that agree have
    scores within ``tol``, and their best ids are identical wherever the top
    two scores lie further apart than twice the two runs' difference; at
    least half the rows agree."""
    agree = 0
    for g_row, w_row in zip(got, want):
        if len(g_row) != len(w_row) or not all(np.array_equal(a[0], b[0]) for a, b in zip(g_row, w_row)):
            continue
        agree += 1
        diff = max(abs(a[1] - b[1]) for a, b in zip(g_row, w_row))
        assert diff <= tol * max(1.0, abs(w_row[0][1])), diff
        if len(w_row) < 2 or w_row[0][1] - w_row[1][1] > 2 * diff:
            np.testing.assert_array_equal(g_row[0][0], w_row[0][0])
    assert agree >= len(want) // 2, (agree, len(want))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_attention_beam_on_card_matches_cpu(cuda, fused, tmp_path):
    cfg = _config()
    model = _state(Trainer(cfg, TrainerConfig(loss_type="attention"), device="cpu"), 8).model
    batch = _batch(9, b=6, t=128)
    x, xl = batch.inputs.numpy(), batch.input_lengths.numpy()
    table = char_lm(tmp_path, lambda alphabet: list(alphabet) + ["</s>"]) if fused else None
    want = Seq2SeqBeamDecoder(model, _IdCoder(), beam_width=4, max_tokens=24, fusion_table=table)
    got = Seq2SeqBeamDecoder(copy.deepcopy(model).to(cuda), _IdCoder(), beam_width=4, max_tokens=24,
                             fusion_table=table)
    assert got._lm_table is None or got._lm_table.is_cuda
    check_nbest(got.decode_batch_nbest(x, xl), want.decode_batch_nbest(x, xl))
    assert got.steps == want.steps > 0


def test_attention_beam1_equals_greedy_walk_on_card(cuda):
    cfg = _config()
    model = _state(Trainer(cfg, TrainerConfig(loss_type="attention"), device="cpu"), 10).model.to(cuda)
    batch = _batch(11, b=4, t=96)
    x, xl = batch.inputs.numpy(), batch.input_lengths.numpy()
    L = 16
    got = Seq2SeqBeamDecoder(model, _IdCoder(), beam_width=1, max_tokens=L).decode_batch(x, xl)
    with torch.no_grad():
        mem = model.encode(batch.inputs.to(cuda), batch.input_lengths)
        valid = model.memory_valid(mem, batch.input_lengths)
        ck, cv = model.cross_kv(mem)
        cache = model.init_decode_cache(len(xl), L)
        tok, score = torch.full((len(xl),), V, device=cuda), torch.zeros(len(xl), device=cuda)
        ids, done = [[] for _ in xl], [False] * len(xl)
        for s in range(L):
            logits, cache = model.decode_step_cached(tok, s, cache, ck, cv, valid)
            total = score[:, None] + torch.log_softmax(logits, dim=-1)  # as the beam adds them
            tok = torch.argmax(total, dim=-1)
            score = total.gather(1, tok[:, None])[:, 0]
            for i, t in enumerate(tok.tolist()):
                done[i] = done[i] or t == V
                if not done[i]:
                    ids[i].append(t)
    for g, w in zip(got, ids):
        np.testing.assert_array_equal(g, w)


@contextlib.contextmanager
def _plain_recurrences():
    c = lstm_bidi.CELL
    c.fwd, c.bwd = c.fwd_ref, c.bwd_ref
    try:
        yield
    finally:
        del c.fwd, c.bwd


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_lstm_encoder_runs_the_persistent_kernels(cuda, cd):
    """``enc_type = lstm``: a seq2seq model with a 1 x 128 BiLSTM encoder on
    the card launches kernel 4 once per forward and kernel 5 once per
    backward, both on the persistent route, and its joint loss and
    gradients match the same model on the plain versions."""
    c = lstm_bidi.CELL
    assert rnn_bidi.fwd_plan(8, 128, c.gates, cd, 2).route == "persistent"
    assert rnn_bidi.bwd_plan(8, 128, c.gates, cd, 2).route == "persistent"
    trainer = Trainer(_config(cd, enc_type="lstm"), TrainerConfig(loss_type="attention"), device=cuda)
    state = _state(trainer, 8)
    batch = _batch(9, b=8, t=48)
    c.reset_counts()
    got, loss = _grads(trainer, state, batch, cuda)
    torch.cuda.synchronize()
    assert (c.fwd_persistent_launches, c.fwd_launches, c.bwd_persistent_launches, c.bwd_launches) == (1, 0, 1, 0)
    with _plain_recurrences():
        want, loss_plain = _grads(trainer, state, batch, cuda)
    assert (c.fwd_persistent_launches, c.bwd_persistent_launches) == (1, 1)
    if cd == torch.float32:
        assert abs(loss - loss_plain) <= 1e-5 * abs(loss_plain)
        _check_grads(got, want, 1e-4)
        return
    trainer32 = Trainer(_config(enc_type="lstm"), TrainerConfig(loss_type="attention"), device=cuda)
    state32 = _state(trainer32, 8)
    with _plain_recurrences():
        ref, _ = _grads(trainer32, state32, batch, cuda)
    for name, r in ref.items():
        if name.endswith(".bk"):
            continue
        mine, theirs = _rel(got[name], r), _rel(want[name], r)
        assert mine <= 2.0 * theirs + 1e-5, (name, mine, theirs)

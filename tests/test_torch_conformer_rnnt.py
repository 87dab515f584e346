"""The Conformer transducer's new pieces on the CPU against the plain
reference ``portbench/reference/conformer_rnnt.py``: relative-position
attention, the conv2d front end, the even kernel's SAME padding, the conv
module's scaled batch norm, the whole loss and every leaf's gradient, and
``Nnet.train`` on the dense lattice.

At a tiny size (2 blocks, ``d_model`` 32, 4 heads, ffn 64, kernel 8, 16-dim
features, 17 labels + the blank, B 3, T ≤ 40; predictor 24, embedding 8,
joint 20), from seeded weights with non-zero biases and gains near 1.
Tolerances, each with its reason:

- f32: the loss within LOSS_RTOL (1e-5) relative, every leaf's gradient
  within GRAD_TOL (1e-4) of the larger of its own and the median leaf's
  norm (the reference sums in other orders: the direct O(T'^2) scores
  against the rel-shift, ``unfold`` against ``conv2d``, taps against
  ``conv1d``, the anti-diagonal recursion against the closed-form rows;
  f32 round-off, measured at 1e-7 / 3e-6). A leaf with no gradient in
  exact arithmetic (the key bias, which softmax cancels) is held to the
  median's scale by the same rule.
- bf16, the reference rounding at the configuration's points: the port's
  gap to it at most MIRROR (0.5) times its gap to the f32 reference, for
  the loss and for the worst leaf: mirroring the roundings must remove at
  least half of the precision gap, else a rounding point differs
  (measured: loss 1e-7 against 3e-4, leaves 1.2e-2 against 8e-2; rounding
  flips of single elements remain).
"""

import configparser
import math
import statistics

import numpy as np
import pytest
import torch

from portbench import corpus as corpus_mod
from portbench.reference import conformer_rnnt as ref
from tfkaldi_tpu_torch.data.bulk_loader import BulkTextBatchSource
from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer
from tfkaldi_tpu_torch.models.transducer import Transducer, TransducerConfig
from tfkaldi_tpu_torch.models.transformer import (Transformer, TransformerConfig, conv2d_out, rel_attention,
                                                  rel_positions)
from tfkaldi_tpu_torch.nnet import Nnet
from tfkaldi_tpu_torch.ops import rnnt_loss
from tfkaldi_tpu_torch.train import trainer as trainer_mod

F_IN, V, D, H, FFN, K, NB = 16, 17, 32, 4, 64, 8, 2
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
MIRROR = 0.5
REF = ref.Config(feat_dim=F_IN, num_labels=V, num_blocks=NB, d_model=D, num_heads=H, ffn_dim=FFN, conv_kernel=K,
                 pred_units=24, embed_dim=8, joint_units=20, joint_chunk=4)
NNET = {"num_blocks": str(NB), "d_model": str(D), "num_heads": str(H), "ffn_dim": str(FFN), "conv_kernel": str(K),
        "causal_conv": "False", "pos_enc": "relative", "frontend": "conv2d",
        "conv_bn_scale": "True"}


def _weights(seed=5):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in ref.param_shapes(REF).items():
        w = torch.randn(shape, generator=g)
        if len(shape) == 1:
            w = w * 0.1 + (1.0 if name.endswith((".g", "bn_gamma")) else 0.0)
        else:
            w = w / math.sqrt(math.prod(shape) // shape[0] if len(shape) > 2 else shape[0])
        out[name] = w
    return out


def _batch(seed=6):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.tensor([40, 31, 17])
    x = torch.randn(3, 40, F_IN, generator=g) * (torch.arange(40)[None, :, None] < lengths[:, None, None])
    label_lengths = torch.tensor([6, 4, 2])
    labels = torch.randint(0, V, (3, 6), generator=g) * (torch.arange(6)[None, :] < label_lengths[:, None])
    return {"x": x, "lengths": lengths, "labels": labels, "label_lengths": label_lengths}


def _model(dtype, keep=1.0):
    cfg = TransducerConfig(input_dim=F_IN, num_labels=V, enc_type="conformer", pred_units=24, embed_dim=8,
                           joint_units=20, enc_extra=tuple(NNET.items()), compute_dtype=dtype, joint_chunk_t=4,
                           dropout=keep)
    model = Transducer(cfg)
    params = dict(model.named_parameters())
    w = _weights()
    assert set(params) == set(w)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(w[name])
    return model


def _port(dtype, batch, keep=1.0, seed=None):
    model = _model(dtype, keep)
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    lp_blank, lp_label = model.lattice_scores(batch["x"], batch["lengths"], batch["labels"], batch["label_lengths"],
                                              train=True, generator=gen)
    nll = rnnt_loss.rnnt_alpha_loss(lp_blank, rnnt_loss.mask_label_scores(lp_label, batch["label_lengths"]),
                                    model.output_lengths(batch["lengths"]), batch["label_lengths"])
    params = dict(model.named_parameters())
    loss = nll.sum()
    return float(loss.detach()), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def _ref(mode, batch, keep=1.0, seed=None):
    p = {n: w.requires_grad_(True) for n, w in _weights().items()}
    draw = None
    if seed is not None:
        gen = torch.Generator().manual_seed(seed)

        def draw(shape):
            return torch.rand(shape, generator=gen) < keep
    loss = ref.loss_sum(p, ref.Config(**{**REF.__dict__, "keep": keep}), batch, mode, draw)
    return float(loss.detach()), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def _gaps(got, want):
    """(relative loss gap, worst leaf's gradient gap over max(its norm, the
    median leaf's))."""
    med = statistics.median(float(g.norm()) for g in want[1].values())
    leaves = max(float((got[1][n] - g).norm()) / max(float(g.norm()), med) for n, g in want[1].items())
    return abs(got[0] - want[0]) / abs(want[0]), leaves


def test_rel_attention_is_the_direct_formula():
    """The port's rel-shift scores against the reference's pair-by-pair
    formula, f32, with padded keys."""
    g = torch.Generator().manual_seed(1)
    w = _weights()
    p = {n[len("enc.blocks.0.attn."):]: t for n, t in w.items() if n.startswith("enc.blocks.0.attn.")}

    class P:
        pass

    attn = P()
    for n, t in p.items():
        setattr(attn, n, t)
    z = torch.randn(2, 9, D, generator=g)
    real = torch.arange(9)[None, :] < torch.tensor([9, 5])[:, None]
    got = rel_attention(z, attn, rel_positions(9, D, "cpu"), real[:, None, None, :], H, torch.float32)
    want = ref.mhsa(w, "enc.blocks.0.attn.", z, real, H, "f32")
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max())), float((got - want).abs().max())


@pytest.mark.parametrize("t", [7, 8, 9, 40, 41, 1600, 1664])
def test_conv2d_front_end_lengths(t):
    """``T' = ((T-1)//2 - 1)//2`` is both the front end's output length and
    ``output_lengths``; 1,600 frames give 399 positions."""
    cfg = TransformerConfig(input_dim=F_IN, num_labels=5, num_blocks=0, d_model=8, num_heads=2,
                            frontend="conv2d")
    model = Transformer(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    out = model._conv_frontend(torch.zeros(1, t, F_IN), torch.float32)
    assert out.shape == (1, conv2d_out(t), 8 * conv2d_out(F_IN)) == (1, int(model.output_lengths(t)), 24)
    assert conv2d_out(1600) == 399 and ref.output_lengths(1600) == 399


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logits_at_real_frames_ignore_padding(dtype):
    """Extra padded frames, filled with noise, leave every real position's
    encoder output as it was."""
    model = _model(dtype)
    a = _batch()
    padded = torch.cat([a["x"], torch.randn(3, 13, F_IN, generator=torch.Generator().manual_seed(3))], dim=1)
    ea, eb = model.encode(a["x"], a["lengths"]), model.encode(padded, a["lengths"])
    for row, n in enumerate(model.output_lengths(a["lengths"]).tolist()):
        assert torch.equal(ea[row, :n], eb[row, :n])


def test_even_kernel_pads_tf_same():
    """Kernel 8 non-causal: output frame t reads frames t-3 .. t+4 ((k-1)//2
    before, k//2 after), as TF's SAME; eval mode, so batch norm adds no
    coupling between frames."""
    cfg = TransformerConfig(input_dim=F_IN, num_labels=5, num_blocks=1, d_model=D, num_heads=H, conformer=True,
                            conv_kernel=8, conv_bn_scale=True)
    model = Transformer(cfg)
    model.reset_parameters(torch.Generator().manual_seed(2))
    blk = model.blocks[0]
    x = torch.randn(1, 20, D)
    mask = torch.ones(1, 20, 1, dtype=torch.bool)
    base = model._conv_module(x, blk, 0, mask, False, torch.float32)
    x2 = x.clone()
    x2[0, 10] += 1.0
    moved = (model._conv_module(x2, blk, 0, mask, False, torch.float32) - base).abs().amax(-1)[0] > 0
    assert moved.nonzero().flatten().tolist() == list(range(10 - 4, 10 + 3 + 1))


@pytest.mark.parametrize("keep,seed", [(1.0, None), (0.9, 7)], ids=["no_dropout", "dropout"])
def test_f32_loss_and_every_gradient_match_the_reference(keep, seed):
    """The dense lattice loss and every leaf's gradient in f32; with dropout
    both sides draw their masks from twin generators, so the draw order is
    checked too."""
    batch = _batch()
    loss_gap, leaf_gap = _gaps(_port(torch.float32, batch, keep, seed), _ref("f32", batch, keep, seed))
    assert loss_gap <= LOSS_RTOL and leaf_gap <= GRAD_TOL, (loss_gap, leaf_gap)


def test_bf16_matches_the_reference_with_mirrored_roundings():
    batch = _batch()
    port = _port(torch.bfloat16, batch)
    mirrored, widened = _gaps(port, _ref("bf16", batch)), _gaps(port, _ref("f32", batch))
    assert all(m <= MIRROR * w for m, w in zip(mirrored, widened)), (mirrored, widened)


def test_validate_streamable_refuses_the_new_options():
    base = dict(input_dim=F_IN, num_labels=5, num_blocks=1, d_model=8, num_heads=2, conformer=True, conv_kernel=3,
                causal_conv=True, left_context=4, right_context=0)
    Transformer(TransformerConfig(**base)).validate_streamable()
    for extra, word in ((dict(pos_enc="relative"), "pos_enc"), (dict(frontend="conv2d"), "frontend")):
        with pytest.raises(ValueError, match=word):
            Transformer(TransformerConfig(**base, **extra)).validate_streamable()
    assert TransformerConfig(**base, frontend="conv2d").subsample == 4  # the front-end's own factor
    assert TransformerConfig(**base, frontend="conv2d", subsample=4).subsample == 4
    with pytest.raises(ValueError, match="leave subsample out"):
        TransformerConfig(**base, frontend="conv2d", subsample=2)


def test_nnet_train_runs_the_dense_lattice(tmp_path):
    """``Nnet``'s ``[nnet]`` parsing → ``TrainingController.train`` →
    ``Trainer`` with ``loss = rnnt`` on the dense lattice, word-piece ids
    through ``AlignmentCoder`` and the bulk text loader."""
    c = corpus_mod.make_corpus(str(tmp_path / "corpus"), 11, num_utts=20, speakers=2, feat_dim=F_IN, targets="pdf",
                               mean_s=0.4, sigma=0.3, min_s=0.2, max_s=0.6, num_pdfs=V, pdf_frames=(6, 12))
    text = tmp_path / "text"
    with open(text, "w") as f:
        for utt, ali in c.alignments.items():
            starts = np.flatnonzero(np.r_[True, ali[1:] != ali[:-1]])
            f.write(f"{utt} {' '.join(str(int(a)) for a in ali[starts])}\n")
    conf = configparser.ConfigParser()
    conf["directories"] = {"expdir": str(tmp_path / "exp")}
    conf["nnet"] = {"name": "conformer_rnnt", "model": "transducer", "loss": "rnnt", "enc_type": "conformer", **NNET,
                    "pred_units": "24", "embed_dim": "8", "joint_units": "20", "rnnt_prune_s": "0",
                    "compute_dtype": "float32", "dropout": "0.9", "batch_size": "4", "valid_batches": "1",
                    "valid_frequency": "2", "check_freq": "2", "num_epochs": "1", "context_width": "0"}
    nnet = Nnet(conf, input_dim=F_IN, num_labels=V, device="cpu")
    source = BulkTextBatchSource(c.feats_scp, c.cmvn_scp, c.utt2spk_path, 0, AlignmentCoder(identity_normalizer, V),
                                 str(text), 4, bucket_multiple=16)
    routes = dict(trainer_mod.rnnt_routes)
    state = nnet.train(source)
    assert state.step == 5  # 20 utterances / 4: the count the validation split leaves as it is
    assert trainer_mod.rnnt_routes["dense"] - routes["dense"] >= 4 and trainer_mod.rnnt_routes["banded"] == routes[
        "banded"]
    assert (tmp_path / "exp" / "conformer_rnnt" / "final.pt").is_file()

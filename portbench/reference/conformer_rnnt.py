"""The plain reference of the Conformer transducer: the forward pass, the
dense RNN-T loss and TF-Adam steps, in plain torch.

The model is Gulati et al., "Conformer: Convolution-augmented Transformer
for Speech Recognition" (Interspeech 2020, arXiv:2005.08100), eq. 1-4 and
Fig. 1-4, written from the paper with nothing of the program under test:

- front end: two ``3x3`` stride-2 VALID convolutions with ReLU over the
  ``[T, F]`` features (``T' = ((T-1)//2 - 1)//2``), flattened channel-major
  into a linear projection to ``d_model``;
- each block: ``x~ = x + FFN(x)/2``, ``x' = x~ + MHSA(x~)``, ``x'' = x' +
  Conv(x')``, ``y = LN(x'' + FFN(x'')/2)``; FFN = LN, linear, Swish,
  linear; MHSA = LN, then multi-head self-attention with the relative
  sinusoidal positions of Transformer-XL (Dai et al. 2019, §3.3): head
  ``h`` scores ``((q_i + u_h)·k_j + (q_i + v_h)·(W_R R_{i-j})) / sqrt(d_h)``,
  computed directly for every pair ``(i, j)`` from ``R`` of the distance
  ``i - j``; Conv = LN, pointwise conv to ``2·d_model``, GLU, a depthwise
  conv of ``k`` taps (TF ``SAME``: ``(k-1)//2`` frames before, ``k//2``
  after), batch norm with scale and offset over the batch's real frames,
  Swish, pointwise conv;
- a one-layer LSTM predictor over the labels after a start token (the
  blank), and the joint ``tanh(enc + pred)`` projected to the labels and
  the blank (the last id), log-softmax;
- the loss: the summed RNN-T negative log-likelihood of the batch by the
  textbook recursion ``alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1,
  u], alpha[t, u-1] + label[t, u-1])`` (taken along anti-diagonals), the
  exit ``alpha[T-1, U] + blank[T-1, U]``, divided by the batch's real input
  frames; the gradient divided by those frames, clipped to ±1, and
  TF-Adam (``lr_t = lr·sqrt(1-b2^t)/(1-b1^t)``, ε outside the root).

Layer norm, batch norm (``E[z²] - mean²``), Swish, the convolutions and
the sinusoid are the textbook formulas as ``torch`` writes them, so that in
bfloat16 the reference rounds the same numbers the program rounds and only
the parts that are computed differently (the pair-by-pair position term,
the recursion) part the two.

Departures from the paper (the configuration's, shared with the program):
dropout is a keep probability applied only to each sublayer's output
before its residual add and to the predictor's output (not inside the FFN,
after the front end or on the attention weights), its masks handed in by
the caller in the order the forward draws them; the relative sinusoid
interleaves sin and cos; ``u`` and ``v`` are per block; the front end has
``d_model`` channels; the encoder and the predictor each end in a linear
layer to the joint's width; layer norm's epsilon is 1e-6, batch norm's
1e-3; no SpecAugment, no variational noise.

Precision (``mode``): ``f32`` computes in float32 (the caller turns TF32
off); ``bf16`` rounds to bfloat16 (:func:`rnd`) where a bfloat16
configuration stores: every product's and convolution's operands (the
products accumulate in f32, their biases are added in f32), the stored
activations (each linear layer's output, layer norm's, Swish's, the GLU's,
the attention weights and context, the residual stream, the joint's
``tanh``), while layer norm, softmax, GLU, the depthwise conv, batch norm,
Swish, the predictor's recurrence and the log-softmax compute in f32;
``fp8`` is the precision under the configuration's: the forward rounds
each of those values to float8 e4m3 with a per-tensor scale (the tensor's
largest magnitude at e4m3's 448, as fp8 training scales), the products'
operands among them, and the backward rounds as ``bf16`` does.

On a card the whole batch runs at once, each block, the front end and
each chunk of ``joint_chunk`` frames of the joint under
``torch.utils.checkpoint``, so that batch norm keeps the batch's
statistics and the activations fit.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MODES = ("f32", "bf16", "fp8")
E4M3_MAX = 448.0
B1, B2, EPS = 0.9, 0.999, 1e-8
LN_EPS, BN_EPS = 1e-6, 1e-3
NEG = -1e9  # an impossible lattice node: finite, so that autograd stays finite


@dataclasses.dataclass(frozen=True)
class Config:
    feat_dim: int
    num_labels: int  # real labels; the blank is num_labels
    num_blocks: int
    d_model: int
    num_heads: int
    ffn_dim: int
    conv_kernel: int
    pred_units: int
    embed_dim: int
    joint_units: int
    keep: float = 1.0  # dropout's keep probability
    joint_chunk: int = 16  # frames of the joint a checkpointed chunk


def output_lengths(n):
    """Positions after the front end: ``((n-1)//2 - 1)//2``."""
    return ((n - 1) // 2 - 1) // 2


def param_shapes(cfg: Config) -> dict[str, tuple]:
    """Every parameter's name and shape, dense weights ``[fan_in,
    fan_out]``."""
    d, f, c, j = cfg.d_model, cfg.ffn_dim, cfg.d_model, cfg.joint_units
    dh = d // cfg.num_heads
    v = cfg.num_labels + 1
    s = {"enc.frontend.w1": (c, 1, 3, 3), "enc.frontend.b1": (c,), "enc.frontend.w2": (c, c, 3, 3),
         "enc.frontend.b2": (c,), "enc.in_proj.w": (c * output_lengths(cfg.feat_dim), d), "enc.in_proj.b": (d,)}
    for l in range(cfg.num_blocks):
        pre = f"enc.blocks.{l}."
        for ln in ("ln_ffn1", "ln_attn", "ln_conv", "ln_ffn", "ln_out"):
            s[pre + ln + ".g"], s[pre + ln + ".b"] = (d,), (d,)
        for ffn in ("ffn1", "ffn"):
            s.update({pre + ffn + ".w1": (d, f), pre + ffn + ".b1": (f,), pre + ffn + ".w2": (f, d),
                      pre + ffn + ".b2": (d,)})
        for w in "qkvo":
            s[pre + f"attn.w{w}"], s[pre + f"attn.b{w}"] = (d, d), (d,)
        s.update({pre + "attn.w_pos": (d, d), pre + "attn.pos_u": (cfg.num_heads, dh),
                  pre + "attn.pos_v": (cfg.num_heads, dh),
                  pre + "conv.w_in": (d, 2 * d), pre + "conv.b_in": (2 * d,),
                  pre + "conv.w_dw": (d, 1, cfg.conv_kernel), pre + "conv.bn_gamma": (d,),
                  pre + "conv.bn_beta": (d,), pre + "conv.w_out": (d, d), pre + "conv.b_out": (d,)})
    s.update({"enc.ln_final.g": (d,), "enc.ln_final.b": (d,), "enc.out.w": (d, j), "enc.out.b": (j,),
              "embed": (v, cfg.embed_dim), "pred.layers.0.0.wx": (cfg.embed_dim, 4 * cfg.pred_units),
              "pred.layers.0.0.wh": (cfg.pred_units, 4 * cfg.pred_units), "pred.layers.0.0.b": (4 * cfg.pred_units,),
              "pred.out.w": (cfg.pred_units, j), "pred.out.b": (j,), "joint.w": (j, v), "joint.b": (v,)})
    return s


# ----------------------------------------------------------------------
# pieces
# ----------------------------------------------------------------------

def rnd(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``x`` rounded to bfloat16 (held in f32) unless ``mode`` is f32; in
    ``fp8`` its value further to scaled float8 e4m3, the gradient passing
    as in ``bf16``."""
    if mode == "f32":
        return x
    y = x.to(torch.bfloat16).float()
    if mode == "fp8":
        v = y.detach()
        scale = v.abs().amax().clamp(min=1e-30) / E4M3_MAX
        y = y + ((v / scale).to(torch.float8_e4m3fn).float() * scale - v)
    return y


def linear(x, w, b, mode):
    """A linear layer: rounded operands, the f32 product plus the f32 bias,
    the output rounded."""
    return rnd(rnd(x, mode) @ rnd(w, mode) + b, mode)


def layer_norm(x, g, b, mode):
    mean = x.mean(-1, keepdim=True)
    var = torch.square(x - mean).mean(-1, keepdim=True)
    return rnd((x - mean) * torch.rsqrt(var + LN_EPS) * g + b, mode)


def swish(x, mode):
    return rnd(F.silu(x), mode)


def dropout(x, mask, keep: float, mode):
    return x if mask is None else torch.where(mask, rnd(x / keep, mode), 0.0)


def sinusoid(pos: torch.Tensor, d: int) -> torch.Tensor:
    """``[..., d]`` f32: ``sin(pos·w_i)`` in the even columns and
    ``cos(pos·w_i)`` in the odd ones, ``w_i = 10000^(-2i/d)``."""
    w = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=pos.device) * float(-math.log(10000.0) / d))
    ang = pos.float()[..., None] * w
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).flatten(-2)


def conv2d(x, w, b, mode):
    """A stride-2 VALID convolution, rounded operands, f32 bias, ReLU, the
    output rounded: ``[B, C, H, W] → [B, C', (H-1)//2, (W-1)//2]``."""
    out = F.conv2d(rnd(x, mode), rnd(w, mode), stride=2) + b[:, None, None]
    return rnd(torch.relu(out), mode)


def frontend(p, x, mode):
    """``[B, T, F]`` → ``[B, T', d_model]``."""
    h = conv2d(x[:, None], p["enc.frontend.w1"], p["enc.frontend.b1"], mode)
    h = conv2d(h, p["enc.frontend.w2"], p["enc.frontend.b2"], mode)
    bsz, c, t, f = h.shape
    return linear(h.transpose(1, 2).reshape(bsz, t, c * f), p["enc.in_proj.w"], p["enc.in_proj.b"], mode)


def ffn(p, pre, z, mode):
    return linear(swish(linear(z, p[pre + "w1"], p[pre + "b1"], mode), mode), p[pre + "w2"], p[pre + "b2"], mode)


def mhsa(p, pre, z, real, heads: int, mode):
    """Relative-position self-attention of ``z [B, T, D]``; ``real [B, T]``
    marks the keys that may be attended."""
    bsz, t, d = z.shape
    dh = d // heads
    q = linear(z, p[pre + "wq"], p[pre + "bq"], mode).reshape(bsz, t, heads, dh)
    k = linear(z, p[pre + "wk"], p[pre + "bk"], mode).reshape(bsz, t, heads, dh)
    v = linear(z, p[pre + "wv"], p[pre + "bv"], mode).reshape(bsz, t, heads, dh)
    idx = torch.arange(t, device=z.device)
    r = sinusoid(idx[:, None] - idx[None, :], d)  # [T, T, D]: R_{i-j}
    wr = (rnd(r, mode) @ rnd(p[pre + "w_pos"], mode)).reshape(t, t, heads, dh)  # W_R R_{i-j}
    content = torch.einsum("bihd,bjhd->bhij", rnd(q + p[pre + "pos_u"], mode), rnd(k, mode))
    position = torch.einsum("bihd,ijhd->bhij", rnd(q + p[pre + "pos_v"], mode), rnd(wr, mode))
    scores = (content + position) * (1.0 / math.sqrt(dh))
    scores = scores.masked_fill(~real[:, None, None, :], -math.inf)
    probs = rnd(torch.softmax(scores, dim=-1), mode)
    ctx = rnd(torch.einsum("bhij,bjhd->bihd", probs, rnd(v, mode)), mode)
    return linear(ctx.reshape(bsz, t, d), p[pre + "wo"], p[pre + "bo"], mode)


def conv_module(p, pre, z, real, kernel: int, mode):
    d = z.shape[-1]
    a = linear(z, p[pre + "w_in"], p[pre + "b_in"], mode)
    m = real[..., None].float()
    glu = rnd(a[..., :d] * torch.sigmoid(a[..., d:]), mode) * m
    lo = (kernel - 1) // 2
    dw = F.conv1d(F.pad(glu.transpose(1, 2), (lo, kernel - 1 - lo)), p[pre + "w_dw"], groups=d).transpose(1, 2)
    rows, m = dw.reshape(-1, d), m.reshape(-1, 1)  # over the batch's real frames
    n = m.sum()
    mean = (rows * m).sum(0) / n
    var = (torch.square(rows) * m).sum(0) / n - torch.square(mean)
    y = ((dw - mean) * torch.rsqrt(var + BN_EPS) * p[pre + "bn_gamma"] + p[pre + "bn_beta"])
    return linear(swish(y, mode), p[pre + "w_out"], p[pre + "b_out"], mode)


def block(p, l: int, cfg: Config, h, real, mode, m_ffn1=None, m_attn=None, m_conv=None, m_ffn=None):
    pre = f"enc.blocks.{l}."
    keep = cfg.keep

    def ln(name, x):
        return layer_norm(x, p[pre + name + ".g"], p[pre + name + ".b"], mode)

    h = rnd(h + 0.5 * dropout(ffn(p, pre + "ffn1.", ln("ln_ffn1", h), mode), m_ffn1, keep, mode), mode)
    h = rnd(h + dropout(mhsa(p, pre + "attn.", ln("ln_attn", h), real, cfg.num_heads, mode), m_attn, keep, mode),
            mode)
    h = rnd(h + dropout(conv_module(p, pre + "conv.", ln("ln_conv", h), real, cfg.conv_kernel, mode), m_conv,
                        keep, mode), mode)
    f = dropout(ffn(p, pre + "ffn.", ln("ln_ffn", h), mode), m_ffn, keep, mode)
    return ln("ln_out", rnd(h + 0.5 * f, mode)) * real[..., None]


def encode(p, cfg: Config, x, lengths, mode, draw=None):
    """``[B, T, F]`` → ``([B, T', J]`` f32, ``T'`` a row); ``draw(shape)``
    gives each dropout mask in the forward's order."""
    h = checkpoint(frontend, p, x, mode, use_reentrant=False)
    t_out = output_lengths(lengths)
    real = torch.arange(h.shape[1], device=x.device)[None, :] < t_out[:, None]
    h = h * real[..., None]
    for l in range(cfg.num_blocks):
        masks = [draw(tuple(h.shape)) for _ in range(4)] if draw is not None else [None] * 4
        h = checkpoint(block, p, l, cfg, h, real, mode, *masks, use_reentrant=False)
    h = layer_norm(h, p["enc.ln_final.g"], p["enc.ln_final.b"], mode)
    return rnd(h, mode) @ rnd(p["enc.out.w"], mode) + p["enc.out.b"], t_out


def predict(p, cfg: Config, labels, label_lengths, mode, draw=None):
    """``[B, U]`` labels → ``[B, U+1, J]`` f32 (position ``u`` after the
    start token and the first ``u`` labels)."""
    bsz, u = labels.shape
    ids = torch.cat([torch.full((bsz, 1), cfg.num_labels, dtype=torch.long, device=labels.device), labels], 1)
    x = p["embed"][ids]
    gx = rnd(x, mode) @ rnd(p["pred.layers.0.0.wx"], mode) + p["pred.layers.0.0.b"]
    wh = rnd(p["pred.layers.0.0.wh"], mode)
    h = torch.zeros(bsz, cfg.pred_units, device=x.device)
    c = torch.zeros_like(h)
    live_rows = label_lengths + 1
    ys = []
    for s in range(u + 1):
        i, f, g, o = (gx[:, s] + rnd(h, mode) @ wh).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        live = (s < live_rows)[:, None]
        h, c = torch.where(live, h_new, h), torch.where(live, c_new, c)
        ys.append(h * live)
    y = torch.stack(ys)  # [U+1, B, H]
    if draw is not None:
        y = torch.where(draw(tuple(y.shape)), y / cfg.keep, 0.0)
    return (rnd(y, mode) @ rnd(p["pred.out.w"], mode) + p["pred.out.b"]).transpose(0, 1)


def joint_scores(enc_c, pred, labels, w, b, mode):
    """One chunk of frames: the blank's and each next label's
    log-probability, ``[B, c, U+1]`` and ``[B, c, U]``."""
    h = rnd(torch.tanh(enc_c[:, :, None, :] + pred[:, None, :, :]), mode)
    lp = torch.log_softmax(rnd(h, mode) @ rnd(w, mode) + b, dim=-1)
    u = labels.shape[1]
    lab = torch.gather(lp[:, :, :u], 3, labels[:, None, :, None].expand(-1, lp.shape[1], -1, 1))[..., 0]
    return lp[..., -1], lab


def rnnt_nll(lp_blank, lp_label, t_len, u_len):
    """Per-utterance NLL ``[B]`` of the lattice ``lp_blank [B, T, U+1]``,
    ``lp_label [B, T, U]`` by the textbook recursion, one anti-diagonal
    ``n = t + u`` at a time."""
    bsz, t, u1 = lp_blank.shape
    dev = lp_blank.device
    n_diag = t + u1 - 1
    tt = torch.arange(t, device=dev)[:, None]
    uu = torch.arange(n_diag, device=dev)[None, :] - tt  # [T, N]: u of diagonal n at frame t
    blank_sk = torch.gather(lp_blank, 2, uu.clamp(0, u1 - 1)[None].expand(bsz, -1, -1))
    blank_sk = torch.where(((uu >= 0) & (uu < u1))[None], blank_sk, NEG)
    label_sk = torch.gather(F.pad(lp_label, (0, 1), value=NEG), 2, uu.clamp(0, u1 - 1)[None].expand(bsz, -1, -1))
    label_sk = torch.where(((uu >= 0) & (uu < u1 - 1))[None], label_sk, NEG)
    on_diag = (uu >= 0) & (uu < u1)  # [T, N]
    a = torch.where(torch.arange(t, device=dev)[None, :] == 0, 0.0, NEG).expand(bsz, t)
    alphas = [a]
    for n in range(1, n_diag):
        by_blank = F.pad((a + blank_sk[:, :, n - 1])[:, :-1], (1, 0), value=NEG)  # from (t-1, u)
        by_label = a + label_sk[:, :, n - 1]  # from (t, u-1)
        a = torch.where(on_diag[:, n][None, :], torch.logaddexp(by_blank, by_label), NEG)
        alphas.append(a)
    alphas = torch.stack(alphas)  # [N, B, T]
    bi = torch.arange(bsz, device=dev)
    last_t = t_len - 1
    return -(alphas[last_t + u_len, bi, last_t] + lp_blank[bi, last_t, u_len])


# ----------------------------------------------------------------------
# the loss and the steps
# ----------------------------------------------------------------------

def loss_sum(p, cfg: Config, batch: dict, mode: str, draw=None) -> torch.Tensor:
    """The batch's summed NLL. ``batch``: ``x [B, T, F]`` zero-padded
    features, ``lengths [B]``, ``labels [B, U]`` zero-padded,
    ``label_lengths [B]``."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: want one of {MODES}")
    enc, t_out = encode(p, cfg, batch["x"], batch["lengths"], mode, draw)
    pred = predict(p, cfg, batch["labels"], batch["label_lengths"], mode, draw)
    parts = [checkpoint(joint_scores, enc[:, i:i + cfg.joint_chunk], pred, batch["labels"], p["joint.w"],
                        p["joint.b"], mode, use_reentrant=False)
             for i in range(0, enc.shape[1], cfg.joint_chunk)]
    lp_blank = torch.cat([b for b, _ in parts], dim=1)
    lp_label = torch.cat([lab for _, lab in parts], dim=1)
    return rnnt_nll(lp_blank, lp_label, t_out, batch["label_lengths"]).sum()


def steps(weights: dict, batches: list, cfg: Config, *, lr: float, mode: str = "f32", masks=None) -> dict:
    """Run ``len(batches)`` optimizer steps from ``weights`` (not changed).
    ``masks(step)``, where given, returns the step's ``draw(shape)`` of
    dropout keep masks. Returns each step's loss (summed NLL ÷ real input
    frames, before its update), each leaf's norm of the first step's
    clipped gradient, and each leaf's norm of the change over all the
    steps."""
    p = {n: w.detach().clone().requires_grad_(True) for n, w in weights.items()}
    m = {n: torch.zeros_like(w) for n, w in p.items()}
    v = {n: torch.zeros_like(w) for n, w in p.items()}
    losses, first_grad = [], {}
    for s, batch in enumerate(batches):
        total = loss_sum(p, cfg, batch, mode, masks(s) if masks is not None else None)
        frames = float(batch["lengths"].sum())
        grads = torch.autograd.grad(total, list(p.values()), allow_unused=True)
        losses.append(float(total.detach()) / frames)
        t = s + 1
        lr_t = lr * math.sqrt(1 - B2 ** t) / (1 - B1 ** t)
        with torch.no_grad():
            for (name, w), gr in zip(p.items(), grads):
                g = torch.zeros_like(w) if gr is None else torch.clamp(gr.float() / frames, -1.0, 1.0)
                if s == 0:
                    first_grad[name] = float(torch.linalg.vector_norm(g))
                m[name].mul_(B1).add_((1 - B1) * g)
                v[name].mul_(B2).add_((1 - B2) * torch.square(g))
                w.sub_(lr_t * m[name] / (torch.sqrt(v[name]) + EPS))
        del grads, total
    change = {n: float(torch.linalg.vector_norm(p[n].detach() - weights[n])) for n in p}
    return {"losses": losses, "first_grad": first_grad, "change": change}

"""Transformer / Conformer acoustic encoder, offline forward.

Port of :mod:`tfkaldi_tpu.models.transformer` (``TransformerConfig``,
``sinusoidal_positions``, ``Transformer``: init, ``reinit_output_layer``,
``apply``, ``output_lengths``, ``subsample_factor``). Parameters keep the
JAX pytree's names (``in_proj.{w,b}``, ``blocks.{l}.{ln_attn,attn,ln_ffn,
ffn[,ln_ffn1,ffn1,ln_conv,conv,ln_out]}``, ``ln_final``, ``out``), every
dense weight ``[fan_in, fan_out]``; the conv module's depthwise weight is
torch's ``[D, 1, k]`` (JAX's ``HIO [k, 1, D]`` transposed by
:func:`tfkaldi_tpu_torch.convert.transformer_from_jax`), and the per-block
batchnorm moving statistics are the buffers ``bn_conv_mean`` /
``bn_conv_var`` ``[blocks, D]``.

The rounding points are the JAX package's:

- every dense layer is :func:`~tfkaldi_tpu_torch.layers.affine`: operands
  rounded to ``compute_dtype``, an f32 product and bias, stored in
  ``compute_dtype``; so the residual stream is in ``compute_dtype``;
- layernorm in f32, returned in its input's dtype;
- attention scores and softmax in f32 with ``-1e30`` masking, the
  probabilities rounded to ``compute_dtype`` before the context product;
- the conv module's GLU in f32, its depthwise conv in f32 (``F.conv1d``
  with ``groups = D``, zero-padded SAME or causal), masked center-only
  batchnorm in f32 (:func:`~tfkaldi_tpu_torch.layers.masked_moments`),
  swish in f32;
- the output layer's product and bias in f32, and the result kept in f32.

The ``subsample`` front-end zeroes frames past each length, pads T to a
multiple of ``s`` and stacks ``s`` frames into one position; positions are
added after the input projection from the f32 sinusoid of
:func:`sinusoidal_at`. Padded keys are masked out of every attention row,
the conv input is zero-masked and the hidden state is re-masked between
blocks, so logits at real frames do not depend on the padding. Dropout is a
keep probability, its masks drawn from the trainer's generator (the bits
are the port's own; under a data split the rank's rows of the whole
batch's draw, :func:`tfkaldi_tpu_torch.parallel.comm.keep_mask`).

Split over a grid's model group (``tp``, set by
:func:`tfkaldi_tpu_torch.parallel.mesh.shard_state`): Megatron's split of
every block, ``wq``/``wk``/``wv`` and the FFNs' ``w1`` by columns (whole
heads: ``num_heads / model`` of them a rank), ``wo`` and ``w2`` by rows,
their partial products summed over the group before the replicated bias,
and the cotangent of each split sublayer's replicated input summed over the
group (:func:`~tfkaldi_tpu_torch.parallel.comm.copy_to_model`). The input
projection, the layernorms, the conv module and the output layer are
replicated.

Streaming (models/transformer.py:478-784), eval only, for a model with
``left_context >= 0``, ``right_context = 0`` and, for the conformer, a
causal conv (:meth:`Transformer.validate_streamable`). The carry holds
each row's global position ``pos``, per block a cache of the last
``left_context`` attention-sublayer inputs (``h_cache [blocks, B, L, D]``)
and, for the conformer, the last ``k-1`` pre-depthwise activations
(``conv_cache [blocks, B, k-1, D]``); under ``subsample = s`` a
right-aligned buffer of the ``s-1`` raw frames still waiting for a full
group (``in_buf``, ``in_fill``). A chunk attends over ``[cache ++ chunk]``
and the caches roll by one gather (slot ``m`` of the new cache is concat
index ``v + m``). The roundings are the offline forward's, including the
GLU rounded to ``compute_dtype`` before the f32 depthwise conv (the JAX
stream keeps that GLU in f32; in f32 the two agree), so a chunked stream
equals this module's own ``forward`` at any chunking up to the order of
the attention sums. :meth:`Transformer.apply_stream_flush` emits the
zero-padded last group of a stream whose length is not a multiple of
``s``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tfkaldi_tpu_torch.layers import affine, batchnorm, masked_moments, product
from tfkaldi_tpu_torch.parallel import comm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NEG = -1e30  # the additive mask of the JAX package's attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    input_dim: int
    num_labels: int
    num_blocks: int = 6
    d_model: int = 256
    num_heads: int = 4
    ffn_dim: int = 1024
    conformer: bool = False  # macaron FFN pair + depthwise conv module
    conv_kernel: int = 15  # conformer depthwise kernel (odd unless causal)
    left_context: int = -1  # time-restricted attention; -1 = unlimited
    right_context: int = -1
    causal_conv: bool = False  # the depthwise conv sees [t-k+1, t], not [t±k/2]
    subsample: int = 1  # frames stacked into one position (CTC only)
    dropout: float = 1.0  # keep probability, reference semantics
    compute_dtype: torch.dtype = torch.float32
    ln_eps: float = 1e-6
    bn_eps: float = 1e-3
    bn_decay: float = 0.999

    def __post_init__(self):
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by num_heads {self.num_heads}")
        if self.conformer and not self.causal_conv and self.conv_kernel % 2 == 0:
            raise ValueError("conv_kernel must be odd (SAME-centered depthwise)")
        if self.left_context < -1 or self.right_context < -1:
            raise ValueError("attention contexts must be >= 0 or -1 (unlimited)")
        if self.subsample < 1:
            raise ValueError("subsample must be >= 1")

    @classmethod
    def from_config(cls, conf: dict, input_dim: int, num_labels: int) -> "TransformerConfig":
        """Build from a reference-style ``[nnet]`` section dict (the keys of
        models/transformer.py:105-124)."""
        dtype = conf.get("compute_dtype", "float32")
        if dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {dtype!r}: want one of {sorted(_DTYPES)}")
        return cls(
            input_dim=input_dim,
            num_labels=num_labels,
            num_blocks=int(conf.get("num_blocks", 6)),
            d_model=int(conf.get("d_model", 256)),
            num_heads=int(conf.get("num_heads", 4)),
            ffn_dim=int(conf.get("ffn_dim", 1024)),
            conformer=str(conf.get("conformer", "False")) == "True",
            conv_kernel=int(conf.get("conv_kernel", 15)),
            left_context=int(conf.get("attention_left_context", -1)),
            right_context=int(conf.get("attention_right_context", -1)),
            causal_conv=str(conf.get("causal_conv", "False")) == "True",
            subsample=int(conf.get("subsample", 1)),
            dropout=float(conf.get("dropout", 1)),
            compute_dtype=_DTYPES[dtype],
        )


@functools.lru_cache(maxsize=64)
def _positions_np(t: int, d: int) -> np.ndarray:
    pos = np.arange(t)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d, 2).astype(np.float64) * (-np.log(10000.0) / d))
    pe = np.zeros((t, d), np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: pe[:, 1::2].shape[1]])
    return pe.astype(np.float32)


def sinusoidal_positions(t: int, d: int) -> np.ndarray:
    """The fixed sin/cos table ``[t, d]`` (f32), computed in f64 by numpy:
    the decoder's positions (models/transformer.py:127-134)."""
    return _positions_np(int(t), int(d)).copy()


def sinusoidal_at(t: int, d: int, device) -> torch.Tensor:
    """The same table computed in f32 on ``device`` (``_sinusoidal_at`` at
    frames ``0..t-1``, models/transformer.py:137-159): the encoder's
    positions. It differs from :func:`sinusoidal_positions` in the last
    ulp, as the JAX package's two tables do."""
    return sinusoid_rows(torch.arange(t, device=device), d)


def sinusoid_rows(positions: torch.Tensor, d: int) -> torch.Tensor:
    """:func:`sinusoidal_at` at any integer frame indices: ``[...]`` →
    ``[..., d]`` f32 (the stream's rows sit at their own global
    positions)."""
    device = positions.device
    pos = positions.to(torch.float32)[..., None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * float(-np.log(10000.0) / d))
    out = torch.zeros(*positions.shape, d, dtype=torch.float32, device=device)
    out[..., 0::2] = torch.sin(pos * div)
    out[..., 1::2] = torch.cos(pos * div[: d // 2])
    return out


def layernorm(x: torch.Tensor, p, eps: float) -> torch.Tensor:
    """Per-frame layernorm in f32 (``p.g``, ``p.b``), returned in
    ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mean).mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * p.g + p.b).to(x.dtype)


def swish(z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``z·sigmoid(z)`` in f32, stored in ``dtype``."""
    return F.silu(z.float()).to(dtype)


def dropout(x: torch.Tensor, keep: float, generator, train: bool) -> torch.Tensor:
    """Inverted dropout with keep probability ``keep`` (training only)."""
    if not train or keep >= 1:
        return x
    if generator is None:
        raise ValueError("dropout requires a generator in training mode")
    mask = comm.keep_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, 0.0)


def attention(hq, hkv, p, mask, num_heads: int, dtype, tp=None) -> torch.Tensor:
    """Multi-head attention of ``hq [B, Tq, D]`` over ``hkv [B, Tk, D]``
    with the projections of ``p`` (``wq, bq, …, wo, bo``); ``mask`` (bool,
    broadcast to ``[B, h, Tq, Tk]``) marks the attendable keys. With ``tp``
    the projections hold this rank's ``num_heads / model`` heads."""
    b, tq, d = hq.shape
    tk = hkv.shape[1]
    dh = d // num_heads
    if tp is not None:
        num_heads //= tp.model
        same = hkv is hq
        hq = comm.copy_to_model(hq, tp)
        hkv = hq if same else comm.copy_to_model(hkv, tp)
    q = affine(hq, p.wq, p.bq, dtype).reshape(b, tq, num_heads, dh).transpose(1, 2)
    k = affine(hkv, p.wk, p.bk, dtype).reshape(b, tk, num_heads, dh).transpose(1, 2)
    v = affine(hkv, p.wv, p.bv, dtype).reshape(b, tk, num_heads, dh).transpose(1, 2)
    scores = product(q, k.transpose(-1, -2), dtype) * (1.0 / np.sqrt(dh))
    scores = torch.where(mask, scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    ctx = product(probs, v, dtype).to(dtype)
    return affine(ctx.transpose(1, 2).reshape(b, tq, num_heads * dh), p.wo, p.bo, dtype, tp)


def feed_forward(h, p, dtype, tp=None) -> torch.Tensor:
    """``w2·swish(w1·h + b1) + b2`` (the FFN of both stacks); with ``tp``
    ``w1`` holds a block of the columns and ``w2`` of the rows."""
    if tp is not None:
        h = comm.copy_to_model(h, tp)
    return affine(swish(affine(h, p.w1, p.b1, dtype), dtype), p.w2, p.b2, dtype, tp)


class Params(nn.Module):
    """One dict of the JAX pytree: named parameters of the given shapes."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.zeros(shape)))


def ln_params(d: int) -> Params:
    return Params(g=(d,), b=(d,))


def attn_params(d: int) -> Params:
    return Params(wq=(d, d), bq=(d,), wk=(d, d), bk=(d,), wv=(d, d), bv=(d,), wo=(d, d), bo=(d,))


def ffn_params(d: int, f: int) -> Params:
    return Params(w1=(d, f), b1=(f,), w2=(f, d), b2=(d,))


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's block init for every ``Params`` under ``module``:
    dense weights ``N(0, 1)/sqrt(fan_in)``, biases 0, layernorm gains 1;
    drawn on the CPU from ``generator``."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "g":
            p.fill_(1.0)
        elif p.dim() == 2:
            p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(p.shape[0]))
        else:
            p.zero_()


class _Block(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d, f = cfg.d_model, cfg.ffn_dim
        self.ln_attn = ln_params(d)
        self.attn = attn_params(d)
        self.ln_ffn = ln_params(d)
        self.ffn = ffn_params(d, f)
        if cfg.conformer:
            self.ln_ffn1 = ln_params(d)
            self.ffn1 = ffn_params(d, f)
            self.ln_conv = ln_params(d)
            self.conv = Params(w_in=(d, 2 * d), b_in=(2 * d,), w_dw=(d, 1, cfg.conv_kernel), bn_beta=(d,),
                               w_out=(d, d), b_out=(d,))
            self.ln_out = ln_params(d)


class Transformer(nn.Module):
    """``forward(inputs [B, T, F], lengths [B], *, train=False,
    generator=None)`` → logits ``[B, T', num_labels]`` float32, ``T' =
    ceil(T / subsample)``."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        cfg = config
        self.in_proj = Params(w=(cfg.input_dim * cfg.subsample, cfg.d_model), b=(cfg.d_model,))
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.num_blocks))
        self.ln_final = ln_params(cfg.d_model)
        self.out = Params(w=(cfg.d_model, cfg.num_labels), b=(cfg.num_labels,))
        self.tp = None  # the grid whose model group splits the blocks (parallel.mesh.shard_state)
        if cfg.conformer:
            self.register_buffer("bn_conv_mean", torch.zeros(cfg.num_blocks, cfg.d_model))
            self.register_buffer("bn_conv_var", torch.ones(cfg.num_blocks, cfg.d_model))

    # ------------------------------------------------------------------
    # parameters (models/transformer.py:196-292)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX ``init``: ``N(0, 1)/sqrt(fan_in)`` dense weights (the
        depthwise weight ``N(0, 1)/sqrt(k)``), zero biases and ``bn_beta``,
        unit layernorm gains, a zero output layer, moving stats (0, 1)."""
        init_params(self.in_proj, generator)
        for blk in self.blocks:
            init_params(blk, generator)
            if self.config.conformer:
                k = self.config.conv_kernel
                blk.conv.w_dw.copy_(torch.randn(blk.conv.w_dw.shape, generator=generator) / math.sqrt(k))
        init_params(self.ln_final, generator)
        self.reinit_output_layer()
        if self.config.conformer:
            self.bn_conv_mean.zero_()
            self.bn_conv_var.fill_(1.0)

    @torch.no_grad()
    def reinit_output_layer(self) -> None:
        """Re-zero the output layer (its init is all zeros)."""
        self.out.w.zero_()
        self.out.b.zero_()

    # ------------------------------------------------------------------
    # forward (models/transformer.py:296-472)
    # ------------------------------------------------------------------

    def output_lengths(self, lengths):
        """Valid output frames for ``lengths`` input frames: ``ceil(n/s)``
        under the stacking front-end, else ``n`` (tensors or numpy)."""
        s = self.config.subsample
        return lengths if s == 1 else (lengths + (s - 1)) // s

    @property
    def subsample_factor(self) -> int:
        return self.config.subsample

    def _rel_mask(self, t: int, device) -> torch.Tensor:
        """The time-restriction band ``[T, T]`` (True = attendable), from
        ``rel[i, j] = i - j``."""
        idx = torch.arange(t, device=device)
        return self._band(idx[:, None] - idx[None, :])

    def _band(self, rel: torch.Tensor) -> torch.Tensor:
        """``rel = q_global - k_global`` → attendable (bool) under the
        configured time restriction."""
        cfg = self.config
        ok = torch.ones_like(rel, dtype=torch.bool)
        if cfg.right_context != -1:
            ok = rel >= -cfg.right_context
        if cfg.left_context != -1:
            ok = ok & (rel <= cfg.left_context)
        return ok

    def _conv_module(self, h, blk, l: int, mask_btf, train: bool, dtype):
        cfg = self.config
        b, t, d = h.shape
        p = blk.conv
        zf = affine(h, p.w_in, p.b_in, dtype).float()
        z = (zf[..., :d] * torch.sigmoid(zf[..., d:])).to(dtype)  # GLU
        z = z * mask_btf.to(z.dtype)  # the depthwise kernel never reads padding
        k = cfg.conv_kernel
        lo = k - 1 if cfg.causal_conv else (k - 1) // 2
        zc = F.pad(z.float().transpose(1, 2), (lo, k - 1 - lo))
        zc = F.conv1d(zc, p.w_dw, groups=d)  # [B, D, T] in f32
        zf = zc.transpose(1, 2).reshape(b * t, d)
        mask = mask_btf.reshape(b * t).float()
        if train:
            mean, var, _ = masked_moments(zf, mask)
            with torch.no_grad():
                decay = cfg.bn_decay
                self.bn_conv_mean[l].copy_(self.bn_conv_mean[l] * decay + mean * (1.0 - decay))
                self.bn_conv_var[l].copy_(self.bn_conv_var[l] * decay + var * (1.0 - decay))
        else:
            mean, var = self.bn_conv_mean[l], self.bn_conv_var[l]
        z = batchnorm(zf, mean, var, p.bn_beta, cfg.bn_eps, torch.float32)
        z = swish(z, dtype).reshape(b, t, d)
        return affine(z, p.w_out, p.b_out, dtype)

    def forward(
        self,
        inputs: torch.Tensor,
        lengths: torch.Tensor | None = None,
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        cfg = self.config
        dtype = cfg.compute_dtype
        if lengths is None:
            raise ValueError("a transformer needs lengths (they mask the keys and the conv)")
        device = inputs.device
        lengths = torch.as_tensor(lengths).to(device)
        b, t, _ = inputs.shape
        inputs = inputs.float()
        if cfg.subsample > 1:
            # zero frames past each length first: the boundary group may
            # straddle the utterance end
            frame_ok = torch.arange(t, device=device)[None, :] < lengths[:, None]
            inputs = inputs * frame_ok[:, :, None].to(inputs.dtype)
            pad = -t % cfg.subsample
            if pad:
                inputs = F.pad(inputs, (0, 0, 0, pad))
            t = (t + pad) // cfg.subsample
            inputs = inputs.reshape(b, t, -1)
            lengths = self.output_lengths(lengths)
        key_mask = torch.arange(t, device=device)[None, :] < lengths[:, None]  # [B, T]
        mask_btf = key_mask[:, :, None]
        eps, keep = cfg.ln_eps, cfg.dropout

        h = affine(inputs, self.in_proj.w, self.in_proj.b, dtype)
        h = h + sinusoidal_at(t, cfg.d_model, device).to(dtype)
        h = h * mask_btf.to(h.dtype)
        attn_mask = key_mask[:, None, None, :] & self._rel_mask(t, device)[None, None]
        tp = self.tp

        for l, blk in enumerate(self.blocks):
            if cfg.conformer:
                z = layernorm(h, blk.ln_ffn1, eps)
                h = h + 0.5 * dropout(feed_forward(z, blk.ffn1, dtype, tp), keep, generator, train)
            z = layernorm(h, blk.ln_attn, eps)
            h = h + dropout(attention(z, z, blk.attn, attn_mask, cfg.num_heads, dtype, tp), keep, generator, train)
            if cfg.conformer:
                z = layernorm(h, blk.ln_conv, eps)
                h = h + dropout(self._conv_module(z, blk, l, mask_btf, train, dtype), keep, generator, train)
            z = layernorm(h, blk.ln_ffn, eps)
            f = dropout(feed_forward(z, blk.ffn, dtype, tp), keep, generator, train)
            if cfg.conformer:
                h = layernorm(h + 0.5 * f, blk.ln_out, eps)
            else:
                h = h + f
            h = h * mask_btf.to(h.dtype)  # padded frames stay inert for the next block

        h = layernorm(h, self.ln_final, eps)
        logits = product(h.reshape(b * t, cfg.d_model), self.out.w, dtype) + self.out.b.float()
        return logits.reshape(b, t, cfg.num_labels)

    # ------------------------------------------------------------------
    # streaming (models/transformer.py:478-784), eval only
    # ------------------------------------------------------------------

    def validate_streamable(self) -> None:
        cfg = self.config
        if cfg.left_context < 0 or cfg.right_context != 0:
            raise ValueError("streaming a transformer requires time-restricted, strictly-causal attention: "
                             "attention_left_context >= 0 and attention_right_context = 0 (a full/right-context "
                             "model is the attention analog of a bidirectional RNN)")
        if cfg.conformer and not cfg.causal_conv:
            raise ValueError("streaming a conformer requires causal_conv = True (the centered depthwise conv has "
                             "(k-1)/2 frames of lookahead)")

    def init_stream_carry(self, batch_size: int, device=None) -> dict:
        """Zero stream state for ``batch_size`` rows: ``pos`` and the caches
        (zeros in unfilled slots are the offline edge padding), plus
        ``in_buf`` / ``in_fill`` under the stacking front-end."""
        self.validate_streamable()
        cfg = self.config
        device = self.in_proj.w.device if device is None else device
        nb, d, b = cfg.num_blocks, cfg.d_model, batch_size
        carry = {"pos": torch.zeros(b, dtype=torch.long, device=device),
                 "h_cache": torch.zeros(nb, b, cfg.left_context, d, device=device)}
        if cfg.conformer:
            carry["conv_cache"] = torch.zeros(nb, b, cfg.conv_kernel - 1, d, device=device)
        if cfg.subsample > 1:
            carry["in_buf"] = torch.zeros(b, cfg.subsample - 1, cfg.input_dim, device=device)
            carry["in_fill"] = torch.zeros(b, dtype=torch.long, device=device)
        return carry

    @staticmethod
    def merge_stream_carry(take_mask, new: dict, old: dict) -> dict:
        """Row-wise select: rows where ``take_mask`` (bool ``[B]``) is True
        take ``new``, the others keep ``old``. The caches have the batch on
        dim 1, everything else on dim 0."""
        mask = torch.as_tensor(take_mask, dtype=torch.bool, device=old["pos"].device)
        out = {}
        for key, b in old.items():
            shape = [1] * b.ndim
            shape[1 if key in ("h_cache", "conv_cache") else 0] = -1
            out[key] = torch.where(mask.reshape(shape), new[key], b)
        return out

    def stream_output_lengths(self, carry: dict, seq_lengths) -> torch.Tensor:
        """Positions :meth:`apply_stream` emits for a chunk of
        ``seq_lengths`` valid frames given the carry BEFORE the call:
        ``seq_lengths``, or ``(in_fill + v) // s`` under the front-end."""
        v = torch.as_tensor(seq_lengths, device=carry["pos"].device).long()
        s = self.config.subsample
        return v if s == 1 else torch.div(carry["in_fill"] + v, s, rounding_mode="floor")

    def apply_stream(self, chunk: torch.Tensor, seq_lengths, carry: dict) -> tuple[torch.Tensor, dict]:
        """One chunk ``[B, Tc, F]`` (``seq_lengths`` valid frames a row) →
        ``(logits [B, Tc', O] f32, new carry)``; ``Tc' = ceil(Tc / s)``, of
        which :meth:`stream_output_lengths` are valid a row. A row of
        length 0 keeps its carry."""
        v = torch.as_tensor(seq_lengths, device=carry["pos"].device).long()
        if self.config.subsample > 1:
            chunk, v, carry = self._stream_stack(chunk, v, carry)
        return self._stream_core(chunk, v, carry)

    def apply_stream_flush(self, carry: dict) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """End of stream: the zero-padded last partial group under the
        front-end, ``(logits [B, 1, O], count [B] in {0, 1}, carry)``; a
        count-0 no-op without it."""
        cfg = self.config
        pos = carry["pos"]
        if cfg.subsample == 1:
            return (torch.zeros(pos.shape[0], 1, cfg.num_labels, device=pos.device), torch.zeros_like(pos), carry)
        group, n, carry = self._stream_flush_group(carry)
        logits, carry = self._stream_core(group, n, carry)
        return logits, n, carry

    def _stream_stack(self, chunk, v, carry):
        """Buffer raw frames until whole ``s``-groups exist and stack them:
        ``(stacked [B, ceil(Tc/s), s·F], n_out [B], carry)``. Each row's
        groups start where its own buffer does, so everything is gathers
        over ``[in_buf ++ chunk]``."""
        s = self.config.subsample
        b, tc, f = chunk.shape
        device = chunk.device
        fill = carry["in_fill"]
        combined = torch.cat([carry["in_buf"], chunk.float()], dim=1)  # a row's stream starts at s-1-fill
        start = (s - 1) - fill
        total = fill + v
        n_out = torch.div(total, s, rounding_mode="floor")
        new_fill = total - n_out * s
        cap = -(-tc // s)
        last = s - 1 + tc - 1
        ar = torch.arange(cap * s, device=device)[None, :]
        idx = (start[:, None] + ar).clamp(0, last)
        frames = torch.gather(combined, 1, idx[:, :, None].expand(-1, -1, f))
        frames = torch.where((ar < (n_out * s)[:, None])[:, :, None], frames, 0.0)  # past the groups: inert
        j = torch.arange(s - 1, device=device)[None, :]
        lead = ((s - 1) - new_fill)[:, None]
        buf_idx = (start[:, None] + (n_out * s)[:, None] + j - lead).clamp(0, last)
        new_buf = torch.where((j >= lead)[:, :, None],
                              torch.gather(combined, 1, buf_idx[:, :, None].expand(-1, -1, f)), 0.0)
        return frames.reshape(b, cap, s * f), n_out, {**carry, "in_buf": new_buf, "in_fill": new_fill}

    def _stream_flush_group(self, carry):
        """The last partial group, zero-padded as the offline forward pads
        its tail, emitted for rows with buffered frames."""
        s = self.config.subsample
        buf, fill = carry["in_buf"], carry["in_fill"]
        b, _, f = buf.shape
        i = torch.arange(s, device=buf.device)[None, :]
        idx = (((s - 1) - fill)[:, None] + i).clamp(0, s - 2)
        frames = torch.where((i < fill[:, None])[:, :, None], torch.gather(buf, 1, idx[:, :, None].expand(-1, -1, f)),
                             0.0)
        n = (fill > 0).long()
        return frames.reshape(b, 1, s * f), n, {**carry, "in_buf": torch.zeros_like(buf),
                                                 "in_fill": torch.zeros_like(fill)}

    @staticmethod
    def _roll(cache, new_rows, v):
        """The cache after ``v`` valid new rows: slot ``m`` is concat index
        ``v + m`` of ``[cache ++ new_rows]``."""
        full = torch.cat([cache, new_rows], dim=1)
        idx = v[:, None] + torch.arange(cache.shape[1], device=cache.device)[None, :]
        return torch.gather(full, 1, idx[:, :, None].expand(-1, -1, full.shape[2]))

    def _stream_core(self, chunk, v, carry):
        """The block stack over an (already stacked) chunk with ``v`` valid
        positions a row."""
        cfg = self.config
        dtype, eps, L = cfg.compute_dtype, cfg.ln_eps, cfg.left_context
        b, tc, _ = chunk.shape
        device = chunk.device
        pos = carry["pos"]
        ar_q = torch.arange(tc, device=device)
        mask_btf = (ar_q[None, :] < v[:, None])[:, :, None]

        h = affine(chunk.float(), self.in_proj.w, self.in_proj.b, dtype)
        h = h + sinusoid_rows(pos[:, None] + ar_q[None, :], cfg.d_model).to(dtype)
        h = h * mask_btf.to(h.dtype)

        # keys [cache ++ chunk]: concat index p holds global frame pos - L + p,
        # query i global frame pos + i, so rel[i, p] = (L + i) - p
        ar_k = torch.arange(L + tc, device=device)[None, :]
        rel = (L + ar_q)[:, None] - ar_k
        key_valid = torch.where(ar_k < L, ar_k >= (L - pos.clamp(max=L))[:, None], (ar_k - L) < v[:, None])
        attn_mask = key_valid[:, None, None, :] & self._band(rel)[None, None]

        h_caches, conv_caches = [], []
        for l, blk in enumerate(self.blocks):
            if cfg.conformer:
                z = layernorm(h, blk.ln_ffn1, eps)
                h = (h + 0.5 * feed_forward(z, blk.ffn1, dtype)) * mask_btf.to(h.dtype)
            cache = carry["h_cache"][l]
            full = torch.cat([cache, h.float()], dim=1)  # [B, L+Tc, D]
            h_caches.append(self._roll(cache, h.float(), v))
            z_full = layernorm(full.to(dtype), blk.ln_attn, eps)
            h = h + attention(z_full[:, L:], z_full, blk.attn, attn_mask, cfg.num_heads, dtype)
            if cfg.conformer:
                h, conv_cache = self._stream_conv(h, blk, l, mask_btf, carry["conv_cache"][l], v)
                conv_caches.append(conv_cache)
            z = layernorm(h, blk.ln_ffn, eps)
            f = feed_forward(z, blk.ffn, dtype)
            h = layernorm(h + 0.5 * f, blk.ln_out, eps) if cfg.conformer else h + f
            h = h * mask_btf.to(h.dtype)

        new_carry = {**carry, "pos": pos + v, "h_cache": torch.stack(h_caches)}
        if cfg.conformer:
            new_carry["conv_cache"] = torch.stack(conv_caches)
        h = layernorm(h, self.ln_final, eps)
        logits = product(h.reshape(b * tc, cfg.d_model), self.out.w, dtype) + self.out.b.float()
        return logits.reshape(b, tc, cfg.num_labels), new_carry

    def _stream_conv(self, h, blk, l: int, mask_btf, cache, v):
        """The conv module over ``[conv_cache ++ chunk]`` with no padding:
        the unfilled cache slots' zeros are the offline causal pad. Returns
        ``(h + module, new conv cache)``, masked."""
        cfg = self.config
        dtype = cfg.compute_dtype
        b, tc, d = h.shape
        p = blk.conv
        zf = affine(layernorm(h, blk.ln_conv, cfg.ln_eps), p.w_in, p.b_in, dtype).float()
        glu = (zf[..., :d] * torch.sigmoid(zf[..., d:])).to(dtype) * mask_btf.to(dtype)
        glu = glu.float()
        new_cache = self._roll(cache, glu, v)
        conv = F.conv1d(torch.cat([cache, glu], dim=1).transpose(1, 2), p.w_dw, groups=d)  # [B, D, Tc] f32
        z = batchnorm(conv.transpose(1, 2).reshape(b * tc, d), self.bn_conv_mean[l], self.bn_conv_var[l],
                      p.bn_beta, cfg.bn_eps, torch.float32)
        out = affine(swish(z, dtype).reshape(b, tc, d), p.w_out, p.b_out, dtype)
        return (h + out) * mask_btf.to(h.dtype), new_cache

"""Attention encoder-decoder: an acoustic encoder and a causal transformer
decoder with cross-attention, trained on teacher-forced targets.

Port of :mod:`tfkaldi_tpu.models.seq2seq` (``Seq2SeqConfig``,
``AttentionSeq2Seq``: init, ``encode``, ``decode_step_logits``,
``ctc_logits``, ``apply_joint``, ``apply_seq2seq``, the KV-cached step
``init_decode_cache`` / ``cross_kv`` / ``_mha_one`` /
``decode_step_cached``, ``sos_eos_id``, ``vocab_size``,
``output_lengths``). Parameters keep the JAX pytree's names
(``enc.*`` the encoder's, ``embed``, ``dec_blocks.{i}.{ln_self,self,
ln_cross,cross,ln_ffn,ffn}``, ``ln_final``, ``out``, and ``embed_proj``
and ``ctc_head`` where configured), so
:func:`tfkaldi_tpu_torch.convert.seq2seq_from_jax` copies them.

- The encoder by ``enc_type``: ``conformer`` / ``transformer`` through
  :class:`~tfkaldi_tpu_torch.models.transformer.Transformer`, ``lstm`` /
  ``gru`` through :mod:`tfkaldi_tpu_torch.models.rnn` (kernels 4-7 on a
  card). Its output layer is the memory projection to ``d_model``, kept in
  f32; it is re-initialised from the encoder's zero output layer.
- The decoder reads the memory rounded to ``compute_dtype``; its token
  embedding is scaled by ``sqrt(embed_dim)`` (and projected by
  ``embed_proj`` when ``embed_dim != d_model``), its positions are the f64
  numpy table, and its output layer adds its bias in f32 and keeps the f32
  result. Every other rounding point is the encoder's
  (:mod:`~tfkaldi_tpu_torch.models.transformer`).
- SOS and EOS share the id ``num_labels``, also the CTC head's blank.

The KV-cached step serves the autoregressive beam
(:class:`tfkaldi_tpu_torch.decode.seq2seq.Seq2SeqBeamDecoder`): it advances
every hypothesis one position, reading per-block self-attention K/V caches
``[blocks, N, L+1, D]`` in f32 (K/V are projected in ``compute_dtype``,
widened on write and narrowed again on read, as the JAX package does) and
the memory's cross-attention K/V computed once; its position term is row
``step`` of the cache-length f64 table, and its f32 logits come from the
``compute_dtype`` product, as the grid forward's do.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn

from tfkaldi_tpu_torch.layers import affine, product
from tfkaldi_tpu_torch.models.rnn import GRU, LSTM, RNNConfig
from tfkaldi_tpu_torch.models.transformer import (
    _NEG,
    Params,
    Transformer,
    TransformerConfig,
    attention,
    attn_params,
    dropout,
    feed_forward,
    ffn_params,
    init_params,
    layernorm,
    ln_params,
    sinusoidal_positions,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the keys of [nnet] handed to the self-attention encoder (models/seq2seq.py:102-110)
_ENC_KEYS = ("num_blocks", "d_model", "num_heads", "ffn_dim", "conv_kernel", "subsample",
             "attention_left_context", "attention_right_context", "causal_conv")


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    input_dim: int
    num_labels: int  # real labels; sos/eos = num_labels (vocab = +1)
    enc_type: str = "conformer"  # lstm | gru | transformer | conformer
    enc_layers: int = 2  # RNN encoders
    enc_units: int = 512
    enc_bidirectional: bool = True
    enc_extra: tuple = ()  # [nnet] keys for TransformerConfig.from_config
    dec_blocks: int = 2
    d_model: int = 256
    num_heads: int = 4
    ffn_dim: int = 1024
    embed_dim: int = 0  # 0 = d_model
    label_smoothing: float = 0.1
    ctc_weight: float = 0.0  # joint CTC-attention: w·CTC + (1-w)·attention CE
    dropout: float = 1.0  # keep probability, reference semantics
    compute_dtype: torch.dtype = torch.float32
    ln_eps: float = 1e-6

    def __post_init__(self):
        if self.d_model % self.num_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by num_heads {self.num_heads}")
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError("label_smoothing must be in [0, 1)")
        if self.enc_type not in ("lstm", "gru", "transformer", "conformer"):
            raise ValueError(f"unknown enc_type {self.enc_type!r}")

    @classmethod
    def from_config(cls, conf: dict, input_dim: int, num_labels: int) -> "Seq2SeqConfig":
        """Build from a reference-style ``[nnet]`` section dict (the keys of
        models/seq2seq.py:93-122; ``scan_unroll`` / ``scan_impl`` select TPU
        scans and are ignored: the port always takes its kernels)."""
        dtype = conf.get("compute_dtype", "float32")
        if dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {dtype!r}: want one of {sorted(_DTYPES)}")
        return cls(
            input_dim=input_dim,
            num_labels=num_labels,
            enc_type=str(conf.get("enc_type", "conformer")),
            enc_layers=int(conf.get("num_hidden_layers", 2)),
            enc_units=int(conf.get("num_hidden_units", 512)),
            enc_bidirectional=str(conf.get("bidirectional", "True")) == "True",
            enc_extra=tuple((k, str(conf[k])) for k in _ENC_KEYS if k in conf),
            dec_blocks=int(conf.get("dec_blocks", 2)),
            d_model=int(conf.get("d_model", 256)),
            num_heads=int(conf.get("num_heads", 4)),
            ffn_dim=int(conf.get("ffn_dim", 1024)),
            embed_dim=int(conf.get("embed_dim", 0)),
            label_smoothing=float(conf.get("label_smoothing", 0.1)),
            ctc_weight=float(conf.get("ctc_weight", 0.0)),
            dropout=float(conf.get("dropout", 1)),
            compute_dtype=_DTYPES[dtype],
        )

    def encoder_config(self):
        """The encoder's config: a ``TransformerConfig`` whose output layer
        (``num_labels = d_model``) is the memory projection, or an
        ``RNNConfig`` of the same role."""
        if self.enc_type in ("transformer", "conformer"):
            tconf = dict(self.enc_extra)
            tconf["conformer"] = "True" if self.enc_type == "conformer" else "False"
            tconf.setdefault("d_model", str(self.d_model))
            tcfg = TransformerConfig.from_config(tconf, self.input_dim, self.d_model)
            return dataclasses.replace(tcfg, dropout=self.dropout, compute_dtype=self.compute_dtype)
        return RNNConfig(
            input_dim=self.input_dim, num_labels=self.d_model, num_layers=self.enc_layers,
            hidden_units=self.enc_units, bidirectional=self.enc_bidirectional, dropout=self.dropout,
            compute_dtype=self.compute_dtype, cell=self.enc_type,
        )


@functools.lru_cache(maxsize=16)
def _positions_on(t: int, d: int, device: torch.device) -> torch.Tensor:
    """:func:`sinusoidal_positions` ``[t, d]`` on ``device``, copied once."""
    return torch.from_numpy(sinusoidal_positions(t, d)).to(device)


class _DecBlock(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.ln_self = ln_params(d)
        self.self = attn_params(d)
        self.ln_cross = ln_params(d)
        self.cross = attn_params(d)
        self.ln_ffn = ln_params(d)
        self.ffn = ffn_params(d, f)


class AttentionSeq2Seq(nn.Module):
    """``forward(inputs, lengths, labels, label_lengths, *, train=False,
    generator=None)`` → teacher-forced logits ``[B, U+1, V]`` float32
    (:meth:`apply_seq2seq`); :meth:`apply_joint` adds the CTC head's."""

    def __init__(self, config: Seq2SeqConfig):
        super().__init__()
        self.config = config
        cfg = config
        enc_cfg = cfg.encoder_config()
        self.enc = Transformer(enc_cfg) if isinstance(enc_cfg, TransformerConfig) else (
            {"lstm": LSTM, "gru": GRU}[cfg.enc_type](enc_cfg))
        d, v, e = cfg.d_model, self.vocab_size, self.embed_dim
        self.embed = nn.Parameter(torch.zeros(v, e))
        self.dec_blocks = nn.ModuleList(_DecBlock(d, cfg.ffn_dim) for _ in range(cfg.dec_blocks))
        self.ln_final = ln_params(d)
        self.out = Params(w=(d, v), b=(v,))
        if e != d:
            self.embed_proj = nn.Parameter(torch.zeros(e, d))
        if cfg.ctc_weight > 0.0:
            self.ctc_head = Params(w=(d, v), b=(v,))

    @property
    def sos_eos_id(self) -> int:
        return self.config.num_labels

    @property
    def vocab_size(self) -> int:
        return self.config.num_labels + 1

    @property
    def embed_dim(self) -> int:
        return self.config.embed_dim or self.config.d_model

    def output_lengths(self, lengths):
        fn = getattr(self.enc, "output_lengths", None)
        return lengths if fn is None else fn(lengths)

    # ------------------------------------------------------------------
    # parameters (models/seq2seq.py:187-264)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX ``init``: the encoder's own init, its zero output layer
        redrawn as ``N(0, 1)/sqrt(fan_in)`` (the memory projection must break
        symmetry), the embedding ``N(0, 1)/sqrt(embed_dim)``, the decoder
        blocks as the encoder's, zero ``out`` and ``ctc_head``; drawn on the
        CPU from ``generator``."""
        self.enc.reset_parameters(generator)
        w = self.enc.out.w
        w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[0]))
        e = self.embed_dim
        self.embed.copy_(torch.randn(self.embed.shape, generator=generator) / math.sqrt(e))
        for blk in self.dec_blocks:
            init_params(blk, generator)
        init_params(self.ln_final, generator)
        self.out.w.zero_()
        self.out.b.zero_()
        if e != self.config.d_model:
            self.embed_proj.copy_(torch.randn(self.embed_proj.shape, generator=generator) / math.sqrt(e))
        if self.config.ctc_weight > 0.0:
            self.ctc_head.w.zero_()
            self.ctc_head.b.zero_()

    @torch.no_grad()
    def reinit_output_layer(self) -> None:
        """Re-zero the decoder's output layer (its init is all zeros)."""
        self.out.w.zero_()
        self.out.b.zero_()

    # ------------------------------------------------------------------
    # forward (models/seq2seq.py:268-382, 488-523)
    # ------------------------------------------------------------------

    def encode(self, inputs, lengths, *, train: bool = False, generator=None) -> torch.Tensor:
        """``[B, T, F]`` features → ``[B, T', d_model]`` f32 memory."""
        return self.enc(inputs, lengths, train=train, generator=generator)

    def memory_valid(self, memory: torch.Tensor, lengths) -> torch.Tensor:
        """``[B, T']`` bool: the memory frames inside each row's
        ``output_lengths``."""
        enc_lengths = torch.as_tensor(self.output_lengths(torch.as_tensor(lengths))).to(memory.device)
        return torch.arange(memory.shape[1], device=memory.device)[None, :] < enc_lengths[:, None]

    def decode_step_logits(self, tokens, token_valid, memory, mem_valid, *, train: bool = False,
                           generator=None) -> torch.Tensor:
        """Causal decoder forward: ``tokens [B, U]`` (SOS-shifted) →
        ``[B, U, V]`` f32 next-token logits; ``token_valid [B, U]`` masks
        padded positions out of the self-attention keys, ``mem_valid
        [B, T']`` padded memory frames out of the cross-attention."""
        cfg = self.config
        dtype, eps, keep = cfg.compute_dtype, cfg.ln_eps, cfg.dropout
        b, u = tokens.shape
        device = memory.device
        h = self.embed[tokens.long()] * math.sqrt(float(self.embed_dim))
        if self.embed_dim != cfg.d_model:
            h = h @ self.embed_proj
        h = h + torch.from_numpy(sinusoidal_positions(u, cfg.d_model)).to(device)[None]
        h = (h * token_valid[:, :, None]).to(dtype)
        mem = memory.to(dtype)
        idx = torch.arange(u, device=device)
        self_mask = token_valid[:, None, None, :] & (idx[:, None] >= idx[None, :])[None, None]
        cross_mask = mem_valid[:, None, None, :]
        for blk in self.dec_blocks:
            z = layernorm(h, blk.ln_self, eps)
            h = h + dropout(attention(z, z, blk.self, self_mask, cfg.num_heads, dtype), keep, generator, train)
            z = layernorm(h, blk.ln_cross, eps)
            h = h + dropout(attention(z, mem, blk.cross, cross_mask, cfg.num_heads, dtype), keep, generator, train)
            z = layernorm(h, blk.ln_ffn, eps)
            h = h + dropout(feed_forward(z, blk.ffn, dtype), keep, generator, train)
        h = layernorm(h, self.ln_final, eps)
        logits = product(h.reshape(b * u, cfg.d_model), self.out.w, dtype) + self.out.b.float()
        return logits.reshape(b, u, self.vocab_size)

    def ctc_logits(self, memory: torch.Tensor) -> torch.Tensor:
        """``[B, T', D]`` memory → ``[B, T', V]`` CTC logits (f32 from the
        ``compute_dtype`` result of the head; ``ctc_weight > 0`` only)."""
        return affine(memory, self.ctc_head.w, self.ctc_head.b, self.config.compute_dtype).float()

    def teacher_forced(self, memory, lengths, labels, label_lengths, *, train: bool = False,
                       generator=None) -> torch.Tensor:
        """The decoder over ``memory`` fed SOS + ``labels``: ``[B, U+1, V]``
        logits, positions past each row's ``label_lengths`` masked out of the
        self-attention keys, frames past ``output_lengths(lengths)`` out of
        the cross-attention."""
        b, u = labels.shape
        device = memory.device
        labels = torch.as_tensor(labels).to(device)
        label_lengths = torch.as_tensor(label_lengths).to(device)
        sos = torch.full((b, 1), self.sos_eos_id, dtype=labels.dtype, device=device)
        tokens = torch.cat([sos, labels], dim=1)  # [B, U+1]
        token_valid = torch.arange(u + 1, device=device)[None, :] <= label_lengths[:, None]
        return self.decode_step_logits(tokens, token_valid, memory, self.memory_valid(memory, lengths),
                                       train=train, generator=generator)

    def apply_joint(self, inputs, lengths, labels, label_lengths, *, train: bool = False, generator=None):
        """One encoder pass feeding both heads: ``(attention logits [B, U+1,
        V], CTC logits [B, T', V])``."""
        memory = self.encode(inputs, lengths, train=train, generator=generator)
        att = self.teacher_forced(memory, lengths, labels, label_lengths, train=train, generator=generator)
        return att, self.ctc_logits(memory)

    def apply_seq2seq(self, inputs, lengths, labels, label_lengths, *, train: bool = False, generator=None):
        """Teacher-forced logits ``[B, U+1, V]``: position u predicts
        ``labels[:, u]`` for u < length and EOS at u = length."""
        memory = self.encode(inputs, lengths, train=train, generator=generator)
        return self.teacher_forced(memory, lengths, labels, label_lengths, train=train, generator=generator)

    forward = apply_seq2seq

    # ------------------------------------------------------------------
    # the KV-cached autoregressive step (models/seq2seq.py:393-487)
    # ------------------------------------------------------------------

    def init_decode_cache(self, n: int, max_len: int, device=None) -> dict[str, torch.Tensor]:
        """Zeroed self-attention K/V caches, ``[blocks, N, max_len+1, D]``
        f32 each (position p holds the K/V of the token fed at step p)."""
        cfg = self.config
        shape = (cfg.dec_blocks, n, max_len + 1, cfg.d_model)
        device = self.embed.device if device is None else device
        return {"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device)}

    def cross_kv(self, memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Every block's cross-attention K/V of the memory, ``[blocks, N,
        T', D]`` f32 each, projected in ``compute_dtype``: once a batch."""
        dtype = self.config.compute_dtype
        mem = memory.to(dtype)
        ks = [affine(mem, blk.cross.wk, blk.cross.bk, dtype) for blk in self.dec_blocks]
        vs = [affine(mem, blk.cross.wv, blk.cross.bv, dtype) for blk in self.dec_blocks]
        return torch.stack(ks).float(), torch.stack(vs).float()

    def _mha_one(self, q, keys, values, p, key_valid, dtype) -> torch.Tensor:
        """One-query attention: ``q [N, D]`` over the projected ``keys`` /
        ``values [N, Tk, D]`` (f32, narrowed to ``dtype`` here);
        ``key_valid [N, Tk]``."""
        n, d = q.shape
        tk = keys.shape[1]
        nh = self.config.num_heads
        dh = d // nh
        qh = q.reshape(n, nh, 1, dh)
        kh = keys.to(dtype).reshape(n, tk, nh, dh).permute(0, 2, 3, 1)  # [N, h, dh, Tk]
        vh = values.to(dtype).reshape(n, tk, nh, dh).transpose(1, 2)  # [N, h, Tk, dh]
        scores = product(qh, kh, dtype) * (1.0 / np.sqrt(dh))  # [N, h, 1, Tk]
        scores = torch.where(key_valid[:, None, None, :], scores, _NEG)
        attn = torch.softmax(scores, dim=-1).to(dtype)
        ctx = product(attn, vh, dtype).to(dtype)  # [N, h, 1, dh]
        return affine(ctx.reshape(n, d), p.wo, p.bo, dtype)

    def decode_step_cached(self, tok: torch.Tensor, step: int, cache: dict, cross_k: torch.Tensor,
                           cross_v: torch.Tensor, mem_valid: torch.Tensor):
        """Advance one position: ``tok [N]`` is the token at sequence
        position ``step`` (SOS at 0, else the label emitted before). Writes
        slot ``step`` of ``cache`` in place and returns ``([N, V] f32 logits,
        cache)``. A finished hypothesis' logits are unused and its slots past
        its length hold garbage that no live query reads (a query at position
        p reads slots <= p)."""
        cfg = self.config
        dtype, eps = cfg.compute_dtype, cfg.ln_eps
        n = tok.shape[0]
        cache_len = cache["k"].shape[2]
        device = tok.device
        h = self.embed[tok.long()] * math.sqrt(float(self.embed_dim))
        if self.embed_dim != cfg.d_model:
            h = h @ self.embed_proj
        h = (h + _positions_on(cache_len, cfg.d_model, device)[step]).to(dtype)
        slot_valid = (torch.arange(cache_len, device=device) <= step)[None, :].expand(n, cache_len)
        for l, blk in enumerate(self.dec_blocks):
            z = layernorm(h, blk.ln_self, eps)
            p = blk.self
            q = affine(z, p.wq, p.bq, dtype)
            cache["k"][l, :, step] = affine(z, p.wk, p.bk, dtype).float()
            cache["v"][l, :, step] = affine(z, p.wv, p.bv, dtype).float()
            h = h + self._mha_one(q, cache["k"][l], cache["v"][l], p, slot_valid, dtype)
            z = layernorm(h, blk.ln_cross, eps)
            p = blk.cross
            h = h + self._mha_one(affine(z, p.wq, p.bq, dtype), cross_k[l], cross_v[l], p, mem_valid, dtype)
            z = layernorm(h, blk.ln_ffn, eps)
            h = h + feed_forward(z, blk.ffn, dtype)
        h = layernorm(h, self.ln_final, eps)
        return product(h, self.out.w, dtype) + self.out.b.float(), cache

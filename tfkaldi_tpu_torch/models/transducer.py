"""RNN-T (transducer) model: an acoustic encoder, a label prediction network
and a joint network, scored by the RNN-T lattice loss.

Port of :mod:`tfkaldi_tpu.models.transducer` (``TransducerConfig``,
``Transducer``: init, ``output_lengths``, ``subsample_factor``,
``encode``, ``predict``, ``apply_transducer``, ``lattice_scores``,
``lattice_scores_pruned``, ``joint_step``, ``predict_step``,
``init_pred_carry``, and the streaming ``validate_streamable``,
``encode_stream`` and ``encode_stream_flush``). Parameters keep the JAX pytree's names (``enc.*``
the encoder's, ``pred.*`` the prediction network's, ``embed``,
``joint.{w,b}``), so :func:`tfkaldi_tpu_torch.convert.transducer_from_jax`
copies them.

- The encoder by ``enc_type``: ``conformer`` / ``transformer`` through
  :class:`~tfkaldi_tpu_torch.models.transformer.Transformer`, built from
  the ``[nnet]`` keys of ``enc_extra`` alone (``_ENC_KEYS``: the JAX
  package's nine, then the port's ``pos_enc``, ``frontend`` and
  ``conv_bn_scale``) with ``dropout`` and ``compute_dtype`` replaced;
  ``lstm`` / ``gru`` through :mod:`tfkaldi_tpu_torch.models.rnn`. Its
  output layer (width ``joint_units``) is the encoder half of the joint.
- The prediction network is a unidirectional LSTM over the embedded labels
  after a start token (the blank id ``num_labels``), lengths
  ``label_lengths + 1``; its output layer is the prediction half of the
  joint. In training it runs kernels 4 and 5 on a card (one direction),
  where the JAX package runs an XLA scan (``scan_impl = "xla"``); in decode
  it steps through ``apply_stream`` (plain torch, as JAX's XLA step).
- Both output layers are redrawn ``N(0, 1)/sqrt(fan_in)`` with a zero
  bias (the recurrent models and the transformer zero them).
- The joint: ``tanh(enc + pred)`` in f32 rounded to ``compute_dtype``, one
  product with ``joint.w`` in f32 plus the f32 bias. The fused score paths
  take it in blocks of ``joint_chunk_t`` frames, each block under
  ``torch.utils.checkpoint`` (the backward recomputes it, as JAX's
  ``jax.checkpoint`` does), and keep only the blank column and each row's
  target label of the log-softmax.
- The banded block copies the JAX function's own roundings, which differ
  from the dense block's: ``enc`` and the gathered ``pred`` rows are
  rounded to ``compute_dtype`` first and ``tanh(enc + pred)`` is taken in
  ``compute_dtype``; the target label's bias is rounded to
  ``compute_dtype``. Its one-hot band extraction (a TPU workaround) is a
  gather here: a band slot past the last label (``p + s = U``) reads the
  last ``pred`` row and a zero label column, whose gradient stays 0.

``torch.profiler`` spans: ``rnnt.encode`` (:meth:`Transducer.encode`),
``rnnt.predict`` (:meth:`Transducer.predict`) and ``rnnt.joint`` inside
each joint block's function, so that the checkpoint's recompute in the
backward opens it too (the lattice's own span, ``rnnt.lattice``, is in
:mod:`tfkaldi_tpu_torch.ops.rnnt_loss`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tfkaldi_tpu_torch.layers import product
from tfkaldi_tpu_torch.models.rnn import GRU, LSTM, RNNConfig
from tfkaldi_tpu_torch.models.transformer import Params, Transformer, TransformerConfig
from tfkaldi_tpu_torch.ops import rnnt_loss

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the keys of [nnet] handed to the self-attention encoder (models/transducer.py:104-112)
_ENC_KEYS = ("num_blocks", "d_model", "num_heads", "ffn_dim", "conv_kernel", "subsample",
             "attention_left_context", "attention_right_context", "causal_conv",
             "pos_enc", "frontend", "conv_bn_scale")


@dataclasses.dataclass(frozen=True)
class TransducerConfig:
    input_dim: int
    num_labels: int  # real labels; blank = num_labels (vocab = num_labels+1)
    enc_type: str = "lstm"  # lstm | gru | transformer | conformer
    enc_layers: int = 2
    enc_units: int = 512
    enc_bidirectional: bool = False
    pred_layers: int = 1
    pred_units: int = 320
    embed_dim: int = 128
    joint_units: int = 320
    dropout: float = 1.0  # keep probability, reference semantics
    compute_dtype: torch.dtype = torch.float32
    joint_chunk_t: int = 32  # frames of a joint block; 0 = all of T in one
    prune_s: int = 0  # band width of the pruned loss; 0 = dense
    prune_band: str = "guided"  # guided | diagonal
    prune_proxy_stride: int = 4  # the guided band's stage-1 time stride
    enc_extra: tuple = ()  # [nnet] keys for TransformerConfig.from_config

    def __post_init__(self):
        if self.enc_type not in ("lstm", "gru", "transformer", "conformer"):
            raise ValueError(f"unknown enc_type {self.enc_type!r}")

    @classmethod
    def from_config(cls, conf: dict, input_dim: int, num_labels: int) -> "TransducerConfig":
        """Build from a reference-style ``[nnet]`` section dict (the keys of
        models/transducer.py:84-113; ``scan_unroll`` / ``scan_impl`` select
        TPU scans and are ignored)."""
        dtype = conf.get("compute_dtype", "float32")
        if dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {dtype!r}: want one of {sorted(_DTYPES)}")
        return cls(
            input_dim=input_dim,
            num_labels=num_labels,
            enc_type=str(conf.get("enc_type", "lstm")),
            enc_layers=int(conf.get("num_hidden_layers", 2)),
            enc_units=int(conf.get("num_hidden_units", 512)),
            enc_bidirectional=str(conf.get("bidirectional", "False")) == "True",
            pred_layers=int(conf.get("pred_layers", 1)),
            pred_units=int(conf.get("pred_units", 320)),
            embed_dim=int(conf.get("embed_dim", 128)),
            joint_units=int(conf.get("joint_units", 320)),
            dropout=float(conf.get("dropout", 1)),
            compute_dtype=_DTYPES[dtype],
            joint_chunk_t=int(conf.get("joint_chunk_t", 32)),
            prune_s=int(conf.get("rnnt_prune_s", 0)),
            prune_band=str(conf.get("rnnt_prune_band", "guided")),
            prune_proxy_stride=int(conf.get("rnnt_prune_stride", 4)),
            enc_extra=tuple((k, str(conf[k])) for k in _ENC_KEYS if k in conf),
        )

    def encoder_config(self):
        """The encoder's config: a ``TransformerConfig`` from ``enc_extra``
        alone, or an ``RNNConfig``; its output width is ``joint_units``."""
        if self.enc_type in ("transformer", "conformer"):
            tconf = dict(self.enc_extra)
            tconf["conformer"] = "True" if self.enc_type == "conformer" else "False"
            tcfg = TransformerConfig.from_config(tconf, self.input_dim, self.joint_units)
            return dataclasses.replace(tcfg, dropout=self.dropout, compute_dtype=self.compute_dtype)
        return RNNConfig(
            input_dim=self.input_dim, num_labels=self.joint_units, num_layers=self.enc_layers,
            hidden_units=self.enc_units, bidirectional=self.enc_bidirectional, dropout=self.dropout,
            compute_dtype=self.compute_dtype, cell=self.enc_type,
        )

    def predictor_config(self) -> RNNConfig:
        return RNNConfig(
            input_dim=self.embed_dim, num_labels=self.joint_units, num_layers=self.pred_layers,
            hidden_units=self.pred_units, bidirectional=False, dropout=self.dropout,
            compute_dtype=self.compute_dtype,
        )


class Transducer(nn.Module):
    """Encoder + prediction network + joint. Trained with ``loss = rnnt``
    through :meth:`lattice_scores` or :meth:`lattice_scores_pruned`;
    decoded by :mod:`tfkaldi_tpu_torch.decode.transducer` and
    :mod:`tfkaldi_tpu_torch.decode.transducer_beam`."""

    def __init__(self, config: TransducerConfig):
        super().__init__()
        self.config = config
        enc_cfg = config.encoder_config()
        self.enc = Transformer(enc_cfg) if isinstance(enc_cfg, TransformerConfig) else (
            {"lstm": LSTM, "gru": GRU}[config.enc_type](enc_cfg))
        self.pred = LSTM(config.predictor_config())
        self.embed = nn.Parameter(torch.zeros(self.vocab_size, config.embed_dim))
        self.joint = Params(w=(config.joint_units, self.vocab_size), b=(self.vocab_size,))

    @property
    def blank_id(self) -> int:
        return self.config.num_labels

    @property
    def vocab_size(self) -> int:
        return self.config.num_labels + 1

    def output_lengths(self, lengths):
        """Valid encoder frames per row: ``ceil(n/s)`` under a subsampling
        encoder, else ``n``."""
        fn = getattr(self.enc, "output_lengths", None)
        return lengths if fn is None else fn(lengths)

    @property
    def subsample_factor(self) -> int:
        return getattr(self.enc, "subsample_factor", 1)

    def validate_streamable(self) -> None:
        """Raise unless the encoder streams exactly: a unidirectional RNN,
        or a causal time-restricted transformer / conformer."""
        check = getattr(self.enc, "validate_streamable", None)
        if check is not None:
            check()
        elif self.enc.config.bidirectional:
            raise ValueError("online decoding requires a unidirectional encoder (bidirectional = False)")

    def encode_stream(self, chunk, lengths, carry):
        """One streaming encoder chunk → ``(enc [B, Tc', J], n_out [B], new
        carry)``: ``n_out`` is ``lengths`` for an RNN encoder, ``(fill +
        v) // s`` under a subsampling front-end."""
        fn = getattr(self.enc, "stream_output_lengths", None)
        n_out = torch.as_tensor(lengths, device=self.embed.device).long() if fn is None else fn(carry, lengths)
        enc, carry = self.enc.apply_stream(chunk, lengths, carry)
        return enc, n_out, carry

    def encode_stream_flush(self, carry):
        """End of stream: the subsampling front-end's zero-padded last group
        ``(enc [B, 1, J], n in {0, 1}, carry)``; a count-0 no-op for an RNN
        encoder."""
        fn = getattr(self.enc, "apply_stream_flush", None)
        if fn is not None:
            return fn(carry)
        b = carry[0][0].shape[0]
        device = self.embed.device
        return (torch.zeros(b, 1, self.config.joint_units, device=device),
                torch.zeros(b, dtype=torch.long, device=device), carry)

    # ------------------------------------------------------------------
    # parameters (models/transducer.py:188-219)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX ``init``: the encoder's and the predictor's own inits,
        both output layers redrawn ``N(0, 1)/sqrt(fan_in)`` with zero bias,
        the embedding ``N(0, 1)/sqrt(embed_dim)``, ``joint.w`` ``N(0,
        1)/sqrt(joint_units)`` and a zero ``joint.b``; drawn on the CPU from
        ``generator``."""
        self.enc.reset_parameters(generator)
        self.pred.reset_parameters(generator)
        for out in (self.enc.out, self.pred.out):
            out.w.copy_(torch.randn(out.w.shape, generator=generator) / math.sqrt(out.w.shape[0]))
            out.b.zero_()
        self.embed.copy_(torch.randn(self.embed.shape, generator=generator) / math.sqrt(self.config.embed_dim))
        j = self.config.joint_units
        self.joint.w.copy_(torch.randn(self.joint.w.shape, generator=generator) / math.sqrt(j))
        self.joint.b.zero_()

    # ------------------------------------------------------------------
    # forward (models/transducer.py:274-603)
    # ------------------------------------------------------------------

    def encode(self, inputs, lengths, *, train: bool = False, generator=None) -> torch.Tensor:
        """``[B, T, F]`` features → ``[B, T', J]`` f32 encoder projections."""
        with torch.profiler.record_function("rnnt.encode"):
            return self.enc(inputs, lengths, train=train, generator=generator)

    def predict(self, labels, label_lengths, *, train: bool = False, generator=None) -> torch.Tensor:
        """``[B, U]`` labels → ``[B, U+1, J]`` f32 prediction projections
        (position u conditions on the first u labels; position 0 on the
        start token, the blank)."""
        device = self.embed.device
        with torch.profiler.record_function("rnnt.predict"):
            labels = torch.as_tensor(labels).to(device).long()
            sos = torch.full((labels.shape[0], 1), self.blank_id, dtype=torch.long, device=device)
            emb = self.embed[torch.cat([sos, labels], dim=1)]
            lengths = torch.as_tensor(label_lengths).to(device) + 1
            return self.pred(emb, lengths, train=train, generator=generator)

    def _joint(self, enc, pred) -> torch.Tensor:
        """``[B, T, J] × [B, U+1, J]`` → ``[B, T, U+1, V]`` f32 logits."""
        cd = self.config.compute_dtype
        with torch.profiler.record_function("rnnt.joint"):
            h = torch.tanh(enc[:, :, None, :] + pred[:, None, :, :]).to(cd)
            return product(h, self.joint.w, cd) + self.joint.b.float()

    def apply_transducer(self, inputs, lengths, labels, label_lengths, *, train: bool = False,
                         generator=None) -> torch.Tensor:
        """The full lattice: ``[B, T', U+1, V]`` joint logits (the joint
        recomputed in the backward)."""
        enc = self.encode(inputs, lengths, train=train, generator=generator)
        pred = self.predict(labels, label_lengths, train=train, generator=generator)
        return _maybe_checkpoint(self._joint, enc, pred)

    def _blocks(self, block, enc, *extra):
        """Run ``block(enc_chunk, *chunks of extra, ...)`` over
        ``joint_chunk_t``-frame blocks of the zero-padded ``enc`` (``extra``
        ``[B, T]`` tensors padded by their last frame), each under
        checkpoint; returns the per-frame outputs concatenated and cut back
        to T."""
        t_max = enc.shape[1]
        chunk = min(self.config.joint_chunk_t or t_max, t_max)
        t_pad = -(-t_max // chunk) * chunk
        if t_pad != t_max:
            enc = nn.functional.pad(enc, (0, 0, 0, t_pad - t_max))
            extra = [torch.cat([x, x[:, -1:].expand(-1, t_pad - t_max)], dim=1) for x in extra]
        outs = [_maybe_checkpoint(block, enc[:, i: i + chunk], *(x[:, i: i + chunk] for x in extra))
                for i in range(0, t_pad, chunk)]
        return [torch.cat(parts, dim=1)[:, :t_max] for parts in zip(*outs)]

    def _label_columns(self, labels):
        """The target labels' columns of the joint projection, ``w_sel [B,
        U, J]`` in ``compute_dtype``, and their biases ``b_sel [B, U]`` f32."""
        return self.joint.w.T[labels].to(self.config.compute_dtype), self.joint.b[labels]

    def lattice_scores(self, inputs, lengths, labels, label_lengths, *, train: bool = False,
                       generator=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Fused joint → scores ``(lp_blank [B, T', U+1], lp_label [B, T',
        U])`` for :func:`~tfkaldi_tpu_torch.ops.rnnt_loss.rnnt_alpha_loss`,
        the ``[B, T', U+1, V]`` logits held one block of frames at a time."""
        cd, blank = self.config.compute_dtype, self.blank_id
        enc = self.encode(inputs, lengths, train=train, generator=generator)
        pred = self.predict(labels, label_lengths, train=train, generator=generator)
        labels = torch.as_tensor(labels).to(enc.device).long()
        u_max = labels.shape[1]
        w_sel, b_sel = self._label_columns(labels)
        w, bias = self.joint.w, self.joint.b

        def block(enc_c):
            with torch.profiler.record_function("rnnt.joint"):
                h = torch.tanh(enc_c[:, :, None, :] + pred[:, None, :, :]).to(cd)  # [B, c, U+1, J]
                logits = product(h, w, cd) + bias.float()
                lse = torch.logsumexp(logits, dim=-1)
                lab = (torch.einsum("bcuj,buj->bcu", h[:, :, :u_max].float(), w_sel.float())
                       + b_sel.float()[:, None, :])
                return logits[..., blank] - lse, lab - lse[..., :u_max]

        return tuple(self._blocks(block, enc))

    def band_starts(self, enc, pred, labels, enc_lengths, label_lengths) -> torch.Tensor:
        """Stage 1 of the pruned loss, no gradients: the band starts ``[B,
        T']`` by ``prune_band`` (``diagonal``, or ``guided`` from a rank-1
        proxy lattice of the separately normalised encoder and prediction
        projections through the joint weights)."""
        cfg = self.config
        t_max, u_max = enc.shape[1], labels.shape[1]
        if cfg.prune_band == "diagonal":
            return rnnt_loss.diagonal_band_starts(enc_lengths, label_lengths, t_max, u_max, cfg.prune_s)
        if cfg.prune_band != "guided":
            raise ValueError(f"unknown prune_band {cfg.prune_band!r}")
        with torch.no_grad():
            w, bias = self.joint.w.float(), self.joint.b.float()
            am = torch.log_softmax(enc.float() @ w + bias, dim=-1)  # [B, T, V]
            lm = torch.log_softmax(pred.float() @ w + bias, dim=-1)  # [B, U+1, V]
            blank = self.blank_id
            proxy_blank = am[..., blank][:, :, None] + lm[..., blank][:, None, :]
            am_sel = torch.gather(am, 2, labels[:, None, :].expand(-1, t_max, -1))
            lm_sel = torch.gather(lm[:, :u_max], 2, labels[:, :, None])[..., 0]
            return rnnt_loss.guided_band_starts(proxy_blank, am_sel + lm_sel[:, None, :], enc_lengths,
                                                label_lengths, cfg.prune_s, cfg.prune_proxy_stride)

    def lattice_scores_pruned(self, inputs, lengths, labels, label_lengths, *, train: bool = False,
                              generator=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Pruned fused scores ``(lp_blank_band [B, T', S], lp_label_band
        [B, T', S], band_starts [B, T'])`` for
        :func:`~tfkaldi_tpu_torch.ops.rnnt_loss.rnnt_alpha_loss_banded`: the
        joint evaluated on ``prune_s`` label positions a frame only."""
        cfg = self.config
        cd, blank, s_range = cfg.compute_dtype, self.blank_id, cfg.prune_s
        enc = self.encode(inputs, lengths, train=train, generator=generator)
        pred = self.predict(labels, label_lengths, train=train, generator=generator)
        device = enc.device
        labels = torch.as_tensor(labels).to(device).long()
        label_lengths = torch.as_tensor(label_lengths).to(device)
        u_max, j = labels.shape[1], enc.shape[2]
        enc_lengths = self.output_lengths(torch.as_tensor(lengths).to(device))
        starts = self.band_starts(enc, pred, labels, enc_lengths, label_lengths)

        w_sel, b_sel = self._label_columns(labels)
        b_sel_cd = b_sel.to(cd)
        pred_cd = pred.to(cd)
        w, bias = self.joint.w, self.joint.b
        s_off = torch.arange(s_range, device=device)

        def block(enc_c, p_c):
            with torch.profiler.record_function("rnnt.joint"):
                return band_block(enc_c, p_c)

        def band_block(enc_c, p_c):
            b, c = p_c.shape
            gidx = (p_c.long()[:, :, None] + s_off).clamp(max=u_max).reshape(b, c * s_range)
            pred_band = torch.gather(pred_cd, 1, gidx[:, :, None].expand(-1, -1, j)).reshape(b, c, s_range, j)
            h = torch.tanh(enc_c.to(cd)[:, :, None, :] + pred_band)  # in compute_dtype, as JAX
            logits = product(h, w, cd) + bias.float()
            lse = torch.logsumexp(logits, dim=-1)
            # the label slot p+s < U reads its label's column; p+s = U reads zeros
            on_label = (gidx < u_max)[:, :, None]
            lab_idx = gidx.clamp(max=max(u_max - 1, 0))
            w_band = torch.where(on_label, torch.gather(w_sel, 1, lab_idx[:, :, None].expand(-1, -1, j)), 0.0)
            b_band = torch.where(on_label[..., 0], torch.gather(b_sel_cd, 1, lab_idx), 0.0).float()
            lab = (h.float() * w_band.reshape(b, c, s_range, j).float()).sum(-1) + b_band.reshape(b, c, s_range)
            return logits[..., blank] - lse, lab - lse

        lp_blank, lp_label = self._blocks(block, enc, starts)
        return lp_blank, rnnt_loss.mask_band_label_scores(lp_label, starts, label_lengths), starts

    # ------------------------------------------------------------------
    # decode-time pieces (models/transducer.py:607-636)
    # ------------------------------------------------------------------

    def joint_step(self, enc_frames, pred_proj) -> torch.Tensor:
        """``[N, J] × [N, J]`` → ``[N, V]`` f32 logits of one lattice node."""
        cd = self.config.compute_dtype
        h = torch.tanh(enc_frames + pred_proj).to(cd)
        return product(h, self.joint.w, cd) + self.joint.b.float()

    def predict_step(self, tokens, advance, carry):
        """One prediction-network step: ``tokens [N]`` fed where ``advance``
        (bool ``[N]``), other rows keep their carry (their returned row is
        not valid). Returns ``([N, J] projection, new carry)``."""
        emb = self.embed[tokens.long()][:, None, :]
        proj, new_carry = self.pred.apply_stream(emb, advance.int(), carry)
        return proj[:, 0, :], new_carry

    def init_pred_carry(self, batch_size: int) -> list:
        return self.pred.init_stream_carry(batch_size, self.embed.device)


def _maybe_checkpoint(fn, *args):
    """``fn(*args)``, recomputed in the backward when a gradient is being
    recorded (``torch.utils.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)

"""Time-delay neural network acoustic model.

Port of :mod:`tfkaldi_tpu.models.tdnn` (``parse_context``, ``TDNNConfig``,
``_shift`` and ``TDNN``: ``init``, ``reinit_output_layer`` and ``apply``).
A hidden layer is ``nonlin(maskedBN(concat_{o in offsets} shift(h, o) @ W +
b))``: the shifts are static pad-and-slice with zero fill beyond the
utterance edges, and the concatenation feeds one product of the whole
spliced input. Parameters keep the JAX pytree's layout (``hidden.{l}.{w,b,
beta}`` with ``w [n_off·fan_in, H]``, ``out.{w,b}``, the moving stats
``bn_mean`` / ``bn_var [L, H]``), so
:func:`tfkaldi_tpu_torch.convert.tdnn_from_jax` copies them as they are.

The per-layer arithmetic is the DNN's unfused chain, in its order: the
input rows are zeroed past each length before the first splice (a positive
offset would otherwise read padding content into the last real frames);
:func:`~tfkaldi_tpu_torch.layers.affine` rounds ``x@w + b`` to the compute
dtype; :func:`~tfkaldi_tpu_torch.models.dnn.masked_batchnorm` over the real
frames; the nonlinearity; dropout in training; the padding frames zeroed
again before the next layer's shifts. The output layer starts at zero and
takes compute-dtype operands into f32 logits.
No hand kernel lies on this path: the JAX model computes its products
outside Pallas.

Split over a grid's model group (``tp``, set by
:func:`tfkaldi_tpu_torch.parallel.mesh.shard_state`) the hidden layers hold
blocks of the ``H`` columns and the output layer a block of the rows, as
the DNN's (:mod:`tfkaldi_tpu_torch.models.dnn`): the whole activation is
gathered before each layer's shifts.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from tfkaldi_tpu_torch.layers import affine, product
from tfkaldi_tpu_torch.models.dnn import _DTYPES, _Layer, _nonlin, dropout_keep, masked_batchnorm
from tfkaldi_tpu_torch.parallel import comm


def parse_context(spec: str, num_layers: int) -> tuple[tuple[int, ...], ...]:
    """Parse a per-layer offset spec like ``"-2,-1,0,1,2;-1,0,1;-3,0,3;0"``.

    Layers beyond the spec reuse its last entry; a single entry applies to
    every layer."""
    groups = [g for g in spec.replace(" ", "").split(";") if g]
    if not groups:
        raise ValueError("empty tdnn context spec")
    offsets = []
    for g in groups:
        offs = tuple(int(tok) for tok in g.split(","))
        if not offs:
            raise ValueError(f"empty offset group in {spec!r}")
        offsets.append(offs)
    while len(offsets) < num_layers:
        offsets.append(offsets[-1])
    return tuple(offsets[:num_layers])


@dataclasses.dataclass(frozen=True)
class TDNNConfig:
    input_dim: int
    num_labels: int
    num_hidden_layers: int = 5
    num_hidden_units: int = 512
    # per-layer time offsets (Kaldi's classic wsj tdnn shape)
    context: str = "-2,-1,0,1,2;-1,0,1;-1,0,1;-3,0,3;-3,0,3"
    nonlin: str = "relu"
    batch_norm: bool = True
    dropout: float = 1.0  # keep probability, reference semantics (nnet.py:70)
    compute_dtype: torch.dtype = torch.float32
    bn_eps: float = 1e-3
    bn_decay: float = 0.999

    @classmethod
    def from_config(cls, conf: dict, input_dim: int, num_labels: int) -> "TDNNConfig":
        """Build from a reference-style ``[nnet]`` section dict (the keys of
        models/tdnn.py:76-88, the offsets under ``tdnn_context``)."""
        dtype = conf.get("compute_dtype", "float32")
        if dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {dtype!r}: want one of {sorted(_DTYPES)}")
        return cls(
            input_dim=input_dim,
            num_labels=num_labels,
            num_hidden_layers=int(conf.get("num_hidden_layers", 5)),
            num_hidden_units=int(conf.get("num_hidden_units", 512)),
            context=conf.get("tdnn_context", cls.context),
            nonlin=conf.get("nonlin", "relu"),
            batch_norm=str(conf.get("batch_norm", "True")) == "True",
            dropout=float(conf.get("dropout", 1)),
            compute_dtype=_DTYPES[dtype],
        )

    @property
    def offsets(self) -> tuple[tuple[int, ...], ...]:
        return parse_context(self.context, self.num_hidden_layers)


def _shift(x: torch.Tensor, offset: int) -> torch.Tensor:
    """``y[:, t] = x[:, t + offset]`` with zero fill at the edges, ``[B, T,
    F]`` (a static pad and slice, no gather)."""
    if offset == 0:
        return x
    if offset > 0:
        return F.pad(x[:, offset:], (0, 0, 0, offset))
    return F.pad(x[:, :offset], (0, 0, -offset, 0))


class TDNN(nn.Module):
    """``forward(inputs [B, T, F], lengths [B], *, train=False,
    generator=None)`` → logits ``[B, T, num_labels]`` float32. Rows past
    ``lengths`` never change real rows, in training and in eval."""

    def __init__(self, config: TDNNConfig):
        super().__init__()
        if config.nonlin not in ("relu", "sigmoid", "tanh", "linear"):
            raise ValueError(f"unknown nonlinearity {config.nonlin!r}")
        self.config = config
        cfg = config
        h = cfg.num_hidden_units
        fan_ins = [cfg.input_dim] + [h] * (cfg.num_hidden_layers - 1)
        self.hidden = nn.ModuleList(
            _Layer(f * len(offs), h, cfg.batch_norm) for f, offs in zip(fan_ins, cfg.offsets)
        )
        self.out = _Layer(h, cfg.num_labels, batch_norm=False)
        self.tp = None  # the grid whose model group splits the layers (parallel.mesh.shard_state)
        self.register_buffer("depth", torch.zeros((), dtype=torch.int32))
        if cfg.batch_norm:
            self.register_buffer("bn_mean", torch.zeros(cfg.num_hidden_layers, h))
            self.register_buffer("bn_var", torch.ones(cfg.num_hidden_layers, h))

    @property
    def left_receptive(self) -> int:
        """Input frames before ``t`` that output ``t`` depends on (the summed
        negative reach of the layers' offsets)."""
        return sum(max(0, -min(layer)) for layer in self.config.offsets)

    @property
    def right_receptive(self) -> int:
        """Input frames after ``t`` that output ``t`` depends on."""
        return sum(max(0, max(layer)) for layer in self.config.offsets)

    # ------------------------------------------------------------------
    # parameters (models/tdnn.py:129-166)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX ``init``: hidden weights ~ N(0, 1/sqrt(fan_in)) with
        ``fan_in`` the spliced width, drawn on the CPU from ``generator``;
        zero biases and ``beta``, a zero output layer, depth 0, moving stats
        (0, 1)."""
        for layer in self.hidden:
            fan_in = layer.w.shape[0]
            layer.w.copy_(torch.randn(layer.w.shape, generator=generator) * (1.0 / math.sqrt(fan_in)))
            layer.b.zero_()
            if self.config.batch_norm:
                layer.beta.zero_()
        self.reinit_output_layer()
        self.depth.zero_()
        if self.config.batch_norm:
            self.bn_mean.zero_()
            self.bn_var.fill_(1.0)

    @torch.no_grad()
    def reinit_output_layer(self) -> None:
        """Re-zero the output layer (its init is all zeros)."""
        self.out.w.zero_()
        self.out.b.zero_()

    # ------------------------------------------------------------------
    # forward (models/tdnn.py:171-238)
    # ------------------------------------------------------------------

    def forward(
        self,
        inputs: torch.Tensor,
        lengths: torch.Tensor,
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        cfg = self.config
        cd = cfg.compute_dtype
        b, t, _ = inputs.shape
        frames = torch.arange(t, device=inputs.device)[None, :]
        mask_bt = (frames < lengths.to(inputs.device)[:, None]).float()
        mask = mask_bt.reshape(b * t)
        # zero the padding rows before the first splice
        h = (inputs * mask_bt[:, :, None]).to(cd)
        tp = self.tp
        for l, (layer, offs) in enumerate(zip(self.hidden, cfg.offsets)):
            if tp is not None and l > 0:
                h = comm.gather_columns(h, tp)
            spliced = torch.cat([_shift(h, o) for o in offs], dim=-1) if offs != (0,) else h
            z = affine(spliced.reshape(b * t, -1), layer.w, layer.b, cd)
            if cfg.batch_norm:
                z = masked_batchnorm(z, mask, layer.beta, self.bn_mean[l], self.bn_var[l], train=train,
                                     eps=cfg.bn_eps, decay=cfg.bn_decay)
            z = _nonlin(z, cfg.nonlin)
            if train and cfg.dropout < 1:
                if generator is None:
                    raise ValueError("dropout requires a generator in training mode")
                keep = dropout_keep(z, b, t, cfg.dropout, generator, tp)
                z = torch.where(keep, z / cfg.dropout, 0.0)
            # padding frames stay zero, so the next layer's shifts read zeros there
            h = z.reshape(b, t, -1) * mask_bt[:, :, None].to(z.dtype)
        # compute-dtype operands, f32 result and bias: unlike the DNN's, these
        # logits are not rounded to the compute dtype (models/tdnn.py:232-238)
        logits = product(h.reshape(b * t, -1), self.out.w, cd)
        if tp is not None:
            logits = comm.reduce_from_model(logits, tp)
        logits = logits + self.out.b.float()
        return logits.reshape(b, t, cfg.num_labels)

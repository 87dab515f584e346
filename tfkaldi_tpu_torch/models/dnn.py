"""Fully-connected DNN acoustic model: init, the training forward and the
eval forward.

Port of :mod:`tfkaldi_tpu.models.dnn`. Per hidden layer, in the
reference's fixed order: affine → batchnorm → nonlinearity → l2-norm →
dropout. With layerwise init a ``depth`` counter selects the hidden
activation that feeds the output layer. Parameters keep the JAX package's
layout (``w`` is ``[fan_in, fan_out]``) so that
:func:`tfkaldi_tpu_torch.convert.dnn_from_jax` copies them as they are.

Training (``train=True``): batchnorm uses the masked batch moments (f32)
and updates the moving stats in place as ``moving·decay + batch·(1−decay)``.
Every relu+batchnorm layer with no l2-norm and no dropout runs through
:class:`tfkaldi_tpu_torch.ops.bn_fused_bwd.BnReluLayer`, whose backward is
the hand-written ``bn_dgrad`` kernel on a card; the kernel masks its edges,
so no shape gate applies. Every other chain runs as plain autograd.

Eval (``train=False``): hidden layers whose chain fits the fused epilogue
(relu or linear, no l2-norm) run through
:func:`tfkaldi_tpu_torch.ops.fused_mlp.fused_ffn_block`; any other chain
runs as plain tensor code. Callers run it under ``torch.inference_mode()``.
The output layer is a plain ``torch.matmul`` in both modes, as the JAX
package leaves it outside any kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from tfkaldi_tpu_torch.layers import affine, batchnorm, masked_moments
from tfkaldi_tpu_torch.ops.bn_fused_bwd import BnReluLayer
from tfkaldi_tpu_torch.ops.fused_mlp import fused_ffn_block

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DNNConfig:
    input_dim: int
    num_labels: int
    num_hidden_layers: int = 6
    num_hidden_units: int = 2048
    nonlin: str = "relu"  # relu | sigmoid | tanh | linear
    batch_norm: bool = False
    l2_norm: bool = False
    dropout: float = 1.0  # keep probability, reference semantics (nnet.py:70)
    layerwise_init: bool = False
    compute_dtype: torch.dtype = torch.float32
    bn_eps: float = 1e-3
    bn_decay: float = 0.999

    @classmethod
    def from_config(cls, conf: dict, input_dim: int, num_labels: int) -> "DNNConfig":
        """Build from a reference-style ``[nnet]`` section dict (the keys the
        JAX package reads; ``use_pallas_ffn``/``fused_bn_bwd`` select TPU
        kernels: the port always takes its kernels where the chain fits)."""
        dtype = conf.get("compute_dtype", "float32")
        if dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {dtype!r}: want one of {sorted(_DTYPES)}")
        return cls(
            input_dim=input_dim,
            num_labels=num_labels,
            num_hidden_layers=int(conf.get("num_hidden_layers", 6)),
            num_hidden_units=int(conf.get("num_hidden_units", 2048)),
            nonlin=conf.get("nonlin", "relu"),
            batch_norm=str(conf.get("batch_norm", "False")) == "True",
            l2_norm=str(conf.get("l2_norm", "False")) == "True",
            dropout=float(conf.get("dropout", 1)),
            layerwise_init=int(conf.get("add_layer_period", 0)) > 0,
            compute_dtype=_DTYPES[dtype],
        )


class _Layer(nn.Module):
    def __init__(self, fan_in: int, fan_out: int, batch_norm: bool):
        super().__init__()
        self.w = nn.Parameter(torch.empty(fan_in, fan_out))
        self.b = nn.Parameter(torch.zeros(fan_out))
        if batch_norm:
            self.beta = nn.Parameter(torch.zeros(fan_out))


class DNN(nn.Module):
    """``forward(inputs [B, T, F], lengths [B], *, train=False,
    generator=None)`` → logits ``[B, T, num_labels]`` float32. In eval
    frames are independent, so rows past ``lengths`` never change real rows;
    in training ``lengths`` masks the batchnorm moments. ``generator``
    draws the dropout masks (training with ``dropout < 1`` only)."""

    def __init__(self, config: DNNConfig):
        super().__init__()
        if config.nonlin not in ("relu", "sigmoid", "tanh", "linear"):
            raise ValueError(f"unknown nonlinearity {config.nonlin!r}")
        self.config = config
        cfg = config
        fan_ins = [cfg.input_dim] + [cfg.num_hidden_units] * (cfg.num_hidden_layers - 1)
        self.hidden = nn.ModuleList(
            _Layer(f, cfg.num_hidden_units, cfg.batch_norm) for f in fan_ins
        )
        self.out = _Layer(cfg.num_hidden_units, cfg.num_labels, batch_norm=False)
        self.register_buffer("depth", torch.zeros((), dtype=torch.int32))
        if cfg.batch_norm:
            shape = (cfg.num_hidden_layers, cfg.num_hidden_units)
            self.register_buffer("bn_mean", torch.zeros(shape))
            self.register_buffer("bn_var", torch.ones(shape))

    # ------------------------------------------------------------------
    # parameters (models/dnn.py:95-137)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX ``init``: hidden weights ~ N(0, 1/sqrt(fan_in)) drawn on
        the CPU from ``generator`` (so every device gets the same numbers),
        zero biases and ``beta``, a zero output layer, depth 0, moving stats
        (0, 1)."""
        for layer in self.hidden:
            fan_in, fan_out = layer.w.shape
            w = torch.randn(fan_in, fan_out, generator=generator) * (1.0 / math.sqrt(fan_in))
            layer.w.copy_(w)
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
        """The layerwise ``init`` control op (dnn.py:112-122): re-zero the
        output layer (its init is all zeros)."""
        self.out.w.zero_()
        self.out.b.zero_()

    def _selected_layers(self) -> int:
        """Hidden layers that reach the output (the depth selector,
        models/dnn.py:275-282)."""
        cfg = self.config
        if not cfg.layerwise_init:
            return cfg.num_hidden_layers
        return min(max(int(self.depth), 0), cfg.num_hidden_layers - 1) + 1

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------

    def forward(
        self,
        inputs: torch.Tensor,
        lengths: torch.Tensor | None = None,
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        if train:
            return self._train_forward(inputs, lengths, generator)
        return self._eval_forward(inputs)

    def _train_forward(self, inputs, lengths, generator):
        cfg = self.config
        b, t, f = inputs.shape
        if lengths is None:
            raise ValueError("training needs lengths (they mask the batchnorm moments)")
        x = inputs.reshape(b * t, f)
        frames = torch.arange(t, device=inputs.device)[None, :]
        mask = (frames < lengths.to(inputs.device)[:, None]).reshape(b * t).float()
        cd = cfg.compute_dtype
        fuse_bn = cfg.batch_norm and cfg.nonlin == "relu" and not cfg.l2_norm and not cfg.dropout < 1
        activations = []
        h = x
        # every layer runs (the JAX package stacks them all and selects by
        # depth), so every layer's moving stats update as they do there
        for l, layer in enumerate(self.hidden):
            if fuse_bn:
                z, mean_b, var_b = BnReluLayer.apply(h.to(cd), layer.w, layer.b, layer.beta, mask, cfg.bn_eps)
                self._update_moving(l, mean_b, var_b)
            else:
                z = affine(h, layer.w, layer.b, cd)
                if cfg.batch_norm:
                    zf = z.float()
                    mean_b, var_b, _ = masked_moments(zf, mask)
                    z = batchnorm(zf, mean_b, var_b, layer.beta, cfg.bn_eps, cd)
                    self._update_moving(l, mean_b, var_b)
                z = _nonlin(z, cfg.nonlin)
                if cfg.l2_norm:
                    z = _l2_norm(z)
                if cfg.dropout < 1:
                    if generator is None:
                        raise ValueError("dropout requires a generator in training mode")
                    keep = torch.rand(z.shape, generator=generator, device=z.device) < cfg.dropout
                    z = torch.where(keep, z / cfg.dropout, 0.0)
            activations.append(z)
            h = z
        h = activations[self._selected_layers() - 1]
        logits = affine(h, self.out.w, self.out.b, cd)
        return logits.float().reshape(b, t, cfg.num_labels)

    @torch.no_grad()
    def _update_moving(self, l: int, mean_b, var_b) -> None:
        """``moving·decay + batch·(1−decay)`` in f32, in place
        (models/dnn.py:238-243, 329-330)."""
        d = self.config.bn_decay
        self.bn_mean[l].copy_(self.bn_mean[l] * d + mean_b * (1.0 - d))
        self.bn_var[l].copy_(self.bn_var[l] * d + var_b * (1.0 - d))

    def _eval_forward(self, inputs):
        cfg = self.config
        b, t, f = inputs.shape
        h = inputs.reshape(b * t, f)
        # layers past the depth selector do not reach the output, so they
        # are not computed
        n_layers = self._selected_layers()
        fused = not cfg.l2_norm and cfg.nonlin in ("relu", "linear")
        for l in range(n_layers):
            layer = self.hidden[l]
            scale = shift = None
            if cfg.batch_norm:
                scale = torch.rsqrt(self.bn_var[l] + cfg.bn_eps)
                shift = layer.beta - self.bn_mean[l] * scale
            if fused:
                h = fused_ffn_block(
                    h.to(cfg.compute_dtype), layer.w.to(cfg.compute_dtype), layer.b,
                    scale, shift, relu=cfg.nonlin == "relu",
                )
                continue
            z = affine(h, layer.w, layer.b, cfg.compute_dtype)
            if cfg.batch_norm:  # eval BN on the moving stats (activation.py:145-161)
                z = ((z.float() - self.bn_mean[l]) * scale + layer.beta).to(z.dtype)
            z = _nonlin(z, cfg.nonlin)
            if cfg.l2_norm:
                z = _l2_norm(z)
            h = z
        logits = affine(h, self.out.w, self.out.b, cfg.compute_dtype)
        return logits.float().reshape(b, t, cfg.num_labels)


def _nonlin(z, kind: str):
    if kind == "relu":
        return torch.relu(z)
    if kind == "sigmoid":
        return torch.sigmoid(z)
    if kind == "tanh":
        return torch.tanh(z)
    return z  # linear


def _l2_norm(z):
    """Divide by the per-frame mean square where it exceeds 1
    (activation.py:87-111; mean square, not RMS)."""
    sig = torch.mean(torch.square(z.float()), dim=1, keepdim=True)
    return torch.where(sig > 1, z / sig.to(z.dtype), z)

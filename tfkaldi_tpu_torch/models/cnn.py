"""Convolutional acoustic model: a 2D conv stack over (time, frequency),
then a dense stack.

Port of :mod:`tfkaldi_tpu.models.cnn` (``_parse_int_list``,
``_parse_kernels``, ``CNNConfig`` and ``CNN``: ``init``,
``reinit_output_layer`` and ``apply``). Activations keep the JAX model's
NHWC layout ``[B, T(H), F(W), C]`` between ops; each convolution hands
``F.conv2d`` the permuted view (a channels-last NCHW tensor) and permutes
its output back, so nothing else moves and the flatten before the dense
stack is W-major then C, as in JAX. Conv weights are stored OIHW
``[C_out, C_in, kt, kf]`` (:func:`tfkaldi_tpu_torch.convert.cnn_from_jax`
transposes JAX's HWIO); every other parameter keeps the JAX layout.

Where the arithmetic must follow the JAX model step by step:

- the splice copies become input channels, ``[B, T, S·F] → [B, T, F, S]``,
  and padding frames enter as zeros and are zeroed again after every
  layer;
- SAME padding is explicit, XLA's rule: ``(k-1)//2`` zeros low and
  ``k//2`` high on time and frequency, so even kernels pad as JAX does;
- a conv runs in the compute dtype and returns it (in bf16 its weight
  gradient is bf16 too, as ``lax.conv``'s VJP); the bias is added in f32,
  the per-channel masked batchnorm (over ``[B·T·W, C]``) runs in f32, and
  the result is rounded to the compute dtype before the nonlinearity;
- max-pooling is over frequency only, stride = window, VALID: ``amax``
  over non-overlapping bands, which splits a tie's gradient evenly, as
  JAX's ``max`` does;
- the dense stack's batchnorm runs on the f32 ``x@w + b`` and the rounding
  to the compute dtype comes after it (unlike the DNN and TDNN layers,
  which round before batchnorm); the logits are f32, not rounded.

No hand kernel lies on this path: the JAX model computes its convolutions
and products outside Pallas. Split over a grid's model group (``tp``, set
by :func:`tfkaldi_tpu_torch.parallel.mesh.shard_state`) the conv stack is
replicated and the dense stack splits as the DNN's: hidden columns in
blocks, the output rows in blocks (when there is a dense stack). Every entry point resolves its device through
:func:`tfkaldi_tpu_torch.device.resolve_device`, which pins TF32 off for
cuDNN's convolutions.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from tfkaldi_tpu_torch.layers import product
from tfkaldi_tpu_torch.models.dnn import _DTYPES, _Layer, _nonlin, dropout_keep, masked_batchnorm
from tfkaldi_tpu_torch.parallel import comm


def _parse_int_list(spec: str, name: str) -> tuple[int, ...]:
    vals = tuple(int(tok) for tok in spec.replace(" ", "").split(",") if tok)
    if not vals:
        raise ValueError(f"empty {name} spec: {spec!r}")
    return vals


def _parse_kernels(spec: str, n_layers: int) -> tuple[tuple[int, int], ...]:
    """``"9x3;3x3"`` → ((9, 3), (3, 3)); short specs repeat the last entry."""
    groups = [g for g in spec.replace(" ", "").split(";") if g]
    if not groups:
        raise ValueError(f"empty cnn kernel spec: {spec!r}")
    kernels = []
    for g in groups:
        parts = g.split("x")
        if len(parts) != 2:
            raise ValueError(f"kernel {g!r} must be TIMExFREQ, e.g. 9x3")
        kernels.append((int(parts[0]), int(parts[1])))
    while len(kernels) < n_layers:
        kernels.append(kernels[-1])
    return tuple(kernels[:n_layers])


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    input_dim: int  # spliced dim = num_channels * freq_dim
    num_labels: int
    filters: str = "64,128"  # out-channels per conv layer
    kernels: str = "9x3;3x3"  # TIMExFREQ per conv layer
    pool: str = "3,1"  # freq-only max-pool window (= stride) per conv layer
    num_channels: int = 1  # input channels (2*context_width+1 splice copies)
    num_hidden_layers: int = 4
    num_hidden_units: int = 1024
    nonlin: str = "relu"
    batch_norm: bool = True
    dropout: float = 1.0  # keep probability, reference semantics (nnet.py:70)
    compute_dtype: torch.dtype = torch.float32
    bn_eps: float = 1e-3
    bn_decay: float = 0.999

    @classmethod
    def from_config(cls, conf: dict, input_dim: int, num_labels: int, num_channels: int = 1) -> "CNNConfig":
        """Build from a reference-style ``[nnet]`` section dict (the keys of
        models/cnn.py:97-114: ``cnn_filters``, ``cnn_kernels``,
        ``cnn_pool`` and the dense stack's)."""
        dtype = conf.get("compute_dtype", "float32")
        if dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {dtype!r}: want one of {sorted(_DTYPES)}")
        return cls(
            input_dim=input_dim,
            num_labels=num_labels,
            filters=conf.get("cnn_filters", cls.filters),
            kernels=conf.get("cnn_kernels", cls.kernels),
            pool=conf.get("cnn_pool", cls.pool),
            num_channels=num_channels,
            num_hidden_layers=int(conf.get("num_hidden_layers", 4)),
            num_hidden_units=int(conf.get("num_hidden_units", 1024)),
            nonlin=conf.get("nonlin", "relu"),
            batch_norm=str(conf.get("batch_norm", "True")) == "True",
            dropout=float(conf.get("dropout", 1)),
            compute_dtype=_DTYPES[dtype],
        )

    @property
    def conv_filters(self) -> tuple[int, ...]:
        return _parse_int_list(self.filters, "cnn filters")

    @property
    def conv_kernels(self) -> tuple[tuple[int, int], ...]:
        return _parse_kernels(self.kernels, len(self.conv_filters))

    @property
    def conv_pools(self) -> tuple[int, ...]:
        pools = _parse_int_list(self.pool, "cnn pool")
        n = len(self.conv_filters)
        return (pools + (pools[-1],) * n)[:n]

    @property
    def freq_dim(self) -> int:
        if self.input_dim % self.num_channels:
            raise ValueError(
                f"input dim {self.input_dim} not divisible by {self.num_channels} splice channels"
            )
        return self.input_dim // self.num_channels

    def conv_output_dim(self) -> int:
        """Flattened (freq × channels) dim after the conv stack."""
        w = self.freq_dim
        for p in self.conv_pools:
            if p > 1:
                w = (w - p) // p + 1
            if w < 1:
                raise ValueError(f"freq dim pooled away: freq_dim={self.freq_dim}, pool={self.pool}")
        return w * self.conv_filters[-1]


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kt: int, kf: int, batch_norm: bool):
        super().__init__()
        self.w = nn.Parameter(torch.empty(c_out, c_in, kt, kf))  # OIHW
        self.b = nn.Parameter(torch.zeros(c_out))
        if batch_norm:
            self.beta = nn.Parameter(torch.zeros(c_out))


class _Stats(nn.Module):
    """One moving-stat buffer per conv layer (channel counts differ), named
    ``0``, ``1``, …: the JAX state's per-layer lists."""

    def __init__(self, sizes, fill: float):
        super().__init__()
        for l, n in enumerate(sizes):
            self.register_buffer(str(l), torch.full((n,), fill))

    def __getitem__(self, l: int) -> torch.Tensor:
        return getattr(self, str(l))


def same_padding(k: int) -> tuple[int, int]:
    """XLA's SAME padding of a stride-1 kernel of size ``k``: (low, high)."""
    return (k - 1) // 2, k // 2


class CNN(nn.Module):
    """``forward(inputs [B, T, S·F], lengths [B], *, train=False,
    generator=None)`` → logits ``[B, T, num_labels]`` float32. Rows past
    ``lengths`` never change real rows, in training and in eval."""

    def __init__(self, config: CNNConfig):
        super().__init__()
        if config.nonlin not in ("relu", "sigmoid", "tanh", "linear"):
            raise ValueError(f"unknown nonlinearity {config.nonlin!r}")
        self.config = config
        cfg = config
        filters = cfg.conv_filters
        c_ins = (cfg.num_channels,) + filters[:-1]
        self.conv = nn.ModuleList(
            _ConvLayer(c_in, c_out, kt, kf, cfg.batch_norm)
            for c_in, c_out, (kt, kf) in zip(c_ins, filters, cfg.conv_kernels)
        )
        h = cfg.num_hidden_units
        fan_ins = [cfg.conv_output_dim()] + [h] * (cfg.num_hidden_layers - 1)
        self.hidden = nn.ModuleList(_Layer(f, h, cfg.batch_norm) for f in fan_ins[: cfg.num_hidden_layers])
        out_in = h if cfg.num_hidden_layers > 0 else cfg.conv_output_dim()
        self.out = _Layer(out_in, cfg.num_labels, batch_norm=False)
        self.tp = None  # the grid whose model group splits the dense stack (parallel.mesh.shard_state)
        self.register_buffer("depth", torch.zeros((), dtype=torch.int32))
        if cfg.batch_norm:
            self.bn_conv_mean = _Stats(filters, 0.0)
            self.bn_conv_var = _Stats(filters, 1.0)
            self.register_buffer("bn_mean", torch.zeros(cfg.num_hidden_layers, h))
            self.register_buffer("bn_var", torch.ones(cfg.num_hidden_layers, h))

    @property
    def left_receptive(self) -> int:
        """Input frames before ``t`` that output ``t`` depends on: SAME
        padding puts ``(k-1)//2`` zeros low per time kernel."""
        return sum(same_padding(kt)[0] for kt, _ in self.config.conv_kernels)

    @property
    def right_receptive(self) -> int:
        """Input frames after ``t`` that output ``t`` depends on."""
        return sum(same_padding(kt)[1] for kt, _ in self.config.conv_kernels)

    # ------------------------------------------------------------------
    # parameters (models/cnn.py:174-240)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX ``init``: conv weights ~ N(0, 1/sqrt(kt·kf·C_in)) and
        dense weights ~ N(0, 1/sqrt(fan_in)), drawn on the CPU from
        ``generator``; zero biases and ``beta``, a zero output layer, depth
        0, moving stats (0, 1)."""
        for layer in (*self.conv, *self.hidden):
            fan_in = layer.w[0].numel() if layer.w.dim() == 4 else layer.w.shape[0]
            layer.w.copy_(torch.randn(layer.w.shape, generator=generator) * (1.0 / math.sqrt(fan_in)))
            layer.b.zero_()
            if self.config.batch_norm:
                layer.beta.zero_()
        self.reinit_output_layer()
        self.depth.zero_()
        if self.config.batch_norm:
            for l in range(len(self.conv)):
                self.bn_conv_mean[l].zero_()
                self.bn_conv_var[l].fill_(1.0)
            self.bn_mean.zero_()
            self.bn_var.fill_(1.0)

    @torch.no_grad()
    def reinit_output_layer(self) -> None:
        """Re-zero the output layer (its init is all zeros)."""
        self.out.w.zero_()
        self.out.b.zero_()

    # ------------------------------------------------------------------
    # forward (models/cnn.py:244-359)
    # ------------------------------------------------------------------

    def _dropout(self, z, train: bool, generator, b: int, t: int):
        """Dropout of a conv activation ``[b, t, W, C]`` (replicated) or a
        dense one ``[b·t, C]`` (a column block under ``tp``)."""
        p = self.config.dropout
        if not (train and p < 1):
            return z
        if generator is None:
            raise ValueError("dropout requires a generator in training mode")
        if z.dim() == 2:
            keep = dropout_keep(z, b, t, p, generator, self.tp)
        else:
            keep = comm.keep_mask(z.shape, p, generator, z.device)
        return torch.where(keep, z / p, 0.0)

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
        h = self.conv_stack(inputs, lengths, train=train, generator=generator)
        mask = (torch.arange(t, device=inputs.device)[None, :] < lengths.to(inputs.device)[:, None])
        mask = mask.reshape(b * t).float()
        tp = self.tp
        if tp is not None and len(self.hidden):
            # the replicated conv features feed column blocks: their cotangent
            # is summed over the model group (Megatron's f)
            h = comm.copy_to_model(h, tp)
        for l, layer in enumerate(self.hidden):
            if tp is not None and l > 0:
                h = comm.gather_columns(h, tp)
            z = product(h, layer.w, cd) + layer.b.float()
            if cfg.batch_norm:  # on the f32 z; the rounding comes after (models/cnn.py:326-342)
                z = masked_batchnorm(z, mask, layer.beta, self.bn_mean[l], self.bn_var[l], train=train,
                                     eps=cfg.bn_eps, decay=cfg.bn_decay)
            z = _nonlin(z.to(cd), cfg.nonlin)
            z = self._dropout(z, train, generator, b, t)
            h = z * mask[:, None].to(z.dtype)
        logits = product(h, self.out.w, cd)
        if tp is not None and len(self.hidden):
            logits = comm.reduce_from_model(logits, tp)
        logits = logits + self.out.b.float()
        return logits.reshape(b, t, cfg.num_labels)

    def conv_stack(
        self,
        inputs: torch.Tensor,
        lengths: torch.Tensor,
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """The conv layers of :meth:`forward`: ``[B, T, S·F]`` →
        ``[B·T, W·C]`` in the compute dtype, flattened W-major then C."""
        cfg = self.config
        cd = cfg.compute_dtype
        b, t, _ = inputs.shape
        frames = torch.arange(t, device=inputs.device)[None, :]
        mask_bt = (frames < lengths.to(inputs.device)[:, None]).float()
        # splice copies → channels: [B, T, S, F] → NHWC [B, T, F, S]
        h = inputs.reshape(b, t, cfg.num_channels, cfg.freq_dim).permute(0, 1, 3, 2).to(cd)
        h = h * mask_bt[:, :, None, None].to(cd)
        for l, (layer, (kt, kf), p) in enumerate(zip(self.conv, cfg.conv_kernels, cfg.conv_pools)):
            padded = F.pad(h, (0, 0, *same_padding(kf), *same_padding(kt)))
            z = F.conv2d(padded.permute(0, 3, 1, 2), layer.w.to(cd)).permute(0, 2, 3, 1)
            z = z.float() + layer.b
            if cfg.batch_norm:
                w_now, c = z.shape[2], z.shape[3]
                m = mask_bt[:, :, None].expand(b, t, w_now).reshape(-1)
                z = masked_batchnorm(z.reshape(-1, c), m, layer.beta, self.bn_conv_mean[l], self.bn_conv_var[l],
                                     train=train, eps=cfg.bn_eps, decay=cfg.bn_decay).reshape(z.shape)
            z = _nonlin(z.to(cd), cfg.nonlin)
            if p > 1:  # frequency-only max-pool: stride = window, VALID
                w_out = (z.shape[2] - p) // p + 1
                z = z[:, :, : w_out * p].reshape(b, t, w_out, p, z.shape[-1]).amax(dim=3)
            z = self._dropout(z, train, generator, b, t)
            h = z * mask_bt[:, :, None, None].to(z.dtype)
        # flatten (freq, channels), W-major then C as JAX does
        return h.reshape(b * t, -1)

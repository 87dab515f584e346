"""Recurrent acoustic models (LSTM, GRU) under frame cross-entropy.

Port of :mod:`tfkaldi_tpu.models.rnn` (``RNNConfig``, ``LSTM``, ``GRU``:
``init``, ``reinit_output_layer`` and ``apply``). Parameters keep the JAX
pytree's layout, ``layers.{l}.{d}.{wx,wh,b}`` and ``out.{w,b}`` with every
weight ``[fan_in, fan_out]``, so :func:`tfkaldi_tpu_torch.convert.rnn_from_jax`
copies them as they are. Per layer and direction:

- the whole-sequence input projection ``gx = x_cd @ wx_cd + b`` in f32
  (``[T·B, F] @ [F, G·H]``, one ``torch.matmul`` of operands widened to
  f32);
- the recurrence through :func:`tfkaldi_tpu_torch.ops.rnn_bidi.run` with
  the LSTM's cell (kernels 4 and 5) or the GRU's (kernels 6 and 7), both
  directions of a bidirectional layer in one kernel: one persistent
  launch per layer call for the forward and for the backward; a
  unidirectional layer passes one direction to the same kernels;
- dropout between layers in training only, masks drawn from the trainer's
  generator (the bits are the port's own; JAX's threefry stream does not
  carry over).

The mask freezes the carry past each utterance's end, so logits at real
frames do not depend on the padding. The output layer takes compute-dtype
operands and adds an f32 bias. ``scan_unroll`` and ``scan_impl`` are read
and ignored: the port always takes its kernels.

Streaming, for unidirectional models: :meth:`LSTM.init_stream_carry`,
:meth:`LSTM.apply_stream` and :meth:`LSTM.merge_stream_carry` (the
transducer's prediction network steps through them in decode, and the
online CTC decoders and the multi-stream server through all three). They
are the plain torch form of the JAX package's XLA step
(models/rnn.py:203-277, 386-420), which reaches no Pallas kernel either:
per layer one :func:`~tfkaldi_tpu_torch.layers.product` for ``gx``, then
per frame ``round_cd(h) @ W_h`` in f32 and the masked update from the
given carry (kernels 4-7 start from a zero carry).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from tfkaldi_tpu_torch.layers import product
from tfkaldi_tpu_torch.ops import gru_bidi, lstm_bidi, rnn_bidi
from tfkaldi_tpu_torch.parallel import comm

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class RNNConfig:
    input_dim: int
    num_labels: int
    num_layers: int = 2
    hidden_units: int = 512
    bidirectional: bool = False
    dropout: float = 1.0  # keep probability, reference semantics (nnet.py:70)
    compute_dtype: torch.dtype = torch.float32
    cell: str = "lstm"  # lstm | gru (the JAX package picks the class instead)

    @classmethod
    def from_config(cls, conf: dict, input_dim: int, num_labels: int) -> "RNNConfig":
        """Build from a reference-style ``[nnet]`` section dict (the keys of
        models/rnn.py:70-82, and ``model`` for the cell)."""
        dtype = conf.get("compute_dtype", "float32")
        if dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {dtype!r}: want one of {sorted(_DTYPES)}")
        cell = conf.get("model", "lstm")
        if cell not in ("lstm", "gru"):
            raise ValueError(f"RNNConfig: model {cell!r} is not a recurrent cell (lstm, gru)")
        return cls(
            input_dim=input_dim,
            num_labels=num_labels,
            num_layers=int(conf.get("num_hidden_layers", 2)),
            hidden_units=int(conf.get("num_hidden_units", 512)),
            bidirectional=str(conf.get("bidirectional", "False")) == "True",
            dropout=float(conf.get("dropout", 1)),
            compute_dtype=_DTYPES[dtype],
            cell=cell,
        )


class _Direction(nn.Module):
    def __init__(self, fan_in: int, gate_units: int, hidden_units: int):
        super().__init__()
        self.wx = nn.Parameter(torch.empty(fan_in, gate_units))
        self.wh = nn.Parameter(torch.empty(hidden_units, gate_units))
        self.b = nn.Parameter(torch.zeros(gate_units))


class _Output(nn.Module):
    def __init__(self, fan_in: int, num_labels: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, num_labels))
        self.b = nn.Parameter(torch.zeros(num_labels))


class LSTM(nn.Module):
    """``forward(inputs [B, T, F], lengths [B], *, train=False,
    generator=None)`` → logits ``[B, T, num_labels]`` float32."""

    GATES = 4  # i, f, g, o; the GRU narrows to 3 (r, z, n)
    CARRIES = 2  # (h, c); the GRU carries h alone
    CELL = lstm_bidi.CELL

    def __init__(self, config: RNNConfig):
        super().__init__()
        self.config = config
        cfg = config
        directions = 2 if cfg.bidirectional else 1
        h = cfg.hidden_units
        fan_ins = [cfg.input_dim] + [h * directions] * (cfg.num_layers - 1)
        self.layers = nn.ModuleList(
            nn.ModuleList(_Direction(f, self.GATES * h, h) for _ in range(directions)) for f in fan_ins
        )
        self.out = _Output(h * directions, cfg.num_labels)

    # ------------------------------------------------------------------
    # parameters (models/rnn.py:100-140)
    # ------------------------------------------------------------------

    def _init_bias(self, b: torch.Tensor) -> None:
        h = self.config.hidden_units
        b.zero_()
        b[h: 2 * h] = 1.0  # forget-gate bias 1.0

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX ``init``: ``wx ~ N(0, 1)/sqrt(fan_in)`` and ``wh ~ N(0,
        1)/sqrt(H)`` drawn on the CPU from ``generator`` (the same numbers
        on every device), the cell's bias init, a zero output layer."""
        for dirs in self.layers:
            for d in dirs:
                fan_in = d.wx.shape[0]
                h = d.wh.shape[0]
                d.wx.copy_(torch.randn(d.wx.shape, generator=generator) / math.sqrt(fan_in))
                d.wh.copy_(torch.randn(d.wh.shape, generator=generator) / math.sqrt(h))
                self._init_bias(d.b)
        self.reinit_output_layer()

    @torch.no_grad()
    def reinit_output_layer(self) -> None:
        """Re-zero the output layer (its init is all zeros)."""
        self.out.w.zero_()
        self.out.b.zero_()

    # ------------------------------------------------------------------
    # forward (models/rnn.py:144-181, 306-340)
    # ------------------------------------------------------------------

    def _run_layer(self, dirs, x, mask):
        """One (bi)directional layer over ``x [T, B, F]``; returns ``[T, B,
        H·directions]``."""
        cfg = self.config
        t, b, f = x.shape
        x_flat = x.reshape(t * b, f)
        gxs = [(product(x_flat, d.wx, cfg.compute_dtype) + d.b.float()).reshape(t, b, -1) for d in dirs]
        ys = rnn_bidi.run(self.CELL, gxs, [d.wh for d in dirs], mask, cfg.compute_dtype)
        return torch.cat(ys, dim=-1) if len(ys) > 1 else ys[0]

    def forward(
        self,
        inputs: torch.Tensor,
        lengths: torch.Tensor | None = None,
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        cfg = self.config
        b, t, _ = inputs.shape
        if lengths is None:
            raise ValueError("a recurrent model needs lengths (the mask freezes the carry)")
        x = inputs.transpose(0, 1).float()  # [T, B, F]
        frames = torch.arange(t, device=inputs.device)[:, None]
        mask = (frames < lengths.to(inputs.device)[None, :])[:, :, None].float()
        for dirs in self.layers:
            x = self._run_layer(dirs, x, mask)
            if train and cfg.dropout < 1:
                if generator is None:
                    raise ValueError("dropout requires a generator in training mode")
                keep = comm.keep_mask(x.shape, cfg.dropout, generator, x.device, batch_dim=1)
                x = torch.where(keep, x / cfg.dropout, 0.0)
        logits = product(x.reshape(t * b, -1), self.out.w, cfg.compute_dtype) + self.out.b.float()
        return logits.reshape(t, b, cfg.num_labels).transpose(0, 1)

    # ------------------------------------------------------------------
    # streaming (models/rnn.py:203-277)
    # ------------------------------------------------------------------

    def init_stream_carry(self, batch_size: int, device=None) -> list:
        """Zero recurrent state: one tuple of ``[B, H]`` f32 per layer."""
        cfg = self.config
        if cfg.bidirectional:
            raise ValueError("streaming requires a unidirectional model (bidirectional = False): the backward "
                             "direction needs the whole future")
        zeros = torch.zeros(batch_size, cfg.hidden_units, device=device)
        return [(zeros,) * self.CARRIES for _ in range(cfg.num_layers)]

    @staticmethod
    def merge_stream_carry(take_mask, new, old) -> list:
        """Row-wise select over stream carries: rows where ``take_mask``
        (bool ``[B]``) is True take ``new``, the others keep ``old``. Every
        leaf is batch-major ``[B, H]``. The multi-stream server ends or
        re-arms one slot through it without touching the others."""
        mask = torch.as_tensor(take_mask, dtype=torch.bool, device=old[0][0].device)[:, None]
        return [tuple(torch.where(mask, a, b) for a, b in zip(ln, lo)) for ln, lo in zip(new, old)]

    @staticmethod
    def _stream_step(carry, gxt, m, wh_cd):
        h, c = carry
        gi, gf, gg, go = (gxt + product(h, wh_cd, wh_cd.dtype)).split(h.shape[1], dim=1)
        c_cand = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h_cand = torch.sigmoid(go) * torch.tanh(c_cand)
        keep = m != 0
        return (torch.where(keep, h_cand, h), torch.where(keep, c_cand, c))

    def apply_stream(self, chunk: torch.Tensor, seq_lengths, carry) -> tuple[torch.Tensor, list]:
        """One streaming step, eval only: ``chunk [B, Tc, F]`` → ``(logits [B,
        Tc, num_labels] f32, new carry)``. Frames past ``seq_lengths`` leave
        the carry as it was (a row of length 0 keeps its state)."""
        cfg = self.config
        if cfg.bidirectional:
            raise ValueError("streaming requires bidirectional = False")
        cd = cfg.compute_dtype
        b, t, _ = chunk.shape
        x = chunk.transpose(0, 1).float()  # [T, B, F]
        lengths = torch.as_tensor(seq_lengths, device=chunk.device)
        mask = (torch.arange(t, device=chunk.device)[:, None] < lengths[None, :])[:, :, None].float()
        new_carry = []
        for l, dirs in enumerate(self.layers):
            d = dirs[0]
            gx = (product(x.reshape(t * b, -1), d.wx, cd) + d.b.float()).reshape(t, b, -1)
            wh_cd = d.wh.to(cd)
            state, ys = tuple(carry[l]), []
            for s in range(t):
                state = self._stream_step(state, gx[s], mask[s], wh_cd)
                ys.append(state[0] * mask[s])
            new_carry.append(state)
            x = torch.stack(ys)
        logits = product(x.reshape(t * b, -1), self.out.w, cd) + self.out.b.float()
        return logits.reshape(t, b, cfg.num_labels).transpose(0, 1), new_carry


class GRU(LSTM):
    """The GRU acoustic model (``model = gru``): the LSTM's contract with
    the fused (cuDNN) GRU cell, kernels 6 and 7, zero bias init."""

    GATES = 3
    CARRIES = 1
    CELL = gru_bidi.CELL

    def _init_bias(self, b: torch.Tensor) -> None:
        b.zero_()

    @staticmethod
    def _stream_step(carry, gxt, m, wh_cd):
        (h,) = carry
        gh = product(h, wh_cd, wh_cd.dtype)
        hdim = h.shape[1]
        r = torch.sigmoid(gxt[:, :hdim] + gh[:, :hdim])
        z = torch.sigmoid(gxt[:, hdim: 2 * hdim] + gh[:, hdim: 2 * hdim])
        n = torch.tanh(gxt[:, 2 * hdim:] + r * gh[:, 2 * hdim:])
        return (torch.where(m != 0, (1.0 - z) * n + z * h, h),)

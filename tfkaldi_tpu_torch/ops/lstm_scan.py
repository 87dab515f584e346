"""Masked LSTM recurrence of one direction, with its analytic backward.

Port of :mod:`tfkaldi_tpu.ops.lstm_scan` (``lstm_scan``, ``_forward``,
``_backward``), the plain version that defines the numerics kernels 4 and 5
(``ops/csrc/lstm_bidi.cu``) are held to, in the JAX op order:

- forward: ``h`` is rounded to the compute dtype before the recurrent
  product (the rounded stream ``h_cd`` is a residual), the product
  accumulates in f32, gate order i, f, g, o, and ``torch.where`` on the
  mask freezes ``h`` and ``c`` past each utterance's end (a select, so
  garbage in the padding of ``gx`` cannot leak); the step output is
  ``h_t · m_t``;
- ``reverse=True`` walks ``t = T-1 … 0`` with the outputs in natural time
  order;
- backward: the analytic recursion against the scan direction, its one
  product ``round_cd(dgates) @ W_hᵀ`` per step, then ``dW_h`` hoisted out
  as one ``[H, T·B] @ [T·B, 4H]`` product of ``h_cd`` and ``round_cd(dgx)``.

Products take compute-dtype operands and accumulate in f32; the recurrent
ones are :func:`tfkaldi_tpu_torch.layers.widened_product` on a card too, so
that the numerics the kernels are held to stay those of the f32 GEMM.
"""

from __future__ import annotations

import torch

from tfkaldi_tpu_torch.layers import product, widened_product


def forward(gx, wh_cd, mask, *, reverse: bool = False):
    """``gx [T, B, 4H]`` f32, ``wh_cd [H, 4H]`` in the compute dtype, ``mask
    [T, B, 1]`` f32 0/1 → ``(ys, acts, cs, h_cds)``: ``ys [T, B, H]`` f32,
    the post-activation gates ``acts [T, B, 4H]`` f32, the cell stream ``cs
    [T, B, H]`` f32 and the rounded hidden stream ``h_cds [T, B, H]`` in the
    compute dtype, all in natural time order."""
    t_len, b, four_h = gx.shape
    h_units = four_h // 4
    cd = wh_cd.dtype
    keep = mask != 0
    h = gx.new_zeros(b, h_units)
    c = gx.new_zeros(b, h_units)
    ys = gx.new_empty(t_len, b, h_units)
    acts = gx.new_empty(t_len, b, four_h)
    cs = gx.new_empty(t_len, b, h_units)
    h_cds = torch.empty(t_len, b, h_units, dtype=cd, device=gx.device)
    for t in range(t_len - 1, -1, -1) if reverse else range(t_len):
        h_cd = h.to(cd)
        gates = gx[t] + widened_product(h_cd, wh_cd, cd)
        gi, gf, gg, go = gates.split(h_units, dim=1)
        i = torch.sigmoid(gi)
        f = torch.sigmoid(gf)
        g = torch.tanh(gg)
        o = torch.sigmoid(go)
        c_cand = f * c + i * g
        h_cand = o * torch.tanh(c_cand)
        h = torch.where(keep[t], h_cand, h)
        c = torch.where(keep[t], c_cand, c)
        ys[t] = h * mask[t]
        acts[t] = torch.cat([i, f, g, o], dim=1)
        cs[t] = c
        h_cds[t] = h_cd
    return ys, acts, cs, h_cds


def carry_input(stream, *, reverse: bool):
    """The carry stream consumed at each step: ``stream`` shifted one step
    along the scan direction, zeros at its start."""
    zrow = torch.zeros_like(stream[:1])
    if reverse:
        return torch.cat([stream[1:], zrow], dim=0)
    return torch.cat([zrow, stream[:-1]], dim=0)


def backward_scan(dys, acts, cs, mask, wh_cd, *, reverse: bool = False):
    """The reverse recursion of ``lstm_scan._backward``: ``dgx [T, B, 4H]``
    f32 (the cotangent of the pre-activation gates) from ``dys [T, B, H]``
    and the forward's residuals."""
    t_len, b, four_h = acts.shape
    h_units = four_h // 4
    cd = wh_cd.dtype
    c_prev = carry_input(cs, reverse=reverse)
    wht = wh_cd.t()
    dh = dys.new_zeros(b, h_units)
    dc = dys.new_zeros(b, h_units)
    dgx = dys.new_empty(t_len, b, four_h)
    # cotangents flow against the forward direction
    for t in range(t_len) if reverse else range(t_len - 1, -1, -1):
        m = mask[t]
        i, f, g, o = acts[t].split(h_units, dim=1)
        dh_cand = m * (dh + dys[t])
        dh_prev = (1.0 - m) * dh
        dc_cand = m * dc
        dc_prev = (1.0 - m) * dc
        tc = torch.tanh(cs[t])
        do_gate = tc * dh_cand
        dc_cand = dc_cand + o * (1.0 - tc * tc) * dh_cand
        df_gate = c_prev[t] * dc_cand
        dc_prev = dc_prev + f * dc_cand
        di_gate = g * dc_cand
        dg_gate = i * dc_cand
        dgates = torch.cat([
            i * (1.0 - i) * di_gate,
            f * (1.0 - f) * df_gate,
            (1.0 - g * g) * dg_gate,
            o * (1.0 - o) * do_gate,
        ], dim=1)
        dh = dh_prev + widened_product(dgates, wht, cd)
        dc = dc_prev
        dgx[t] = dgates
    return dgx


def weight_grad(h_cds, dg, compute_dtype):
    """``dW_h = Σ_t h_cd_tᵀ @ round_cd(dg_t)`` as one ``[H, T·B] @ [T·B, G·H]``
    product (f32 accumulation; :func:`tfkaldi_tpu_torch.layers.product`,
    as the kernels' autograd Function computes it too)."""
    t_len, b, h_units = h_cds.shape
    return product(h_cds.reshape(t_len * b, h_units).t(), dg.reshape(t_len * b, -1), compute_dtype)


class LSTMScan(torch.autograd.Function):
    """``(gx, wh, mask, compute_dtype, reverse)`` → ``ys``; the gradient of
    ``gx`` and of the f32 master weight ``wh``."""

    @staticmethod
    def forward(ctx, gx, wh, mask, compute_dtype, reverse):
        wh_cd = wh.to(compute_dtype)
        ys, acts, cs, h_cds = forward(gx, wh_cd, mask, reverse=reverse)
        ctx.reverse = reverse
        ctx.wh_dtype = wh.dtype
        ctx.save_for_backward(acts, cs, h_cds, mask, wh_cd)
        return ys

    @staticmethod
    def backward(ctx, dys):
        acts, cs, h_cds, mask, wh_cd = ctx.saved_tensors
        dgx = backward_scan(dys.contiguous(), acts, cs, mask, wh_cd, reverse=ctx.reverse)
        dwh = weight_grad(h_cds, dgx, wh_cd.dtype).to(ctx.wh_dtype)
        return dgx, dwh, None, None, None


def lstm_scan(gx, wh, mask, compute_dtype, reverse: bool = False):
    """Run the masked LSTM recurrence over precomputed gate inputs.

    ``gx [T, B, 4H]`` f32 (input projections plus bias), ``wh [H, 4H]`` f32,
    ``mask [T, B, 1]`` f32 0/1 → ``[T, B, H]`` f32 ``h_t · m_t``."""
    return LSTMScan.apply(gx, wh, mask, compute_dtype, reverse)

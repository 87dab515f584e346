"""Masked GRU recurrence of one direction, with its analytic backward.

Port of :mod:`tfkaldi_tpu.ops.gru_scan`, the plain version that defines the
numerics kernels 6 and 7 (``ops/csrc/gru_bidi.cu``) are held to. The cell
is the fused (cuDNN) formulation, gate order r, z, n:

    r = σ(gx_r + gh_r),  z = σ(gx_z + gh_z),  n = tanh(gx_n + r·gh_n),
    h' = (1 − z)·n + z·h,  gh = round_cd(h) @ W_h

so the recurrent contribution is one ``[B, H] @ [H, 3H]`` product a step.
Residuals: the gates ``acts``, the hidden stream ``hs`` (f32, for the
z-gate cotangent ``h_prev − n``), the rounded stream ``h_cds`` and the
recurrent n projection ``gh_n``. The backward emits ``dgx`` and ``dgh``
(its n block carries the reset-gate factor ``r``); ``dW_h`` contracts
against ``dgh``. Rounding, masking and direction as in
:mod:`tfkaldi_tpu_torch.ops.lstm_scan`.
"""

from __future__ import annotations

import torch

from tfkaldi_tpu_torch.layers import widened_product
from tfkaldi_tpu_torch.ops.lstm_scan import carry_input, weight_grad


def forward(gx, wh_cd, mask, *, reverse: bool = False):
    """``gx [T, B, 3H]`` f32, ``wh_cd [H, 3H]`` in the compute dtype, ``mask
    [T, B, 1]`` → ``(ys, acts, hs, h_cds, ghns)``, natural time order."""
    t_len, b, three_h = gx.shape
    h_units = three_h // 3
    cd = wh_cd.dtype
    keep = mask != 0
    h = gx.new_zeros(b, h_units)
    ys = gx.new_empty(t_len, b, h_units)
    acts = gx.new_empty(t_len, b, three_h)
    hs = gx.new_empty(t_len, b, h_units)
    ghns = gx.new_empty(t_len, b, h_units)
    h_cds = torch.empty(t_len, b, h_units, dtype=cd, device=gx.device)
    for t in range(t_len - 1, -1, -1) if reverse else range(t_len):
        h_cd = h.to(cd)
        ghr, ghz, ghn = widened_product(h_cd, wh_cd, cd).split(h_units, dim=1)
        gxr, gxz, gxn = gx[t].split(h_units, dim=1)
        r = torch.sigmoid(gxr + ghr)
        z = torch.sigmoid(gxz + ghz)
        n = torch.tanh(gxn + r * ghn)
        h_cand = (1.0 - z) * n + z * h
        h = torch.where(keep[t], h_cand, h)
        ys[t] = h * mask[t]
        acts[t] = torch.cat([r, z, n], dim=1)
        hs[t] = h
        h_cds[t] = h_cd
        ghns[t] = ghn
    return ys, acts, hs, h_cds, ghns


def backward_scan(dys, acts, hs, ghns, mask, wh_cd, *, reverse: bool = False):
    """The reverse recursion of ``gru_scan._backward``: ``(dgx, dgh)``, each
    ``[T, B, 3H]`` f32."""
    t_len, b, three_h = acts.shape
    h_units = three_h // 3
    cd = wh_cd.dtype
    h_prev = carry_input(hs, reverse=reverse)
    wht = wh_cd.t()
    dh = dys.new_zeros(b, h_units)
    dgx = dys.new_empty(t_len, b, three_h)
    dgh = dys.new_empty(t_len, b, three_h)
    for t in range(t_len) if reverse else range(t_len - 1, -1, -1):
        m = mask[t]
        r, z, n = acts[t].split(h_units, dim=1)
        dh_cand = m * (dh + dys[t])
        dh_prev = (1.0 - m) * dh
        dn = (1.0 - z) * dh_cand
        dz = (h_prev[t] - n) * dh_cand
        dh_prev = dh_prev + z * dh_cand
        dpre_n = (1.0 - n * n) * dn
        dr = dpre_n * ghns[t]
        dpre_r = r * (1.0 - r) * dr
        dpre_z = z * (1.0 - z) * dz
        dgh_t = torch.cat([dpre_r, dpre_z, dpre_n * r], dim=1)
        dh = dh_prev + widened_product(dgh_t, wht, cd)
        dgx[t] = torch.cat([dpre_r, dpre_z, dpre_n], dim=1)
        dgh[t] = dgh_t
    return dgx, dgh


class GRUScan(torch.autograd.Function):
    """``(gx, wh, mask, compute_dtype, reverse)`` → ``ys``."""

    @staticmethod
    def forward(ctx, gx, wh, mask, compute_dtype, reverse):
        wh_cd = wh.to(compute_dtype)
        ys, acts, hs, h_cds, ghns = forward(gx, wh_cd, mask, reverse=reverse)
        ctx.reverse = reverse
        ctx.wh_dtype = wh.dtype
        ctx.save_for_backward(acts, hs, h_cds, ghns, mask, wh_cd)
        return ys

    @staticmethod
    def backward(ctx, dys):
        acts, hs, h_cds, ghns, mask, wh_cd = ctx.saved_tensors
        dgx, dgh = backward_scan(dys.contiguous(), acts, hs, ghns, mask, wh_cd, reverse=ctx.reverse)
        dwh = weight_grad(h_cds, dgh, wh_cd.dtype).to(ctx.wh_dtype)
        return dgx, dwh, None, None, None


def gru_scan(gx, wh, mask, compute_dtype, reverse: bool = False):
    """Run the masked GRU recurrence over precomputed gate inputs.

    ``gx [T, B, 3H]`` f32, ``wh [H, 3H]`` f32 (gate order r, z, n), ``mask
    [T, B, 1]`` f32 0/1 → ``[T, B, H]`` f32 ``h_t · m_t``."""
    return GRUScan.apply(gx, wh, mask, compute_dtype, reverse)

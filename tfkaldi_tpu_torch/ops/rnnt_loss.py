"""The RNN-T (transducer) lattice loss, dense and pruned, in plain torch.

Port of :mod:`tfkaldi_tpu.ops.rnnt_loss`. The JAX module reaches no
``pallas_call``: this is not a kernel, it *is* the plain form. The alpha
recursion runs one row of the ``(T, U+1)`` lattice at a time in its closed
form,

    alpha[t, u] = C[u] + logcumsumexp(A - C)[u],
    A[u] = alpha[t-1, u] + blank[t-1, u],  C[u] = sum_{j<u} label[t, j],

so the only sequential axis is T: a Python loop of T steps of
``torch.logcumsumexp`` over the label axis. Gradients come from autograd
through the loop. Padding carries ``_NEG = -1e9`` (never ``-inf``, which
makes NaN gradients through the cumulative ops).

The pruned (banded) lattice keeps ``S`` label positions a frame, ``u ∈
[p[t], p[t]+S)``, with band starts from :func:`diagonal_band_starts` or the
two-stage :func:`guided_band_starts`, and runs the same closed form in band
coordinates. Where the JAX module writes a gather as a contraction against
a 0/1 selection mask (the carry shift between bands, the per-sequence
flips of :func:`_proxy_betas`; TPU workarounds, an exact selection in f32
on the CPU), the port gathers, with ``_NEG`` where the index leaves the
range. ``torch.logcumsumexp`` / ``cummax`` / ``cummin`` round differently
from XLA's associative scans, so the port agrees with the JAX module to
rounding, not to the bit (``tests/test_torch_rnnt_loss.py``).

The recursion (:func:`_scan`, dense and banded) runs under a
``rnnt.lattice`` ``torch.profiler`` span.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# a large finite stand-in for -inf: exp(_NEG - anything reasonable) == 0.0
# in f32, while arithmetic on it stays finite (no NaN under autograd)
_NEG = -1e9


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def _scan(lp_blank_t: torch.Tensor, c_rows: torch.Tensor, a_init: torch.Tensor, deltas=None) -> torch.Tensor:
    """The row recursion over time-major ``[T, B, W]`` scores: returns the
    alphas ``[T, B, W]``. With ``deltas [T, B]`` (band shifts) the carry is
    re-indexed from band(t-1) to band(t) coordinates before each row."""
    width = a_init.shape[1]
    s_idx = torch.arange(width, device=a_init.device)
    a, alphas = a_init, []
    with torch.profiler.record_function("rnnt.lattice"):
        for t in range(c_rows.shape[0]):
            if deltas is not None:
                idx = s_idx[None, :] + deltas[t][:, None]
                shifted = torch.gather(a, 1, idx.clamp(0, width - 1))
                a = torch.where((idx >= 0) & (idx < width), shifted, _NEG)
            alpha = c_rows[t] + torch.logcumsumexp(a - c_rows[t], dim=1)
            alphas.append(alpha)
            a = alpha + lp_blank_t[t]
        return torch.stack(alphas)


def _corner(b: int, width: int, device) -> torch.Tensor:
    """The virtual row t = -1: only the (0, 0) corner is reachable."""
    a = torch.full((b, width), _NEG, device=device)
    a[:, 0] = 0.0
    return a


def _c_rows(lp_label: torch.Tensor, width: int) -> torch.Tensor:
    """``C`` per row, time-major ``[T, B, width]``: the cumulative sum of the
    row's first ``width - 1`` label scores, shifted so ``C[0] = 0``."""
    lab = lp_label.float().transpose(0, 1)[:, :, : width - 1]
    return torch.cumsum(F.pad(lab, (1, 0)), dim=2)


def rnnt_alphas(lp_blank: torch.Tensor, lp_label: torch.Tensor) -> torch.Tensor:
    """Dense alpha table ``[B, T, U+1]`` (the scan of
    :func:`rnnt_alpha_loss` without the exit gather): the guided band's
    stage 1."""
    b, _, u_plus1 = lp_blank.shape
    alphas = _scan(lp_blank.float().transpose(0, 1), _c_rows(lp_label, u_plus1), _corner(b, u_plus1, lp_blank.device))
    return alphas.transpose(0, 1)


def rnnt_alpha_loss(lp_blank: torch.Tensor, lp_label: torch.Tensor, input_lengths, label_lengths) -> torch.Tensor:
    """Per-sequence NLL ``[B]`` from lattice scores ``lp_blank [B, T, U+1]``
    and ``lp_label [B, T, U]`` (already masked past each row's label length
    to ``_NEG``, :func:`mask_label_scores`): the exit from ``(T_b - 1, U_b)``
    with a blank."""
    b, _, u_plus1 = lp_blank.shape
    device = lp_blank.device
    alphas = _scan(lp_blank.float().transpose(0, 1), _c_rows(lp_label, u_plus1), _corner(b, u_plus1, device))
    bi = torch.arange(b, device=device)
    tt = (_long(input_lengths, device) - 1).clamp(min=0)
    uu = _long(label_lengths, device).clamp(max=u_plus1 - 1)
    return -(alphas[tt, bi, uu] + lp_blank[bi, tt, uu].float())


def mask_label_scores(lp_label: torch.Tensor, label_lengths) -> torch.Tensor:
    """Label-transition scores past each row's label length → ``_NEG``."""
    u_max = lp_label.shape[-1]
    lengths = _long(label_lengths, lp_label.device)
    valid = torch.arange(u_max, device=lp_label.device)[None, None, :] < lengths[:, None, None]
    return torch.where(valid, lp_label, _NEG)


def rnnt_loss(logits: torch.Tensor, labels, input_lengths, label_lengths, blank_id: int) -> torch.Tensor:
    """Per-sequence NLL ``[B]`` from materialized joint logits ``[B, T, U+1,
    V]`` (the yardstick the fused score paths are held to): index
    ``blank_id`` advances t, ``labels[b, u]`` advances u."""
    b, t_max, u_plus1, _ = logits.shape
    u_max = u_plus1 - 1
    labels = _long(labels, logits.device)
    if labels.shape[1] != u_max:
        raise ValueError(f"labels U={labels.shape[1]} must be logits' U+1-1={u_max}")
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    lp_blank = log_probs[..., blank_id]
    idx = labels[:, None, :, None].expand(b, t_max, u_max, 1)
    lp_label = torch.gather(log_probs[:, :, :u_max, :], 3, idx)[..., 0]
    return rnnt_alpha_loss(lp_blank, mask_label_scores(lp_label, label_lengths), input_lengths, label_lengths)


# ---------------------------------------------------------------------------
# the pruned (banded) lattice
# ---------------------------------------------------------------------------


def diagonal_band_starts(input_lengths, label_lengths, t_max: int, u_max: int, s_range: int) -> torch.Tensor:
    """Linear band starts ``[B, T]`` int32: ``p[t] = floor(t·(U_b+1−S) /
    (T_b−1))``, clipped into ``[0, u_max+1−S]``, covering the entry and the
    exit corners."""
    t_len = _long(input_lengths, None)
    u_len = _long(label_lengths, t_len.device)
    top = (u_len + 1 - s_range).clamp(min=0)
    denom = (t_len - 1).clamp(min=1)
    t = torch.minimum(torch.arange(t_max, device=t_len.device)[None, :], (t_len - 1)[:, None])
    p = torch.div(t * top[:, None], denom[:, None], rounding_mode="floor")
    return p.clamp(max=max(u_max + 1 - s_range, 0)).int()


def _gather_t(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``out[b, t', c] = x[b, src[b, t'], c]`` (the index clipped; callers
    mask what falls outside)."""
    idx = src.clamp(0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def _gather_u(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``out[b, t, u'] = x[b, t, src[b, u']]`` (the index clipped)."""
    idx = src.clamp(0, x.shape[2] - 1)
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


def _proxy_betas(lp_blank: torch.Tensor, lp_label: torch.Tensor, input_lengths, label_lengths) -> torch.Tensor:
    """Backward (beta) node scores ``[B, T, U+1]`` of the dense lattice,
    by the alpha scan over per-row flipped scores (t' = T_b−1−t, u' =
    U_b−u), then flipped back, plus the exit blank."""
    b, t_max, u_plus1 = lp_blank.shape
    u_max = u_plus1 - 1
    device = lp_blank.device
    t_len = _long(input_lengths, device)[:, None]
    u_len = _long(label_lengths, device)[:, None]
    t_ar = torch.arange(t_max, device=device)[None, :]
    u_ar = torch.arange(u_plus1, device=device)[None, :]
    c_ar = torch.arange(u_max, device=device)[None, :]

    def flipped(x, src_t, src_u, ok):
        return torch.where(ok, _gather_u(_gather_t(x, src_t), src_u), _NEG)

    # blank'[b, t', u'] = blank[b, T_b-2-t', U_b-u']
    src_t, src_u = t_len - 2 - t_ar, u_len - u_ar
    ok = (src_t >= 0)[:, :, None] & ((src_u >= 0) & (src_u <= u_max))[:, None, :]
    blank_f = flipped(lp_blank.float(), src_t, src_u, ok)
    # label'[b, t', c] = label[b, T_b-1-t', U_b-1-c]
    src_t2, src_u2 = t_len - 1 - t_ar, u_len - 1 - c_ar
    ok2 = (src_t2 >= 0)[:, :, None] & (src_u2 >= 0)[:, None, :]
    label_f = flipped(lp_label.float(), src_t2, src_u2, ok2)

    alphas_f = rnnt_alphas(blank_f, label_f)
    bi = torch.arange(b, device=device)
    exit_blank = lp_blank[bi, (t_len[:, 0] - 1).clamp(min=0), u_len[:, 0].clamp(max=u_max)].float()
    # beta[b, t, u] = alpha'[b, T_b-1-t, U_b-u] + exit blank
    dst_u = u_len - u_ar
    ok3 = (src_t2 >= 0)[:, :, None] & ((dst_u >= 0) & (dst_u <= u_max))[:, None, :]
    return flipped(alphas_f, src_t2, dst_u, ok3) + exit_blank[:, None, None]


def guided_band_starts(proxy_blank: torch.Tensor, proxy_label: torch.Tensor, input_lengths, label_lengths,
                       s_range: int, proxy_stride: int = 1) -> torch.Tensor:
    """k2-style stage-1 band ``[B, T]`` int32: the dense forward and
    backward scans on the proxy scores, each frame's band centred on the
    argmax occupancy ``alpha + beta``, then :func:`_finalize_band_starts`.
    ``proxy_stride = k > 1`` runs the stage on ``k``-frame blocks (blank
    scores summed, label scores maxed) and interpolates the block starts
    back to frames linearly between block midpoints. No gradients."""
    b, t_max, u_plus1 = proxy_blank.shape
    u_max = u_plus1 - 1
    device = proxy_blank.device
    t_len = _long(input_lengths, device)
    proxy_blank, proxy_label = proxy_blank.float(), proxy_label.float()
    if proxy_stride > 1:
        k = proxy_stride
        n_blk = -(-t_max // k)
        pad = n_blk * k - t_max
        pb = F.pad(proxy_blank, (0, 0, 0, pad))
        pl = F.pad(proxy_label, (0, 0, 0, pad))
        valid = torch.arange(n_blk * k, device=device)[None, :, None] < t_len[:, None, None]
        blank_blk = torch.where(valid, pb, 0.0).reshape(b, n_blk, k, u_plus1).sum(dim=2)
        label_blk = torch.where(valid, pl, _NEG).reshape(b, n_blk, k, u_max).amax(dim=2)
        p_blk = guided_band_starts(blank_blk, label_blk, torch.div(t_len + k - 1, k, rounding_mode="floor"),
                                   label_lengths, s_range)
        # linear interpolation between block midpoints: one [T, n_blk] matrix
        tpos = (torch.arange(t_max, device=device, dtype=torch.float32) - (k - 1) / 2.0) / k
        i0 = torch.floor(tpos).long().clamp(0, n_blk - 1)
        i1 = (i0 + 1).clamp(max=n_blk - 1)
        frac = (tpos - i0).clamp(0.0, 1.0)
        w_up = F.one_hot(i0, n_blk) * (1.0 - frac)[:, None] + F.one_hot(i1, n_blk) * frac[:, None]
        p = torch.floor(p_blk.float() @ w_up.T + 0.5).long()
        return _finalize_band_starts(p, input_lengths, label_lengths, s_range)
    proxy_label = mask_label_scores(proxy_label, label_lengths)
    gamma = rnnt_alphas(proxy_blank, proxy_label) + _proxy_betas(proxy_blank, proxy_label, input_lengths,
                                                                  label_lengths)
    u_len = _long(label_lengths, device)
    valid = ((torch.arange(u_plus1, device=device)[None, None, :] <= u_len[:, None, None])
             & (torch.arange(t_max, device=device)[None, :, None] < t_len[:, None, None]))
    center = torch.argmax(torch.where(valid, gamma, -torch.inf), dim=2)  # the first of equal maxima
    return _finalize_band_starts(center - (s_range - 1) // 2, input_lengths, label_lengths, s_range)


def _finalize_band_starts(p: torch.Tensor, input_lengths, label_lengths, s_range: int) -> torch.Tensor:
    """Raw starts ``[B, T]`` projected onto the feasible set: clipped into
    ``[0, U_b+1−S]``, made monotone (running max), jump-limited to ``S−1`` a
    frame (``cummin(p − t(S−1)) + t(S−1)``), under the entry envelope ``p[t]
    ≤ t(S−1)`` and over the minimal exit ramp that puts ``(T_b−1, U_b)`` in
    the last band."""
    device = p.device
    t_max = p.shape[1]
    rate = max(s_range - 1, 1)
    top = (_long(label_lengths, device) + 1 - s_range).clamp(min=0)[:, None]
    p = torch.minimum(p.long().clamp(min=0), top)
    p = torch.cummax(p, dim=1).values
    t_ramp = torch.arange(t_max, device=device)[None, :] * rate
    p = torch.cummin(p - t_ramp, dim=1).values + t_ramp
    p = torch.minimum(p, t_ramp)
    frames_left = (_long(input_lengths, device)[:, None] - 1 - torch.arange(t_max, device=device)[None, :]).clamp(min=0)
    ramp = torch.minimum((top - frames_left * rate).clamp(min=0), top)
    return torch.maximum(p, ramp).int()


def rnnt_alpha_loss_banded(lp_blank_band: torch.Tensor, lp_label_band: torch.Tensor, band_starts, input_lengths,
                           label_lengths) -> torch.Tensor:
    """Per-sequence NLL ``[B]`` over the pruned lattice: scores ``[B, T, S]``
    at ``u = p[t] + s`` (labels masked past each row's length,
    :func:`mask_band_label_scores`), starts ``[B, T]``. The carry moves from
    band(t−1) to band(t) by a gather (virtual ``p[−1] = 0``). A band that
    misses the exit node gives a loss of about 1e9: loudly wrong."""
    b, _, s_range = lp_blank_band.shape
    device = lp_blank_band.device
    starts = _long(band_starts, device)
    p_t = starts.transpose(0, 1)
    deltas = torch.cat([p_t[:1], p_t[1:] - p_t[:-1]], dim=0)  # [T, B]
    alphas = _scan(lp_blank_band.float().transpose(0, 1), _c_rows(lp_label_band, s_range),
                   _corner(b, s_range, device), deltas)
    bi = torch.arange(b, device=device)
    tt = (_long(input_lengths, device) - 1).clamp(min=0)
    ss = _long(label_lengths, device) - starts[bi, tt]  # the exit node in band coordinates
    in_band = (ss >= 0) & (ss < s_range)
    ss_c = ss.clamp(0, s_range - 1)
    loglik = alphas[tt, bi, ss_c] + lp_blank_band[bi, tt, ss_c].float()
    return -torch.where(in_band, loglik, _NEG)


def mask_band_label_scores(lp_label_band: torch.Tensor, band_starts, label_lengths) -> torch.Tensor:
    """The banded :func:`mask_label_scores`: band slots whose global label
    index ``p[t] + s`` is past the row's label length → ``_NEG``."""
    device = lp_label_band.device
    s_range = lp_label_band.shape[-1]
    u_global = _long(band_starts, device)[:, :, None] + torch.arange(s_range, device=device)[None, None, :]
    return torch.where(u_global < _long(label_lengths, device)[:, None, None], lp_label_band, _NEG)

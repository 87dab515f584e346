"""The CTC loss of the character recipe, with ``optax.ctc_loss``'s semantics.

Port of the loss of tfkaldi_tpu/train/trainer.py:276-295, which calls
``optax.ctc_loss`` on ``logits.float()`` with logit padding from the
output lengths, label padding from the target lengths and the blank the
caller names. Its result for one row is the negative log-likelihood of the
row's label sequence under ``log_softmax(logits)``. optax writes ``log 0``
as ``log_epsilon = -1e5``, so a row with no alignment at all (fewer frames
than labels plus adjacent repeats) still gets a finite loss of about
``1e5`` per missing frame and a finite gradient; the JAX dispenser does not
drop such rows, so the port keeps that value.

Both routes take the f32 ``log_softmax`` values widened to f64, and the
loss comes back in f32:

- ``plain``: :func:`ctc_loss_plain`, optax's log-space alpha recursion
  written out in torch (blank and label states, ``log_epsilon`` in place of
  ``log 0``, padded frames carrying the state through). It defines the
  numerics and takes any row.
- ``library``: ``torch.nn.functional.ctc_loss`` (torch's own CTC on the CPU
  or the card; cuDNN's needs blank 0 and f32, so it is never the one
  chosen), for the rows a host-side plan (:func:`feasible_rows`) finds
  feasible. There the two agree to rounding: optax's ``log_epsilon`` paths
  weigh ``exp(-1e5) = 0``. On an infeasible row torch returns ``inf`` and a
  NaN gradient, so such rows always take the plain recursion.

Why f64: the alphas of a row sit near its negative log-likelihood, about
1,800 for 500 frames of the recipe at step 0, where an f32 step is 1.2e-4,
and an infeasible row's near -1e5, where it is 0.008. In f32 the logit
gradient is then rounding noise at the 1e-3 level, whichever code computes
it (optax's own f32 gradient of an infeasible row lies more than 1e-4 from
its f64 value, tests/test_torch_ctc.py; torch's f32 CTC at the recipe's
shape, chip_smoke.py's CTC phase). In f64 the two routes agree to the f32
rounding of their result.

The route is chosen by the plan, never by catching an ``inf`` or a failure,
and each route counts its calls in :data:`launches_by_route`, as the kernel
wrappers count theirs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5  # optax.ctc_loss's default stand-in for log(0)
ROUTES = ("library", "plain")

launches_by_route = {route: 0 for route in ROUTES}


def reset_counts() -> None:
    for route in ROUTES:
        launches_by_route[route] = 0


def host(a) -> np.ndarray:
    """A tensor (any device) or array as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def feasible_rows(targets, target_lengths, output_lengths) -> np.ndarray:
    """The plan: ``[B]`` bool, True where a row has at least one CTC
    alignment, i.e. ``T_out >= L + (adjacent repeats among its L labels)``
    (a repeated label needs a blank between its two emissions)."""
    targets, lengths = host(targets), host(target_lengths).astype(np.int64)
    frames = host(output_lengths).astype(np.int64)
    later = np.arange(1, targets.shape[1])[None, :] < lengths[:, None]
    repeats = ((targets[:, 1:] == targets[:, :-1]) & later).sum(axis=1)
    return frames >= lengths + repeats


def ctc_loss_plain(log_probs: torch.Tensor, output_lengths, targets, target_lengths, blank_id: int,
                   log_epsilon: float = LOG_EPSILON) -> torch.Tensor:
    """Per-row CTC loss ``[B]`` of ``log_probs`` ``[B, T, V]`` (log_softmax
    outputs; the recursion runs in their dtype), optax's recursion step for
    step: ``phi[n]`` is the blank state after ``n`` labels, ``emit[n]`` the state emitting label ``n``;
    a label equal to the next one reaches that one's state through a blank
    only; padded frames leave both states as they are."""
    b, t_len, _ = log_probs.shape
    device, dtype = log_probs.device, log_probs.dtype
    targets = torch.as_tensor(host(targets), dtype=torch.int64, device=device)
    n = targets.shape[1]
    output_lengths = torch.as_tensor(host(output_lengths), dtype=torch.int64, device=device)
    target_lengths = torch.as_tensor(host(target_lengths), dtype=torch.int64, device=device)
    repeat = torch.zeros(b, n, dtype=dtype, device=device)
    repeat[:, :-1] = (targets[:, :-1] == targets[:, 1:]).to(dtype)
    lp_phi = log_probs[:, :, blank_id]  # [B, T]
    lp_emit = torch.gather(log_probs, 2, targets[:, None, :].expand(b, t_len, n))  # [B, T, N]
    pad = (torch.arange(t_len, device=device)[None, :] >= output_lengths[:, None]).to(dtype)
    eps_repeat, eps_other = log_epsilon * repeat, log_epsilon * (1.0 - repeat)

    def add_to_later(phi, score):  # phi[:, 1:] ⊕= score, in log space
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)], dim=1)

    phi = torch.full((b, n + 1), log_epsilon, dtype=dtype, device=device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), log_epsilon, dtype=dtype, device=device)
    for t in range(t_len):
        # label n to the blank before label n+1 without a frame, unless n+1 repeats n
        phi_in = add_to_later(phi, emit + eps_repeat)
        e, p, keep = lp_emit[:, t], lp_phi[:, t : t + 1], pad[:, t : t + 1]
        next_emit = torch.logaddexp(phi_in[:, :-1] + e, emit + e)
        # blank self-loop, and label n to blank n+1 on a blank frame where n+1 repeats n
        next_phi = add_to_later(phi_in + p, emit + p + eps_other)
        emit = keep * emit + (1.0 - keep) * next_emit
        phi = keep * phi + (1.0 - keep) * next_phi
    phi = add_to_later(phi, emit)  # the last label's closing transition
    return -phi.gather(1, target_lengths[:, None])[:, 0]


def ctc_loss(logits: torch.Tensor, output_lengths, targets, target_lengths, blank_id: int, *,
             route: str | None = None) -> torch.Tensor:
    """Per-row CTC loss ``[B]`` (f32) of ``logits`` ``[B, T, V]`` over
    ``log_softmax(logits.float())``; the lengths and targets may be tensors
    on any device or numpy arrays. Numpy arrays cost no host copy here: a
    caller that holds them keeps the host from waiting on the forward.

    ``route=None`` sends the rows that :func:`feasible_rows` finds feasible
    to ``F.ctc_loss`` and the rest to :func:`ctc_loss_plain`;
    ``route="plain"`` sends every row to the plain recursion."""
    if route not in (None, "plain"):
        raise ValueError(f"route {route!r}: want None (planned) or 'plain'")
    log_probs = torch.log_softmax(logits.float(), dim=-1).double()
    if route == "plain":
        launches_by_route["plain"] += 1
        return ctc_loss_plain(log_probs, output_lengths, targets, target_lengths, blank_id).float()
    targets_h, out_h, tgt_h = host(targets), host(output_lengths), host(target_lengths)
    plan = feasible_rows(targets_h, tgt_h, out_h)
    device = log_probs.device
    loss = torch.zeros(log_probs.shape[0], dtype=torch.float64, device=device)
    rows = np.flatnonzero(plan)
    if rows.size:
        launches_by_route["library"] += 1
        idx = torch.as_tensor(rows, device=device)
        got = F.ctc_loss(
            log_probs[idx].transpose(0, 1), torch.as_tensor(targets_h[rows], dtype=torch.int64, device=device),
            tuple(out_h[rows].tolist()), tuple(tgt_h[rows].tolist()),
            blank=blank_id, reduction="none", zero_infinity=False,
        )
        loss = loss.index_copy(0, idx, got)
    rows = np.flatnonzero(~plan)
    if rows.size:
        launches_by_route["plain"] += 1
        idx = torch.as_tensor(rows, device=device)
        got = ctc_loss_plain(log_probs[idx], out_h[rows], targets_h[rows], tgt_h[rows], blank_id)
        loss = loss.index_copy(0, idx, got)
    return loss.float()

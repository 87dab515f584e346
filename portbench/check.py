"""The comparisons that decide ``correct``.

Training cells compare three numbers of the program's first steps with the
reference's (:mod:`portbench.reference.train`):

- ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps;
- ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first clipped gradient, over the larger of
  the reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same for the norm of each leaf's change over the
  steps.

A leaf whose reference gradient norm is under a thousandth of the median
leaf's (a bias ahead of batch norm, which the mean removes) moves under
Adam by round-off alone; it is left out of both leaf gaps by that rule.

Decode cells compare ``ll_gap``: the largest absolute gap between the log
pseudo-likelihoods read back from the program's ark bytes and the
reference's, over the sampled utterances.
"""

from __future__ import annotations

import statistics

TRIVIAL = 1e-3  # a leaf's gradient under this share of the median leaf's is round-off


def counted_leaves(ref_first_grad: dict) -> list[str]:
    med = statistics.median(ref_first_grad.values())
    return [n for n, g in ref_first_grad.items() if g >= TRIVIAL * med]


def leaf_gap(prog: dict, ref: dict, leaves: list[str]) -> float:
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: program {sorted(set(prog) - set(ref))}, reference "
                         f"{sorted(set(ref) - set(prog))}")
    med = statistics.median(ref[n] for n in leaves)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in leaves)


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """The three numbers of a training cell (see the module docstring);
    ``prog`` and ``ref`` as :func:`portbench.reference.train.steps` returns."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError(f"{len(prog['losses'])} program steps against {len(ref['losses'])} reference steps")
    leaves = counted_leaves(ref["first_grad"])
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": leaf_gap(prog["first_grad"], ref["first_grad"], leaves),
        "change_gap": leaf_gap(prog["change"], ref["change"], leaves),
    }


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, list[tuple[str, float, float]]]:
    """Every number at or under its limit (a NaN fails); the numbers beside
    their limits, in the limits' order."""
    rows = [(name, float(numbers.get(name, float("nan"))), float(limit)) for name, limit in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows

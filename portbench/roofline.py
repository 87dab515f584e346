"""Peaks of the card, the least time a piece of work could take, and the
operations the recipes' models need.

The bound arithmetic of the port's kernel tables (``chip_smoke.py`` /
``profile_ffn.py``), copied: the least time is the larger of operations
over the peak rate of the compute type and bytes over the memory rate,
with every input byte read once and every output byte written once. The
model operation counts are written anew for the port's DNN: two
operations a multiply-add of every product a real frame needs, a training
step three times its forward.
"""

from __future__ import annotations

# NVIDIA H100 SXM, the data sheet's dense rates
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def dtype_size(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


# ----------------------------------------------------------------------
# model operations a real frame
# ----------------------------------------------------------------------

def dnn_forward_flops(input_dim: int, layers: int, units: int, labels: int) -> float:
    """The DNN's products a frame: ``F·H + (L−1)·H² + H·O`` multiply-adds."""
    return 2.0 * (input_dim * units + (layers - 1) * units * units + units * labels)


# ----------------------------------------------------------------------
# kernels
# ----------------------------------------------------------------------

def ffn_bound_s(n: int, k: int, m: int, dtype: str) -> float:
    """Kernel 1, ``relu((x @ w + b)·scale + shift)`` of ``x [n, k]``,
    ``w [k, m]``: x, w, the three vectors and the output each moved once."""
    size = dtype_size(dtype)
    ops = 2.0 * n * k * m + 4.0 * n * m
    nbytes = (n * k + k * m + n * m) * size + 3 * m * 4
    return bound_s(ops, nbytes, dtype)


def dnn_kernel3_step_bound_s(rows: int, input_dim: int, layers: int, units: int, dtype: str) -> float:
    """Kernel 3 over one training step of ``rows`` padded rows: a launch a
    hidden layer, the first the dz pass alone (reads g, z, the mask and
    five vectors, writes dz), the others the dz pass and ``dh = dz @ wᵀ``
    (also reads w, writes dh)."""
    size = dtype_size(dtype)
    total = 0.0
    for l in range(layers):
        fan_in = input_dim if l == 0 else units
        nbytes = 3 * rows * units * size + rows * 4 + 5 * units * 4
        ops = 0.0
        if l > 0:
            nbytes += (fan_in * units + rows * fan_in) * size
            ops = 2.0 * rows * units * fan_in
        total += bound_s(ops, nbytes, dtype)
    return total

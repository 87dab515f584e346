"""The operation and byte counts of roofline.py against hand counts."""

from __future__ import annotations

import pytest

from portbench import roofline


def test_dnn_forward_flops():
    # 440 -> 6 x 2048 -> 2000: 440·2048 + 5·2048² + 2048·2000 multiply-adds
    assert roofline.dnn_forward_flops(440, 6, 2048, 2000) == 2 * (901_120 + 20_971_520 + 4_096_000)


def test_ffn_bound():
    n, k, m = 4096, 2048, 2048
    ops = 2 * n * k * m + 4 * n * m
    nbytes = 4 * (n * k + k * m + n * m) + 12 * m
    assert roofline.ffn_bound_s(n, k, m, "float32") == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))


def test_kernel3_bound():
    rows = 1000
    first = (3 * rows * 2048 * 4 + rows * 4 + 5 * 2048 * 4) / 3.35e12  # dz pass alone: bytes
    later = max(2 * rows * 2048 * 2048 / 67e12,
                (3 * rows * 2048 * 4 + rows * 4 + 5 * 2048 * 4 + 4 * (2048 * 2048 + rows * 2048)) / 3.35e12)
    assert roofline.dnn_kernel3_step_bound_s(rows, 440, 3, 2048, "float32") == pytest.approx(first + 2 * later)

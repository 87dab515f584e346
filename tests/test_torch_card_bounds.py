"""The card's peaks and bound arithmetic have two copies: the port's
(``tfkaldi_tpu_torch.profile_ffn``: ``PEAK_*``, ``bound``, ``ffn_bound``;
chip_smoke.py's kernel table reads them) and the benchmark's
(``portbench/roofline.py``, which must not import the program). They must
agree at every row of the kernel table (PERF.md §6, ``profile_ffn``'s
``*_ROWS``): the same operations and bytes give the same bound on both.
The benchmark has no f64 rate; kernel 2's f64 rows are bound by their
bytes, held to the benchmark's bytes bound."""

import math

import pytest
import torch

from portbench import roofline
from tfkaldi_tpu_torch import profile_ffn

ROWS = ([("ffn", row) for row in profile_ffn.FFN_ROWS] + [("frame", row) for row in profile_ffn.FRAME_ROWS]
        + [("bn", row) for row in profile_ffn.BN_ROWS]
        + [(f"rnn_{way}", row) for row in profile_ffn.RNN_ROWS for way in ("fwd", "bwd")]
        + [("split", route) for route in profile_ffn.SPLIT_ROWS])


def _id(kernel, row) -> str:
    return f"{kernel}-" + "-".join(str(x) for x in (row if isinstance(row, tuple) else (row,)))


def test_peaks_agree():
    assert profile_ffn.PEAK_F32 == roofline.PEAK_FLOPS["float32"]
    assert profile_ffn.PEAK_BF16 == roofline.PEAK_FLOPS["bfloat16"]
    assert profile_ffn.PEAK_BYTES == roofline.PEAK_BYTES
    assert profile_ffn.PEAKS == {"float32": profile_ffn.PEAK_F32, "bfloat16": profile_ffn.PEAK_BF16,
                                "float64": profile_ffn.PEAK_F64}


@pytest.mark.parametrize("kernel,row", ROWS, ids=[_id(k, r) for k, r in ROWS])
def test_bound_agrees_with_the_benchmark(kernel, row):
    flops, nbytes, dtype = profile_ffn.work(kernel, row)
    assert flops > 0 and nbytes > 0
    got = profile_ffn.bound(flops, nbytes, profile_ffn.PEAKS[dtype])
    assert profile_ffn.row_bound(kernel, row) == got
    if dtype == "float64":
        assert got["bound_by"] == "bytes"
        assert got["bound_ms"] == pytest.approx(roofline.bound_s(0.0, nbytes, "float32") * 1e3, rel=1e-12)
    else:
        assert got["bound_ms"] == pytest.approx(roofline.bound_s(flops, nbytes, dtype) * 1e3, rel=1e-12)
        by_ops = flops / roofline.PEAK_FLOPS[dtype] >= nbytes / roofline.PEAK_BYTES
        assert got["bound_by"] == ("operations" if by_ops else "bytes")
    if kernel == "ffn" and row[4]:  # kernel 1 with its BN affine: the benchmark's own formula
        n, k, m, name = row[:4]
        want = roofline.ffn_bound_s(n, k, m, name) * 1e3
        assert profile_ffn.ffn_bound(n, k, m, getattr(torch, name))["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert math.isfinite(got["bound_ms"])

"""The control comes out as not correct: the reference computed in the
precision under the configuration's (TF32 for float32) in the program's
place, at a size a test run holds, against each cell's limits."""

from __future__ import annotations

import pytest

from portbench import calibrate, check, spec

SEEDS = (3_000_000_501, 3_000_000_502, 3_000_000_503)


@pytest.mark.parametrize("name", ["aurora4_dnn.train", "aurora4_dnn.decode"])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails(tiny_cell, tmp_path, name, seed):
    cell = tiny_cell(name)
    mode = calibrate.CONTROL[cell["config_data"]["nnet"].get("compute_dtype", "float32")]
    numbers = spec.driver(cell).control_numbers(cell, seed, "cpu", str(tmp_path), mode)
    ok, rows = check.judge(numbers, cell["limits"])
    assert not ok, rows

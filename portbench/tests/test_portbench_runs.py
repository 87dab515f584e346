"""Tiny CPU runs of each traffic driver against the reference, the result
line they give, and the check of the check: the harness driven with the
timed path broken underneath, and ``correct`` coming out false."""

from __future__ import annotations

import json
import re

import pytest

from portbench import run as prun

SEED = 3_000_000_017  # more than 31 bits: seeds are any whole number
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

CASES = ["aurora4_dnn.train", "aurora4_dnn.decode"]
FAULTS = [("aurora4_dnn.train", "unchanged"), ("aurora4_dnn.train", "half_batch"), ("aurora4_dnn.decode", "altered")]


def _line(cell, trace, fault=None, seconds=1.0):
    rec = prun.run_cell(cell, SEED, seconds, trace, "cpu", fault=fault)
    return rec, prun.result_line(rec, cell, trace, {"platform": "cpu", "kind": "cpu", "count": 1})


@pytest.mark.parametrize("name,trace", [(n, t) for n in CASES for t in (False, True)])
def test_tiny_run_is_correct(tiny_cell, name, trace):
    cell = tiny_cell(name)
    rec, line = _line(cell, trace)
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    json.dumps(line)
    wanted = cell["per_layer"] if trace else cell["end_to_end"]
    for m_name, m in line["metrics"].items():
        assert NAME.match(m_name) and UNIT.match(m["unit"])
        assert m_name in {w["name"] for w in wanted}
    if not trace:
        assert {m["name"] for m in wanted} == set(line["metrics"])
        assert line["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("name,fault", FAULTS)
def test_broken_path_is_not_correct(tiny_cell, name, fault):
    rec, line = _line(tiny_cell(name), False, fault)
    assert not line["correct"], line["compared"]


def test_train_line_counts_validations_and_rollbacks(tiny_cell):
    rec, line = _line(tiny_cell("aurora4_dnn.train"), False, seconds=2.0)
    w = line["window"]
    assert set(w) == {"validations", "rollbacks", "lr_fact", "recipe_stop"}
    # the baseline validation in set-up, then one every valid_frequency (3) steps
    assert w["validations"] and all(len(v) == 2 for v in w["validations"])
    assert w["lr_fact"] == 0.5 ** w["rollbacks"]
    assert list(line)[-2:] == ["window", "compared"]


def test_recipe_stop_closes_the_window(tiny_cell):
    """A training that the recipe ends (here its last epoch) inside the
    window closes the window there, and the line says so."""
    cell = tiny_cell("aurora4_dnn.train")
    cell["config_data"]["nnet"]["num_epochs"] = "1"
    rec, line = _line(cell, False, seconds=600.0)
    assert line["window"]["recipe_stop"] and line["correct"]
    assert 0 < rec.window_s < 600.0 and line["attempted"] > 0


def test_decode_phases_split_the_window(tiny_cell):
    rec, line = _line(tiny_cell("aurora4_dnn.decode"), True)
    phases = line["window"]
    assert set(phases) == {"read_s", "device_s", "serialise_s"}
    assert all(v > 0 for v in phases.values()) and sum(phases.values()) <= rec.window_s
    for name in ("decode_read_ms", "decode_device_ms", "decode_serialise_ms"):
        assert line["metrics"][name]["value"] > 0

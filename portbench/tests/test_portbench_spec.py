"""Every cell of BENCHMARK.json resolves to its files by name, and the file
keeps to the contract's names, units and keys."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.cell(name)
    assert os.path.isfile(os.path.join(spec.HERE, "traffic", f"{cell['traffic']}.json"))
    assert spec.driver(cell).run
    assert cell["limits"]
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert spec.reader(m["name"]).read
    for m in cell["per_layer"]:
        assert m["moves"] in e2e, (name, m["name"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    with open(os.path.join(spec.ROOT, config["file"])) as f:
        data = json.load(f)
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert all(k in data for k in config["reduced"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_metric_files_are_named_by_metrics():
    names = {m["name"].replace(".", "_") for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(spec.HERE, "metrics")) if f.endswith(".py")} - {"__init__"}
    assert files == names

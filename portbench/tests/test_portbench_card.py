"""On a card: one short run of each one-card cell through the command of
BENCHMARK.json gives a correct result line (skipped without a card)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"] if w["chips"] == 1])
def test_cell_runs_on_the_card(card, name):
    got = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name, "--seed", "3000000777",
                          "--seconds", "3", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert got.returncode == 0, got.stderr[-3000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"

"""Finding a cell's files by the names in ``BENCHMARK.json``.

- configuration ``<c>``: the ``file`` its entry names (``portbench/configs/<c>.json``);
- traffic mix ``<t>``: ``portbench/traffic/<t>.json``, whose ``driver``
  names ``portbench/drivers/<driver>.py``;
- cell ``<w>``: the limits of its comparison, ``portbench/limits/<w>.json``;
- metric ``<m>``: its reader, ``portbench/metrics/<m>.py`` (a ``.`` in the
  name is a ``_`` in the file's).

Adding a configuration, a mix, a cell or a metric adds files and entries;
no file that is there changes.
"""

from __future__ import annotations

import importlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, bench: dict | None = None, root: str = ROOT) -> dict:
    """The cell's entry with its configuration, traffic and limits loaded."""
    bench = bench or benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    out = dict(entry)
    out["config_data"] = _json(os.path.join(root, config["file"]))
    out["traffic_data"] = _json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json"))
    out["limits"] = _json(os.path.join(HERE, "limits", f"{name}.json"))
    out["end_to_end"] = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    out["per_layer"] = [m for m in bench["per_layer"] if reports(m, name, out["end_to_end"])]
    return out


def reports(metric: dict, cell_name: str, end_to_end: list[dict]) -> bool:
    """Whether a per-layer metric belongs in the cell's traced line: the
    cells its ``workloads`` lists, else every cell that reports the
    end-to-end metric it moves."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return any(m["name"] == metric["moves"] for m in end_to_end)


def driver(cell_entry: dict):
    return importlib.import_module(f"portbench.drivers.{cell_entry['traffic_data']['driver']}")


def reader(metric_name: str):
    return importlib.import_module(f"portbench.metrics.{metric_name.replace('.', '_')}")

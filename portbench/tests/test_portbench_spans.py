"""The readers of the program's own spans (``source`` ``program_span``):
every one reads a value from a traced tiny run of its cell, the decode
idle split stays inside the device's idle share, nested spans count once,
and a trace without the program's spans reads nothing."""

from __future__ import annotations

import pytest

from portbench import run as prun, spec
from portbench.record import Record
from portbench.trace import Trace

SEED = 3_000_000_019
NEW = {"aurora4_dnn.train": ["train_validate_ms", "train_checkpoint_ms", "train_prefetch_wait_ms"],
       "aurora4_dnn.decode": ["decode_compute_ms", "decode_fetch_ms", "decode_idle_read_pct",
                              "decode_idle_write_pct"]}


def _read(name, rec):
    return spec.reader(name).read(rec)


@pytest.mark.parametrize("name", sorted(NEW))
def test_traced_tiny_run_reads_every_span_metric(tiny_cell, name):
    cell = tiny_cell(name)
    assert set(NEW[name]) <= {m["name"] for m in cell["per_layer"]}
    rec = prun.run_cell(cell, SEED, 2.0, True, "cpu")
    metrics = prun.result_line(rec, cell, True, {"platform": "cpu", "kind": "cpu", "count": 1})["metrics"]
    for m in NEW[name]:
        assert m in metrics, (m, sorted(metrics))
        assert metrics[m]["value"] >= 0.0
        if m.endswith("_pct"):
            assert metrics[m]["value"] <= 100.0
    if name == "aurora4_dnn.decode":
        split = metrics["decode_idle_read_pct"]["value"] + metrics["decode_idle_write_pct"]["value"]
        assert 0.0 < split <= metrics["decode_device_idle_pct"]["value"] + 1e-9
    else:
        assert metrics["train_validate_ms"]["value"] > 0 and metrics["train_checkpoint_ms"]["value"] > 0


def _annotation(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur, "args": {}}


def _record(events, extent=None):
    rec = Record(cell="c", config={}, traffic={}, chips=1)
    rec.trace, rec.trace_extent = Trace(events), extent
    return rec


def test_nested_checkpoint_spans_count_once():
    """Two steps over [0, 3000] us; a validated save over [1000, 1600]
    holding its state's save [1100, 1500], and a save [2800, 3500] that the
    window clips at 3000: (600 + 200) us ÷ 2 steps."""
    events = [_annotation("train_step", 0, 1000), _annotation("train_step", 2000, 1000),
              _annotation("train.checkpoint", 1000, 600), _annotation("train.checkpoint", 1100, 400),
              _annotation("train.checkpoint", 2800, 700)]
    assert _read("train_checkpoint_ms", _record(events)) == pytest.approx(0.4)


def test_decode_idle_split_reads_the_gaps_inside_each_span():
    """A window [0, 1000] us: reads at [0, 300] and [600, 700], a write at
    [400, 600]; the device busy over [200, 450]: idle inside reads 200 + 100,
    inside the write 150."""
    events = [_annotation("decode.read", 0, 300), _annotation("decode.read", 600, 100),
              _annotation("decode.write", 400, 200), _annotation("decode.compute", 300, 100), _kernel(200, 250)]
    rec = _record(events, (0.0, 1000.0))
    assert _read("decode_idle_read_pct", rec) == pytest.approx(30.0)
    assert _read("decode_idle_write_pct", rec) == pytest.approx(15.0)
    assert _read("decode_compute_ms", rec) == pytest.approx(0.1)


def test_a_trace_without_the_program_spans_reads_nothing():
    """The parent's program has none of the spans: every new reader gives
    ``None`` and none raises."""
    events = [_annotation("train_step", 0, 1000), _annotation("train_step", 2000, 1000),
              _annotation("portbench.decode_batch", 0, 500), _kernel(100, 100)]
    rec = _record(events, (0.0, 500.0))
    for name in NEW["aurora4_dnn.train"] + NEW["aurora4_dnn.decode"]:
        assert _read(name, rec) is None, name

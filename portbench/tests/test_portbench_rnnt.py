"""The transducer cell at a CPU size: its driver against the reference,
each fault and the control coming out as not correct, the operation and
parameter counts, and its per-layer metrics read from a synthetic trace
with backward launches."""

from __future__ import annotations

import copy
import json
import math
import tempfile

import pytest
import torch

from portbench import calibrate, check, conformer_flops, run as prun, spec
from portbench.drivers import rnnt_train
from portbench.record import Record
from portbench.reference import conformer_rnnt as ref
from portbench.regions import Regions
from portbench.trace import Trace

NAME = "conformer_l_rnnt.rnnt_train"
SEED = 3_000_000_017


def tiny() -> dict:
    """The cell with its widths, corpus and batches cut so that a run takes
    seconds on the CPU (the cell itself runs at full size on the card)."""
    cell = copy.deepcopy(spec.cell(NAME))
    cfg, tr = cell["config_data"], cell["traffic_data"]
    cfg.update(train_utterances=24, feat_dim=16, num_labels=17)
    cfg["nnet"].update(num_blocks="2", d_model="32", num_heads="4", ffn_dim="64", conv_kernel="8", pred_units="24",
                       embed_dim="8", joint_units="20", batch_size="4", valid_batches="1")
    tr.update(mean_s=0.5, min_s=0.3, max_s=0.8, speakers=3, token_frames=[4, 8], bucket_multiple=16)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(trace):
    cell = tiny()
    rec = prun.run_cell(cell, SEED, 1.0, trace, "cpu")
    line = prun.result_line(rec, cell, trace, {"platform": "cpu", "kind": "cpu", "count": 1})
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] > 0
    json.dumps(line)
    if trace:  # the trace's steps run ahead of the window, which is the untraced run's; no device ops here
        assert set(line["metrics"]) == {"rnnt_train_mfu", "train_stall_ms", "train_data_wait_ms",
                                        "train_prefetch_wait_ms", "train_device_idle_pct"}
        assert len(rec.trace.spans["train_step"]) == cell["traffic_data"]["trace_steps"]
    else:
        assert set(line["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert all(len(s["utterances"]) == s["batch"] for s in rec.steps)


@pytest.mark.parametrize("fault", rnnt_train.FAULTS)
def test_fault_is_not_correct(fault):
    rec = prun.run_cell(tiny(), SEED, 0.0, False, "cpu", fault=fault)
    assert not rec.correct, rec.compared


def test_control_is_not_correct(tmp_path):
    """The control, the reference in fp8 in the program's place, fails the
    cell's limits."""
    numbers = rnnt_train.control_numbers(tiny(), SEED, "cpu", str(tmp_path), rnnt_train.CONTROL)
    assert not check.judge(numbers, tiny()["limits"])[0], numbers


def test_calibrate_takes_the_control_for_the_call_alone(monkeypatch):
    """``python3 -m portbench.drivers.rnnt_train`` runs ``portbench.calibrate``
    with ``bfloat16 → fp8``; importing the driver leaves calibrate's map as
    it is."""
    before = dict(calibrate.CONTROL)
    assert "bfloat16" not in before
    seen = {}

    def main(argv):
        seen["mode"] = calibrate.CONTROL["bfloat16"]
        return 0

    monkeypatch.setattr(calibrate, "main", main)
    assert rnnt_train.calibrate_main(["--workload", NAME]) == 0
    assert seen["mode"] == "fp8" and calibrate.CONTROL == before


def test_counts_at_the_published_widths():
    """The hand count of :mod:`portbench.conformer_flops` equals the
    reference's shapes and the program's model (≈ 120.1 M, within 3% of the
    paper's 118.8 M); the forward's operations grow with T'² through
    attention."""
    from tfkaldi_tpu_torch.models import TransducerConfig
    from tfkaldi_tpu_torch.models.transducer import Transducer

    cfg = spec.cell(NAME)["config_data"]
    widths = conformer_flops.Widths.from_config(cfg)
    n = conformer_flops.parameters(widths)
    assert n == sum(math.prod(s) for s in ref.param_shapes(rnnt_train.ref_config(cfg)).values())
    with torch.device("meta"):
        model = Transducer(TransducerConfig.from_config(cfg["nnet"], cfg["feat_dim"], cfg["num_labels"]))
    assert n == sum(p.numel() for p in model.parameters())
    assert abs(n / 118.8e6 - 1) < 0.03 and 120.0e6 < n < 120.3e6
    one, two = conformer_flops.forward_flops(widths, 800, 30), conformer_flops.forward_flops(widths, 1600, 30)
    assert 2 * one < two < 3 * one


def _ev(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def _synthetic_events():
    """One step [0, 1000] on thread 1 (the profiler's forward thread 1):
    the encoder's forward op (sequence 7) launches kernel A; the joint's op
    (sequence 9) launches B. On autograd's thread 2: the encoder's backward
    (sequence 7, thread 1) launches C; the joint's recompute (thread 2's
    sequence 3, inside a joint span) launches D and its backward E; an
    optimizer op outside every span launches F."""
    ev = [_ev("user_annotation", "train_step", 0, 1000, 1),
          _ev("user_annotation", "rnnt.encode", 10, 100, 1),
          _ev("cpu_op", "aten::mm", 20, 10, 1, **{"Sequence number": 7, "Fwd thread id": 0}),
          _ev("cuda_runtime", "cudaLaunchKernel", 22, 2, 1, correlation=1),
          _ev("user_annotation", "rnnt.joint", 200, 50, 1),
          _ev("cpu_op", "aten::mm", 210, 10, 1, **{"Sequence number": 9, "Fwd thread id": 0}),
          _ev("cuda_runtime", "cudaLaunchKernel", 212, 2, 1, correlation=2),
          _ev("cpu_op", BWD + "MmBackward0", 400, 40, 2, **{"Sequence number": 7, "Fwd thread id": 1}),
          _ev("cuda_runtime", "cudaLaunchKernel", 410, 2, 2, correlation=3),
          _ev("cpu_op", BWD + "TanhBackward0", 500, 100, 2, **{"Sequence number": 9, "Fwd thread id": 1}),
          _ev("user_annotation", "rnnt.joint", 510, 30, 2),
          _ev("cpu_op", "aten::mm", 515, 10, 2, **{"Sequence number": 3, "Fwd thread id": 0}),
          _ev("cuda_runtime", "cudaLaunchKernel", 517, 2, 2, correlation=4),
          _ev("cpu_op", BWD + "MmBackward0", 600, 20, 2, **{"Sequence number": 3, "Fwd thread id": 2}),
          _ev("cuda_runtime", "cudaLaunchKernel", 605, 2, 2, correlation=5),
          _ev("cuda_runtime", "cudaLaunchKernel", 800, 2, 1, correlation=6)]
    for corr, (ts, dur) in enumerate([(30, 100), (220, 50), (420, 200), (520, 10), (620, 30), (810, 40)], 1):
        ev.append(_ev("kernel", f"k{corr}", ts, dur, 7, correlation=corr))
    return ev


BWD = "autograd::engine::evaluate_function: "


def test_regions_attribute_backward_and_recompute_launches():
    got = Regions(_synthetic_events()).device_s(0, 1000)
    assert got == pytest.approx({"rnnt.encode": 300e-6, "rnnt.joint": 90e-6, None: 40e-6})


def test_metrics_read_the_synthetic_trace():
    events = _synthetic_events()
    rec = Record(cell=NAME, config=spec.cell(NAME)["config_data"], traffic={}, chips=1)
    rec.trace, rec.trace_extent = Trace(events), (0, 1000)
    rec.window = {"device_s": {str(k): v for k, v in Regions(events).device_s(0, 1000).items()}}
    assert spec.reader("rnnt_encode_ms").read(rec) == pytest.approx(0.3)
    assert spec.reader("rnnt_joint_ms").read(rec) == pytest.approx(0.09)
    assert spec.reader("rnnt_lattice_ms").read(rec) is None  # no lattice span in this trace
    rec.window_s, rec.steps = 2.0, [{"utterances": [(1600, 60), (800, 30)]}]
    w = conformer_flops.Widths.from_config(rec.config)
    want = 100 * 3 * (conformer_flops.forward_flops(w, 1600, 60) + conformer_flops.forward_flops(w, 800, 30)) / 2.0
    assert spec.reader("rnnt_train_mfu").read(rec) == pytest.approx(want / 989e12)
    rec.window = {}  # a program without the spans: the readers find nothing
    assert spec.reader("rnnt_encode_ms").read(rec) is None


def test_parent_stops_at_once_without_the_model(monkeypatch, tmp_path):
    """A program that cannot build the configuration raises before the corpus
    is written."""
    from tfkaldi_tpu_torch.models import transformer

    def refuse(self):
        raise ValueError("no such encoder")

    monkeypatch.setattr(transformer.TransformerConfig, "__post_init__", refuse)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(ValueError, match="no such encoder"):
        prun.run_cell(tiny(), SEED, 1.0, False, "cpu")
    assert not list(tmp_path.glob("portbench-*/corpus"))

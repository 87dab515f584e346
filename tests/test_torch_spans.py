"""The port's ``torch.profiler`` spans at its layer boundaries: the training
controller's ``train.validate``, ``train.checkpoint``, ``prefetch.next``
and the prefetch worker's ``prefetch.build`` under the program's own
``utils.profiling`` trace (every thread), and ``Decoder.decode_to_writer``'s
``decode.read`` / ``decode.compute`` / ``decode.fetch`` / ``decode.write``
under a plain ``torch.profiler`` of the calling thread, as the benchmark
runs it. The benchmark's trace parser still takes the thread that holds
these spans as its host thread."""

import json
import math
import threading

import numpy as np
import pytest
import torch

from portbench.trace import Trace as BenchTrace
from tests.test_torch_controller import _pipeline
from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.convert import dnn_from_jax
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.decode.decoder import Decoder
from tfkaldi_tpu_torch.io import ArkWriter
from tfkaldi_tpu_torch.models import DNN, DNNConfig
from tfkaldi_tpu_torch.train import checkpoint as ckpt
from tfkaldi_tpu_torch.utils.profiling import trace_profile

DECODE_SPANS = ("decode.read", "decode.compute", "decode.fetch", "decode.write")


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _spans(events, name):
    """``(start, end, tid)`` of each ``name`` annotation, by start."""
    return sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == name)


def _outermost(spans):
    return [s for s in spans if not any(o is not s and o[0] <= s[0] and s[1] <= o[1] for o in spans)]


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _bench_host_tids(path):
    return {h[3] for h in BenchTrace.load(path)._host}


def test_trace_records_every_thread(tmp_path):
    """A span on a thread started before the program's trace is in it,
    under that thread's id."""
    go, done = threading.Event(), threading.Event()

    def work():
        go.wait(timeout=30)
        with torch.profiler.record_function("worker.span"):
            torch.ones(4).sum()
        done.set()

    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    with trace_profile(str(tmp_path / "p")) as trace:
        go.set()
        assert done.wait(timeout=30)
    worker.join(timeout=30)
    assert not worker.is_alive()
    (span,) = _spans(_events(trace.path), "worker.span")
    assert span[2] == worker.native_id != threading.get_native_id()


@pytest.mark.parametrize("case", ["steady", "rollback"])
def test_controller_spans(tmp_path, monkeypatch, case):
    """Under the program's trace of a whole run: one ``train.validate`` a
    validation (the baseline too); each outermost ``train.checkpoint`` holds
    exactly one file written, and every file write lies in one; each
    ``prefetch.next`` lies inside a ``train_step``; ``prefetch.build`` runs
    on the worker's thread, at least once a step."""
    rollback = case == "rollback"
    controller, _, _ = _pipeline(tmp_path, lr=100.0 if rollback else 1e-3, valid_retries=1, valid_adapt=rollback)
    validations = []
    controller.validation_hook = lambda step, loss: validations.append(step)
    save = ckpt._atomic_save

    def marked_save(obj, path):
        with torch.profiler.record_function("test.file_written"):
            save(obj, path)

    monkeypatch.setattr(ckpt, "_atomic_save", marked_save)
    with trace_profile(str(tmp_path / "trace")) as trace:
        state = controller.train()
    assert (state.lr_fact < 1.0) == rollback
    events = _events(trace.path)
    steps = _spans(events, "train_step")
    (main,) = {s[2] for s in steps}
    assert len(steps) >= 4
    assert len(_spans(events, "train.validate")) == 1 + len(validations) >= 3

    writes = _spans(events, "test.file_written")
    outer = _outermost(_spans(events, "train.checkpoint"))
    assert outer and len(writes) == len(outer)
    for span in outer:
        assert sum(_inside(w, span) for w in writes) == 1

    nexts = _spans(events, "prefetch.next")
    assert len(nexts) == len(steps)
    assert all(any(_inside(n, s) for s in steps) for n in nexts)
    builds = _spans(events, "prefetch.build")
    assert len(builds) >= len(steps) and main not in {b[2] for b in builds}
    assert _bench_host_tids(trace.path) == {main}


def _decode(tmp_path, profiled: bool):
    featdir, _, info = synthetic.make_featdir(tmp_path)
    input_dim = info["feat_dim"] * 3
    params, state = synthetic.random_dnn_pytree(input_dim, 16, 2, 7, seed=3)
    model = DNN(DNNConfig(input_dim=input_dim, num_labels=7, num_hidden_layers=2, num_hidden_units=16,
                          batch_norm=True))
    model.load_state_dict(dnn_from_jax(params, state))
    decoder = Decoder(model, np.full(7, 1 / 7, np.float32))
    reader = FeatureReader(f"{featdir}/feats.scp", f"{featdir}/cmvn.scp", f"{featdir}/utt2spk", 1, 60)
    ark = str(tmp_path / "likes.ark")
    trace = None
    with ArkWriter(str(tmp_path / "likes.scp"), ark) as writer:
        if profiled:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                count = decoder.decode_to_writer(reader, writer, batch_size=4, bucket_multiple=16)
            trace = str(tmp_path / "trace.json")
            prof.export_chrome_trace(trace)
        else:
            count = decoder.decode_to_writer(reader, writer, batch_size=4, bucket_multiple=16)
    reader.close()
    with open(ark, "rb") as f:
        return count, f.read(), trace


def test_decode_spans(tmp_path):
    """One ``decode.read``, ``decode.compute``, ``decode.fetch`` and
    ``decode.write`` a batch, in that order, none overlapping the next, and
    the ``decode.read`` that ends the stream; the ark's bytes are those of a
    run with no profiler."""
    count, plain, _ = _decode(tmp_path / "plain", False)
    count_p, traced, path = _decode(tmp_path / "traced", True)
    assert count_p == count > 0 and traced == plain
    events = _events(path)
    spans = sorted((s, e, tid, name) for name in DECODE_SPANS for s, e, tid in _spans(events, name))
    batches = math.ceil(count / 4)
    assert [name for *_, name in spans] == list(DECODE_SPANS) * batches + ["decode.read"]
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    (main,) = {tid for _, _, tid, _ in spans}
    assert _bench_host_tids(path) == {main}

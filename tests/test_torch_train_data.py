"""The port's training data layer against the JAX package's, on the CPU.

The dispensers read the same featdir and alignment archive
(tests/synthetic.make_featdir); their batches and every cursor operation
(``skip_batch``, ``return_batch``, ``split``) must match byte for byte.
The prefetcher is held to the cases of tests/test_prefetch.py.
"""

import numpy as np
import pytest
import torch

from tests.synthetic import make_featdir
from tfkaldi_tpu.data import AlignmentBatchDispenser as JaxDispenser
from tfkaldi_tpu.data import AlignmentCoder as JaxCoder
from tfkaldi_tpu.data import DeviceBatcher as JaxBatcher
from tfkaldi_tpu.data import FeatureReader as JaxReader
from tfkaldi_tpu.data import identity_normalizer as jax_identity
from tfkaldi_tpu_torch.data.batching import DeviceBatcher
from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.data.prefetch import PrefetchingBatchSource
from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer


def _featdir(tmp_path):
    # utterances of 1-2 frames (< 2c+1 = 3) are too short to splice
    return make_featdir(tmp_path, num_speakers=2, utts_per_speaker=8, min_frames=1, max_frames=12)


def _dispensers(featdir, alifile, info, batch=4):
    args = (f"{featdir}/feats.scp", f"{featdir}/cmvn.scp", f"{featdir}/utt2spk", 1, 60)
    port = AlignmentBatchDispenser(FeatureReader(*args), AlignmentCoder(identity_normalizer, info["num_labels"]),
                                   batch, alifile)
    ref = JaxDispenser(JaxReader(*args), JaxCoder(jax_identity, info["num_labels"]), batch, alifile)
    return port, ref


def _same(a, b):
    for x, y in zip(a.fields() if hasattr(a, "fields") else a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def test_dispenser_batches_and_cursor_ops_match_jax(tmp_path):
    featdir, alifile, info = _featdir(tmp_path)
    port, ref = _dispensers(featdir, alifile, info)
    pb, rb = DeviceBatcher(bucket_multiple=16), JaxBatcher(bucket_multiple=16)
    assert port.num_utt == ref.num_utt and port.num_batches == ref.num_batches
    assert port._usable == ref._usable and len(port._usable) < port.num_utt

    def step(op):
        if op == "get":
            p, r = port.get_padded_batch(pb), ref.get_padded_batch(rb)
            _same(p, (r.inputs, r.targets, r.input_lengths, r.target_lengths))
        else:
            getattr(port, op)()
            getattr(ref, op)()
        assert port.feature_reader.reader.scp_position == ref.feature_reader.reader.scp_position, op

    for op in ["get", "split", "get", "get", "skip_batch", "get", "return_batch", "return_batch",
               "get", "get", "get", "skip_batch", "skip_batch", "get", "return_batch", "get"]:
        step(op)
    np.testing.assert_array_equal(port.compute_target_count(), ref.compute_target_count())


def test_device_batcher_pads_like_jax():
    rng = np.random.default_rng(0)
    inputs = [rng.standard_normal((n, 5)).astype(np.float32) for n in (7, 130, 1)]
    targets = [rng.integers(0, 9, n).astype(np.int32) for n in (7, 130, 1)]
    for kw in ({"bucket_multiple": 128}, {"bucket_multiple": 16}, {"fixed_input_length": 200, "fixed_target_length": 150}):
        p, r = DeviceBatcher(**kw)(inputs, targets), JaxBatcher(**kw)(inputs, targets)
        _same(p, (r.inputs, r.targets, r.input_lengths, r.target_lengths))
        assert p.num_frames == r.num_frames == 138
    with pytest.raises(ValueError):
        DeviceBatcher(fixed_input_length=100)(inputs, targets)
    on = DeviceBatcher(bucket_multiple=16)(inputs, targets).to("cpu")
    assert isinstance(on.inputs, torch.Tensor) and on.inputs.shape == (3, 144, 5)


def _prefetch_dispenser(tmp_path, batch=4):
    featdir, alifile, info = make_featdir(tmp_path, num_speakers=2, utts_per_speaker=8)
    return _dispensers(featdir, alifile, info, batch)[0]


def test_prefetch_delivers_same_batches_as_direct(tmp_path):
    disp_a = _prefetch_dispenser(tmp_path / "a")
    disp_b = _prefetch_dispenser(tmp_path / "b")
    batcher = DeviceBatcher(bucket_multiple=16)
    direct = [batcher(*disp_a.get_batch()) for _ in range(4)]
    with PrefetchingBatchSource(disp_b, batcher, depth=2, device="cpu") as source:
        fetched = [source.next() for _ in range(4)]
    for d, f in zip(direct, fetched):
        assert isinstance(f.inputs, torch.Tensor)
        np.testing.assert_array_equal(d.inputs, f.inputs.numpy())
        np.testing.assert_array_equal(d.targets, f.targets.numpy())


def test_prefetch_rewind_replays_batches(tmp_path):
    disp = _prefetch_dispenser(tmp_path)
    with PrefetchingBatchSource(disp, DeviceBatcher(bucket_multiple=16), depth=2, device="cpu") as source:
        first = [source.next() for _ in range(2)]
        source.rewind(2)  # un-consume both (plus whatever was buffered)
        replay = [source.next() for _ in range(2)]
    for a, b in zip(first, replay):
        assert torch.equal(a.inputs, b.inputs) and torch.equal(a.targets, b.targets)


def test_prefetch_partial_rewind(tmp_path):
    disp = _prefetch_dispenser(tmp_path)
    with PrefetchingBatchSource(disp, DeviceBatcher(bucket_multiple=16), depth=1, device="cpu") as source:
        b0 = source.next()
        b1 = source.next()
        source.rewind(1)  # un-consume only b1
        again = source.next()
    assert torch.equal(b1.inputs, again.inputs)
    assert not torch.equal(b0.inputs, again.inputs)


def test_worker_failure_raises_in_next():
    """A dispenser exception on the worker thread surfaces in next()
    instead of deadlocking the training loop."""

    class BoomDispenser:
        def get_padded_batch(self, batcher):
            raise ValueError("boom")

    src = PrefetchingBatchSource(BoomDispenser(), DeviceBatcher(), depth=1, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="prefetch worker failed"):
            src.next()
    finally:
        src.close()

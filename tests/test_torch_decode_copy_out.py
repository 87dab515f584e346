"""How ``Decoder.decode_to_writer`` hands a batch's likelihoods to the
writer (``decode.fetch``): one float32 matrix of real rows an utterance,
which never changes after the writer gets it, and the ``copy_out`` counts
of rows computed against rows handed over.

On the CPU the matrices are views of the batch's output. On a card only
the real rows are copied, into page-locked host memory; the tests marked
``cuda`` hold that path to the plain ``.cpu().numpy()`` of the padded batch
byte for byte, and skip without a card. The file imports no JAX:

    python -m pytest tests/test_torch_decode_copy_out.py --noconftest -q -m cuda
"""

import numpy as np
import pytest
import torch

from tfkaldi_tpu_torch import synthetic
from tfkaldi_tpu_torch.convert import dnn_from_jax
from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
from tfkaldi_tpu_torch.decode import decoder as decoder_mod
from tfkaldi_tpu_torch.decode.decoder import Decoder, fetch_real_rows
from tfkaldi_tpu_torch.decode.streaming import pick_stream
from tfkaldi_tpu_torch.io import ArkWriter
from tfkaldi_tpu_torch.models import DNN, DNNConfig

BATCH, BUCKET, CONTEXT = 4, 16, 1


class KeepingWriter:
    """``ArkWriter``'s surface: keeps every matrix it is handed, as handed,
    and a copy of it taken at the call."""

    def __init__(self):
        self.kept, self.at_call = {}, {}

    def write_next_utt(self, utt_id, mat):
        self.kept[utt_id] = mat
        self.at_call[utt_id] = np.array(mat)


def _job(tmp_path, device="cpu", labels=7, units=16, **featdir):
    """A seeded batchnorm DNN's decoder and a reader factory over a featdir
    whose batches pad to several ``T_pad``."""
    featdir_path, _, info = synthetic.make_featdir(tmp_path, **featdir)
    input_dim = info["feat_dim"] * (2 * CONTEXT + 1)
    params, state = synthetic.random_dnn_pytree(input_dim, units, 2, labels, seed=3)
    model = DNN(DNNConfig(input_dim=input_dim, num_labels=labels, num_hidden_layers=2, num_hidden_units=units,
                          batch_norm=True))
    model.load_state_dict(dnn_from_jax(params, state))
    prior = np.random.default_rng(9).uniform(0.5, 1.5, labels).astype(np.float32)
    decoder = Decoder(model.to(device), prior / prior.sum())

    def reader():
        return FeatureReader(f"{featdir_path}/feats.scp", f"{featdir_path}/cmvn.scp", f"{featdir_path}/utt2spk",
                             CONTEXT, 10_000)

    return decoder, reader


def _batches(reader_factory):
    reader = reader_factory()
    try:
        return list(pick_stream(reader)(reader, batch_size=BATCH, bucket_multiple=BUCKET))
    finally:
        reader.close()


def _decode(decoder, reader_factory, writer):
    reader = reader_factory()
    try:
        return decoder.decode_to_writer(reader, writer, batch_size=BATCH, bucket_multiple=BUCKET)
    finally:
        reader.close()


def test_kept_records_equal_a_fresh_compute(tmp_path):
    """A writer that keeps every matrix: after a job of batches with
    different ``T_pad``, each kept matrix is its batch's fresh
    ``compute_batch`` cut to its length, and unchanged since its call."""
    decoder, reader = _job(tmp_path, min_frames=20, max_frames=90)
    batches = _batches(reader)
    assert len({inputs.shape[1] for _, inputs, _ in batches}) > 1
    writer = KeepingWriter()
    count = _decode(decoder, reader, writer)
    assert count == sum(len(ids) for ids, _, _ in batches) == len(writer.kept)
    for utt_ids, inputs, lengths in batches:
        fresh = decoder.compute_batch(inputs, lengths).numpy()
        for i, utt in enumerate(utt_ids):
            got = writer.kept[utt]
            assert got.dtype == np.float32 and got.shape == (lengths[i], fresh.shape[2])
            np.testing.assert_array_equal(got, fresh[i, : lengths[i]])
            np.testing.assert_array_equal(got, writer.at_call[utt])


def test_copy_out_counts(tmp_path):
    """Over a job: one batch a fetch, every padded row computed, the real
    rows alone handed over, and no pinned copy on the CPU."""
    decoder, reader = _job(tmp_path, min_frames=20, max_frames=90)
    batches = _batches(reader)
    before = dict(decoder_mod.copy_out)
    _decode(decoder, reader, KeepingWriter())
    delta = {k: v - before[k] for k, v in decoder_mod.copy_out.items()}
    assert delta == {
        "batches": len(batches),
        "rows_computed": sum(inputs.shape[0] * inputs.shape[1] for _, inputs, _ in batches),
        "rows_copied": sum(int(n) for _, _, lengths in batches for n in lengths),
        "pinned_batches": 0,
    }
    assert delta["rows_copied"] < delta["rows_computed"]


@pytest.mark.parametrize("lengths", [[5, 3, 7], [6, 6], [4], [0, 2]], ids=["ragged", "equal", "one", "empty"])
def test_fetch_real_rows_on_the_cpu(lengths):
    """CPU: views of the batch's own memory, one an utterance, in order,
    with no copy."""
    out = torch.randn(len(lengths), 8, 5)
    got = fetch_real_rows(out, np.asarray(lengths, np.int32))
    assert len(got) == len(lengths)
    for i, n in enumerate(lengths):
        np.testing.assert_array_equal(got[i], out[i, :n].numpy())
        assert got[i].dtype == np.float32 and got[i].shape == (n, 5)
        if n:
            assert np.shares_memory(got[i], out.numpy())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned copy out runs only on a card")
    from tfkaldi_tpu_torch.device import resolve_device

    return resolve_device("cuda")


class ArkAndFirstBatch:
    """An ``ArkWriter`` that also keeps the first ``keep`` matrices it is
    handed, so that the later batches' host blocks are reused around them."""

    def __init__(self, scp, ark, keep):
        self.ark, self.keep, self.kept = ArkWriter(scp, ark), keep, []

    def write_next_utt(self, utt_id, mat):
        if len(self.kept) < self.keep:
            self.kept.append(mat)
        self.ark.write_next_utt(utt_id, mat)


@pytest.mark.cuda
def test_pinned_copy_out_is_the_padded_copy_byte_for_byte(card, tmp_path):
    """On the card: the job's ark bytes equal those of the old route (the
    whole padded batch through ``.cpu().numpy()``, cut on the host); the
    matrices live in pinned memory; one pinned copy a batch; the first
    batch's matrices, kept through the job, still equal the old route's."""
    decoder, reader = _job(tmp_path, device=card, labels=2000, units=256, num_speakers=3, utts_per_speaker=10,
                           min_frames=40, max_frames=700, feat_dim=40)
    batches = _batches(reader)
    assert len({inputs.shape[1] for _, inputs, _ in batches}) > 1

    oracle, want = tmp_path / "oracle.ark", {}
    with ArkWriter(str(tmp_path / "oracle.scp"), str(oracle)) as w:
        for utt_ids, inputs, lengths in batches:
            out = decoder.compute_batch(inputs, lengths).cpu().numpy()
            for i, utt in enumerate(utt_ids):
                w.write_next_utt(utt, out[i, : lengths[i]])
                want[utt] = out[i, : lengths[i]]

    before = dict(decoder_mod.copy_out)
    writer = ArkAndFirstBatch(str(tmp_path / "likes.scp"), str(tmp_path / "likes.ark"), BATCH)
    with writer.ark:
        count = _decode(decoder, reader, writer)
    delta = {k: v - before[k] for k, v in decoder_mod.copy_out.items()}
    assert count == len(want)
    assert (tmp_path / "likes.ark").read_bytes() == oracle.read_bytes()
    assert delta["pinned_batches"] == delta["batches"] == len(batches)
    assert delta["rows_copied"] == sum(int(n) for _, _, lengths in batches for n in lengths)
    first_ids = batches[0][0]
    for utt, mat in zip(first_ids, writer.kept):
        assert torch.from_numpy(mat).is_pinned()
        np.testing.assert_array_equal(mat, want[utt])

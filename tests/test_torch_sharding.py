"""The port's scp sharding (tfkaldi_tpu_torch/data/sharding.py) against the
JAX package's (tfkaldi_tpu/data/sharding.py), and the port's dispenser cap
on ``num_batches``; the cases of tests/test_multihost.py:15-36."""

import os

import pytest

from tfkaldi_tpu.data import sharding as jax_sharding
from tfkaldi_tpu_torch.data import sharding

LINES = [f"utt{i} a.ark:{i}\n" for i in range(23)]


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 5])
def test_shard_lines_equal_jax(num_shards, drop_remainder):
    shards = [sharding.shard_scp_lines(LINES, num_shards, i, drop_remainder) for i in range(num_shards)]
    for i, shard in enumerate(shards):
        assert shard == jax_sharding.shard_scp_lines(LINES, num_shards, i, drop_remainder)
    # disjoint, strided, and covering (all of it, or its multiple of num_shards)
    got = sorted(line for s in shards for line in s)
    kept = LINES[: len(LINES) - len(LINES) % num_shards] if drop_remainder else LINES
    assert got == sorted(kept)
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= (0 if drop_remainder else 1)
    assert all(line == LINES[i + k * num_shards] for i, s in enumerate(shards) for k, line in enumerate(s))


def test_shard_index_out_of_range_raises():
    with pytest.raises(ValueError, match="not in"):
        sharding.shard_scp_lines(LINES, 3, 3)


@pytest.mark.parametrize("drop_remainder", [False, True])
def test_shard_scp_file_equals_jax(tmp_path, drop_remainder):
    scp = tmp_path / "port" / "feats.scp"
    ref = tmp_path / "jax" / "feats.scp"
    for path in (scp, ref):
        path.parent.mkdir()
        path.write_text("".join(f"utt{i} a.ark:{i}\n" for i in range(10)))
    for i in range(3):
        out = sharding.shard_scp(str(scp), num_shards=3, shard_index=i, drop_remainder=drop_remainder)
        want = jax_sharding.shard_scp(str(ref), num_shards=3, shard_index=i, drop_remainder=drop_remainder)
        assert out.endswith(f".shard{i}of3.scp") and os.path.basename(out) == os.path.basename(want)
        assert out == sharding.shard_path(str(scp), 3, i)
        assert open(out).read() == open(want).read()
    assert open(sharding.shard_path(str(scp), 3, 0)).read() == (
        "utt0 a.ark:0\nutt3 a.ark:3\nutt6 a.ark:6\n" + ("" if drop_remainder else "utt9 a.ark:9\n"))


def test_one_shard_is_the_original_path(tmp_path):
    scp = tmp_path / "feats.scp"
    scp.write_text("utt0 a.ark:0\n")
    assert sharding.shard_scp(str(scp), num_shards=1, shard_index=0) == str(scp)
    # no process group: the defaults are one shard, index 0
    assert sharding.shard_scp(str(scp)) == str(scp)
    assert os.listdir(tmp_path) == ["feats.scp"]


def test_dispenser_limit_num_batches(tmp_path):
    """The port's Python dispenser caps ``num_batches`` at an agreed value,
    as the JAX one (tfkaldi_tpu/data/dispenser.py:154) and the port's bulk
    loader do."""
    from tfkaldi_tpu_torch import synthetic
    from tfkaldi_tpu_torch.data.dispenser import AlignmentBatchDispenser
    from tfkaldi_tpu_torch.data.feature_reader import FeatureReader
    from tfkaldi_tpu_torch.data.target_coder import AlignmentCoder
    from tfkaldi_tpu_torch.data.target_normalizers import identity_normalizer

    featdir, alifile, _ = synthetic.make_featdir(str(tmp_path), num_speakers=2, utts_per_speaker=5, feat_dim=4,
                                                 num_labels=3)
    reader = FeatureReader(f"{featdir}/feats.scp", f"{featdir}/cmvn.scp", f"{featdir}/utt2spk", 1, 60)
    disp = AlignmentBatchDispenser(reader, AlignmentCoder(identity_normalizer, 3), 4, alifile)
    assert disp.num_batches == 2.5
    disp.limit_num_batches(2.25)
    assert disp.num_batches == 2.25
    disp.limit_num_batches(7.0)  # a cap above the count leaves it
    assert disp.num_batches == 2.5
    reader.close()


def test_port_featdir_equals_the_tests_featdir(tmp_path):
    """``synthetic.make_featdir`` writes the bytes of tests/synthetic.py's
    copy for the same seed."""
    from tests.synthetic import make_featdir
    from tfkaldi_tpu_torch import synthetic

    (tmp_path / "jax").mkdir()
    synthetic.make_featdir(str(tmp_path / "port"), num_speakers=2, utts_per_speaker=3, feat_dim=5, num_labels=4,
                           learnable=True, seed=3)
    make_featdir(tmp_path / "jax", num_speakers=2, utts_per_speaker=3, feat_dim=5, num_labels=4, learnable=True,
                 seed=3)
    for name in ("feats.ark", "feats.scp", "cmvn.ark", "utt2spk", "spk2utt", "maxlength"):
        got = (tmp_path / "port" / "featdir" / name).read_bytes()
        want = (tmp_path / "jax" / "featdir" / name).read_bytes()
        if name.endswith(".scp"):
            got, want = (b.replace(str(tmp_path / d).encode(), b"") for b, d in ((got, "port"), (want, "jax")))
        assert got == want, name
    import gzip

    assert gzip.open(tmp_path / "port" / "pdf.all.gz").read() == gzip.open(tmp_path / "jax" / "pdf.all.gz").read()

"""The port's strict Kaldi consumer (``tfkaldi_tpu_torch.io.kaldi_compat``
on its copy of native/kaldi_consumer.cpp) against the JAX package's, on the
same good and corrupt arks: the record counts, every record (key and
matrix, sequentially and at its scp offset), the error codes, the
``copy-feats`` rewrite and ``validate_archive`` (the cases of
tests/test_kaldi_consumer.py). Tolerance 0: both read the same bytes.
"""

import struct

import numpy as np
import pytest

from tfkaldi_tpu.io import kaldi_compat as jax_kc
from tfkaldi_tpu_torch.io import ArkReader, ArkWriter
from tfkaldi_tpu_torch.io import kaldi_compat as kc


@pytest.fixture(autouse=True)
def _built():
    if not (kc.available() and jax_kc.available()):
        pytest.fail("a native Kaldi consumer did not build")


def _outcome(fn, *args):
    """What a consumer call gives: ``("ok", value)`` with matrices as bytes,
    or ``("error", code)``."""
    try:
        value = fn(*args)
    except jax_kc.KaldiFormatError as e:  # the JAX class
        return "error", e.code, "jax"
    except kc.KaldiFormatError as e:
        return "error", e.code, "port"
    if isinstance(value, tuple):  # (key, matrix)
        return "ok", value[0], value[1].dtype.str, value[1].shape, value[1].tobytes()
    if isinstance(value, np.ndarray):
        return "ok", value.dtype.str, value.shape, value.tobytes()
    return "ok", value


def _same(name, *args):
    got, want = _outcome(getattr(kc, name), *args), _outcome(getattr(jax_kc, name), *args)
    if got[0] == "error":
        assert got[:2] == want[:2] and got[2] == "port" and want[2] == "jax", (got, want)
    else:
        assert got == want
    return got


def _corpus(tmp_path, n=12, seed=0):
    rng = np.random.default_rng(seed)
    scp, ark = str(tmp_path / "f.scp"), str(tmp_path / "f.ark")
    mats = {}
    with ArkWriter(scp, ark) as w:
        for i in range(n):
            key = f"spk{i % 3}_utt{i}" + "x" * int(rng.integers(0, 20))
            mats[key] = rng.standard_normal((int(rng.integers(1, 200)), int(rng.integers(1, 50)))).astype(np.float32)
            w.write_next_utt(key, mats[key])
    return scp, ark, mats


def _raw_ark(tmp_path, name, payload: bytes) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(payload)
    return path


def _fm(key: bytes, rows, cols, data: bytes, marker=4, token=b"FM ") -> bytes:
    return key + b"\x00B" + token + struct.pack("<bi", marker, rows) + struct.pack("<bi", 4, cols) + data


def _bad_arks(tmp_path):
    one = np.ones((1, 2), np.float32).tobytes()
    mat = np.arange(6, dtype=np.float32).reshape(2, 3)
    rng = np.random.default_rng(2)
    dms = b"".join(f"u{i} ".encode() + b"\x00BDM " + struct.pack("<bi", 4, 3) + struct.pack("<bi", 4, 4)
                   + rng.standard_normal((3, 4)).astype("<f8").tobytes() for i in range(3))
    cap_rows = 1 << 13
    return {
        "text_record": _raw_ark(tmp_path, "text.ark", b"utt1 1.0 2.0\n"),
        "reference_writer_no_space": _raw_ark(tmp_path, "ref.ark", _fm(b"utt1", 2, 3, mat.tobytes())),
        "size_marker_8": _raw_ark(tmp_path, "marker.ark", _fm(b"utt1 ", 1, 2, one, marker=8)),
        "truncated_payload": _raw_ark(tmp_path, "trunc.ark", _fm(b"utt1 ", 1, 2, one[:-2])),
        "unknown_token": _raw_ark(tmp_path, "token.ark", b"utt1 \x00BXM " + struct.pack("<bi", 4, 1)),
        "implausible_dims": _raw_ark(tmp_path, "dims.ark", _fm(b"u1 ", 1 << 30, 1 << 30, b"")),
        "retry_cap": _raw_ark(tmp_path, "cap.ark", _fm(b"u1 ", cap_rows, kc._MAX_RETRY_ELEMS // cap_rows, b"")),
        "below_retry_cap": _raw_ark(tmp_path, "cap2.ark", _fm(b"u1 ", 1, (1 << 21) + 1, b"")),
        "negative_dims": _raw_ark(tmp_path, "neg.ark", _fm(b"u1 ", -1, 2, one)),
        "double_records": _raw_ark(tmp_path, "dm.ark", dms),
        "missing": str(tmp_path / "absent.ark"),
    }


def test_errors_and_cap_match():
    assert kc.ERRORS == jax_kc.ERRORS
    assert kc._MAX_RETRY_ELEMS == jax_kc._MAX_RETRY_ELEMS
    assert issubclass(kc.KaldiFormatError, IOError)


def test_good_corpus_reads_the_same(tmp_path):
    """An ArkWriter corpus: counts, every record sequentially and at its scp
    offset, validate_archive and the copy-feats rewrite, byte for byte."""
    scp, ark, mats = _corpus(tmp_path)
    assert _same("count", ark) == ("ok", len(mats))
    for i, (key, mat) in enumerate(mats.items()):
        assert _same("seq_read", ark, i)[1:] == (key, "<f4", mat.shape, mat.tobytes())
    with ArkReader(scp) as reader:
        for key, (path, offset) in zip(reader.utt_ids, reader.scp_data):
            assert _same("read_at", path, offset)[3] == mats[key].tobytes()
    assert _same("validate_archive", scp) == ("ok", len(mats))
    _same("seq_read", ark, len(mats))  # past the end
    outs = {}
    for name, module in (("port", kc), ("jax", jax_kc)):
        out_ark, out_scp = str(tmp_path / f"{name}.ark"), str(tmp_path / f"{name}.scp")
        assert module.copy_feats(ark, out_ark, out_scp) == len(mats)
        outs[name] = open(out_ark, "rb").read()
        assert kc.validate_archive(out_scp) == len(mats)
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("case", ["text_record", "reference_writer_no_space", "size_marker_8", "truncated_payload",
                                  "unknown_token", "implausible_dims", "retry_cap", "below_retry_cap",
                                  "negative_dims", "double_records", "missing"])
def test_corrupt_arks_fail_alike(tmp_path, case):
    """Each malformed ark gives the same count, the same records and the
    same error codes from both consumers, sequentially and at offsets."""
    ark = _bad_arks(tmp_path)[case]
    count = _same("count", ark)
    for index in range(3):
        _same("seq_read", ark, index)
    for offset in (0, 3, 4, 5):
        _same("read_at", ark, offset)
    if case == "reference_writer_no_space":
        # the key swallows the binary header in a sequential read; the scp offset still works
        assert count[0] == "error" and _same("read_at", ark, 4)[0] == "ok"
    if case == "double_records":
        assert count == ("ok", 3)
        copied = str(tmp_path / "dm_copy.ark")
        assert _same("copy_feats", ark, copied, str(tmp_path / "dm_copy.scp")) == ("ok", 3)


def test_random_corruption_fails_alike(tmp_path):
    """Byte flips of a valid ark (half of them in the first record's framing
    bytes): every sequential read succeeds or raises with the same code on
    both consumers."""
    rng = np.random.default_rng(11)
    _, ark, mats = _corpus(tmp_path, n=6, seed=11)
    good = open(ark, "rb").read()
    errors = 0
    for trial in range(40):
        blob = bytearray(good)
        span = 24 if trial % 2 == 0 else len(blob)
        for _ in range(int(rng.integers(1, 4))):
            blob[int(rng.integers(0, span))] = int(rng.integers(0, 256))
        bad = _raw_ark(tmp_path, f"fuzz{trial}.ark", bytes(blob))
        _same("count", bad)
        for index in range(len(mats)):
            if _same("seq_read", bad, index)[0] == "error":
                errors += 1
                break
    assert errors > 0

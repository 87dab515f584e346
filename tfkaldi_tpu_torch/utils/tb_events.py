"""Self-contained TensorBoard event-file writer and reader (numpy only).

A copy of :mod:`tfkaldi_tpu.utils.tb_events`, kept in the port so that it
imports nothing of the JAX package; the bytes it writes are the JAX
writer's for the same calls. It implements the on-disk format the
reference's ``visualise = True`` writes (trainer.py:207-211, 249-258 via
``tf.train.SummaryWriter``) without TensorFlow or ``torch.utils.tensorboard``:

- TFRecord framing: ``uint64 length | uint32 masked_crc(length) |
  data | uint32 masked_crc(data)`` with CRC-32C (Castagnoli) and TF's
  mask rotation.
- Hand-encoded protobuf for the two messages TensorBoard needs:
  ``Event{wall_time=1, step=2, file_version=3, summary=5}`` and
  ``Summary.Value{tag=1, simple_value=2, histo=5}`` with
  ``HistogramProto{min=1,max=2,num=3,sum=4,sum_squares=5,
  bucket_limit=6,bucket=7}`` (field numbers from tensorflow
  event.proto/summary.proto, a stable public wire format).

:func:`read_events` parses a file back, checking the CRC framing the way
TensorBoard's record reader does.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

# ---------------------------------------------------------------------------
# CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) + TF masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", float(value))


def _float_field(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(value))


def _varint_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(int(value))


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _packed_doubles(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _bytes_field(field, payload)


def _scalar_value(tag: str, value: float) -> bytes:
    # Summary.Value{tag=1, simple_value=2}
    return _bytes_field(1, tag.encode()) + _float_field(2, value)


def _histogram_proto(values: np.ndarray, bins: int = 30) -> bytes:
    v = np.asarray(values, np.float64).ravel()
    if v.size == 0:
        v = np.zeros(1)
    counts, edges = np.histogram(v, bins=bins)
    msg = (
        _double_field(1, float(v.min()))
        + _double_field(2, float(v.max()))
        + _double_field(3, float(v.size))
        + _double_field(4, float(v.sum()))
        + _double_field(5, float(np.square(v).sum()))
        # TensorBoard pairs bucket i with right edge bucket_limit[i]
        + _packed_doubles(6, edges[1:])
        + _packed_doubles(7, counts)
    )
    return msg


def _histo_value(tag: str, values: np.ndarray) -> bytes:
    # Summary.Value{tag=1, histo=5}
    return _bytes_field(1, tag.encode()) + _bytes_field(5, _histogram_proto(values))


def _event(step: int | None, summary_values: list | None, file_version: str | None = None,
           wall_time: float | None = None) -> bytes:
    # Event{wall_time=1, step=2, file_version=3, summary=5}
    msg = _double_field(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        msg += _varint_field(2, step)
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())
    if summary_values:
        # Summary{repeated Value value = 1}: each value body wraps as a
        # length-delimited field-1 entry inside the Summary submessage
        summary = b"".join(_bytes_field(1, v) for v in summary_values)
        msg += _bytes_field(5, summary)
    return msg


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------


class EventFileWriter:
    """Append-only ``events.out.tfevents.*`` writer TensorBoard can read."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self._path = os.path.join(logdir, name)
        self._fid = open(self._path, "ab")
        self._write_record(_event(None, None, file_version="brain.Event:2"))

    @property
    def path(self) -> str:
        return self._path

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._fid.write(header)
        self._fid.write(struct.pack("<I", masked_crc(header)))
        self._fid.write(data)
        self._fid.write(struct.pack("<I", masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_event(step, [_scalar_value(tag, value)]))

    def add_histogram(self, tag: str, values, step: int) -> None:
        self._write_record(_event(step, [_histo_value(tag, np.asarray(values))]))

    def flush(self) -> None:
        self._fid.flush()

    def close(self) -> None:
        if not self._fid.closed:
            self._fid.flush()
            self._fid.close()


def read_events(path: str):
    """Parse an event file back into ``(step, {tag: value})`` tuples —
    the verification half of the writer (checks the CRC framing exactly
    the way TensorBoard's record reader does). Scalars only; histogram
    records yield ``(step, {tag: "histogram"})``."""
    out = []
    with open(path, "rb") as fid:
        while True:
            header = fid.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", fid.read(4))
            if hcrc != masked_crc(header):
                raise IOError(f"{path}: bad length crc")
            data = fid.read(length)
            (dcrc,) = struct.unpack("<I", fid.read(4))
            if dcrc != masked_crc(data):
                raise IOError(f"{path}: bad data crc")
            out.append(_parse_event(data))
    return out


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_event(buf: bytes):
    pos, step, values = 0, None, {}
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            if field == 2:
                step = val
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            payload = buf[pos : pos + ln]
            pos += ln
            if field == 5:  # summary
                values.update(_parse_summary(payload))
            elif field == 3:
                values["__file_version__"] = payload.decode()
        else:
            raise IOError(f"unsupported wire type {wire}")
    return step, values


def _parse_summary(buf: bytes):
    values, pos = {}, 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire != 2 or field != 1:
            raise IOError("unexpected summary field")
        ln, pos = _read_varint(buf, pos)
        value_buf = buf[pos : pos + ln]
        pos += ln
        tag, scalar, histo, vpos = None, None, False, 0
        while vpos < len(value_buf):
            vkey, vpos = _read_varint(value_buf, vpos)
            vfield, vwire = vkey >> 3, vkey & 7
            if vwire == 2:
                vln, vpos = _read_varint(value_buf, vpos)
                payload = value_buf[vpos : vpos + vln]
                vpos += vln
                if vfield == 1:
                    tag = payload.decode()
                elif vfield == 5:
                    histo = True
            elif vwire == 5:
                if vfield == 2:
                    (scalar,) = struct.unpack("<f", value_buf[vpos : vpos + 4])
                vpos += 4
            elif vwire == 1:
                vpos += 8
            elif vwire == 0:
                _, vpos = _read_varint(value_buf, vpos)
        if tag is not None:
            values[tag] = "histogram" if histo else scalar
    return values

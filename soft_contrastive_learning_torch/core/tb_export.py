"""TensorBoard event-file export for JSONL metrics, with no dependency.
Own copy of ``soft_contrastive_learning_tpu/core/tb_export.py`` (the port
imports nothing of the JAX package; the module is pure Python): the same
CRC32C, event-file writer, ``export_jsonl``, ``export_run`` and
``read_events``, so that the two packages write the same events.

The trainer writes its scalars as JSONL (``core/logging.py::MetricsWriter``)
for two writers, 'local' (the training region) and 'other' (the held-out
region). This module writes them as standard ``events.out.tfevents.*``
files, which TensorBoard loads, without TensorFlow or tensorboard
(``cli metrics --tb-export``).

The tfevents format is a sequence of length-prefixed, CRC32C-framed records
(TFRecord framing), each record a serialized ``tensorflow.Event`` protobuf.
Only three Event fields matter for scalars — wall_time (1, double), step
(2, int64), summary (5, message of repeated Value{tag (1, string),
simple_value (2, float)}) — so the protobuf encoding is done by hand here
(protobuf wire format is stable and tiny for this subset).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Dict, Iterable, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven; TFRecord framing uses the masked variant.
# ---------------------------------------------------------------------------

_CRC_TABLE = []
_POLY = 0x82F63B78
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoding (varint + tagged fields).
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's-complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _encode_value(tag: str, value: float) -> bytes:
    """Summary.Value{tag=1 string, simple_value=2 float}."""
    t = tag.encode("utf-8")
    return (
        _field(1, 2) + _varint(len(t)) + t
        + _field(2, 5) + struct.pack("<f", value)
    )


def _encode_event(
    wall_time: float,
    step: int,
    values: Optional[Dict[str, float]] = None,
    file_version: Optional[str] = None,
) -> bytes:
    """tensorflow.Event{wall_time=1 double, step=2 int64, file_version=3
    string, summary=5 Summary{value=1 repeated Value}}."""
    msg = _field(1, 1) + struct.pack("<d", wall_time) + _field(2, 0) + _varint(step)
    if file_version is not None:
        fv = file_version.encode("utf-8")
        msg += _field(3, 2) + _varint(len(fv)) + fv
    if values:
        summary = b"".join(  # one Summary.value submessage per scalar
            _field(1, 2) + _varint(len(v)) + v
            for v in (_encode_value(t, x) for t, x in values.items())
        )
        msg += _field(5, 2) + _varint(len(summary)) + summary
    return msg


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class EventFileWriter:
    """Append scalar events to a TensorBoard-readable event file."""

    def __init__(self, log_dir: str, suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s%s" % (
            int(time.time()), socket.gethostname(), suffix
        )
        self.path = os.path.join(log_dir, name)
        self._fh = open(self.path, "wb")
        self._fh.write(
            _record(_encode_event(time.time(), 0, file_version="brain.Event:2"))
        )

    def add_scalars(
        self, values: Dict[str, float], step: int, wall_time: Optional[float] = None
    ) -> None:
        self._fh.write(
            _record(
                _encode_event(
                    wall_time if wall_time is not None else time.time(), step, values
                )
            )
        )

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.flush()
        self._fh.close()


def export_jsonl(jsonl_path: str, log_dir: str) -> int:
    """Convert one metrics_{role}.jsonl file into an event file under
    ``log_dir``. Returns the number of scalar points written.

    Prior exports in ``log_dir`` are removed first: TensorBoard concatenates
    every event file in a run directory, so re-exporting into the same dir
    would double every point."""
    if os.path.isdir(log_dir):
        for name in os.listdir(log_dir):
            if name.startswith("events.out.tfevents."):
                os.remove(os.path.join(log_dir, name))
    writer = EventFileWriter(log_dir)
    n = 0
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            writer.add_scalars(
                {rec["tag"]: float(rec["value"])},
                int(rec["step"]),
                wall_time=float(rec.get("t", time.time())),
            )
            n += 1
    writer.close()
    return n


def export_run(run_dir: str, out_dir: Optional[str] = None,
               roles: Iterable[str] = ("local", "other")) -> Dict[str, int]:
    """Export every metrics_{role}.jsonl in ``run_dir`` to
    ``out_dir/{role}/events.out.tfevents.*`` (TensorBoard's one directory
    per run, one per writer)."""
    out_dir = out_dir or os.path.join(run_dir, "tb")
    counts: Dict[str, int] = {}
    for role in roles:
        src = os.path.join(run_dir, f"metrics_{role}.jsonl")
        if os.path.exists(src):
            counts[role] = export_jsonl(src, os.path.join(out_dir, role))
    return counts


# ---------------------------------------------------------------------------
# Reader (for tests and for verifying exports without TensorBoard installed).
# ---------------------------------------------------------------------------


def read_events(path: str):
    """Parse an event file back into [(wall_time, step, {tag: value})].
    Records failing CRC checks raise ValueError."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos : pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        if _masked_crc(header) != hcrc:
            raise ValueError(f"bad header crc at {pos}")
        payload = data[pos + 12 : pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if _masked_crc(payload) != pcrc:
            raise ValueError(f"bad payload crc at {pos}")
        out.append(_decode_event(payload))
        pos += 12 + length + 4
    return out


def _read_varint(buf: bytes, pos: int):
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _decode_event(buf: bytes):
    wall_time, step, values = 0.0, 0, {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if num == 1 and wire == 1:
            (wall_time,) = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif num == 2 and wire == 0:
            step, pos = _read_varint(buf, pos)
            if step >= 1 << 63:
                step -= 1 << 64
        elif num == 5 and wire == 2:
            ln, pos = _read_varint(buf, pos)
            values.update(_decode_summary(buf[pos : pos + ln]))
            pos += ln
        elif wire == 2:  # skip length-delimited (e.g. file_version)
            ln, pos = _read_varint(buf, pos)
            pos += ln
        elif wire == 0:
            _, pos = _read_varint(buf, pos)
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return wall_time, step, values


def _decode_summary(buf: bytes) -> Dict[str, float]:
    values: Dict[str, float] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        assert num == 1 and wire == 2, "expected Summary.value"
        ln, pos = _read_varint(buf, pos)
        val = buf[pos : pos + ln]
        pos += ln
        tag, simple = None, None
        vpos = 0
        while vpos < len(val):
            vkey, vpos = _read_varint(val, vpos)
            vnum, vwire = vkey >> 3, vkey & 7
            if vnum == 1 and vwire == 2:
                vln, vpos = _read_varint(val, vpos)
                tag = val[vpos : vpos + vln].decode("utf-8")
                vpos += vln
            elif vnum == 2 and vwire == 5:
                (simple,) = struct.unpack_from("<f", val, vpos)
                vpos += 4
            elif vwire == 2:
                vln, vpos = _read_varint(val, vpos)
                vpos += vln
            elif vwire == 0:
                _, vpos = _read_varint(val, vpos)
            elif vwire == 1:
                vpos += 8
            elif vwire == 5:
                vpos += 4
        if tag is not None and simple is not None:
            values[tag] = simple
    return values

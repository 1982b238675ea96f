"""Minimal TensorBoard event-file writer (copy of
``lisec_tpu/utils/tb_writer.py``).

Pure Python, so nothing needs installing. It writes the two formats
TensorBoard reads:

  * TFRecord framing: [uint64 len][masked crc32c(len)][payload]
    [masked crc32c(payload)], little-endian.
  * ``Event`` protobuf with ``wall_time`` (field 1, double), ``step``
    (field 2, varint), ``file_version`` (field 3, string) and
    ``summary`` (field 5) holding ``Summary.Value { tag = 1,
    simple_value = 2 }``, hand-encoded (the subset is tiny and the
    wire format is stable).

Scalars written here load in stock TensorBoard. Used by
``training/loop.py`` behind ``train.tensorboard: true``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

_CRC_TABLE = []


def _crc32c_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _scalar_event(step: int, tag: str, value: float,
                  wall_time: float) -> bytes:
    tag_b = tag.encode()
    val = (_key(1, 2) + _varint(len(tag_b)) + tag_b
           + _key(2, 5) + struct.pack("<f", float(value)))
    summary = _key(1, 2) + _varint(len(val)) + val
    return (_key(1, 1) + struct.pack("<d", wall_time)
            + _key(2, 0) + _varint(step)
            + _key(5, 2) + _varint(len(summary)) + summary)


def _version_event(wall_time: float) -> bytes:
    v = b"brain.Event:2"
    return (_key(1, 1) + struct.pack("<d", wall_time)
            + _key(3, 2) + _varint(len(v)) + v)


class TensorBoardWriter:
    """Append-only scalar writer producing stock-readable event files."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}"
                 f".{socket.gethostname()}")
        self._f = open(os.path.join(logdir, fname), "ab")
        self._record(_version_event(time.time()))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        now = time.time()
        for tag, value in scalars.items():
            try:
                v = float(value)
            except (TypeError, ValueError):
                continue
            self._record(_scalar_event(step, tag, v, now))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_scalar_events(path: str):
    """Decode scalar events back from an event file (test/debug aid;
    TensorBoard itself is the primary consumer)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (ln,) = struct.unpack_from("<Q", data, pos)
        payload = data[pos + 12:pos + 12 + ln]
        assert struct.unpack_from("<I", data, pos + 8)[0] \
            == _masked_crc(data[pos:pos + 8]), "corrupt length crc"
        assert struct.unpack_from("<I", data, pos + 12 + ln)[0] \
            == _masked_crc(payload), "corrupt payload crc"
        pos += 12 + ln + 4
        out.append(_decode_event(payload))
    return out


def _read_varint(buf, i):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _decode_event(buf: bytes):
    i = 0
    ev = {"step": 0, "scalars": {}}
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 1:
            if field == 1:
                ev["wall_time"] = struct.unpack_from("<d", buf, i)[0]
            i += 8
        elif wire == 0:
            n, i = _read_varint(buf, i)
            if field == 2:
                ev["step"] = n
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            sub = buf[i:i + ln]
            i += ln
            if field == 5:
                j = 0
                while j < len(sub):
                    k2, j = _read_varint(sub, j)
                    if k2 >> 3 == 1 and k2 & 7 == 2:
                        vl, j = _read_varint(sub, j)
                        val = sub[j:j + vl]
                        j += vl
                        tag, sv, m = None, None, 0
                        while m < len(val):
                            k3, m = _read_varint(val, m)
                            if k3 >> 3 == 1 and k3 & 7 == 2:
                                tl, m = _read_varint(val, m)
                                tag = val[m:m + tl].decode()
                                m += tl
                            elif k3 >> 3 == 2 and k3 & 7 == 5:
                                sv = struct.unpack_from("<f", val, m)[0]
                                m += 4
                            else:
                                break
                        if tag is not None and sv is not None:
                            ev["scalars"][tag] = sv
                    else:
                        break
        else:
            break
    return ev

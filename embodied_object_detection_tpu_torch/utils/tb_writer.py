"""Dependency-free TensorBoard scalar event writer.

The reference logs through detectron2's `TensorboardXWriter`
(train_mp3d.py:534-542). tensorboard/tensorboardX are not in this image,
so this module hand-encodes the TFRecord + Event/Summary protobuf wire
format for *scalars* (the only summary kind the reference writes):

  record  = uint64le(len) crc(len) payload crc(payload)
  Event   = {1: wall_time double, 2: step int64, 5: Summary}
  Summary = {1: repeated Value {1: tag string, 2: simple_value float}}

with TF's masked crc32c. Files are readable by standard TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

__all__ = ["SummaryWriter"]

_CRC_TABLE = []


def _build_crc_table():
    poly = 0x82F63B78  # crc32c (Castagnoli), reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    if n < 0:
        # protobuf encodes negative int64 as 10-byte two's complement;
        # a raw right-shift of a negative Python int never reaches 0 and
        # the loop below would hang the process inside a logging call
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _double_field(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _float_field(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _varint_field(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def _bytes_field(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _scalar_event(step: int, scalars: Dict[str, float],
                  wall_time: Optional[float] = None) -> bytes:
    values = b"".join(
        _bytes_field(1, _bytes_field(1, tag.encode()) +
                     _float_field(2, float(v)))
        for tag, v in scalars.items())
    return (_double_field(1, wall_time or time.time()) +
            _varint_field(2, step) + _bytes_field(5, values))


def _file_version_event() -> bytes:
    return (_double_field(1, time.time()) +
            _bytes_field(3, b"brain.Event:2"))


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload +
            struct.pack("<I", _masked_crc(payload)))


class SummaryWriter:
    """Minimal tensorboard scalar writer (events file per instance)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "wb")
        self._f.write(_record(_file_version_event()))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self.add_scalars({tag: value}, step)

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        self._f.write(_record(_scalar_event(step, scalars)))
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_events(path: str):
    """Parse scalar events back out (for tests): yields
    (step, {tag: value})."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos:pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert hcrc == _masked_crc(header), "corrupt record header"
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        assert pcrc == _masked_crc(payload), "corrupt record payload"
        pos += 12 + length + 4
        step, scalars = _parse_event(payload)
        if scalars:
            yield step, scalars


def _parse_event(buf: bytes):
    pos, step, scalars = 0, 0, {}
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
            if num == 2:
                # step is int64: undo the two's-complement varint encoding
                step = v - (1 << 64) if v >= (1 << 63) else v
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos:pos + ln]
            pos += ln
            if num == 5:  # Summary
                scalars.update(_parse_summary(sub))
    return step, scalars


def _read_varint(buf: bytes, p: int):
    shift = v = 0
    while True:
        b = buf[p]
        v |= (b & 0x7F) << shift
        p += 1
        if not b & 0x80:
            return v, p
        shift += 7


def _parse_summary(buf: bytes):
    out = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        assert wire == 2 and num == 1
        ln, pos = _read_varint(buf, pos)
        val = buf[pos:pos + ln]
        pos += ln
        tag, simple = None, None
        vp = 0
        while vp < len(val):
            k, vp = _read_varint(val, vp)
            n, w = k >> 3, k & 7
            if w == 2:
                l2, vp = _read_varint(val, vp)
                if n == 1:
                    tag = val[vp:vp + l2].decode()
                vp += l2
            elif w == 5:
                if n == 2:
                    (simple,) = struct.unpack_from("<f", val, vp)
                vp += 4
            else:
                raise AssertionError("unexpected field")
        if tag is not None:
            out[tag] = simple
    return out

"""TensorBoard event files, written without TensorBoard's packages.

An event file is a sequence of TFRecords, each holding one serialized
``Event`` protocol buffer (tensorboard/compat/proto/event.proto):

  record   u64 length (little-endian), u32 masked CRC32C of those 8 bytes,
           the data, u32 masked CRC32C of the data;
  Event    wall_time (field 1, double), step (2, int64), file_version
           (3, string) or summary (5, Summary);
  Summary  repeated value (1): Value{tag (1, string), simple_value
           (2, float)}.

The first record carries ``file_version "brain.Event:2"``; every later
one a step's scalars. The file is ``events.out.tfevents.<time>.<host>``,
the name TensorBoard globs for. CRC32C (Castagnoli) comes from a table
built here, since no crc32c module is installed.
"""

from __future__ import annotations

import os
import socket
import struct
import time

_CRC_TABLE: list[int] = []


def _crc_table() -> list[int]:
    if not _CRC_TABLE:
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    n &= 0xFFFFFFFFFFFFFFFF  # int64 fields: negatives as 10-byte varints
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(data)) + data


def event(wall_time: float, step: int = 0, *, file_version: str = "",
          scalars: dict[str, float] | None = None) -> bytes:
    """One serialized Event."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _varint(2 << 3) + _varint(step)
    if file_version:
        out += _bytes_field(3, file_version.encode())
    if scalars is not None:
        summary = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode())
                         + _varint(2 << 3 | 5) + struct.pack("<f", value))
            for tag, value in scalars.items())
        out += _bytes_field(5, summary)
    return out


class EventFileWriter:
    """Scalars into ``<log_dir>/events.out.tfevents.<time>.<host>``."""

    def __init__(self, log_dir: str):
        now = time.time()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}")
        self._f = open(self.path, "ab")
        self._f.write(tfrecord(event(now, file_version="brain.Event:2")))

    def add_scalars(self, step: int, scalars: dict[str, float]) -> None:
        self._f.write(tfrecord(event(time.time(), step, scalars=scalars)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

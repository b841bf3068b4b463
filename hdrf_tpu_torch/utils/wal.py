"""Shared write-ahead-log framing (port of hdrf_tpu/utils/wal.py, the same
frames: CRC32C from the port's ``native.crc32c``).

One record = ``[u32 payload_len][u32 crc32c(payload)][payload]``.  A torn final
record (crash mid-append) fails the CRC and is dropped; a corrupt record stops
replay at the last good prefix.  Used by the chunk index (Redis replacement)
and the NameNode edit log (FSEditLog.java:124 analog).
"""

from __future__ import annotations

import struct
from typing import Iterator

from hdrf_tpu_torch import native

_HDR = struct.Struct("<II")


def frame(payload: bytes) -> bytes:
    return _HDR.pack(len(payload), native.crc32c(payload)) + payload


def iter_frames(data: bytes) -> Iterator[bytes]:
    """Yield payloads of intact records; stop at the first torn/corrupt one."""
    payloads, _ = scan(data)
    yield from payloads


def scan(data: bytes) -> tuple[list[bytes], int]:
    """Intact payload list + length of the good prefix (bytes before the
    first torn/corrupt record)."""
    payloads: list[bytes] = []
    pos = 0
    while pos + _HDR.size <= len(data):
        ln, crc = _HDR.unpack_from(data, pos)
        payload = data[pos + _HDR.size : pos + _HDR.size + ln]
        if len(payload) < ln or native.crc32c(payload) != crc:
            break
        payloads.append(payload)
        pos += _HDR.size + ln
    return payloads, pos


def recover(path: str, truncate: bool = True) -> list[bytes]:
    """Read a WAL, return intact payloads, and TRUNCATE any torn tail so a
    subsequent append-open continues at the good prefix.  Without the
    truncation, records appended after a crash would land behind the garbage
    and be unreachable by the next replay — silently losing acked writes.
    ``truncate=False`` is the read-only mode (offline viewers)."""
    import os

    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        data = f.read()
    payloads, good_len = scan(data)
    if truncate and good_len < len(data):
        with open(path, "r+b") as f:
            f.truncate(good_len)
    return payloads

"""Composable file-level checksums (port of hdrf_tpu/utils/checksum.py:
``crc32c_combine``, ``compose_chunks``; the FileChecksumHelper.java:56 /
BlockChecksumHelper.java:61 analog, in COMPOSITE_CRC mode).

The reference's default MD5-of-MD5-of-CRC file checksum depends on block and
cell boundaries, so a replicated file and an EC-striped file with identical
bytes hash differently; Hadoop added COMPOSITE_CRC (HDFS-13056) — a
mathematically *combinable* CRC over the logical byte stream — precisely so
layouts stay comparable.  This module is that combiner for CRC32C: given the
per-chunk CRCs the DataNodes already store in BlockMeta (no data reads), it
derives the CRC32C of the whole logical stream, which equals
``crc32c(file_bytes)`` by construction — a property the tests use as the
oracle.

``crc32c_combine(crc1, crc2, len2)`` follows zlib's crc32_combine GF(2)
matrix method with the Castagnoli polynomial: append ``len2`` zero bytes to
the stream behind ``crc1`` by repeated matrix squaring, then xor ``crc2``.
"""

from __future__ import annotations

_POLY = 0x82F63B78  # reflected Castagnoli (CRC32C)


def _matrix_times(mat: list[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _matrix_square(mat: list[int]) -> list[int]:
    return [_matrix_times(mat, m) for m in mat]


def crc32c_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32C of A+B from crc32c(A), crc32c(B), len(B)."""
    if len2 <= 0:
        return crc1
    # operator matrices: odd = one zero BIT appended
    odd = [0] * 32
    odd[0] = _POLY
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    even = _matrix_square(odd)   # 2 bits
    odd = _matrix_square(even)   # 4 bits
    # walk len2 (bytes): first squaring lands on 8 bits = 1 byte
    while True:
        even = _matrix_square(odd)
        if len2 & 1:
            crc1 = _matrix_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _matrix_square(even)
        if len2 & 1:
            crc1 = _matrix_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def compose_chunks(crcs: list[int], chunk: int, length: int,
                   crc: int = 0, pos: int = 0) -> tuple[int, int]:
    """Fold a run of per-chunk CRCs (each covering ``chunk`` bytes, the
    last possibly partial against ``length``) into a running stream CRC.
    Returns (crc, new_pos).  ``pos`` is the running stream position —
    only used to size the final partial chunk."""
    for i, c in enumerate(crcs):
        clen = min(chunk, length - i * chunk)
        if clen <= 0:
            break
        crc = c if pos == 0 else crc32c_combine(crc, c, clen)
        pos += clen
    return crc, pos

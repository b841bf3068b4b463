"""Block-codec helpers, one place for codec name -> implementation (the
port's copy of hdrf_tpu/utils/codec.py).

The container seal (the reference's LZ4-on-rollover,
DataDeduplicator.java:770-781) and the compress-only schemes
(BlockReceiver.java:822-866) both land here for every codec but the
device LZ4 path; ``lz4`` is the port's own native copy of the serial
encoder and the decoder.
"""

from __future__ import annotations

import zlib

CODEC_IDS = {"none": 0, "lz4": 1, "zstd": 2, "gzip": 3, "snappy": 4}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}


def compress(codec: str, data: bytes) -> bytes:
    if codec == "lz4":
        from hdrf_tpu_torch import native

        return native.lz4_compress(data)
    if codec == "zstd":
        import zstandard

        return zstandard.ZstdCompressor(level=1).compress(data)
    if codec == "gzip":
        return zlib.compress(data, 1)
    if codec == "snappy":
        import snappy  # optional dependency; absent -> ImportError

        return snappy.compress(data)
    if codec == "none":
        return data
    raise KeyError(f"unknown codec {codec!r}")


def decompress(codec: str, data: bytes, usize: int) -> bytes:
    if codec == "lz4":
        from hdrf_tpu_torch import native

        return native.lz4_decompress(data, usize)
    if codec == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(data,
                                                       max_output_size=usize)
    if codec == "gzip":
        return zlib.decompress(data)
    if codec == "snappy":
        import snappy

        return snappy.decompress(data)
    if codec == "none":
        return data
    raise KeyError(f"unknown codec {codec!r}")


def available(codec: str) -> bool:
    try:
        compress(codec, b"x")
        return True
    except (ImportError, KeyError):
        return False

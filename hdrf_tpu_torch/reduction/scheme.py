"""ReductionScheme plugin registry — the abstraction the reference promises
(port of hdrf_tpu/reduction/scheme.py: ``ReductionContext``, the registry,
``DirectScheme``, ``CompressScheme``).

The reference README describes "an abstract class ReductionScheme ... selectable
in DataNode" (README.md:3) but ships no such class; scheme selection is a
hardcoded ``public static int compressor = 2`` switch (DataNode.java:438, modes
at :439-445).  This module is that promised abstraction, built for real:

==========  =======================  ====================================
ref mode    reference behavior        scheme name here
==========  =======================  ====================================
-1          direct file write         ``direct``
 0          Snappy stream             ``zstd`` (snappy-class speed, zstd format)
 1          dedup only                ``dedup``
 2          dedup + LZ4 containers    ``dedup_lz4``   (flagship, the default)
 3          Lzop stream               ``gzip`` (DEFLATE family)
 4          LZ4 stream                ``lz4``
 5          Gzip stream               ``gzip``
==========  =======================  ====================================

Schemes are selected **per file by explicit policy** (client passes the scheme
name at create; CreateOptions), not by the reference's fragile content sniffing
of MapReduce headers (BlockReceiver.java:800-820).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import TYPE_CHECKING

from hdrf_tpu_torch.reduction import accounting
from hdrf_tpu_torch.utils import codec as codecs

if TYPE_CHECKING:
    from hdrf_tpu_torch.config import ReductionConfig
    from hdrf_tpu_torch.index.chunk_index import ChunkIndex
    from hdrf_tpu_torch.storage.container_store import ContainerStore


@dataclass
class ReductionContext:
    """Per-datanode resources a scheme may use."""

    config: "ReductionConfig"
    containers: "ContainerStore | None" = None
    index: "ChunkIndex | None" = None
    backend: str = "native"  # execution backend for the hot ops (dispatch)
    # Co-located reduction worker client (reduction_worker.WorkerClient):
    # when set, schemes offload their hot ops to the worker process.
    worker: object | None = None
    # Device reconstructor (ops/reconstruct.DeviceReconstructor): when set,
    # reconstruction-heavy reads gather chunks from device-resident
    # container images instead of host memory.
    recon: object | None = None
    # Chunk-granular serving engine (server/read_plane.ReadPlane): when
    # set, dedup reconstruction serves chunk misses through its shared
    # decoded-chunk cache + read coalescer instead of per-read
    # read_chunks.  None keeps the direct container-store path (bench
    # micro-harnesses, tests).
    read_plane: object | None = None


class ReductionScheme(ABC):
    """A pluggable stage of the block write/read path.

    ``reduce`` maps a full logical block to the bytes stored in the replica
    data file (empty for dedup schemes, whose bytes land in chunk containers);
    ``reconstruct`` inverts it.  Both are whole-block on the write side —
    mirroring the reference, which buffers the block into ``bf1``
    (BlockReceiver.java:877-897) — while reads are chunk-granular where the
    stored form allows."""

    name: str = ""

    @abstractmethod
    def reduce(self, block_id: int, data: bytes, ctx: ReductionContext) -> bytes:
        ...

    @abstractmethod
    def reconstruct(self, block_id: int, stored: bytes, logical_len: int,
                    ctx: ReductionContext, offset: int = 0,
                    length: int = -1) -> bytes:
        ...

    def delete(self, block_id: int, ctx: ReductionContext) -> None:
        """Release out-of-band state (index rows, chunk refcounts)."""

    def describe(self) -> str:
        return self.name


_REGISTRY: dict[str, ReductionScheme] = {}


def register(scheme: ReductionScheme) -> ReductionScheme:
    _REGISTRY[scheme.name] = scheme
    return scheme


def get(name: str) -> ReductionScheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown reduction scheme {name!r}; "
                       f"available: {sorted(_REGISTRY)}") from None


def names() -> list[str]:
    return sorted(_REGISTRY)


# ------------------------------------------------------------- basic schemes


class DirectScheme(ReductionScheme):
    """Identity — reference mode -1 (direct file write, DataNode.java:439)."""

    name = "direct"

    def reduce(self, block_id: int, data: bytes, ctx: ReductionContext) -> bytes:
        accounting.record_reduce(self.name, len(data), len(data))
        return data

    def reconstruct(self, block_id: int, stored: bytes, logical_len: int,
                    ctx: ReductionContext, offset: int = 0,
                    length: int = -1) -> bytes:
        end = logical_len if length < 0 else min(offset + length, logical_len)
        return stored[offset:end]


class CompressScheme(ReductionScheme):
    """Whole-block compression — reference's stream-codec modes (0/3/4/5),
    which pipe packets through a codec stream into ``chunkDir/<blkid>``
    (BlockReceiver.java:822-866) and stream-decompress on read
    (DataConstructor.java:102-220).  Codec impls live in utils/codec.py."""

    def __init__(self, codec: str):
        self.name = codec
        self._codec = codec

    def reduce(self, block_id: int, data: bytes, ctx: ReductionContext) -> bytes:
        from hdrf_tpu_torch.ops import dispatch

        out = None
        if ctx.worker is not None:
            from hdrf_tpu_torch.server.reduction_worker import WorkerError

            try:
                out = ctx.worker.compress(self._codec, data)
            except WorkerError:
                pass  # dead worker: host codec below
        if out is None:
            out = dispatch.block_compress(self._codec, data, ctx.backend)
        accounting.record_reduce(self.name, len(data), len(out))
        return out

    def reconstruct(self, block_id: int, stored: bytes, logical_len: int,
                    ctx: ReductionContext, offset: int = 0,
                    length: int = -1) -> bytes:
        full = codecs.decompress(self._codec, stored, logical_len)
        end = logical_len if length < 0 else min(offset + length, logical_len)
        return full[offset:end]


register(DirectScheme())
register(CompressScheme("lz4"))
register(CompressScheme("gzip"))
register(CompressScheme("zstd"))
# The reference's mode 0 (Snappy): python-snappy is an optional dependency;
# register only when importable (environment gating, not a hard requirement).
from hdrf_tpu_torch.utils import codec as _codec  # noqa: E402

if _codec.available("snappy"):
    register(CompressScheme("snappy"))

# Dedup schemes register themselves on import (reduction/dedup.py).
from hdrf_tpu_torch.reduction import dedup as _dedup  # noqa: E402,F401

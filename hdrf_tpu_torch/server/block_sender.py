"""Block read path: serve logical bytes, reconstructing reduced blocks (port
of hdrf_tpu/server/block_sender.py, PROVIDED replicas included: their bytes
come through the DataNode's alias map).

Re-expression of BlockSender.java: the ctor decides whether the block can be
served straight from the replica file or needs reconstruction
(BlockSender.java:306-330 Redis probe -> ``runNormally``), reconstructed
blocks are materialized and served from memory (:612-623) — here
reconstruction is **chunk-granular for range reads** (only containers
overlapping the requested range are touched), fixing the reference's
full-block materialization (SURVEY.md §7 hard part e).

End-to-end integrity: per-checksum-chunk crc32c from BlockMeta rides the op
response header; full-block reads are verified against it server-side before
the bytes hit the wire (BlockScanner-style verification folded into the send
path; the client re-verifies per packet via the transfer framing CRC).
"""

from __future__ import annotations

import socket
import time
from typing import TYPE_CHECKING

from hdrf_tpu_torch.proto import datatransfer as dt
from hdrf_tpu_torch.proto.rpc import send_frame
from hdrf_tpu_torch.utils import metrics, profiler, qos, tenants, tracing

if TYPE_CHECKING:
    from hdrf_tpu_torch.server.datanode import DataNode

_M = metrics.registry("block_sender")
_TR = tracing.tracer("datanode")

# sentinel: "resolve the meta yourself" (None is a real value — PROVIDED
# blocks have no local BlockMeta)
_UNRESOLVED = object()


class BlockSender:
    def __init__(self, dn: "DataNode"):
        self._dn = dn

    def read_logical(self, block_id: int, offset: int = 0,
                     length: int = -1, meta=_UNRESOLVED) -> bytes:
        """Logical bytes of a block, whatever its stored form.  ``meta``
        threads an already-resolved BlockMeta (or None for a PROVIDED
        block) through from serve_read so the replica index is probed once
        per request — the double get_meta used to book a second
        ``index_lookup`` span per read."""
        dn = self._dn
        with profiler.phase("cache_probe"):
            cached = dn.cache.get(block_id, offset, length)
        if cached is not None:
            _M.incr("cached_reads")
            return cached  # pinned logical bytes: no disk, no reconstruction
        if meta is _UNRESOLVED:
            with profiler.phase("index_lookup"):
                meta = dn.replicas.get_meta(block_id)
        if meta is None:
            # PROVIDED replica: bytes live in the external store the alias
            # map points at (FileRegion -> ProvidedStorageLocation)
            with dn.read_slot(), profiler.phase("container_decode"):
                data = dn.aliasmap.read_bytes(block_id, offset, length)
            if data is not None:
                _M.incr("provided_serves")
                return data
            raise KeyError(f"block {block_id} not on this datanode")
        scheme = dn.scheme(meta.scheme)
        with profiler.phase("container_decode"):
            stored = (dn.replicas.read_data(block_id)
                      if meta.physical_len else b"")
        with dn.read_slot():  # admission control (DataXceiver.java:313-347)
            return scheme.reconstruct(block_id, stored, meta.logical_len,
                                      dn.reduction_ctx, offset, length)

    def serve_read(self, sock: socket.socket, fields: dict) -> None:
        """READ_BLOCK op: header frame {status, length, checksums...}, then a
        packet run of the requested byte range."""
        dn = self._dn
        block_id = fields["block_id"]
        offset = fields.get("offset", 0)
        length = fields.get("length", -1)
        tenant = fields.get("_client")
        t_start = time.monotonic()
        with _TR.span("serve_read",
                      parent=tuple(fields["_trace"]) if fields.get("_trace") else None) as sp, \
                profiler.read_timeline(block_id) as tl:
            sp.annotate("block_id", block_id)
            try:
                # Overload gate FIRST (utils/qos.py): over-rate tenants
                # and ops whose deadline budget can't cover the p95
                # estimate are refused here — before the read touches a
                # slot, the cache, or the decode plane — with a structured
                # retryable refusal instead of a mid-pipeline timeout.
                # Unattributed requests (DN-to-DN reconstruction fan-in)
                # are internal and never shed.
                if tenant is not None:
                    dn.qos.admit(tenant, "read")
                # Umbrella phase: gaps between the inner spans (scheme
                # resolution, read-slot admission, the materialize copy)
                # attribute here; nested index_lookup/cache_probe spans
                # still win their intervals (PHASE_ORDER lists them first).
                with qos.bind_tenant(tenant), \
                        profiler.phase("container_decode"):
                    with profiler.phase("index_lookup"):
                        meta = dn.replicas.get_meta(block_id)
                        region = (dn.aliasmap.read(block_id) if meta is None
                                  else None)
                    if meta is None and region is None:
                        raise KeyError(
                            f"block {block_id} not on this datanode")
                    data = self.read_logical(block_id, offset, length,
                                             meta=meta)
                    tl.nbytes = len(data)
            except Exception as e:  # noqa: BLE001 — status crosses the wire
                frame = {"status": 1, "error": type(e).__name__,
                         "message": str(e)}
                retry_after = getattr(e, "retry_after_s", None)
                if retry_after is not None:
                    frame["retry_after_s"] = retry_after
                send_frame(sock, frame)
                if isinstance(e, qos.ShedError):
                    _M.incr("read_sheds")
                else:
                    _M.incr("read_errors")
                tenants.note_op(tenant, "read",
                                latency_s=time.monotonic() - t_start)
                return
            with profiler.phase("net_send"):
                send_frame(sock, {"status": 0, "length": len(data),
                                  "logical_len": (meta.logical_len if meta
                                                  else region.length),
                                  "offset": offset,
                                  "checksum_chunk": (meta.checksum_chunk
                                                     if meta else 64 * 1024),
                                  "checksums": (meta.checksums
                                                if meta else [])})
                dt.stream_bytes(sock, data, dn.config.packet_size)
                _M.incr("blocks_served")
                _M.incr("bytes_served", len(data))
        served_s = time.monotonic() - t_start
        tenants.note_op(tenant, "read", len(data), latency_s=served_s)
        # deficit bucket debit + service estimator feed (utils/qos.py):
        # bytes are only known NOW, so admission charged nothing
        dn.qos.charge(tenant, "read", len(data), latency_s=served_s)

"""Block write path: packet ingest, pipeline mirroring, reduction hook (port of
hdrf_tpu/server/block_receiver.py, whole).

Re-expression of BlockReceiver.java:

- ``receive_direct``: the stock streaming path — packets forwarded to the
  mirror as received (BlockReceiver.java:635-641 ``mirrorPacketTo``), written
  to the local replica, per-packet acks upstream (PacketResponder,
  BlockReceiver.java:1509).  The final empty packet's ack aggregates the
  whole downstream chain (durability); earlier acks are flow control.
  The port reads the mirror's acks as they arrive (``dt.AckPump``) and
  hands them out where the reference reads them (flush barriers, the
  end); the reference leaves them unread until then, which stalls the
  stream on a network stack that charges each unread segment against
  the receive window (stream_probe.py).  The wire is unchanged, and a
  pipeline that owes no ack is left unread, as the reference leaves it.
- ``receive_reduced``: the reduction path.  The reference buffers the block
  into a direct ByteBuffer ``bf1`` (BlockReceiver.java:877-897), acks, and
  reduces asynchronously (DDRunner) — while every pipeline node re-runs
  reduction on the raw stream independently.  Here DN1 buffers, reduces
  ONCE, then ships the *reduced form* downstream ("reduced Block Mirroring",
  the IEEE-paper capability missing from the reference snapshot; SURVEY.md §0
  fact 3) and acks the last packet only after local commit + downstream ack.
- Mirror-side ingest of the reduced form is ``ingest_reduced``: for dedup
  schemes the mirror receives the ordered hash list, answers with the set of
  chunks it lacks (one round trip), and receives exactly those bytes — the
  "chunk index delta".

Checksums: crc32c per ``checksum_chunk`` of the LOGICAL bytes are computed on
ingest and stored in BlockMeta (the reference writes the checksum meta file
even in reduction mode, BlockReceiver.java:924-986) so readers can verify
end-to-end regardless of the stored form.

Every ingest path opens a utils/profiler.py BlockTimeline and attributes its
wall time to named phases (``recv``/``checksum``/``container_io``/
``mirror_stream``/``ack`` here; ``dedup_lookup``/``wal_commit`` land from
reduction/dedup.py and index/chunk_index.py; ``device_wait`` from the device
ledger) — the decomposition the gap-attribution report and ROADMAP item 1's
pipeline refactor are measured by.
"""

from __future__ import annotations

import contextlib
import queue
import socket
import threading
import time
from typing import TYPE_CHECKING

from hdrf_tpu_torch import native
from hdrf_tpu_torch.proto import datatransfer as dt
from hdrf_tpu_torch.proto.rpc import recv_frame, send_frame
from hdrf_tpu_torch.utils import (fault_injection, log, metrics, profiler, qos,
                            retry, tracing)

if TYPE_CHECKING:
    from hdrf_tpu_torch.server.datanode import DataNode

_M = metrics.registry("block_receiver")
_TR = tracing.tracer("datanode")
_LOG = log.get_logger("block_receiver")


def _checksums(data: bytes, chunk: int) -> list[int]:
    return [int(c) for c in native.crc32c_chunks(data, chunk)]


class MirrorLegFailed(IOError):
    """A downstream mirror hop failed; ``dn_id`` names the ACTUAL broken
    peer — propagated back through the per-hop status frame that rides
    ahead of the fixed 9-byte ack — so the NN outlier feed never blames
    ``targets[0]`` for a failure two relay hops down."""

    def __init__(self, msg: str, dn_id: str | None = None):
        super().__init__(msg)
        self.dn_id = dn_id


def _connect(addr: list | tuple, dn=None, block_id: int | None = None,
             token: dict | None = None) -> socket.socket:
    """Mirror-leg socket; encrypts when this DN is configured to (the
    reference's DN->DN SASL legs — tokens minted from the shared block keys
    when the incoming op's token isn't reusable)."""
    # connect timeout clamped by the ambient deadline budget (a mirror
    # leg may never outlive what's left of the end-to-end write budget)
    s = socket.create_connection((addr[0], addr[1]),
                                 timeout=retry.effective_budget(60.0))
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    if dn is not None and dn.config.encrypt_data_transfer:
        if not token or not token.get("sig"):
            token = dn.tokens.mint(block_id, "w")
        s = dt.secure_socket(s, token, True)
    return s


class BlockReceiver:
    def __init__(self, dn: "DataNode"):
        self._dn = dn
        # block id -> [lock, holders]: pushes of one block ingest in turn
        self._ingests: dict[int, list] = {}
        self._ingests_lock = threading.Lock()

    @contextlib.contextmanager
    def _one_ingest(self, block_id: int):
        """Hold the block's ingest lock.  Two sources may push one block
        at once (a re-sent ``replicate`` and the first push, or two
        sources commanded in turn); the reference lets both look up,
        append and commit, which counts the block's chunk references
        twice.  Here the second waits for the first and then finds the
        replica held."""
        with self._ingests_lock:
            slot = self._ingests.setdefault(block_id, [threading.Lock(), 0])
            slot[1] += 1
        try:
            with slot[0]:
                yield
        finally:
            with self._ingests_lock:
                slot[1] -= 1
                if not slot[1]:
                    del self._ingests[block_id]

    def _note_peer(self, target: dict, seconds: float, nbytes: int) -> None:
        """Record a downstream-transfer latency sample for slow-peer
        detection (DataNodePeerMetrics feeding SlowPeerTracker.java:56),
        normalized to seconds per MB ACTUALLY SENT.  ``seconds`` must cover
        only the downstream portion: the push_reduced leg passes its whole
        duration (all of it is downstream transfer); the direct pipeline
        passes the accumulated mirror write + ack-drain time so upstream
        recv/disk slowness is never misattributed to the peer."""
        dn_id = target.get("dn_id")
        if dn_id and nbytes > 0:
            self._dn.note_peer_latency(
                dn_id, seconds / max(nbytes / 2**20, 1e-3))

    # ------------------------------------------------------------ direct path

    def receive_direct(self, sock: socket.socket, fields: dict) -> None:
        """Stock pipeline: stream packets to disk + mirror, ack per packet."""
        dn = self._dn
        block_id, gen_stamp = fields["block_id"], fields["gen_stamp"]
        targets = fields.get("targets", [])
        mirror_sock = mirror_acks = None
        with profiler.block_timeline(block_id) as tl, \
                dn.direct_slot():  # bounded concurrent streaming writes
            with profiler.phase("container_io"):
                writer = dn.replicas.create_rbw(
                    block_id, gen_stamp,
                    storage_type=fields.get("storage_type"))
            try:
                if targets:
                    mirror_sock = _connect(targets[0]["addr"], dn, block_id,
                                           fields.get("token"))
                    # each hop rewrites the routing hint to ITS target's
                    # slot type (the NN annotates every target)
                    dt.send_op(mirror_sock, dt.WRITE_BLOCK,
                               **{**fields, "targets": targets[1:],
                                  "storage_type":
                                  targets[0].get("storage_type")})
                    mirror_acks = dt.AckPump(mirror_sock)
                crcs: list[int] = []
                tail = b""
                cchunk = dn.checksum_chunk
                forwarded = 0
                drained = 0   # mirror acks consumed by flush barriers
                fwd_bytes = 0
                mirror_t = 0.0  # downstream-only time (write + ack drain)
                for seqno, data, flags in profiler.timed_iter(
                        "recv", dt.iter_packets_ex(sock)):
                    last = bool(flags & dt.FLAG_LAST)
                    fault_injection.point("block_receiver.packet",
                                          block_id=block_id, seqno=seqno,
                                          dn_id=dn.dn_id)
                    if mirror_sock is not None:
                        _mt0 = time.perf_counter()
                        with profiler.phase("mirror_stream"):
                            dt.write_packet(mirror_sock, seqno, data,
                                            flags=flags)
                            mirror_acks.expect()
                        mirror_t += time.perf_counter() - _mt0
                        forwarded += 1
                        fwd_bytes += len(data)
                    if data:
                        with profiler.phase("container_io"):
                            writer.write(data)
                        with profiler.phase("checksum"):
                            tail += data
                            while len(tail) >= cchunk:
                                crcs.append(native.crc32c(tail[:cchunk]))
                                tail = tail[cchunk:]
                    if not last and flags & (dt.FLAG_FLUSH | dt.FLAG_SYNC):
                        # hflush/hsync barrier: every downstream node must
                        # have processed the prefix before we ack (the
                        # PipelineAck semantics hflush depends on) — drain
                        # the mirror's acks up to this packet, then expose
                        # the visible length (+fsync for hsync) locally.
                        status = dt.ACK_SUCCESS
                        if mirror_sock is not None:
                            _mt0 = time.perf_counter()
                            with profiler.phase("mirror_stream"):
                                while drained < forwarded:
                                    _, down = mirror_acks.read_ack()
                                    status = max(status, down)
                                    drained += 1
                            mirror_t += time.perf_counter() - _mt0
                        vis_crcs = crcs + ([native.crc32c(tail)]
                                           if tail else [])
                        with profiler.phase("container_io"):
                            writer.flush_visible(
                                vis_crcs, cchunk,
                                sync=bool(flags & dt.FLAG_SYNC))
                        with profiler.phase("ack"):
                            dt.send_ack(sock, seqno, status)
                    elif not last:
                        with profiler.phase("ack"):
                            dt.send_ack(sock, seqno)
                    else:
                        if tail:
                            crcs.append(native.crc32c(tail))
                        status = dt.ACK_SUCCESS
                        if mirror_sock is not None:
                            # Drain ALL mirror acks (one per forwarded packet);
                            # the final one carries the aggregated downstream
                            # status — earlier ones are flow control.
                            _mt0 = time.perf_counter()
                            with profiler.phase("mirror_stream"):
                                for _ in range(forwarded - drained):
                                    _, down = mirror_acks.read_ack()
                                    status = max(status, down)
                            mirror_t += time.perf_counter() - _mt0
                            self._note_peer(targets[0], mirror_t, fwd_bytes)
                        with profiler.phase("container_io"):
                            meta = writer.finalize(writer.bytes_written,
                                                   "direct", crcs, cchunk)
                        writer = None
                        tl.nbytes = meta.logical_len
                        with profiler.phase("ack"):
                            dn.notify_block_received(block_id,
                                                     meta.logical_len,
                                                     meta.gen_stamp)
                            dt.send_ack(sock, seqno, status)
                        _M.incr("blocks_received_direct")
            except (ConnectionError, OSError, IOError):
                # Pipeline died mid-stream (client/upstream crash): persist
                # the acked prefix as a partial replica instead of dropping
                # it — the RBW-persistence behavior lease recovery's length
                # sync depends on (BlockRecoveryWorker syncs the MINIMUM
                # replica length across the pipeline; a dropped prefix here
                # would silently shrink that to zero).  Every buffered packet
                # passed its CRC, so the prefix is a safe sync candidate.
                if writer is not None and writer.bytes_written > 0 \
                        and not dn._crashed:
                    # _crashed: a crash simulation (MiniCluster
                    # kill_datanode) — a dead process cannot finalize, and
                    # doing so here would race the restarted DN's recovery
                    # scan over the same directory
                    if tail:
                        crcs.append(native.crc32c(tail))
                    meta = writer.finalize(writer.bytes_written, "direct",
                                           crcs, cchunk)
                    writer = None
                    dn.notify_block_received(block_id, meta.logical_len,
                                             meta.gen_stamp)
                    _M.incr("partial_replicas_persisted")
                raise
            finally:
                if writer is not None:
                    if dn._crashed:
                        writer.detach()   # crash sim: leave rbw + sidecar
                    else:
                        writer.abort()
                if mirror_acks is not None:
                    mirror_acks.close()
                if mirror_sock is not None:
                    mirror_sock.close()

    # ----------------------------------------------------------- reduced path

    def receive_reduced(self, sock: socket.socket, fields: dict) -> None:
        """Reduce-path ingest.  The admission slot is acquired BEFORE any
        buffering (the reference gates at op dispatch, DataXceiver.java:
        349-380 — gating after the buffer fills is the unbounded-memory
        failure mode SURVEY §7(b) warns about): at most
        ``max_concurrent_writes`` blocks are ever buffered.

        With a co-located reduction worker configured, packets are
        FORWARDED to the worker as they arrive (client -> DN -> worker ->
        device memory is one pipeline; the worker stages bytes mid-stream)
        and only (cuts, digests) come back; otherwise the block buffers
        locally (bf1 analog) and reduces in-process.

        Memory: even on the worker path the
        DN ALSO accumulates the block host-side (``parts``) — container
        appends need the unique chunks' bytes after the worker answers,
        and re-fetching them from the worker would double the IPC.  So
        "the DN host stays device-free" holds, but peak host memory is
        ~2x block per in-flight write across the two processes, bounded
        by the admission slots acquired above."""
        dn = self._dn
        block_id, gen_stamp = fields["block_id"], fields["gen_stamp"]
        scheme_name = fields["scheme"]
        targets = fields.get("targets", [])
        scheme = dn.scheme(scheme_name)
        tenant = fields.get("_client")
        t_start = time.monotonic()
        # Overload gate BEFORE the slot and the buffer (utils/qos.py): a
        # shed burns neither an admission slot nor pipeline work.  The
        # write protocol has no pre-stream response frame, so the client
        # streams regardless — consume the packet run (flow control only,
        # nothing buffered) and answer every packet with an ACK_SHED whose
        # seqno field carries the retry-after hint in ms
        # (proto/datatransfer.py ACK_SHED).  Unattributed ingests (mirror
        # relays re-entering as write ops) are internal and never shed.
        if tenant is not None:
            try:
                dn.qos.admit(tenant, "write")
            except qos.ShedError as e:
                _M.incr("write_sheds")
                hint_ms = int(max(e.retry_after_s, 0.0) * 1e3)
                for _seqno, _data, _last in dt.iter_packets(sock):
                    dt.send_ack(sock, hint_ms, dt.ACK_SHED)
                raise
        with profiler.block_timeline(block_id) as tl, \
                dn.write_slot(), \
                qos.bind_tenant(tenant):  # admission BEFORE buffering
            parts: list[bytes] = []
            last_seqno = [0]
            # each next() wait on the client stream is one "recv" span
            packets = profiler.timed_iter("recv", dt.iter_packets(sock))

            def stream():
                for seqno, data, last in packets:
                    last_seqno[0] = seqno
                    # same per-packet crash window as the direct path (the
                    # resilience fault matrix kills the worker mid-stream
                    # from here); a RAISING handler aborts the write like
                    # any other client-stream error
                    fault_injection.point("block_receiver.packet",
                                          block_id=block_id, seqno=seqno,
                                          dn_id=dn.dn_id)
                    # ack (flow control) and buffer BEFORE yielding: a
                    # consumer abandoning the generator mid-yield (worker
                    # death) must lose neither the ack nor the bytes
                    if not last:
                        with profiler.phase("ack"):
                            dt.send_ack(sock, seqno)
                    if data:
                        parts.append(data)
                        yield data

            precomputed = None
            worker_down = False
            crcs = None
            use_worker = (dn.reduction_ctx.worker is not None
                          and getattr(scheme, "container_codec", None)
                          is not None)
            # multi-block pipeline (pipeline_depth > 1): acks + CRC move to
            # a pump thread, the device dispatch to the shared coalescer
            pipelined = (not use_worker
                         and dn.write_pipeline is not None
                         and getattr(scheme, "container_codec", None)
                         is not None)
            if use_worker:
                from hdrf_tpu_torch.server.reduction_worker import WorkerError

                try:
                    precomputed = dn.reduction_ctx.worker.reduce_stream(
                        stream(), dn.reduction_ctx.config.cdc)
                    _M.incr("worker_reduces")
                except (WorkerError, retry.DeadlineExceeded) as e:
                    # WORKER failed, hung past its deadline budget, or its
                    # breaker is open (zero-cost refusal) — client-stream
                    # errors propagate as their own types and abort the
                    # write as before.  Degraded mode: drain the remaining
                    # packets and compute in-process (passthrough).
                    _M.incr("worker_fallbacks")
                    _M.incr("degraded_writes")
                    _LOG.warning("worker reduce failed; degraded write",
                                 dn_id=dn.dn_id, block_id=block_id,
                                 trace=tracing.current_context(),
                                 error=f"{type(e).__name__}: {e}")
                    worker_down = True
                    for _ in stream():
                        pass
            elif pipelined:
                data, crcs, precomputed = self._drain_pipelined(
                    sock, tl, block_id, packets, parts, last_seqno)
            else:
                for _ in stream():
                    pass
            if not pipelined:
                with profiler.phase("buffer_assemble"):
                    data = b"".join(parts)
                tl.nbytes = len(data)
            if worker_down:
                # compute here WITHOUT re-trying the dead worker (the
                # scheme would otherwise reconnect per block while the
                # admission slot is held)
                import numpy as _np

                from hdrf_tpu_torch.ops import dispatch as _dispatch

                precomputed = _dispatch.chunk_and_fingerprint(
                    _np.frombuffer(data, dtype=_np.uint8),
                    dn.reduction_ctx.config.cdc, dn.reduction_ctx.backend)
            # parent: the ambient xceiver span when _xceive opened one
            # (Tracer.span falls back to it), else resume the wire context
            # directly (continueTraceSpan, Receiver.java:94-98)
            with _TR.span("reduce_block",
                          parent=tuple(fields["_trace"])
                          if fields.get("_trace")
                          and tracing.current_context() is None
                          else None) as sp:
                sp.annotate("block_id", block_id)
                sp.annotate("scheme", scheme_name)
                status = self._store_and_mirror(
                    block_id, gen_stamp, scheme_name, data, targets,
                    precomputed=precomputed, crcs=crcs)
            with profiler.phase("ack"):
                dt.send_ack(sock, last_seqno[0], status)
            if tenant is not None:
                # deficit bucket debit + write service estimator feed:
                # actual bytes are only known after the stream landed
                dn.qos.charge(tenant, "write", len(data),
                              latency_s=time.monotonic() - t_start)
        _M.incr("blocks_received_reduced")

    def _drain_pipelined(self, sock: socket.socket, tl, block_id: int,
                         packets, parts: list[bytes], last_seqno: list):
        """Pipelined ingest (``pipeline_depth`` > 1, no co-located worker).

        Two moves off the connection thread's critical path:

        - flow-control acks and incremental CRC run on a per-connection
          pump thread bound to this block's timeline, so the CRC
          overlaps the client-stream ``recv`` waits;
        - the fully-buffered block goes to the DN's shared WritePipeline;
          its device dispatch is ENQUEUED before the pump join below, so
          block K+1's device work is in flight while block K's host
          commit runs on its own connection thread.

        The pump is the sole socket writer until joined; the caller sends
        the final ack only after this returns.  Returns
        ``(data, crcs, (cuts, digests))``."""
        dn = self._dn
        pump_q: queue.Queue = queue.Queue()
        crcs: list[int] = []
        pump_err: list[BaseException] = []

        def _pump():
            tail = b""
            cchunk = dn.checksum_chunk
            with profiler.bind_timeline(tl):
                while True:
                    item = pump_q.get()
                    if item is None:
                        break
                    if pump_err:
                        continue  # drain so the recv loop never blocks
                    seqno, part = item
                    try:
                        if seqno is not None:
                            with profiler.phase("ack"):
                                dt.send_ack(sock, seqno)
                        if part:
                            with profiler.phase("checksum"):
                                tail += part
                                while len(tail) >= cchunk:
                                    crcs.append(int(native.crc32c(
                                        tail[:cchunk])))
                                    tail = tail[cchunk:]
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        pump_err.append(e)
                if not pump_err and tail:
                    with profiler.phase("checksum"):
                        crcs.append(int(native.crc32c(tail)))

        with profiler.phase("pipeline_submit"):  # thread spawn is host work
            pump = threading.Thread(target=_pump, name="recv-pump",
                                    daemon=True)
            pump.start()
        try:
            for seqno, data, last in packets:
                last_seqno[0] = seqno
                fault_injection.point("block_receiver.packet",
                                      block_id=block_id, seqno=seqno,
                                      dn_id=dn.dn_id)
                # hand ack + CRC to the pump BEFORE buffering continues —
                # same loss-safety as stream(): the bytes land in ``parts``
                # on this thread regardless of what the pump does
                pump_q.put((None if last else seqno, data))
                if data:
                    parts.append(data)
        finally:
            pump_q.put(None)  # pump exits even if the client stream died
        with profiler.phase("buffer_assemble"):
            data = b"".join(parts)
        tl.nbytes = len(data)
        import numpy as _np

        with profiler.phase("pipeline_submit"):
            fut = dn.write_pipeline.submit(
                block_id, _np.frombuffer(data, dtype=_np.uint8), tl)
        # residual pump work (tail CRC chunks) runs under the dispatch just
        # enqueued; the join wait is checksum time from this thread's view
        with profiler.phase("checksum"):
            pump.join()
        if pump_err:
            raise pump_err[0]
        return data, crcs, fut.result()

    def _store_and_mirror(self, block_id: int, gen_stamp: int, scheme_name: str,
                          data: bytes, targets: list,
                          precomputed=None, crcs=None) -> int:
        dn = self._dn
        scheme = dn.scheme(scheme_name)
        if crcs is None:
            with profiler.phase("checksum"):
                crcs = _checksums(data, dn.checksum_chunk)
        with metrics.registry("datanode").time("reduce_us"):
            # no host phase around reduce itself: the native path records
            # "reduce_compute" at the dispatch choke point, the worker path
            # records "device_wait" at its final drain, and the in-process
            # device path is attributed by the device ledger
            if precomputed is not None:
                # (cuts, digests) from the worker/pipeline path; the mesh
                # plane adds a third element — the on-device dedup-probe
                # verdict set that lets dedup_commit skip the host index
                # walk for probe-negative chunks.
                cuts, digs, *rest = precomputed
                stored = scheme.reduce_with(block_id, data, cuts, digs,
                                            dn.reduction_ctx,
                                            probe=rest[0] if rest else None)
            else:
                stored = scheme.reduce(block_id, data, dn.reduction_ctx)
        with profiler.phase("container_io"):
            writer = dn.replicas.create_rbw(block_id, gen_stamp)
        try:
            with profiler.phase("container_io"):
                if stored:
                    writer.write(stored)
                meta = writer.finalize(len(data), scheme_name, crcs,
                                       dn.checksum_chunk)
        except (OSError, ValueError) as e:
            # storage-layer failure (disk IO / corrupt state): clean up the
            # rbw, log with the active trace, and re-raise — the xceiver
            # accounts it.  Anything else propagates with the rbw left for
            # the startup recovery scan (no silent broad catch).
            _LOG.error("reduced store failed", dn_id=dn.dn_id,
                       block_id=block_id,
                       trace=tracing.current_context(),
                       error=f"{type(e).__name__}: {e}")
            if dn._crashed:
                writer.detach()   # crash sim: dead processes delete nothing
            else:
                writer.abort()
            raise
        with profiler.phase("ack"):
            dn.notify_block_received(block_id, meta.logical_len,
                                     meta.gen_stamp)
        status = dt.ACK_SUCCESS
        if targets:
            try:
                failed_dn = dn.mirror.push(block_id, gen_stamp, scheme_name,
                                           len(data), stored, crcs, targets)
                if failed_dn:
                    # every leg we drove landed, but a deeper relay hop
                    # broke: the per-hop status frame carried its dn_id up
                    self._note_mirror_failure(
                        self._target_named(targets, failed_dn), block_id,
                        IOError("downstream relay leg failed"))
            except (OSError, ConnectionError, retry.DeadlineExceeded) as e:
                # Mirror failed; local copy is durable — the NN's redundancy
                # monitor re-replicates (§3.5).  Matches pipeline-recovery
                # semantics: report success for the local replica.
                if not getattr(e, "already_attributed", False):
                    self._note_mirror_failure(
                        self._target_named(targets,
                                           getattr(e, "dn_id", None)),
                        block_id, e)
        return status

    @staticmethod
    def _target_named(targets: list, dn_id: str | None) -> dict:
        """The target dict matching ``dn_id``; falls back to targets[0]
        (a direct-leg failure carries no deeper attribution)."""
        if dn_id:
            for t in targets:
                if t.get("dn_id") == dn_id:
                    return t
            return {"dn_id": dn_id}
        return targets[0]

    def _note_mirror_failure(self, target: dict, block_id: int,
                             e: BaseException) -> None:
        """Outright mirror-leg failure: per-peer attribution rides the
        next heartbeat (DataNode.note_mirror_failure) so the NN's outlier
        detector flags BROKEN mirrors, not just slow ones."""
        _M.incr("mirror_failures")
        dn_id = target.get("dn_id")
        if dn_id:
            self._dn.note_mirror_failure(dn_id)
        _LOG.warning("mirror push failed", dn_id=self._dn.dn_id,
                     peer=dn_id, block_id=block_id,
                     trace=tracing.current_context(),
                     error=f"{type(e).__name__}: {e}")

    # -------------------------------------------- reduced mirroring (push side)

    def push_reduced(self, block_id: int, gen_stamp: int, scheme_name: str,
                     logical_len: int, stored: bytes, crcs: list[int],
                     targets: list, throttler=None) -> str | None:
        """Ship the reduced form to targets[0], which relays to the rest.
        Used by both pipeline mirroring and NN-commanded re-replication
        (transferBlock, DataNode.java:2361 — which the reference serves by
        reconstructing FULL bytes, §3.3 note).  ``throttler`` caps the
        send rate on background legs (balancer moves, re-replication —
        DataTransferThrottler's role); client pipeline legs pass None.

        Returns the dn_id of a FAILED deeper relay hop when the local leg
        succeeded anyway (propagated up through the per-hop status frame),
        None when the whole chain landed; raises :class:`MirrorLegFailed`
        carrying the broken hop's dn_id otherwise."""
        dn = self._dn
        scheme = dn.scheme(scheme_name)
        push_t0 = time.perf_counter()
        mirror = _connect(targets[0]["addr"], dn, block_id)
        try:
            with profiler.phase("mirror_stream"):
                if getattr(scheme, "container_codec", None) is not None:
                    # dedup family: hashes + need-list negotiation + chunk
                    # delta
                    entry = dn.index.get_block(block_id)
                    if entry is None:
                        raise IOError(
                            f"block {block_id} missing from chunk index")
                    dt.send_op(mirror, "write_reduced", block_id=block_id,
                               gen_stamp=gen_stamp, scheme=scheme_name,
                               logical_len=logical_len, checksums=crcs,
                               checksum_chunk=dn.checksum_chunk,
                               token=dn.tokens.mint(block_id, "w"),
                               hashes=entry.hashes, targets=targets[1:])
                    # indices into unique hash list
                    need = recv_frame(mirror)["need"]
                    uniq = list(dict.fromkeys(entry.hashes))
                    needed_hashes = [uniq[i] for i in need]
                    with profiler.phase("dedup_lookup"):
                        locs = dn.index.lookup_chunks(needed_hashes)
                    chunk_locs = [(locs[h].container_id, locs[h].offset,
                                   locs[h].length) for h in needed_hashes]
                    with profiler.phase("container_io"):
                        chunks = dn.containers.read_chunks(chunk_locs)
                    seqno = 0
                    sent_bytes = 0
                    for chunk in chunks:
                        if throttler is not None:
                            throttler.throttle(len(chunk))
                        # the mid-chunk-delta crash window: a mirror dying
                        # between packets of the delta stream
                        fault_injection.point("block_receiver.mirror_push",
                                              block_id=block_id,
                                              seqno=seqno, dn_id=dn.dn_id,
                                              peer=targets[0].get("dn_id"))
                        dt.write_packet(mirror, seqno, chunk)
                        sent_bytes += len(chunk)
                        seqno += 1
                    dt.write_packet(mirror, seqno, b"", last=True)
                    hop = recv_frame(mirror)  # per-hop status frame
                    _, status = dt.read_ack(mirror)
                else:
                    # direct/compress family: ship the stored bytes as-is
                    dt.send_op(mirror, "write_reduced", block_id=block_id,
                               gen_stamp=gen_stamp, scheme=scheme_name,
                               logical_len=logical_len, checksums=crcs,
                               checksum_chunk=dn.checksum_chunk,
                               token=dn.tokens.mint(block_id, "w"),
                               hashes=None, targets=targets[1:])
                    # symmetric need-frame (always empty here)
                    recv_frame(mirror)
                    dt.stream_bytes(mirror, stored, dn.config.packet_size,
                                    throttle=throttler.throttle
                                    if throttler is not None else None)
                    sent_bytes = len(stored)
                    hop = recv_frame(mirror)  # per-hop status frame
                    _, status = dt.read_ack(mirror)
            failed_dn = hop.get("failed_dn") if isinstance(hop, dict) else None
            if status != dt.ACK_SUCCESS:
                raise MirrorLegFailed(
                    f"mirror returned status {status}",
                    dn_id=failed_dn or targets[0].get("dn_id"))
            self._note_peer(targets[0], time.perf_counter() - push_t0,
                            max(sent_bytes, 1))
            _M.incr("reduced_mirror_pushes")
            return failed_dn
        finally:
            mirror.close()

    # ------------------------------------------- reduced mirroring (ingest side)

    def ingest_reduced(self, sock: socket.socket, fields: dict) -> None:
        """Mirror side of push_reduced: store the reduced form WITHOUT
        re-running reduction (the whole point of reduced block mirroring)."""
        dn = self._dn
        block_id, gen_stamp = fields["block_id"], fields["gen_stamp"]
        scheme_name, logical_len = fields["scheme"], fields["logical_len"]
        crcs, cchunk = fields["checksums"], fields["checksum_chunk"]
        hashes, targets = fields["hashes"], fields.get("targets", [])
        with profiler.block_timeline(block_id, nbytes=logical_len):
            self._ingest_reduced_inner(sock, dn, block_id, gen_stamp,
                                       scheme_name, logical_len, crcs, cchunk,
                                       hashes, targets)
        _M.incr("blocks_ingested_reduced")

    def _ingest_reduced_inner(self, sock, dn, block_id, gen_stamp, scheme_name,
                              logical_len, crcs, cchunk, hashes,
                              targets) -> None:
        # ingest-entry crash window (the fault matrix kills the mirror
        # right here, before any frame goes back upstream)
        fault_injection.point("block_receiver.ingest_reduced",
                              block_id=block_id, gen_stamp=gen_stamp,
                              dn_id=dn.dn_id)
        # one ingest of a block at a time: a second push of the block
        # waits here, then finds the replica held (``_store_reduced``)
        with self._one_ingest(block_id):
            meta, stored = self._store_reduced(sock, dn, block_id, gen_stamp,
                                               scheme_name, logical_len,
                                               crcs, cchunk, hashes)
        with profiler.phase("ack"):
            dn.notify_block_received(block_id, meta.logical_len,
                                     meta.gen_stamp)
        # a full replica supersedes any coded segments held for the block
        # (re-push upgrade path of the partial-replica lifecycle)
        dn.mirror.on_full_replica(block_id)
        status = dt.ACK_SUCCESS
        failed_dn = None
        if targets:  # relay down the chain
            try:
                failed_dn = self.push_reduced(block_id, gen_stamp,
                                              scheme_name, logical_len,
                                              stored, list(crcs), targets)
            except (OSError, ConnectionError, retry.DeadlineExceeded) as e:
                failed_dn = getattr(e, "dn_id", None) \
                    or targets[0].get("dn_id")
                self._note_mirror_failure(
                    self._target_named(targets, failed_dn), block_id, e)
        with profiler.phase("ack"):
            # per-hop status frame ahead of the fixed 9-byte ack: carries
            # the failing downstream dn_id so upstream hops (and
            # ultimately the primary's outlier feed) blame the ACTUAL
            # broken peer, not targets[0]
            send_frame(sock, {"status": int(status), "failed_dn": failed_dn})
            dt.send_ack(sock, 0, status)

    def _store_reduced(self, sock, dn, block_id, gen_stamp, scheme_name,
                       logical_len, crcs, cchunk, hashes):
        """Negotiate, receive and store one pushed replica; returns its
        meta and the bytes a non-dedup scheme stored (relayed as they
        are).  Runs under ``_one_ingest(block_id)``."""
        existing = dn.replicas.get_meta(block_id)
        if existing is not None and existing.gen_stamp > gen_stamp:
            # stale-generation push (a re-push raced a pipeline-recovery
            # gen bump, updatePipeline/FSNamesystem.java analog): refuse
            # before any container append — accepting would roll the
            # replica back behind its recovered generation
            _M.incr("stale_gen_rejected")
            raise IOError(f"stale gen_stamp {gen_stamp} < "
                          f"{existing.gen_stamp} for block {block_id}")
        # the replica is already here at this generation: a ``replicate``
        # the NameNode sent again (its pending timeout passed before the
        # first push's IBR counted), or two sources pushing in turn or at
        # once (the later one waited in ``_one_ingest``).  It is
        # acknowledged and reported again; the reference commits the
        # block's chunk references a second time and then fails on
        # create_rbw (FileExistsError).
        held = (existing is not None and existing.gen_stamp == gen_stamp
                and existing.logical_len == logical_len)
        stored = b""
        if hashes is not None:
            hashes = [bytes(h) for h in hashes]
            uniq = list(dict.fromkeys(hashes))
            if held:
                need = []
            else:
                with profiler.phase("dedup_lookup"):
                    known = dn.index.lookup_chunks(uniq)
                need = [i for i, h in enumerate(uniq) if known[h] is None]
            # torn need-frame window: the mirror dying mid-negotiation
            # (upstream sees a half-written frame / reset socket)
            fault_injection.point("block_receiver.need_frame",
                                  block_id=block_id, dn_id=dn.dn_id)
            send_frame(sock, {"need": need})
            chunks = [data for _, data, last in profiler.timed_iter(
                "recv", dt.iter_packets(sock)) if data]
            if len(chunks) != len(need):
                raise IOError(f"expected {len(need)} chunks, got {len(chunks)}")
            if not held:
                with profiler.phase("container_io"):
                    locs = dn.containers.append_chunks(
                        chunks, on_seal=dn.index.seal_container)
                new_chunks = {uniq[i]: loc for i, loc in zip(need, locs)}
                dn.index.commit_block(block_id, logical_len, hashes,
                                      new_chunks)
        else:
            send_frame(sock, {"need": []})
            with profiler.phase("recv"):
                stored = dt.collect_packets(sock)
        if held:
            _M.incr("replicas_already_held")
            meta = existing
        else:
            with profiler.phase("container_io"):
                writer = dn.replicas.create_rbw(block_id, gen_stamp)
            try:
                with profiler.phase("container_io"):
                    if stored:
                        writer.write(stored)
                    meta = writer.finalize(logical_len, scheme_name,
                                           list(crcs), cchunk)
            except (OSError, ValueError) as e:
                # same contract as _store_and_mirror: typed cleanup +
                # traced log + re-raise (no silent broad catch)
                _LOG.error("reduced ingest failed", dn_id=dn.dn_id,
                           block_id=block_id,
                           trace=tracing.current_context(),
                           error=f"{type(e).__name__}: {e}")
                if dn._crashed:
                    writer.detach()   # crash sim: dead processes delete nothing
                else:
                    writer.abort()
                raise
        return meta, stored

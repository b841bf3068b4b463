"""DataNode: the data plane daemon (port of hdrf_tpu/server/datanode.py).

Re-expression of the reference's DataNode stack — DataNode.java (daemon,
3.7 kLoC), DataXceiverServer.java:44 (accept loop, thread per op),
DataXceiver.java (op dispatch + admission control :313-380), BPServiceActor
(heartbeats + block reports + NN command execution) — around the storage and
reduction layers:

- xceiver loop: thread-per-connection serving WRITE_BLOCK / READ_BLOCK /
  write_reduced / mirror_segment(_read) / BLOCK_CHECKSUM / replica_info /
  truncate_replica / disk_balance / the three stripe ops / trace_spans
  (Receiver.java:101-135 dispatch analog)
- write ops route by scheme: ``direct`` -> streaming pipeline; everything
  else -> buffered reduction with reduced block mirroring (block_receiver.py)
- admission control: bounded semaphores per direction, replacing the
  reference's racy static ticket queues (DataXceiver.java:130-133, the
  sleep-loop waits at :313-380)
- heartbeat thread executes NN commands: replicate (reduced-form push),
  invalidate, ec_reconstruct, stripe_demote / stripe_repair
  (server/ec_tier.py), mirror_assemble (server/mirror_plane.py),
  recover_block, cache / uncache, balancer_bandwidth, finalize_upgrade
- block reports: full report on register + periodic; incremental (IBR) on
  every finalize; a lifeline while heartbeats are overdue; one NameNode or
  several (HA, federation)

Port notes.  The device backend is ``cuda`` (ops/dispatch.resolve_backend
maps the reference's ``auto`` and ``tpu`` to it); every reference test of
``backend == "tpu"`` — the in-process device seal, the device
reconstructor, the write pipeline's coalescer — is "not ``native``"
here, so the ``cpu`` backend (the kernels' plain versions) runs the same
structure on a machine without a card.  The co-located worker path
(``worker_addr``) keeps the reference's documented degraded mode: a
failed worker seal falls back to the host codec and counts
``worker_fallbacks``; nothing else falls back from the card.  With
``reduction.worker_spawn`` the DataNode owns that worker process through
a ``WorkerSupervisor`` (server/reduction_worker.py), which respawns it
with capped backoff and repoints the ``WorkerClient``.

Every plane of the reference runs here, the ones off by default too: the
status HTTP server (``status_port``, server/status_http.py), the integrity
scrubber (server/scrubber.py: built always, its loop on
``scrub_interval_s`` > 0), provided storage (storage/aliasmap.py, the
``alias_add`` op, PROVIDED reports and reads), the simulated dataset
(``simulated_dataset``, storage/simulated.py), live reconfiguration
(``reconfigure`` / ``get_reconfigurable``) and the adaptive chunking tick
(``reduction.cdc_adaptive``: ``AdaptiveChunkController`` steps applied
through ``reconfigure``, a retune guarded by tools/slo_report.guard).  A
retune changes the shared ``CdcConfig``; the next reducer resolution (the
dispatch funnel, the write pipeline, a co-located worker's next
``reduce``) cuts with it.  The flight archive (``flight_archive_dir``),
short-circuit reads (server/shortcircuit.py on ``<data_dir>/sc.sock``) and
the block scanner (``scan_interval_s``) are ported.
"""

from __future__ import annotations

import contextlib
import os
import socket
import socketserver
import threading
import time
import uuid
from typing import Iterator

import numpy as np

from hdrf_tpu_torch import native
from hdrf_tpu_torch.config import DataNodeConfig
from hdrf_tpu_torch.index.chunk_index import ChunkIndex
from hdrf_tpu_torch.ops import dispatch as ops_dispatch
from hdrf_tpu_torch.ops import rs
from hdrf_tpu_torch.proto import datatransfer as dt
from hdrf_tpu_torch.proto.rpc import (RpcClient, RpcError, normalize_addrs,
                                      recv_frame, send_frame)
from hdrf_tpu_torch.reduction import scheme as schemes
from hdrf_tpu_torch.reduction.scheme import ReductionContext, ReductionScheme
from hdrf_tpu_torch.server.block_receiver import BlockReceiver
from hdrf_tpu_torch.server.block_sender import BlockSender
from hdrf_tpu_torch.server.status_http import StatusHttpServer
from hdrf_tpu_torch.reduction import accounting
from hdrf_tpu_torch.utils import (device_ledger, fault_injection,
                                  flight_archive, flight_recorder, log,
                                  metrics, profiler, qos, retry, rollwin,
                                  tenants, tracing)
from hdrf_tpu_torch.utils.watchdog import StallWatchdog

_M = metrics.registry("datanode")
_TR = tracing.tracer("datanode")

class PinnedCache:
    """DN-side pinned replica cache (FsDatasetCache.java:67 analog).  The
    reference mmaps + mlocks replica files; here the LOGICAL bytes are
    pinned in RAM (covering reduced blocks too — a cached dedup'd block
    skips reconstruction AND disk), bounded by a byte budget.  Pin/unpin
    is NN-directed via DNA_CACHE/DNA_UNCACHE commands."""

    def __init__(self, capacity: int):
        self._capacity = capacity
        self._lock = threading.Lock()
        self._data: dict[int, bytes] = {}
        self._used = 0

    def set_capacity(self, capacity: int) -> None:
        """Live budget change (dfs.datanode.max.locked.memory is one of
        the reference's reconfigurable keys); shrink evicts nothing —
        pins just stop until usage drains below the new cap."""
        with self._lock:
            self._capacity = capacity

    def pin(self, block_id: int, data: bytes) -> bool:
        with self._lock:
            if block_id in self._data:
                return True
            if self._used + len(data) > self._capacity:
                _M.incr("cache_pin_rejected")
                return False
            self._data[block_id] = data
            self._used += len(data)
            _M.incr("blocks_cached")
            return True

    def unpin(self, block_id: int) -> None:
        with self._lock:
            data = self._data.pop(block_id, None)
            if data is not None:
                self._used -= len(data)
                _M.incr("blocks_uncached")

    def get(self, block_id: int, offset: int = 0,
            length: int = -1) -> bytes | None:
        with self._lock:
            data = self._data.get(block_id)
        if data is None:
            return None
        _M.incr("cache_hits")
        end = len(data) if length < 0 else min(offset + length, len(data))
        return data[offset:end]

    def ids(self) -> list[int]:
        with self._lock:
            return sorted(self._data)

    def used(self) -> int:
        with self._lock:
            return self._used


class DataNode:
    def __init__(self, config: DataNodeConfig, namenode_addr,
                 dn_id: str | None = None):
        """``namenode_addr``: one (host, port) or a list of them — with HA the
        DN reports to EVERY NameNode (the BPOfferService-per-NN pattern: the
        standby needs block reports too, so its block map is warm at
        failover) but executes commands only from the active."""
        self.config = config
        # dn_id is fixed BEFORE the worker wiring below: the DN->worker
        # circuit breaker is registered per edge as "<dn_id>->worker", so
        # MiniCluster DNs sharing one worker address get SEPARATE breakers.
        self.dn_id = dn_id or f"dn-{uuid.uuid4().hex[:8]}"
        self.checksum_chunk = 64 * 1024
        # background-transfer cap (DataTransferThrottler analog): balancer
        # moves, re-replication, EC reconstruction — never client pipelines
        from hdrf_tpu_torch.utils.throttler import Throttler

        self.balance_throttler = Throttler(config.balancer_bandwidth)
        red = config.reduction
        # Layout check/upgrade BEFORE anything opens the store (the
        # reference's Storage.analyzeStorage + doUpgrade at startup): a
        # flat pre-volume dir is migrated to volumes/vol-0 with a
        # rollback snapshot under previous/.
        from hdrf_tpu_torch.storage import version as storage_version

        storage_version.ensure_layout(config.data_dir, "datanode",
                                      storage_version.DN_UPGRADERS)
        backend = ops_dispatch.resolve_backend(red.backend)
        # the card (cuda) or the kernels' plain versions (cpu): the
        # reference's in-process ``tpu`` paths
        on_device = backend != "native"
        # Seal entropy stage (the reference's rollover LZ4,
        # DataDeduplicator.java:770-781), most-capable-first: the
        # co-located worker process (device-owning; the DN host stays
        # device-free, falling back to the host codec if it dies), else
        # the in-process device path, else the host codec default.
        self._worker = None
        self._worker_breaker = None
        self._worker_supervisor = None
        seal_fn = None
        seal_batch_fn = None
        if red.worker_spawn and not red.worker_addr:
            # Supervised co-located worker: the DN owns the process and
            # respawns it with backoff; each respawn repoints the client
            # (fresh ephemeral port) and the breaker's half-open probe
            # re-admits the edge.
            from hdrf_tpu_torch.server.reduction_worker import \
                WorkerSupervisor

            self._worker_supervisor = WorkerSupervisor(
                backend=red.backend,
                base_s=red.worker_respawn_base_s,
                cap_s=red.worker_respawn_cap_s,
                on_respawn=lambda addr: self._worker.set_addr(addr))
            red.worker_addr = list(self._worker_supervisor.start())
        if red.worker_addr:
            from hdrf_tpu_torch.server.reduction_worker import (WorkerClient,
                                                          WorkerError)

            self._worker_breaker = retry.breaker(
                f"{self.dn_id}->worker",
                failure_threshold=red.worker_breaker_failures,
                reset_s=red.worker_breaker_reset_s)
            self._worker = WorkerClient(
                tuple(red.worker_addr),
                deadline_s=red.worker_deadline_s,
                deadline_s_per_mb=red.worker_deadline_s_per_mb,
                breaker=self._worker_breaker)

            def _worker_seal(data: bytes) -> bytes:
                try:
                    return self._worker.compress("lz4", data)
                except (WorkerError, retry.DeadlineExceeded):
                    _M.incr("worker_fallbacks")
                    from hdrf_tpu_torch.utils import codec as codecs

                    return codecs.compress("lz4", data)

            def _worker_seal_batch(datas: list) -> list:
                try:
                    return self._worker.compress_batch("lz4", datas)
                except (WorkerError, retry.DeadlineExceeded):
                    _M.incr("worker_fallbacks")
                    from hdrf_tpu_torch.utils import codec as codecs

                    return [codecs.compress("lz4", d) for d in datas]

            if red.container_codec == "lz4":
                seal_fn = _worker_seal
                seal_batch_fn = _worker_seal_batch
        elif on_device and red.container_codec == "lz4":
            seal_fn = (lambda data:
                       ops_dispatch.block_compress("lz4", data, backend))
            seal_batch_fn = (lambda datas:
                             ops_dispatch.block_compress_batch(
                                 "lz4", datas, backend))
        # Volumes (FsVolumeList analog): one ReplicaStore + ContainerStore
        # per configured volume type, replica/chunk placement across them,
        # per-volume failure ejection (storage/volumes.py).
        from hdrf_tpu_torch.storage.volumes import VolumeSet

        self.volume_types = list(config.volume_types
                                 or [config.storage_type])
        self.volumes = VolumeSet(
            config.data_dir, self.volume_types,
            container_kw=dict(container_size=red.container_size,
                              codec=red.container_codec,
                              compress_fn=seal_fn,
                              compress_batch_fn=seal_batch_fn,
                              fsync=red.fsync_containers))
        if config.simulated_dataset:
            from hdrf_tpu_torch.storage.simulated import SimulatedReplicaStore

            self.replicas = SimulatedReplicaStore()
        else:
            self.replicas = self.volumes
        self.containers = self.volumes.containers
        # WAL group-commit window: armed only when the multi-block pipeline
        # is on (depth > 1) — serial writes would just pay the window wait
        self.index = ChunkIndex(
            os.path.join(config.data_dir, "index"),
            group_window_s=(red.group_commit_window_ms / 1000.0
                            if red.pipeline_depth > 1 else 0.0),
            group_max=red.pipeline_max_inflight)
        recon = None
        if red.device_recon and on_device and self._worker is None:
            from hdrf_tpu_torch.ops.reconstruct import DeviceReconstructor

            recon = DeviceReconstructor(
                device=ops_dispatch._device_for(backend))
            self.containers._on_delete = recon.invalidate
        self.reduction_ctx = ReductionContext(
            config=red, containers=self.containers, index=self.index,
            backend=backend, worker=self._worker, recon=recon)
        # Overload-safety plane (utils/qos.py): one AdmissionController
        # shared by the read and write planes — per-tenant token buckets
        # plus deadline-aware shedding, surfaced on /prom, /health, the
        # flight recorder, and the heartbeat stats.
        self.qos = qos.AdmissionController(
            rate_mb_s=red.qos_tenant_rate_mb_s,
            burst_mb=red.qos_tenant_burst_mb,
            shed_p95_mult=red.shed_p95_mult)
        # Chunk-granular serving engine (server/read_plane.py): shared
        # decoded-chunk cache + coalesced container decodes.  The retire
        # hook drops cached chunks when a container is quarantined or
        # deleted (scrubber/compaction interplay).
        from hdrf_tpu_torch.server.read_plane import ReadPlane

        self.read_plane = ReadPlane(
            self.containers, chunk_cache_mb=red.chunk_cache_mb,
            window_ms=red.read_batch_window_ms,
            max_inflight=red.read_max_inflight, backend=backend,
            qos_ctrl=self.qos)
        self.read_plane.attach_store(self.containers)
        self.reduction_ctx.read_plane = self.read_plane
        # EC cold tier (server/ec_tier.py): stripe store + demote/serve/
        # repair roles; installs the degraded-read fallback hooks on the
        # container stores (AFTER the recon _on_delete wiring above — the
        # tier chains, not replaces, that observer).
        from hdrf_tpu_torch.server.ec_tier import EcTier

        self.ec = EcTier(self)
        # Coded-exchange plane (server/coded_exchange.py): the shared
        # background bulk-transfer sender — QoS control lane + balance
        # throttle + smaller-of LZ4 negotiation — used by EC repair/demote
        # legs and any future rebalance/compaction move.
        from hdrf_tpu_torch.server.coded_exchange import CodedExchange

        self.coded = CodedExchange(self)
        # Multi-block write pipeline (server/write_pipeline.py): shared
        # device batches + overlap scheduling when depth > 1; None keeps
        # the one-block-at-a-time serial path exactly as before.
        self.write_pipeline = None
        # Mesh-sharded reduction plane (parallel/sharded.py): flips the
        # dispatch-layer routing (batched lz4 seals included) and arms the
        # coalescer's MeshReducer below.
        ops_dispatch.set_mesh_plane(red.mesh_plane)
        if red.pipeline_depth > 1:
            from hdrf_tpu_torch.server.write_pipeline import WritePipeline

            self.write_pipeline = WritePipeline(
                red.cdc, backend, depth=red.pipeline_depth,
                max_inflight=red.pipeline_max_inflight,
                mesh_plane=red.mesh_plane,
                mesh_lanes=red.mesh_lanes_per_device,
                mesh_bucket_slots=red.mesh_bucket_slots,
                qos_ctrl=self.qos)
            if self.write_pipeline.mesh_reducer is not None:
                # the device bucket table tracks the authoritative index
                # incrementally: every commit's first-seen fingerprints
                # flow into the next mesh step's refresh dispatch
                self.index.add_commit_listener(
                    self.write_pipeline.mesh_reducer.table.note_new)
            # seal compression off the commit critical path too: an
            # unlucky rollover must not stall the blocks queued behind it
            self.containers.enable_async_seals()
        # Content-adaptive chunk sizing (reduction/accounting.py
        # AdaptiveChunkController): the heartbeat tick feeds it the dedup
        # hit/miss counters; the steps it emits are applied through
        # reconfigure() — the same validated path an operator would use —
        # so geometry never changes behind the config's audit trail.
        self._cdc_controller = None
        if red.cdc_adaptive:
            self._cdc_controller = accounting.AdaptiveChunkController(
                target_mask_bits=red.cdc_target_mask_bits,
                min_size=red.cdc_min_size)
        # Post-retune regression guard (tools/slo_report.py guard): armed
        # after every applied retune with a baseline of recent flight
        # samples; once enough post-retune samples accrue, a regressing
        # window rolls the geometry back through reconfigure().
        self._cdc_guard: dict | None = None
        # Admission control: bounded slots instead of ticket queues.
        self._write_sem = threading.Semaphore(red.max_concurrent_writes)
        self._read_sem = threading.Semaphore(red.max_concurrent_reads)
        self._direct_sem = threading.Semaphore(red.max_concurrent_direct)
        self.cache = PinnedCache(config.cache_capacity)
        # provided storage (aliasmap/InMemoryAliasMap.java): blocks whose
        # bytes live in an external store; persisted regions are reported
        # as PROVIDED replicas and served through the read path
        from hdrf_tpu_torch.storage.aliasmap import InMemoryAliasMap

        self.aliasmap = InMemoryAliasMap(
            os.path.join(config.data_dir, "aliasmap"),
            mount_root=config.provided_mount_root or None)
        # Federation (BPOfferService.java:57 per namespace): accept either
        # one nameservice's addr(s) or a LIST of nameservices (list of
        # addr lists).  The DN registers/reports to every NN of every
        # nameservice; block pools are disjoint id ranges, so reports are
        # partitioned per NN by the pool index learned at registration.
        def _is_ns_list(a) -> bool:
            return (isinstance(a, (list, tuple)) and a
                    and isinstance(a[0], (list, tuple)) and a[0]
                    and isinstance(a[0][0], (list, tuple)))

        self._nameservices = ([normalize_addrs(ns) for ns in namenode_addr]
                              if _is_ns_list(namenode_addr)
                              else [normalize_addrs(namenode_addr)])
        self._nns = [RpcClient(a) for ns in self._nameservices for a in ns]
        # RpcClient -> block_pool_index (from registration); None until
        # learned, meaning "send everything, the NN pool-guards anyway"
        self._pool_of: dict[int, int] = {}
        from hdrf_tpu_torch.security import BlockTokenVerifier
        self.tokens = BlockTokenVerifier()
        self._receiver = BlockReceiver(self)
        self._sender = BlockSender(self)
        # coded mirror plane (server/mirror_plane.py): k-of-n segment
        # fan-out with hedged parity legs; mirror_parity=0 degrades to the
        # serial push_reduced relay through this object unchanged
        from hdrf_tpu_torch.server.mirror_plane import MirrorPlane
        self.mirror = MirrorPlane(self)
        # integrity-scrub plane (server/scrubber.py): container/stripe/
        # replica re-verification + garbage census; loop gated on
        # scrub_interval_s > 0, tests drive run_cycle() directly
        from hdrf_tpu_torch.server.scrubber import Scrubber
        self.scrubber = Scrubber(self)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._ibr_queue: list[tuple[int, int, int, str | None, bool]] = []
        self._ibr_event = threading.Event()
        # Slow-peer detection inputs (DataNodePeerMetrics analog): decayed
        # rolling window of normalized downstream-transfer latencies per
        # peer, plus the same shape per volume over disk-probe durations
        # (DataNodeVolumeMetrics analog).  Both ride heartbeats to the NN.
        self._peer_win = rollwin.WindowMap(window_s=300.0, maxlen=64)
        self._vol_win = rollwin.WindowMap(window_s=300.0, maxlen=64)
        # outright mirror failures per peer (vs merely slow ones above);
        # cumulative counts, shipped in every heartbeat's stats
        self._mirror_fail: dict[str, int] = {}
        self._mirror_fail_lock = threading.Lock()
        self._log = log.get_logger("datanode")
        # lifeline trigger clocks, PER NN (the reference's lifeline is
        # per-BPServiceActor): a heartbeat landing at one NN must not
        # suppress lifelines to another that is receiving none
        now0 = time.monotonic()
        self._last_hb_ok = {id(nn): now0 for nn in self._nns}

        # Crash simulation (MiniCluster.kill_datanode): when set, in-flight
        # receivers tear down WITHOUT touching disk (a dead process can't
        # finalize or delete replicas) — see BlockReceiver's teardown.
        self._crashed = False
        self._inflight = 0                       # active xceiver handlers
        self._inflight_cv = threading.Condition()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                outer._conns.add(self.request)
                with outer._inflight_cv:
                    outer._inflight += 1
                try:
                    outer._xceive(self.request)
                finally:
                    outer._conns.discard(self.request)
                    with outer._inflight_cv:
                        outer._inflight -= 1
                        outer._inflight_cv.notify_all()

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((config.host, config.port), Handler)
        self._conns: set[socket.socket] = set()
        # Stall watchdog over in-flight xceiver ops (DataXceiver has no
        # analog): flags ops outliving ``stall_budget_s`` + optional
        # per-daemon status HTTP endpoint (HttpServer2 analog).
        self.watchdog = StallWatchdog(self.dn_id,
                                      budget_s=config.stall_budget_s,
                                      registry=_M)
        # Flight recorder: over-time curve of this DN's key gauges,
        # served as /timeseries (utils/flight_recorder.py); optionally
        # backed by a crash-safe archive so the curve survives restarts
        # (utils/flight_archive.py).
        self.flight_archive = None
        if config.flight_archive_dir:
            arch_dir = config.flight_archive_dir
            if not os.path.isabs(arch_dir):
                arch_dir = os.path.join(config.data_dir, arch_dir)
            self.flight_archive = flight_archive.FlightArchive(
                arch_dir, max_bytes=config.flight_archive_max_mb << 20)
        self.flight = flight_recorder.FlightRecorder(
            self.dn_id, self._flight_sample,
            interval_s=config.flight_interval_s,
            capacity=config.flight_capacity,
            archive=self.flight_archive)
        self._status = None
        if config.status_port is not None:
            self._status = StatusHttpServer(self.dn_id, host=config.host,
                                            port=config.status_port,
                                            watchdog=self.watchdog,
                                            recorder=self.flight)
        from hdrf_tpu_torch.server.shortcircuit import ShortCircuitServer
        self._sc = ShortCircuitServer(
            self, os.path.join(config.data_dir, "sc.sock"))

    # ------------------------------------------------------------ lifecycle

    @property
    def addr(self) -> tuple[str, int]:
        return self._server.server_address

    def start(self) -> "DataNode":
        self._verify_index_containers()
        t = threading.Thread(target=self._server.serve_forever,
                             name=f"{self.dn_id}-xceiver", daemon=True)
        t.start()
        self._threads.append(t)
        self._sc.start()
        self.watchdog.start()
        if self.config.flight_interval_s > 0:
            self.flight.start()
        if self._status is not None:
            self._status.start()
        self._register()
        hb = threading.Thread(target=self._heartbeat_loop,
                              name=f"{self.dn_id}-heartbeat", daemon=True)
        hb.start()
        self._threads.append(hb)
        ll = threading.Thread(target=self._lifeline_loop,
                              name=f"{self.dn_id}-lifeline", daemon=True)
        ll.start()
        self._threads.append(ll)
        ibr = threading.Thread(target=self._ibr_loop,
                               name=f"{self.dn_id}-ibr", daemon=True)
        ibr.start()
        self._threads.append(ibr)
        if self.config.scan_interval_s > 0:
            sc = threading.Thread(target=self._scanner_loop,
                                  name=f"{self.dn_id}-scanner", daemon=True)
            sc.start()
            self._threads.append(sc)
        if self.config.scrub_interval_s > 0:
            sb = threading.Thread(target=self._scrub_loop,
                                  name=f"{self.dn_id}-scrubber", daemon=True)
            sb.start()
            self._threads.append(sb)
        if self.config.volume_check_interval_s > 0 \
                and not self.config.simulated_dataset:
            vc = threading.Thread(target=self._volume_check_loop,
                                  name=f"{self.dn_id}-volcheck", daemon=True)
            vc.start()
            self._threads.append(vc)
        if self.config.lazy_writer_interval_s > 0 \
                and not self.config.simulated_dataset \
                and any(v.storage_type == "RAM_DISK"
                        for v in self.volumes.volumes):
            lw = threading.Thread(target=self._lazy_writer_loop,
                                  name=f"{self.dn_id}-lazywriter",
                                  daemon=True)
            lw.start()
            self._threads.append(lw)
        self._log.info("datanode started", dn_id=self.dn_id,
                       addr=f"{self.addr[0]}:{self.addr[1]}",
                       volumes=len(self.volumes.volumes),
                       backend=self.reduction_ctx.backend)
        return self

    def _lazy_writer_loop(self) -> None:
        """RamDiskAsyncLazyPersistService analog: shadow RAM replicas onto
        DISK, evict persisted ones past the RAM capacity budget."""
        while not self._stop.wait(self.config.lazy_writer_interval_s):
            try:
                self.volumes.lazy_persist_tick(self.config.ram_disk_capacity)
            except Exception:  # noqa: BLE001 — a bad volume must not kill
                _M.incr("lazy_writer_errors")

    def stop(self) -> None:
        self._stop.set()
        self.watchdog.stop()
        self.flight.stop()
        if self.flight_archive is not None:
            self.flight_archive.close()
        if self._status is not None:
            self._status.stop()
        self._sc.stop()
        self._sc.stop_registry()
        self._server.shutdown()
        self._server.server_close()
        self._sever_connections()
        for t in self._threads:
            t.join(timeout=5)
        if self.write_pipeline is not None:
            self.write_pipeline.close()   # before flush: no new dispatches
        self.read_plane.close()           # drain the coalescer's worker
        self.containers.flush_open(on_seal=self.index.seal_container)
        if hasattr(self.containers, "close_async_seals"):
            self.containers.close_async_seals()
        self.index.close()
        if self._worker_supervisor is not None:
            self._worker_supervisor.stop()
        if self._worker is not None:
            self._worker.close()
        for nn in self._nns:
            nn.close()

    def _sever_connections(self) -> None:
        for s in list(self._conns):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()

    def await_xceivers(self, timeout: float = 5.0) -> bool:
        """Wait for in-flight xceiver handlers to unwind (severed sockets
        make them exit promptly).  kill_datanode uses this so a restart
        over the same directory never races a dying handler's teardown."""
        with self._inflight_cv:
            return self._inflight_cv.wait_for(
                lambda: self._inflight == 0, timeout)

    # --------------------------------------------------------------- helpers

    def scheme(self, name: str) -> ReductionScheme:
        return schemes.get(name)

    @contextlib.contextmanager
    def write_slot(self) -> Iterator[None]:
        if not self._write_sem.acquire(timeout=300):
            raise TimeoutError("write admission timeout")
        try:
            yield
        finally:
            self._write_sem.release()

    @contextlib.contextmanager
    def direct_slot(self) -> Iterator[None]:
        if not self._direct_sem.acquire(timeout=300):
            raise TimeoutError("direct-write admission timeout")
        try:
            yield
        finally:
            self._direct_sem.release()

    @contextlib.contextmanager
    def read_slot(self) -> Iterator[None]:
        if not self._read_sem.acquire(timeout=300):
            raise TimeoutError("read admission timeout")
        try:
            yield
        finally:
            self._read_sem.release()

    def notify_block_received(self, block_id: int, length: int,
                              gen_stamp: int = -1,
                              storage_type: str | None = None,
                              partial: bool = False) -> None:
        """Incremental block report (IBR) on finalize: queued and delivered
        by a dedicated thread so an unreachable NN can never stall the write
        pipeline's ack (HDFS IBRs are asynchronous for the same reason);
        best-effort — the periodic full report reconciles anything missed.
        Carries the replica's gen stamp so the NN can fence a superseded
        pipeline's late finalize.  ``partial=True`` registers a coded
        mirror SEGMENT (server/mirror_plane.py): never a read location —
        the NN's reconciliation monitor upgrades it in the background."""
        # a (re)finalized replica invalidates any pinned copy: append's
        # copy-on-append rewrites the same block id, and serving the stale
        # pinned bytes would lose the appended region
        self.cache.unpin(block_id)
        # ... and revokes outstanding short-circuit grants for the same
        # reason (a cached client fd still maps the superseded inode)
        self._sc.registry.revoke(block_id)
        if not partial:
            # a FULL replica landing (any path: direct receive, replicate
            # push, ec reconstruct, mirror assemble) shadows any partial
            # mirror segments still held for the block — reclaim them now
            # instead of leaking them as garbage (on_full_replica is
            # idempotent: it only counts when segments were dropped)
            self.mirror.on_full_replica(block_id)
        self._ibr_queue.append((block_id, length, gen_stamp, storage_type,
                                partial))
        self._ibr_event.set()

    def _ibr_loop(self) -> None:
        while not self._stop.is_set():
            self._ibr_event.wait(timeout=0.5)
            self._ibr_event.clear()
            while self._ibr_queue:
                block_id, length, gen_stamp, stype, partial = \
                    self._ibr_queue.pop(0)
                for nn in self._nns:
                    # pool-partitioned like full reports: a foreign NS's
                    # NN would only bounce the IBR off its pool guard
                    pool = self._pool_of.get(id(nn))
                    if pool is not None and block_id >> 48 != pool:
                        continue
                    try:
                        nn.call("block_received", dn_id=self.dn_id,
                                block_id=block_id, length=length,
                                gen_stamp=gen_stamp, storage_type=stype,
                                partial=partial)
                    except (OSError, ConnectionError):
                        _M.incr("ibr_failures")

    # ---------------------------------------------------------- xceiver loop

    def _xceive(self, sock: socket.socket) -> None:
        from hdrf_tpu_torch import security

        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            op, fields = dt.recv_op(sock)
            if op == security.HANDSHAKE_OP:
                # Encrypted connection: run the token-keyed handshake, then
                # read the real op off the AEAD channel.  The authenticated
                # token doubles as the op's token when none is carried.
                sock, hs_token = security.server_handshake(
                    sock, fields, self.tokens._keys)
                op, fields = dt.recv_op(sock)
                fields.setdefault("token", hs_token)
            elif self.config.encrypt_data_transfer:
                _M.incr("plaintext_refused")
                sock.close()
                return  # strict mode: no plaintext ops
        except PermissionError:
            _M.incr("op_auth_failures")
            sock.close()
            return
        except (ConnectionError, OSError):
            sock.close()
            return
        fault_injection.point("datanode.op", op=op)
        trace = fields.get("_trace")
        try:
            if op == "trace_spans":
                # Observability poll (gateway /traces fan-out): serve the
                # local span sink + device ledger, proxying the co-located
                # worker's so callers never need the worker addr.  Served
                # OUTSIDE the xceiver span so polling never pollutes traces.
                self._serve_trace_spans(sock)
                return
            if op == "flight_timeseries":
                # Long-horizon poll (gateway /timeseries?scope=cluster
                # fan-out): ring + archive merged, filtered, tail-limited
                # (utils/flight_archive.py query).  Same no-span rule as
                # trace_spans — polling must not pollute observability.
                send_frame(sock, flight_archive.query(
                    self.flight, self.flight_archive,
                    metric=fields.get("metric"),
                    since=fields.get("since"),
                    limit=int(fields.get("limit") or 2048)))
                return
            with retry.bind_remaining(fields.get(retry.DEADLINE_KEY)), \
                    self.watchdog.track(f"xceiver.{op}"), \
                    _TR.span(f"xceiver.{op}",
                             parent=tuple(trace) if trace else None) as sp:
                sp.annotate("dn_id", self.dn_id)
                self._dispatch_op(sock, op, fields)
        except PermissionError:
            _M.incr("op_auth_failures")
        except qos.ShedError:
            # admission refusals are intentional overload behavior, not
            # op failures — ShedError subclasses IOError, so this clause
            # must sit ABOVE the OSError arm to keep the books honest
            _M.incr("op_sheds")
        except (ConnectionError, OSError):
            _M.incr("op_io_errors")
        except Exception:  # noqa: BLE001 — xceiver thread must not die silently
            _M.incr("op_errors")
        finally:
            sock.close()

    def _serve_trace_spans(self, sock: socket.socket) -> None:
        out = {"daemon": self.dn_id,
               "spans": tracing.all_span_snapshots(),
               "ledger": device_ledger.events_snapshot(),
               "counters": profiler.counters_snapshot()}
        if self._worker is not None:
            from hdrf_tpu_torch.server.reduction_worker import WorkerError

            try:
                w = self._worker.traces()
                out["spans"] = out["spans"] + list(w.get("spans") or ())
                out["ledger"] = out["ledger"] + list(w.get("ledger") or ())
                out["counters"] = (out["counters"]
                                   + list(w.get("counters") or ()))
            except (WorkerError, ConnectionError, OSError,
                    retry.DeadlineExceeded) as e:
                # worker down: local view still serves
                _M.incr("worker_trace_failures")
                self._log.warning("worker trace poll failed",
                                     dn_id=self.dn_id,
                                     trace=tracing.current_context(),
                                     error=f"{type(e).__name__}: {e}")
        send_frame(sock, out)

    def _dispatch_op(self, sock: socket.socket, op, fields: dict) -> None:
        """Xceiver op chain (Receiver.java:101-135 dispatch analog).  The
        caller (_xceive) owns the socket lifetime, the xceiver span, the
        watchdog tracking and the exception accounting."""
        if op == dt.WRITE_BLOCK:
            self.tokens.verify(fields.get("token"), fields["block_id"], "w")
            t_start = time.monotonic()
            if fields["scheme"] == "direct":
                self._receiver.receive_direct(sock, fields)
            else:
                self._receiver.receive_reduced(sock, fields)
            if fields.get("_client"):
                meta = self.replicas.get_meta(fields["block_id"])
                tenants.note_op(fields["_client"], "write",
                                meta.logical_len if meta else 0,
                                latency_s=time.monotonic() - t_start)
        elif op == "write_reduced":
            self.tokens.verify(fields.get("token"), fields["block_id"], "w")
            self._receiver.ingest_reduced(sock, fields)
        elif op == "mirror_segment":
            # coded mirror plane leg: one RS segment of the reduced
            # payload (server/mirror_plane.py); write-gated like any
            # other ingest
            self.tokens.verify(fields.get("token"), fields["block_id"], "w")
            self.mirror.serve_segment(sock, fields)
        elif op == "mirror_segment_read":
            # peer gather leg of a partial-replica assembly
            self.tokens.verify(fields.get("token"), fields["block_id"], "r")
            self.mirror.serve_segment_read(sock, fields)
        elif op == dt.READ_BLOCK:
            self.tokens.verify(fields.get("token"), fields["block_id"], "r")
            self._sender.serve_read(sock, fields)
        elif op == dt.BLOCK_CHECKSUM:
            self.tokens.verify(fields.get("token"), fields["block_id"],
                               "r")
            self._serve_checksum(sock, fields)
        elif op == "replica_info":
            self.tokens.verify(fields.get("token"), fields["block_id"], "r")
            meta = self.replicas.get_meta(fields["block_id"])
            send_frame(sock, {"length": meta.logical_len if meta else -1,
                              "gen_stamp": meta.gen_stamp if meta else -1,
                              "rbw": self.replicas.is_rbw(
                                  fields["block_id"])})
        elif op == "alias_add":
            # provided-storage mount push (the live-cluster form of
            # the reference's offline alias-map generation): persist
            # the regions, report them immediately via IBR.  Gated by
            # per-region WRITE block tokens (minted by the superuser-
            # only rpc_provide_file) — without the check, anyone with
            # DN network access could repoint provided blocks at
            # arbitrary local files
            from hdrf_tpu_torch.storage.aliasmap import FileRegion
            regions = [FileRegion.unpack(v) for v in fields["regions"]]
            tokens = fields.get("tokens") or [None] * len(regions)
            for reg, tok in zip(regions, tokens):
                self.tokens.verify(tok, reg.block_id, "w")
            try:
                for reg in regions:
                    self.aliasmap.check_uri(reg.uri)
            except IOError as e:
                _M.incr("alias_rejects")
                send_frame(sock, {"ok": False, "error": str(e)})
                return
            self.aliasmap.write(regions)
            for reg in regions:
                self.notify_block_received(reg.block_id, reg.length, 0,
                                           storage_type="PROVIDED")
            send_frame(sock, {"ok": True, "count": len(regions)})
        elif op == "reconfigure":
            send_frame(sock, self.reconfigure(fields.get("key", ""),
                                              fields.get("value")))
        elif op == "get_reconfigurable":
            send_frame(sock, {"keys": sorted(self.RECONFIGURABLE)})
        elif op == "disk_balance":
            # intra-DN volume evening (diskbalancer -plan/-execute in
            # one round trip; like the DN protocol, trusted within the
            # deployment perimeter rather than block-token gated)
            plan = self.volumes.plan_moves(
                float(fields.get("threshold", 0.10)))
            moved = self.volumes.execute_moves(plan)
            send_frame(sock, {
                "planned": len(plan), "moved": moved,
                "volumes": [{"vol": v.vol_id, "type": v.storage_type,
                             "used": v.used_bytes(),
                             "failed": v.failed}
                            for v in self.volumes.volumes]})
        elif op == "truncate_replica":
            self.tokens.verify(fields.get("token"), fields["block_id"], "w")
            ok = self.replicas.truncate_replica(
                fields["block_id"], fields["length"],
                new_gs=fields.get("new_gen_stamp"))
            send_frame(sock, {"ok": ok})
        elif op == dt.STRIPE_READ:
            # EC cold tier: hand one local stripe to a gathering peer
            # (DN-protocol trust, like disk_balance — stripe ops never
            # carry client bytes, only already-stored container stripes)
            self.ec.serve_read(sock, fields)
        elif op == dt.STRIPE_WRITE:
            self.ec.serve_write(sock, fields)
        elif op == dt.STRIPE_CODED_READ:
            # coded-exchange partial-sum repair hop (server/ec_tier.py
            # serve_coded_read; same DN-protocol trust as stripe_read)
            self.ec.serve_coded_read(sock, fields)
        else:
            _M.incr("unknown_ops")

    def _serve_checksum(self, sock: socket.socket, fields: dict) -> None:
        meta = self.replicas.get_meta(fields["block_id"])
        if meta is None:
            # PROVIDED replica: no stored chunk CRCs — compute them from
            # the external bytes (BlockChecksumHelper recomputes for
            # replicas without meta the same way)
            data = self.aliasmap.read_bytes(fields["block_id"])
            if data is not None:
                crcs = [int(c) for c in native.crc32c_chunks(
                    data, self.checksum_chunk)]
                send_frame(sock, {"status": 0,
                                  "checksum_chunk": self.checksum_chunk,
                                  "checksums": crcs,
                                  "logical_len": len(data)})
                return
            send_frame(sock, {"status": 1, "error": "KeyError",
                              "message": "no such block"})
            return
        send_frame(sock, {"status": 0, "checksum_chunk": meta.checksum_chunk,
                          "checksums": meta.checksums,
                          "logical_len": meta.logical_len})

    # ------------------------------------------------------- NN interaction

    def _register(self, nn: RpcClient | None = None) -> None:
        """Per-NN error isolation: one dead NN (e.g. the old active after a
        failover) must not block registration/reports to the live ones."""
        ok = 0
        for c in ([nn] if nn else self._nns):
            try:
                resp = c.call("register_datanode", dn_id=self.dn_id,
                              addr=list(self.addr), sc_path=self._sc.path,
                              rack=self.config.rack,
                              storage_type=self.volume_types[0],
                              storage_types=self.volume_types)
                if resp.get("block_keys"):
                    self.tokens.update_keys(resp["block_keys"])
                if "block_pool_index" in resp:
                    self._pool_of[id(c)] = int(resp["block_pool_index"])
                self._send_block_report(c)
                ok += 1
            except (OSError, ConnectionError):
                _M.incr("register_failures")
                self._log.warning("namenode registration failed",
                                  dn_id=self.dn_id, namenode=c.addr)
        if ok == 0 and nn is None:
            raise ConnectionError("no namenode reachable at registration")

    def _send_block_report(self, nn: RpcClient | None = None) -> None:
        report = [list(t) for t in self.replicas.block_report()]
        report.extend([r.block_id, 0, r.length, "PROVIDED"]
                      for r in self.aliasmap.list())
        for c in ([nn] if nn else self._nns):
            pool = self._pool_of.get(id(c))
            rows = (report if pool is None
                    else [t for t in report if t[0] >> 48 == pool])
            try:
                c.call("block_report", dn_id=self.dn_id, blocks=rows)
            except (OSError, ConnectionError, RpcError):
                if nn is not None:
                    raise  # caller handles (registration path)
                # a NameNode that restarted, or declared this DataNode
                # dead, refuses the report of an unregistered dn_id
                # (RpcError KeyError) until the next heartbeat re-registers
                # it.  In the reference that error ends the heartbeat
                # thread, and the lifeline then keeps the DataNode alive at
                # the NameNode with every command it is sent undelivered.
                _M.incr("block_report_failures")

    def _heartbeat_loop(self) -> None:
        interval = self.config.heartbeat_interval_s
        last_report = 0.0
        while not self._stop.wait(interval):
            fault_injection.point("datanode.heartbeat", dn_id=self.dn_id)
            self._cdc_tick()
            stats = self._stats()
            for nn in self._nns:
                try:
                    resp = nn.call("heartbeat", dn_id=self.dn_id, stats=stats)
                    self._last_hb_ok[id(nn)] = time.monotonic()
                    if resp.get("block_keys"):
                        self.tokens.update_keys(resp["block_keys"])
                    if resp.get("reregister"):
                        self._register(nn)
                        continue
                    # only the active commands; a standby answers with none
                    for cmd in resp.get("commands", []):
                        self._run_command(cmd)
                except (OSError, ConnectionError):
                    _M.incr("heartbeat_failures")
                except Exception:  # noqa: BLE001
                    _M.incr("command_errors")
            now = time.monotonic()
            if now - last_report > self.config.block_report_interval_s:
                try:
                    self._send_block_report()
                except (OSError, ConnectionError):
                    _M.incr("heartbeat_failures")
                last_report = now

    def _cdc_tick(self) -> None:
        """Adaptive-chunking control step (heartbeat cadence): feed the
        controller the cumulative dedup counters; apply whatever ordered
        reconfigure steps it emits through the SAME validated reconfigure
        path an operator uses.  A rejected step (bounds, transient
        min>max the ordering should have prevented) abandons the retune —
        the controller re-decides next window from fresh evidence.

        Every APPLIED retune arms the regression guard (ROADMAP item 5's
        "a bad retune rolls itself back"): the flight ring's most recent
        samples become the baseline; once enough post-retune samples
        accrue, tools/slo_report.py's guard() compares the windows and a
        direction-aware regression reverts the geometry through the same
        reconfigure path, counts ``retune_rollbacks``, and holds the
        controller for two observation windows so the loop cannot flap."""
        ctl = self._cdc_controller
        if ctl is None:
            return
        self._cdc_guard_tick(ctl)
        hit, miss = accounting.dedup_counters()
        cdc = self.reduction_ctx.config.cdc
        old_bits = cdc.mask_bits
        steps = ctl.observe(hit, miss, old_bits)
        applied = False
        for key, value in steps:
            r = self.reconfigure(key, value)
            if not r.get("ok"):
                _M.incr("cdc_retune_rejected")
                self._log.warning("cdc retune step %s=%s rejected: %s",
                                  key, value, r.get("error"))
                return
            accounting.record_retune(key, r["old"], r["new"])
            applied = True
        if applied:
            self._arm_cdc_guard(old_bits, self.reduction_ctx.config.cdc.mask_bits)

    GUARD_GAUGES = ("dedup_ratio", "storage_ratio",
                    "write_p95_ms", "read_p95_ms")
    GUARD_MIN_SAMPLES = 3

    def _arm_cdc_guard(self, old_bits: int, new_bits: int) -> None:
        samples = self.flight.snapshot()["samples"]
        self._cdc_guard = {
            "old_bits": int(old_bits), "new_bits": int(new_bits),
            "baseline": samples[-8:],
            "armed_mono": samples[-1]["mono"] if samples else 0.0}

    def _cdc_guard_tick(self, ctl) -> None:
        """Evaluate an armed retune guard once enough post-retune flight
        samples exist; regress -> revert geometry + hold the controller."""
        guard = self._cdc_guard
        if guard is None or not guard["baseline"]:
            return
        from hdrf_tpu_torch.tools import slo_report

        samples = self.flight.snapshot()["samples"]
        current = [s for s in samples if s["mono"] > guard["armed_mono"]]
        if len(current) < self.GUARD_MIN_SAMPLES:
            return
        self._cdc_guard = None
        verdict = slo_report.guard(guard["baseline"], current,
                                   gauges=self.GUARD_GAUGES)
        if not verdict["regressed"]:
            return
        for key, value in ctl.steps(guard["new_bits"], guard["old_bits"]):
            r = self.reconfigure(key, value)
            if not r.get("ok"):
                _M.incr("cdc_retune_rejected")
                return
        accounting.record_retune_rollback()
        ctl.note_rollback()
        _M.incr("cdc_guard_rollbacks")
        self._log.warning("cdc retune rolled back by regression guard",
                          dn_id=self.dn_id,
                          regressions=[r["metric"]
                                       for r in verdict["rows"]
                                       if r.get("regressed")])

    def _lifeline_loop(self) -> None:
        """DatanodeLifelineProtocol analog: a LOW-COST liveness-only
        channel that keeps a loaded/stalled DN from being declared dead.
        Fires only while the full heartbeat is overdue (the reference
        sends lifelines whenever the service actor falls behind); the
        NN's rpc_lifeline touches the liveness clock and nothing else —
        no stats processing, no command queue, so it stays cheap exactly
        when the node is struggling."""
        interval = self.config.heartbeat_interval_s
        while not self._stop.wait(interval):
            now = time.monotonic()
            for nn in self._nns:
                if now - self._last_hb_ok[id(nn)] <= 2 * interval:
                    continue   # heartbeats flowing TO THIS NN: idle
                try:
                    resp = nn.call("lifeline", dn_id=self.dn_id)
                    _M.incr("lifelines_sent")
                    if resp.get("reregister"):
                        # the NN restarted during the stall and has
                        # forgotten us: a liveness touch on an unknown
                        # dn_id keeps nothing alive
                        self._register(nn)
                except (OSError, ConnectionError):
                    _M.incr("lifeline_failures")

    def note_peer_latency(self, dn_id: str, s_per_mb: float) -> None:
        self._peer_win.note(dn_id, s_per_mb)

    def note_mirror_failure(self, dn_id: str) -> None:
        """A pipeline mirror to ``dn_id`` failed outright (vs merely slow):
        counted per peer and shipped in the next heartbeat's stats so the
        NN's outlier detector sees BROKEN mirrors within two heartbeats."""
        with self._mirror_fail_lock:
            self._mirror_fail[dn_id] = self._mirror_fail.get(dn_id, 0) + 1

    @property
    def reduction_degraded(self) -> bool:
        """True while the DN->worker edge is not fully admitted (breaker
        open or probing): writes still succeed via in-process passthrough,
        but the node is running without its co-located reduction worker."""
        return (self._worker_breaker is not None
                and self._worker_breaker.state != "closed")

    def note_volume_latency(self, vol_id: int, seconds: float) -> None:
        """Disk-probe / IO duration sample for slow-volume detection
        (DataNodeVolumeMetrics feeding SlowDiskTracker)."""
        self._vol_win.note(int(vol_id), seconds)

    def _peer_report(self) -> dict:
        """dn_id -> (median s/MB, samples) — rides heartbeats to the NN
        (SlowPeerReports analog)."""
        return {d: [s["median"], s["count"]]
                for d, s in self._peer_win.summaries().items()}

    def peer_latency_summaries(self) -> dict:
        """dn_id -> full rolling-window summary (median/mean/max/p95 s/MB)
        — the coded mirror plane's hedge-deadline input (it scales the
        p95 by mirror_hedge_p95_mult; utils/rollwin.py:58)."""
        return self._peer_win.summaries()

    def _volume_report(self) -> dict:
        """vol_id -> health + IO summary, riding heartbeats (the
        VolumeFailureSummary + SlowDiskReports payload, folded into one)."""
        probes = self._vol_win.summaries()
        out = {}
        for v in self.volumes.volumes:
            p = probes.get(v.vol_id)
            out[str(v.vol_id)] = {
                "storage_type": v.storage_type,
                "failed": v.failed,
                "used_bytes": 0 if v.failed else v.used_bytes(),
                "probe_median_s": p["median"] if p else None,
                "probe_count": p["count"] if p else 0,
            }
        return out

    def _reduction_report(self) -> dict:
        """Per-DN reduction-effectiveness aggregate: chunk-index truth
        (logical vs unique bytes, refcount histogram), container
        utilization deciles, and the process accounting counters.  Pure
        host-side table reads — no device work."""
        acc = self.index.accounting()
        live = self.index.container_live_bytes()
        sizes = {}
        if not self.config.simulated_dataset:
            try:
                sizes = self.containers.container_sizes()
            except OSError:
                pass
        return {
            "logical_bytes": acc["logical_bytes"],
            "unique_chunk_bytes": acc["unique_chunk_bytes"],
            "dedup_ratio": accounting.dedup_ratio(
                acc["logical_bytes"], acc["unique_chunk_bytes"]),
            "refcount_hist": acc["refcount_hist"],
            "container_util_hist": accounting.utilization_hist(live, sizes),
            "counters": accounting.snapshot(),
        }

    def _read_plane_report(self) -> dict:
        """Serving-path aggregate riding heartbeats to /health: decoded-
        container + decoded-chunk cache hit ratios, per-scheme read
        amplification, and the per-tenant rolling SLO summaries
        (utils/tenants.py)."""
        from hdrf_tpu_torch.server import read_plane as read_plane_mod
        from hdrf_tpu_torch.storage import container_store

        return {
            "container_cache_hit_ratio": container_store.cache_hit_ratio(),
            "chunk_cache_hit_ratio": read_plane_mod.chunk_cache_hit_ratio(),
            "chunk_cache_bytes": self.read_plane.cache.bytes_used,
            "read_amplification": accounting.read_amplification_report(),
            "tenants": tenants.summaries(),
            "qos": self.qos.report(),
        }

    @staticmethod
    def _hist_quantile_ms(reg_name: str, key: str, q: float = 0.95) -> float:
        """p-quantile (ms) of one registry histogram, 0.0 when absent."""
        reg = metrics.registry(reg_name)
        with reg._lock:
            h = reg._histograms.get(key)
            return (h.quantile(q) / 1e3) if h is not None else 0.0

    def _flight_sample(self) -> dict:
        """The flight recorder's gauge set — the ~dozen numbers whose
        over-time curve is the honest production story (ROADMAP item 3):
        storage/dedup ratios, cache hit rate, read/write p95, inflight
        ops, breaker states."""
        from hdrf_tpu_torch.server import read_plane as read_plane_mod
        from hdrf_tpu_torch.storage import container_store

        acc = self.index.accounting()
        logical = sum(m[2] for m in self.replicas.block_report())
        physical = (self.replicas.physical_bytes()
                    + self.containers.physical_bytes()
                    + self.ec.store.physical_bytes())
        brs = retry.all_breakers().values()
        states = [b.state for b in brs]
        with self._inflight_cv:
            inflight = self._inflight
        return {
            "storage_ratio": (physical / logical) if logical else 0.0,
            "dedup_ratio": accounting.dedup_ratio(
                acc["logical_bytes"], acc["unique_chunk_bytes"]),
            "container_cache_hit_ratio": container_store.cache_hit_ratio(),
            "chunk_cache_hit_ratio": read_plane_mod.chunk_cache_hit_ratio(),
            "read_p95_ms": self._hist_quantile_ms("read_profiler",
                                                  "read_wall_us"),
            "write_p95_ms": self._hist_quantile_ms("write_profiler",
                                                   "block_wall_us"),
            "inflight": inflight,
            "blocks": len(self.replicas.block_ids()),
            "stalls": self.watchdog.stall_count(),
            "breakers_open": sum(1 for s in states if s == "open"),
            "breakers_half_open": sum(1 for s in states
                                      if s == "half_open"),
            "tenant_count": tenants.tenant_count(),
            # overload plane: shed growth is the regression curve — a
            # healthy cluster sheds ~0; the retry-after p50 shows
            # whether hints track the actual recovery horizon
            "sheds_total": self.qos.sheds_total(),
            "shed_retry_after_p50_ms": self.qos.shed_retry_after_p50_ms(),
            # integrity-drift curve: garbage growth and corruption rate
            # belong in the /timeseries regressions
            "garbage_bytes": sum(self.scrubber._last_census.values()),
            "scrub_corrupt_total": self.scrubber.corrupt_total(),
        }

    def _stats(self) -> dict:
        with self._mirror_fail_lock:
            mirror_failures = dict(self._mirror_fail)
        return {
            "reduction_degraded": self.reduction_degraded,
            "mirror_failures": mirror_failures,
            "peer_transfer": self._peer_report(),
            "volumes": self._volume_report(),
            "reduction": self._reduction_report(),
            "read_plane": self._read_plane_report(),
            "stalls": self.watchdog.stall_count(),
            "blocks": len(self.replicas.block_ids()),
            "logical_bytes": sum(m[2] for m in self.replicas.block_report()),
            "physical_bytes": (self.replicas.physical_bytes()
                               + self.containers.physical_bytes()
                               + self.ec.store.physical_bytes()),
            "cached_blocks": self.cache.ids(),
            "cache_used": self.cache.used(),
            "index": self.index.stats(),
            "ec": self.ec.report(),
            "mirror": self.mirror.report(),
            "scrub": self.scrubber.report(),
            "qos": self.qos.report(),
        }

    def _run_command(self, cmd: dict) -> None:
        """One NameNode command, its failure counted on its own
        (``command_errors``) so that the rest of the heartbeat's commands
        still run.  The reference ends the reply's command loop at the
        first command that raises, and counts an ``OSError`` there (a
        ``replicate`` whose push failed) as ``heartbeat_failures``."""
        try:
            self._execute(cmd)
        except Exception as e:  # noqa: BLE001 — one command, not the loop
            _M.incr("command_errors")
            self._log.warning("namenode command failed", dn_id=self.dn_id,
                              cmd=cmd.get("cmd"),
                              block_id=cmd.get("block_id"),
                              error=f"{type(e).__name__}: {e}")

    def _execute(self, cmd: dict) -> None:
        """NN command execution (BPServiceActor.processCommand analog)."""
        if cmd["cmd"] == "invalidate":
            # provided entries purge as ONE map rewrite, not one per
            # block (each remove persists + fsyncs the whole map)
            prov = [b for b in cmd["block_ids"]
                    if self.aliasmap.read(b) is not None]
            if prov:
                self.aliasmap.remove(prov)
            for bid in cmd["block_ids"]:
                self._invalidate(bid)
        elif cmd["cmd"] == "replicate":
            self._replicate(cmd)
        elif cmd["cmd"] == "ec_reconstruct":
            self._ec_reconstruct(cmd)
        elif cmd["cmd"] == "stripe_demote":
            self.ec.demote(cmd)
        elif cmd["cmd"] == "stripe_repair":
            self.ec.repair(cmd)
        elif cmd["cmd"] == "mirror_assemble":
            # no full replica survives: assemble one from any k coded
            # segments gathered off peers (server/mirror_plane.py)
            self.mirror.assemble(cmd["block_id"])
        elif cmd["cmd"] == "recover_block":
            self._recover_block(cmd)
        elif cmd["cmd"] == "cache":
            for bid in cmd["block_ids"]:
                if self.replicas.get_meta(bid) is not None:
                    self.cache.pin(bid, self._sender.read_logical(bid))
        elif cmd["cmd"] == "uncache":
            for bid in cmd["block_ids"]:
                self.cache.unpin(bid)
        elif cmd["cmd"] == "balancer_bandwidth":
            # dfsadmin -setBalancerBandwidth rides the heartbeat (the
            # reference's BalancerBandwidthCommand)
            self.config.balancer_bandwidth = int(cmd["bytes_per_s"])
            self.balance_throttler.set_rate(cmd["bytes_per_s"])
            _M.incr("bandwidth_commands")
        elif cmd["cmd"] == "finalize_upgrade":
            from hdrf_tpu_torch.storage import version as storage_version

            if storage_version.finalize_upgrade(self.config.data_dir):
                _M.incr("upgrades_finalized")

    def _peer_call(self, addr, op: str, **fields) -> dict:
        """One-shot framed request to a peer DN's xceiver (recovery ops)."""
        s = socket.create_connection(tuple(addr), timeout=10)
        try:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s = dt.secure_socket(s, fields.get("token"),
                                 self.config.encrypt_data_transfer)
            dt.send_op(s, op, **fields)
            return recv_frame(s)
        finally:
            s.close()

    def _recover_block(self, cmd: dict) -> None:
        """Primary-DN block recovery (BlockRecoveryWorker analog): collect
        replica (gen_stamp, length) from every holder, keep the replicas of
        the HIGHEST generation, sync those to the MINIMUM length (every byte
        below it was CRC-verified on each node; bytes above it may be
        missing somewhere), restamp survivors with the recovery gen stamp
        from the NN (so the next full block report doesn't invalidate
        them), then report the synced length to the NN
        (commitBlockSynchronization)."""
        bid = cmd["block_id"]
        rec_gs = cmd["gen_stamp"]
        token = self.tokens.mint(bid, "w")
        infos: dict[str, tuple[int, int]] = {}  # dn_id -> (gs, length)
        peers = {p["dn_id"]: p for p in cmd["peers"]}
        for dn_id, peer in peers.items():
            try:
                if dn_id == self.dn_id:
                    meta = self.replicas.get_meta(bid)
                    r = {"length": meta.logical_len if meta else -1,
                         "gen_stamp": meta.gen_stamp if meta else -1}
                else:
                    r = self._peer_call(tuple(peer["addr"]), "replica_info",
                                        block_id=bid, token=token)
                if r.get("rbw"):
                    # an in-flight writer (or its teardown persist) is
                    # still running on this peer: abort the round — the
                    # NN re-dispatches shortly and the replica will have
                    # settled (initReplicaRecovery's stopWriter analog)
                    _M.incr("block_recovery_rbw_aborts")
                    return
                if r.get("length", -1) >= 0:
                    infos[dn_id] = (r.get("gen_stamp", 0), r["length"])
            except (OSError, ConnectionError, IOError):
                continue
        if infos:
            top = max(gs for gs, _ in infos.values())
            cand = {d: ln for d, (gs, ln) in infos.items() if gs == top}
            new_len = min(cand.values())
        else:
            cand, new_len = {}, 0
        synced = []
        for dn_id in cand:
            try:
                if dn_id == self.dn_id:
                    ok = self.replicas.truncate_replica(bid, new_len,
                                                        new_gs=rec_gs)
                else:
                    ok = self._peer_call(tuple(peers[dn_id]["addr"]),
                                         "truncate_replica", block_id=bid,
                                         length=new_len,
                                         new_gen_stamp=rec_gs,
                                         token=token).get("ok", False)
                if ok:
                    synced.append(dn_id)
            except (OSError, ConnectionError, IOError):
                continue
        for nn in self._nns:
            try:
                nn.call("commit_block_sync", path=cmd["path"], block_id=bid,
                        length=new_len if synced else 0, dn_ids=synced,
                        gen_stamp=rec_gs)
                _M.incr("blocks_recovered")
                return
            except (OSError, ConnectionError, RpcError):
                continue  # standby / raced recovery: another NN may accept
        _M.incr("block_recovery_failures")

    # Live reconfiguration (ReconfigurationProtocol.proto /
    # TestDataNodeReconfiguration analog): a whitelist of keys applied
    # without a restart.  Loops read config each tick, so interval
    # changes take effect at the next wakeup.
    RECONFIGURABLE = frozenset({
        "scan_interval_s", "volume_check_interval_s",
        "block_report_interval_s", "cache_capacity",
        "balancer_bandwidth", "scrub_interval_s",
        "cdc_mask_bits", "cdc_min_chunk", "cdc_max_chunk",
    })

    # Live CDC geometry: bounds mirror AdaptiveChunkController's emit
    # range plus headroom for operator-driven reconfigures; the min<=max
    # invariant is checked against the OTHER live field so a retune
    # sequence must order its steps (accounting.py steps()).
    _CDC_BOUNDS = {"cdc_mask_bits": (6, 20),
                   "cdc_min_chunk": (32, 1 << 22),
                   "cdc_max_chunk": (64, 1 << 24)}

    def _reconfigure_cdc(self, key: str, value) -> dict:
        """Apply a live CDC-geometry change to the SHARED CdcConfig (the
        write pipeline and dispatch funnel hold the same object, so new
        cuts pick it up on their next reducer resolution; committed
        fingerprints are content-addressed and stay valid —
        ARCHITECTURE.md decision 15)."""
        cdc = self.reduction_ctx.config.cdc
        field = key[len("cdc_"):]
        old = getattr(cdc, field)
        try:
            cast = int(value)
        except (TypeError, ValueError) as e:
            return {"ok": False, "error": f"bad value for {key}: {e}"}
        lo, hi = self._CDC_BOUNDS[key]
        if not lo <= cast <= hi:
            return {"ok": False,
                    "error": f"{key}={cast} outside [{lo}, {hi}]"}
        mn = cast if field == "min_chunk" else cdc.min_chunk
        mx = cast if field == "max_chunk" else cdc.max_chunk
        if mn > mx:
            return {"ok": False,
                    "error": f"{key}={cast} would leave min_chunk={mn} > "
                             f"max_chunk={mx}; reorder the steps"}
        setattr(cdc, field, cast)
        _M.incr("reconfigurations")
        return {"ok": True, "key": key, "old": old, "new": cast}

    def reconfigure(self, key: str, value) -> dict:
        if key not in self.RECONFIGURABLE:
            return {"ok": False,
                    "error": f"'{key}' is not reconfigurable "
                             f"(allowed: {sorted(self.RECONFIGURABLE)})"}
        if key.startswith("cdc_"):
            return self._reconfigure_cdc(key, value)
        old = getattr(self.config, key)
        try:
            cast = type(old)(value)
        except (TypeError, ValueError) as e:
            return {"ok": False, "error": f"bad value for {key}: {e}"}
        if key.endswith("_interval_s"):
            # the loops wait() on these each tick: 0/negative would turn
            # them into busy-spins, and a loop that was DISABLED at start
            # (interval 0) was never spawned — a new interval could not
            # take effect and must not pretend to
            if cast <= 0:
                return {"ok": False,
                        "error": f"{key} must be > 0 (disabling a loop "
                                 "requires a restart)"}
            thread_of = {"scan_interval_s": "-scanner",
                         "volume_check_interval_s": "-volcheck",
                         "scrub_interval_s": "-scrubber"}
            suffix = thread_of.get(key)
            if suffix is not None and not any(
                    t.name.endswith(suffix) and t.is_alive()
                    for t in self._threads):
                return {"ok": False,
                        "error": f"{key}: that loop was disabled at "
                                 "startup and is not running"}
        setattr(self.config, key, cast)
        if key == "cache_capacity":
            self.cache.set_capacity(int(cast))
        elif key == "balancer_bandwidth":
            self.balance_throttler.set_rate(cast)
        _M.incr("reconfigurations")
        return {"ok": True, "key": key, "old": old, "new": cast}

    def _verify_index_containers(self) -> list[int]:
        """Startup cross-check: with ``fsync_containers=False`` an OS crash
        can leave the (always-fsync'd) chunk index referencing container
        bytes that never reached disk — and since chunks are SHARED, one
        lost container silently corrupts every dedup'd block referencing
        it.  Before the first block report advertises anything, verify each
        referenced container is reachable and drop blocks touching missing
        ones (the NN re-replicates them from healthy peers; at
        replication=1 set fsync_containers=True instead — see
        ReductionConfig)."""
        referenced = set(self.index.container_live_bytes().keys())
        missing = set()
        for c in referenced:
            # max live extent, not mere existence: the typical crash
            # artifact is a truncated raw file, not a missing one
            extent = max((off + ln for off, ln
                          in self.index.live_chunks_in(c).values()),
                         default=0)
            if not self.containers.has_container(c, need_bytes=extent):
                missing.add(c)
        if not missing:
            return []
        bad: list[int] = []
        for bid in self.index.block_ids():
            e = self.index.get_block(bid)
            if e is None:
                continue
            for h in set(e.hashes):
                loc = self.index.chunk_location(h)
                if loc is not None and loc.container_id in missing:
                    bad.append(bid)
                    break
        for bid in bad:
            self._invalidate(bid)
            _M.incr("startup_lost_container_blocks")
        return bad

    def _invalidate(self, block_id: int) -> None:
        self.cache.unpin(block_id)
        self._sc.registry.revoke(block_id)  # cached client fds must drop
        if self.aliasmap.read(block_id) is not None:
            self.aliasmap.remove([block_id])  # provided mount entry
        meta = self.replicas.get_meta(block_id)
        if meta is None:
            return
        self.scheme(meta.scheme).delete(block_id, self.reduction_ctx)
        self.replicas.delete(block_id)
        _M.incr("blocks_invalidated")

    def _replicate(self, cmd: dict) -> None:
        """DNA_TRANSFER: push our replica to targets, in reduced form
        (vs the reference's reconstruct-full-bytes DataTransfer,
        DataNode.java:2533)."""
        block_id = cmd["block_id"]
        meta = self.replicas.get_meta(block_id)
        if meta is None:
            # the NameNode lists a replica this DataNode does not hold (the
            # reference returns without a trace): count it, and send a full
            # report so that the NameNode drops the location and its next
            # schedule takes another source
            _M.incr("replicate_source_missing")
            self._log.warning("replicate of a replica not held",
                              dn_id=self.dn_id, block_id=block_id)
            self._send_block_report()
            return
        stored = self.replicas.read_data(block_id) if meta.physical_len else b""
        self._receiver.push_reduced(block_id, meta.gen_stamp, meta.scheme,
                                    meta.logical_len, stored, meta.checksums,
                                    cmd["targets"],
                                    throttler=self.balance_throttler)
        _M.incr("blocks_replicated")

    def _ec_reconstruct(self, cmd: dict) -> None:
        """DNA_ERASURE_CODING_RECONSTRUCTION: fan-in k surviving shards from
        peer DNs, RS-decode the lost shard (MXU bit-matmul, ops/rs.py), store
        it locally (ErasureCodingWorker/StripedBlockReconstructor analog —
        fan-in at erasurecode/StripedBlockReader, decode, StripedBlockWriter).
        The decode runs where the EC tier runs RS (``EcTier.device``)."""

        k, m, cell = rs.parse_policy(cmd["policy"])
        shards: dict[int, np.ndarray] = {}
        for surv in cmd["survivors"]:
            if len(shards) >= k:
                break
            for loc in surv["locations"]:
                try:
                    data = dt.fetch_block(
                        tuple(loc["addr"]), surv["block_id"],
                        token=self.tokens.mint(surv["block_id"], "r"),
                        encrypt=self.config.encrypt_data_transfer)
                    # reconstruction fan-in is a background leg too
                    self.balance_throttler.throttle(len(data))
                    shards[surv["index"]] = np.frombuffer(data, dtype=np.uint8)
                    break
                except (OSError, ConnectionError, IOError):
                    continue
        if len(shards) < k:
            _M.incr("ec_reconstruct_failures")
            return
        rec = rs.rs_decode(shards, k, m, want=[cmd["index"]],
                           device=self.ec.device)[cmd["index"]]
        writer = self.replicas.create_rbw(cmd["block_id"], cmd["gen_stamp"])
        try:
            writer.write(rec.tobytes())
            crcs = [int(c) for c in native.crc32c_chunks(rec.tobytes(),
                                                         self.checksum_chunk)]
            meta = writer.finalize(rec.size, "direct", crcs,
                                   self.checksum_chunk)
        except Exception:
            writer.abort()
            raise
        self.notify_block_received(cmd["block_id"], meta.logical_len,
                                   meta.gen_stamp)
        _M.incr("ec_blocks_reconstructed")

    # ------------------------------------------------------------ inspection

    def run_directory_scan(self) -> list[str]:
        """DirectoryScanner trigger (tests + admin)."""
        return self.replicas.scan()

    # ---------------------------------------------------------- volume health

    def check_volume(self, root: str | None = None) -> bool:
        """One write+read+unlink probe of a volume root (the
        DatasetVolumeChecker disk check).  True = healthy."""
        probe = os.path.join(root or self.config.data_dir, ".probe")
        try:
            with open(probe, "wb") as f:
                f.write(b"hdrf-volume-probe")
                f.flush()
                os.fsync(f.fileno())
            with open(probe, "rb") as f:
                ok = f.read() == b"hdrf-volume-probe"
            os.unlink(probe)
            return ok
        except OSError:
            return False

    def eject_volume(self, vol_id: int) -> None:
        """Volume failure (DataNode.handleVolumeFailures): drop the volume,
        push an immediate block report so the NN learns the lost replicas
        NOW (not at the next periodic report) and re-replicates."""
        lost = self.volumes.eject(vol_id)
        self._log.warning("volume ejected", dn_id=self.dn_id, vol_id=vol_id,
                          lost_replicas=len(lost))
        if lost:
            try:
                self._send_block_report()
            except (OSError, ConnectionError):
                pass  # periodic report will carry it

    def _volume_check_loop(self) -> None:
        """Async disk health (DatasetVolumeChecker + ThrottledAsyncChecker
        analog), per volume: a volume failing 3 consecutive probes is
        EJECTED (blocks re-replicate from peers, the DN keeps serving the
        rest); the DN exits only when the last volume has failed — the
        reference's failed.volumes.tolerated behavior."""
        fails = {v.vol_id: 0 for v in self.volumes.volumes}
        while not self._stop.wait(self.config.volume_check_interval_s):
            for v in self.volumes.volumes:
                if v.failed:
                    continue
                t0 = time.perf_counter()
                ok = self.check_volume(v.root)
                if ok:
                    # probe duration feeds slow-volume detection: a disk
                    # that still answers but slowly is exactly what the
                    # 3-strikes ejection below can never see
                    self.note_volume_latency(v.vol_id,
                                             time.perf_counter() - t0)
                    fails[v.vol_id] = 0
                    _M.incr("volume_checks_ok")
                    continue
                fails[v.vol_id] += 1
                _M.incr("volume_checks_failed")
                if fails[v.vol_id] >= 3:
                    self.eject_volume(v.vol_id)
            if self.volumes.alive_count() == 0:
                _M.incr("volume_failures_fatal")
                threading.Thread(target=self.stop, daemon=True).start()
                return

    # ----------------------------------------------------------- block scanner

    def _scanner_loop(self) -> None:
        """BlockScanner/VolumeScanner analog: rolling checksum verification of
        finalized replicas at a throttled rate; corrupt replicas are reported
        to the NN (markBlockAsCorrupt path) which drops the location and lets
        the redundancy monitor re-replicate from a good copy."""
        cursor = 0
        # interval re-read each tick: scan_interval_s is live-reconfigurable
        while not self._stop.wait(self.config.scan_interval_s):
            try:
                bids = sorted(self.replicas.block_ids())
                if not bids:
                    continue
                bid = bids[cursor % len(bids)]
                cursor += 1
                bad = self.verify_block(bid)
                if bad:
                    _M.incr("scanner_corrupt_found")
                    self._log.warning("scanner found corrupt replica",
                                      dn_id=self.dn_id, block_id=bid)
                    for nn in self._nns:
                        try:
                            nn.call("bad_block", dn_id=self.dn_id,
                                    block_id=bid)
                        except (OSError, ConnectionError):
                            _M.incr("scanner_errors")
                    self._invalidate(bid)
            except (OSError, ConnectionError):
                _M.incr("scanner_errors")
            except Exception:  # noqa: BLE001
                _M.incr("scanner_errors")

    def _scrub_loop(self) -> None:
        """Integrity-scrub driver (server/scrubber.py): one full cycle per
        wakeup; interval re-read each tick (live-reconfigurable)."""
        _SCRUB = metrics.registry("scrub")
        while not self._stop.wait(self.config.scrub_interval_s):
            try:
                self.scrubber.run_cycle()
            except (OSError, ConnectionError):
                _SCRUB.incr("scrub_errors")
            except Exception:  # noqa: BLE001
                _SCRUB.incr("scrub_errors")

    def verify_block(self, block_id: int) -> bool:
        """True if the replica is corrupt (stored checksums don't match).
        Reduced replicas verify their reconstructed logical bytes — corruption
        in the chunk store surfaces here too."""
        meta = self.replicas.get_meta(block_id)
        if meta is None or not meta.checksums:
            return False
        if meta.scheme == "direct":
            data = self.replicas.read_data(block_id)
        else:
            stored = (self.replicas.read_data(block_id)
                      if meta.physical_len else b"")
            data = self.scheme(meta.scheme).reconstruct(
                block_id, stored, meta.logical_len, self.reduction_ctx)
        crcs = [int(c) for c in native.crc32c_chunks(data,
                                                     meta.checksum_chunk)]
        _M.incr("blocks_scanned")
        return crcs != list(meta.checksums)

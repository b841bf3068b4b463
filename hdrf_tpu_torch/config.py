"""Configuration (port of hdrf_tpu/config.py): ``CdcConfig``
(config.py:28-46), ``ReductionConfig`` (:50-230), ``NameNodeConfig``
(:232-338), ``DataNodeConfig`` (:343-427), ``ClientConfig`` and
``HdrfConfig`` (:429-569) with its layered loading: defaults -> TOML
file -> ``HDRF_*`` environment -> explicit overrides (``_dotted_set``,
``_coerce``, ``_parse_scalar``, ``default_config``).

Copies of the reference dataclasses with the same field names and
defaults, so ``HdrfConfig.to_dict()`` equals the reference's for the same
file, environment and overrides, and a reference
``dataclasses.asdict(CdcConfig)`` dict maps onto the port's field for
field (``ops.dispatch.from_reference_cdc``).  ``backend`` takes the
reference's names: ``auto`` and ``tpu`` select the card, ``native`` the
host C++ library, ``cpu`` the kernels' plain versions
(ops/dispatch.resolve_backend).

Every plane the reference's settings turn on runs on the port:
``status_port`` (both daemons), ``simulated_dataset``,
``scrub_interval_s`` > 0 and the reduction config's ``cdc_adaptive``.
"""

from __future__ import annotations

import dataclasses
import os
import tomllib
from dataclasses import dataclass, field
from typing import Any

ENV_PREFIX = "HDRF_"


@dataclass
class CdcConfig:
    """Content-defined chunking parameters (Gear hash, min/max cut rule)."""

    # Gear-hash boundary mask: boundary candidate when (hash & mask) == 0.
    # mask_bits=13 -> average chunk ~8 KiB.
    mask_bits: int = 13
    min_chunk: int = 2048
    max_chunk: int = 65536
    # Carried for field parity with the reference; the cut rule does not
    # read it (the reference's hot path ignores it too).
    normalized: bool = True

    @property
    def avg_chunk(self) -> int:
        return 1 << self.mask_bits


@dataclass
class ReductionConfig:
    """Reduction pipeline selection + resources.

    Replaces DataNode.java:438 ``compressor`` hardcoded switch and the per-scheme
    concurrency table at DataNode.java:499-510.
    """

    # Default scheme name for new files; overridable per-create by client policy.
    default_scheme: str = "dedup_lz4"
    # Max concurrent reduction jobs per datanode (admission control; replaces the
    # ticket queues at DataXceiver.java:313-380).
    max_concurrent_writes: int = 4
    max_concurrent_reads: int = 8
    # Streaming (direct-scheme) writes: wide like the reference's direct mode
    # (999 at DataNode.java:499-510) but still bounded.
    max_concurrent_direct: int = 64
    # Chunk container rollover size (reference: 2**25 at DataNode.java:434).
    container_size: int = 1 << 25
    # Compress containers on rollover (reference: LZ4 at DataDeduplicator.java:770-781).
    container_codec: str = "lz4"
    # Execution backend for the per-byte scans (ops/dispatch.py): "native"
    # (the host C++ library), "auto" or "tpu" (the card; no host fallback).
    backend: str = "auto"
    # fsync container data files on append.  Default OFF — HDFS parity:
    # DataNodes do not fsync block data on finalize (durability comes from
    # replication; hsync is opt-in per client), and the scanner +
    # re-replication path covers post-crash chunk loss.  The index WAL is
    # always fsync'd (metadata integrity is not replication-recoverable).
    # CAUTION: because chunks are SHARED, an OS crash that loses one
    # container corrupts every dedup'd block referencing it on this DN; the
    # DN cross-checks index-vs-containers at startup and drops affected
    # blocks so peers re-replicate them — but at replication=1 there IS no
    # peer: set fsync_containers=True for replication=1 deployments.
    fsync_containers: bool = False
    # Co-located reduction worker (host, port): when set, the DN streams
    # block bytes to this separate worker PROCESS for CDC+SHA (and LZ4
    # container seals) instead of computing in-process — the north-star
    # deployment shape (BASELINE.json; bytes land in the worker's HBM as
    # they stream).  None = in-process compute via ``backend``.
    worker_addr: list | None = None
    # Per-op worker deadline budget: base seconds + a per-MiB term scaled by
    # payload size (replaces the reference's fixed 600 s socket timeout —
    # DataNode.java:436 ``socketTimeout`` has no payload awareness).  A hung
    # worker costs at most this budget before the DN falls back to the
    # in-process codec.
    worker_deadline_s: float = 120.0
    worker_deadline_s_per_mb: float = 2.0
    # DN->worker circuit breaker: open after N consecutive WORKER failures
    # (caller-side iterator errors never count), half-open probe after
    # reset_s, re-close on probe success.  While open, writes skip the
    # connect entirely and reduce in-process (degraded passthrough).
    worker_breaker_failures: int = 3
    worker_breaker_reset_s: float = 10.0
    # DN-side worker supervision: when True the DN spawns its own
    # co-located reduction worker (spawn_local_worker) and respawns it
    # with capped backoff if it dies; worker_addr then names the LIVE
    # address and is updated on each respawn.
    worker_spawn: bool = False
    worker_respawn_base_s: float = 0.5
    worker_respawn_cap_s: float = 15.0
    # Device read path: reconstruction-heavy reads gather chunks from
    # device-resident container images (ops/reconstruct.py).  Default OFF
    # (the reference's default): it pays where repeat reads amortize the
    # image staging.
    device_recon: bool = False
    # Async multi-block write pipeline (server/write_pipeline.py).
    # pipeline_depth: how many in-flight blocks one shared device batch may
    # coalesce (the ResidentReducer submit_many group bound); 1 = today's
    # serial one-block-at-a-time path, every pipeline stage bypassed.
    pipeline_depth: int = 4
    # Bounded WAL group-commit window (ms): concurrent commit_block calls
    # arriving within the window share ONE fsync (index/chunk_index.py).
    # Only armed when pipeline_depth > 1; 0 disables grouping outright.
    group_commit_window_ms: float = 2.0
    # Admission bound on blocks simultaneously inside the pipeline
    # (admitted-but-uncommitted); backpressures client streams beyond it.
    pipeline_max_inflight: int = 8
    # Mesh-sharded reduction plane (parallel/sharded.MeshReducer): when
    # True and >1 device is attached, coalesced groups run CDC+SHA+dedup
    # probe as ONE dispatch per mesh step, blocks data-parallel over the
    # whole mesh, with the device-resident sharded fingerprint bucket
    # table answering the dedup probe on-mesh.  The single-device serial
    # path stays verbatim as the bit-identity oracle.
    mesh_plane: bool = False
    # Per-device lane capacity: a mesh step coalesces up to
    # n_devices * mesh_lanes_per_device blocks.
    mesh_lanes_per_device: int = 2
    # Bucket slots PER DEVICE in the sharded fingerprint table (u32 pairs;
    # 2^15 slots = 256 KiB/device).  Collisions only cost a host re-check
    # or a duplicate append — never correctness.
    mesh_bucket_slots: int = 1 << 15
    # Coded mirror plane (server/mirror_plane.py): number of RS parity
    # segments cut over the reduced mirror payload.  0 = today's serial
    # relay through targets[0] (byte-identical path); m > 0 splits the
    # payload into k = n_targets - m data segments + m parity segments,
    # fans the legs out concurrently, and acks once ANY k land — a dead
    # or straggling mirror costs m/k extra bytes instead of a stall.
    mirror_parity: int = 0
    # Hedge trigger: parity legs launch when fewer than k data legs have
    # landed after (rolling-window p95 per-peer leg latency) * this
    # multiplier (the peer latency windows feed the p95; no window data
    # falls back to mirror_hedge_floor_s).
    mirror_hedge_p95_mult: float = 3.0
    # Hedge-delay floor/fallback in seconds: used when the peer latency
    # windows have no samples yet, and as a lower bound so a cold window
    # never hedges at ~0 s.
    mirror_hedge_floor_s: float = 0.25
    # Read plane (server/read_plane.py): byte budget of the DN-wide
    # decoded-chunk cache, keyed by fingerprint so hits serve cross-file
    # as far as dedup reached.  0 disables the cache (plans still resolve
    # chunk-granular).
    chunk_cache_mb: float = 8.0
    # Read coalescer window (ms): concurrent readers' container-decode
    # misses arriving within the window decode through one batched
    # dispatch.  Only armed on the card's backend with read_max_inflight > 1;
    # 0 decodes inline on the reader's thread (today's serial behavior).
    read_batch_window_ms: float = 2.0
    # Admission bound on plans simultaneously inside the read plane's
    # fetch stage (the read-side sibling of pipeline_max_inflight; the
    # DN-level max_concurrent_reads gate still applies outside it).
    read_max_inflight: int = 16
    # Per-tenant QoS admission (utils/qos.py): token-bucket refill rate in
    # MB/s and burst depth in MB, per tenant, shared across the DN's write
    # and read planes.  0 rate disables bucket-based admission (the
    # deadline shed below still applies); the bucket is a DEFICIT bucket —
    # admission charges nothing, actual bytes are debited after the op.
    qos_tenant_rate_mb_s: float = 0.0
    qos_tenant_burst_mb: float = 8.0
    # Deadline-aware load shedding: an op whose ambient ``_deadline``
    # budget cannot cover (rolling-p95 service time) * this multiplier is
    # refused AT ADMISSION with a retryable ShedError + retry-after hint,
    # instead of burning a slot to time out mid-pipeline.  Only fires when
    # the client sent a deadline AND the estimator has warmed up (≥5
    # samples in the 5-minute window).  0 disables.
    shed_p95_mult: float = 3.0
    # k+δ hedged stripe reads (server/ec_tier.py _gather): number of extra
    # stripe legs launched alongside the k primaries once the rolling
    # per-holder p95 leg latency (* mirror_hedge_p95_mult, floored at
    # mirror_hedge_floor_s) elapses — decode proceeds from the first k legs
    # to land, so one straggling holder never sets read latency.
    # 0 restores the serial holder-by-holder gather.
    ec_read_hedge_delta: int = 1
    # Coded-exchange shuffle plane (server/coded_exchange.py).
    # ec_coded_repair: stripe repair gathers partial SUMS instead of full
    # stripes — each surviving holder bit-matmuls its local stripes into a
    # GF-combined contribution and the chain XOR-folds them on the way back,
    # so the repairing owner ingests ~|missing| stripes of bytes instead of
    # k (ops/rs.py repair_rows/partial_sums).  False pins the classic full
    # gather (byte-identical output either way — the partial-sum fold IS
    # the decode, redistributed).
    ec_coded_repair: bool = True
    # LZ4-compress coded-exchange intermediates (repair contributions,
    # stripe pushes on demote/repair) via the batched compress path
    # (ops/dispatch.py block_compress_batch; the device compress_many when
    # the backend resolves to the card).  Negotiated per op: smaller-of ships, raw
    # wins ties, old peers that never asked get raw — False pins raw.
    coded_exchange_compress: bool = True
    # Mirror-plane segment legs (server/mirror_plane.py) ship
    # LZ4-compressed segments under the same smaller-of negotiation
    # (seg_crc always covers the RAW bytes).  False pins the old raw
    # path for A/B.
    mirror_compress_segments: bool = True
    # Content-adaptive chunk sizing (reduction/accounting.py
    # AdaptiveChunkController): the DN heartbeat observes the dedup
    # hit/miss counters and retunes cdc_mask_bits/min/max through the
    # live-reconfig path when a window of commits shows the corpus is
    # dedup-poor (coarsen) or dedup-rich (walk back toward the target).
    # Off by default: geometry then stays exactly the static CdcConfig.
    cdc_adaptive: bool = False
    # Floor under the controller's emitted min_chunk (the smallest cut
    # spacing any retune may select; the overflow-cap regression test pins
    # the fused kernel's fallback at this floor's smallest geometry).
    cdc_min_size: int = 512
    # The mask_bits the controller steps back toward when dedup yield is
    # healthy; 13 reproduces the shipped 2048/65536 geometry exactly.
    cdc_target_mask_bits: int = 13
    cdc: CdcConfig = field(default_factory=CdcConfig)


@dataclass
class NameNodeConfig:
    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral
    # Namespace persistence (FSImage.java:85 + FSEditLog.java:124 equivalents).
    meta_dir: str = "/tmp/hdrf/name"
    # Default replication factor & block size (hdfs-default.xml equivalents).
    replication: int = 3
    block_size: int = 128 * 1024 * 1024
    # Heartbeat bookkeeping (HeartbeatManager.java:44).
    heartbeat_interval_s: float = 1.0
    dead_node_interval_s: float = 6.0
    # How long a scheduled re-replication may stay in flight before the
    # monitor re-queues it (PendingReconstructionBlocks timeout analog).
    pending_replication_timeout_s: float = 30.0
    editlog_checkpoint_every: int = 1000  # ops between auto-checkpoints
    # Federation (multiple nameservices over one DN set,
    # BPOfferService.java:57): this NN's nameservice id and block-pool
    # index.  The block pool is an ID RANGE — block ids are allocated as
    # (pool_index << 48) | seq — so pools never collide and a DataNode
    # partitions its reports per nameservice with a shift (the role
    # BPOfferService's per-pool bookkeeping plays in the reference; chunk
    # containers stay DN-wide, so dedup even spans namespaces).
    nameservice_id: str = "ns0"
    block_pool_index: int = 0
    # HA: "active" serves + writes the journal; "standby" tails it read-only
    # and answers (possibly slightly stale) reads until failover; "observer"
    # tails like a standby but serves the read-only RPC set to clients with
    # a staleness bound (ObserverReadProxyProvider analog) and is never a
    # failover candidate.
    role: str = "active"
    # Standby journal catch-up cadence (EditLogTailer interval analog).
    tail_interval_s: float = 0.5
    # Observer read plane (design decision 19).  A read carrying a client
    # state-id the observer hasn't applied yet waits at most
    # observer_wait_s for the tailer to catch up, then bounces the call
    # back to the active (typed ObserverStaleError — never silently
    # stale).  Independently, reads are refused whenever the last
    # successful tail pass is older than observer_max_lag_s (the hard
    # staleness bound, dfs.ha.tail-edits.period + observer staleness
    # check analog).  observer_msync_wait_s bounds a parameterless
    # rpc_msync barrier.
    observer_wait_s: float = 0.25
    observer_max_lag_s: float = 5.0
    observer_msync_wait_s: float = 5.0
    # Block access tokens (dfs.block.access.token.enable analog): NN mints
    # HMAC tokens, DNs verify; keys ride heartbeat responses.
    block_tokens: bool = False
    # Enforce owner/group/mode + ACLs on namespace RPCs
    # (dfs.permissions.enabled analog).  The superuser (NN process owner)
    # and in-process callers always bypass.
    permissions_enabled: bool = True
    # Require a valid delegation token on client namespace RPCs
    # (hadoop.security.authentication=token analog; DN-protocol and
    # token-acquisition methods stay open — kerberos has no analog here).
    require_token_auth: bool = False
    # Startup safemode: hold mutations until this fraction of known blocks
    # has a reported replica (dfs.namenode.safemode.threshold-pct analog).
    safemode_threshold: float = 0.999
    # Quorum journal (dfs.namenode.shared.edits.dir=qjournal://... analog):
    # when set, edits live on this list of JournalNode (host, port) addrs
    # with majority-ack durability and only the fsimage stays in meta_dir;
    # when None, meta_dir is the (possibly NFS-shared) journal directory.
    journal_addrs: list | None = None
    # Peer NameNode control addrs — a quorum-mode standby that fell behind
    # the journal's purge horizon bootstraps its fsimage from a peer
    # (the standby-checkpointer image-transfer analog).
    peers: list | None = None
    # Observability status HTTP server (/prom, /traces, /stacks — the
    # HttpServer2 servlet-set analog); None = disabled.  0 = ephemeral port.
    status_port: int | None = None
    # Watchdog budget for in-flight RPCs (utils/watchdog.py).
    stall_budget_s: float = 30.0
    # Control-plane contention observatory (utils/lockprof.py): cap on
    # concurrent RPC handler connections — past it the accept loop parks
    # and a metadata storm backs up into the TCP listen queue instead of
    # spawning threads without bound (None = unbounded, the reference's
    # thread-per-connection default) — and the instrumented namesystem
    # lock's long-hold budget (stack captured + lockprof.long_hold fired
    # for any hold past it; the write-lock-reporting-threshold analog).
    rpc_max_handlers: int | None = None
    lock_long_hold_s: float = 0.5
    # EC cold tier (storage/stripe_store.py): sealed-container striping
    # geometry (ErasureCodingPolicy RS-k-m analog, default RS(6,3)) and
    # the demotion age: a complete, fully-replicated block whose file has
    # been idle this long is demoted from ``replication``x full copies to
    # (k+m)/k x stripes.  <= 0 disables demotion (default: the cold tier
    # is opt-in, like dfs.namenode.ec.system.default.policy being unset).
    ec_data_shards: int = 6
    ec_parity_shards: int = 3
    ec_demote_after_s: float = 0.0
    # Partial-replica reconciliation (coded mirror plane): how long a
    # scheduled upgrade re-push may stay in flight before the monitor
    # re-schedules it (the pending_replication_timeout_s analog for the
    # partial_replica -> full-replica lifecycle).
    partial_reconcile_timeout_s: float = 15.0
    # Flight recorder (utils/flight_recorder.py): fixed-cadence gauge
    # snapshots into a bounded ring, served as /timeseries.  interval <= 0
    # disables the sampler thread (the ring still answers, just empty
    # until sample_once is driven).
    flight_interval_s: float = 1.0
    flight_capacity: int = 512
    # Flight archive (utils/flight_archive.py): crash-safe JSONL
    # persistence of every flight sample, so daemon restarts keep the
    # long-horizon curve.  Empty dir disables; a relative dir resolves
    # under the metadata dir.  max_mb bounds the on-disk history (oldest
    # sealed segments GC'd first).
    flight_archive_dir: str = ""
    flight_archive_max_mb: int = 64


@dataclass
class DataNodeConfig:
    host: str = "127.0.0.1"
    port: int = 0
    data_dir: str = "/tmp/hdrf/data"
    # Topology label for rack-aware placement (net.topology mapping analog).
    rack: str = "/default-rack"
    # This DN's default storage type (StorageType enum analog: DISK/SSD/
    # ARCHIVE/RAM_DISK); storage POLICIES on paths select across nodes
    # and, with multiple volumes, across a node's volumes.
    storage_type: str = "DISK"
    # Per-volume storage types (dfs.datanode.data.dir's [SSD]/path list
    # analog): each entry creates volumes/vol-i of that type under
    # data_dir.  None = one volume of ``storage_type``.
    volume_types: list | None = None
    # Packet size on the data-transfer wire (reference default 64 KB).
    packet_size: int = 64 * 1024
    # Pinned replica cache budget (dfs.datanode.max.locked.memory analog).
    cache_capacity: int = 64 * 1024 * 1024
    heartbeat_interval_s: float = 1.0
    block_report_interval_s: float = 30.0
    # Rolling replica verification cadence (BlockScanner analog); one block
    # verified per tick, 0 disables.
    scan_interval_s: float = 30.0
    # Volume health probe cadence (DatasetVolumeChecker analog); 0 disables.
    volume_check_interval_s: float = 15.0
    # RAM-backed fake dataset for protocol tests at scale
    # (SimulatedFSDataset analog).
    simulated_dataset: bool = False
    # Require + speak the encrypted data-transfer handshake
    # (dfs.encrypt.data.transfer): plaintext ops are refused, and this DN's
    # own outgoing legs (mirroring, transfers, reconstruction) encrypt.
    encrypt_data_transfer: bool = False
    # Cap on BACKGROUND transfer legs — balancer moves, NN-commanded
    # re-replication, EC reconstruction fan-in — in bytes/s
    # (dfs.datanode.balance.bandwidthPerSec analog; the reference defaults
    # to 100 MB/s).  0 disables.  Live-reconfigurable, and settable
    # cluster-wide via ``dfsadmin -setBalancerBandwidth``.
    balancer_bandwidth: int = 100 * 1024 * 1024
    # Lazy-persist (RAM_DISK) machinery: the lazy writer copies RAM
    # replicas to DISK every this many seconds (0 disables; the loop only
    # starts when a RAM_DISK volume is configured), and evicts persisted
    # RAM copies once the RAM volume exceeds the capacity budget
    # (dfs.datanode.ram.disk.low.watermark analog, expressed as a cap).
    lazy_writer_interval_s: float = 3.0
    ram_disk_capacity: int = 64 * 1024 * 1024
    # Provided-storage mount root: ``alias_add`` file:// URIs must resolve
    # inside this directory or the region is rejected (without it, anyone
    # holding a write token could alias a block to an arbitrary DN-local
    # file — /etc/passwd disclosure through the ordinary read path).
    # Empty = provided storage disabled for file:// URIs; "/" opts out of
    # confinement explicitly.
    provided_mount_root: str = ""
    # Observability status HTTP server (/prom, /traces, /stacks — the
    # HttpServer2 servlet-set analog); None = disabled.  0 = ephemeral port.
    status_port: int | None = None
    # Watchdog budget for in-flight data-transfer ops (utils/watchdog.py):
    # flags ops outliving this many seconds.
    stall_budget_s: float = 30.0
    # Flight recorder (utils/flight_recorder.py): fixed-cadence gauge
    # snapshots into a bounded ring, served as /timeseries.  interval <= 0
    # disables the sampler thread.
    flight_interval_s: float = 1.0
    flight_capacity: int = 512
    # Flight archive (utils/flight_archive.py): crash-safe JSONL
    # persistence of flight samples (restart-surviving /timeseries).
    # Empty dir disables; a relative dir resolves under data_dir.
    flight_archive_dir: str = ""
    flight_archive_max_mb: int = 64
    # Continuous integrity scrub (server/scrubber.py): background cycle
    # re-verifying sealed containers / EC stripes / replica invariants and
    # taking the garbage census.  interval <= 0 disables the loop (the
    # default: tests and operators opt in); the rate cap bounds scrub disk
    # reads (VolumeScanner's dfs.block.scanner.volume.bytes.per.second
    # analog); sample_frac is the fraction of a container's live chunks
    # digest-verified per cycle (1.0 = every chunk).
    scrub_interval_s: float = 0.0
    scrub_rate_mb_s: float = 8.0
    scrub_sample_frac: float = 0.25
    # Crashed tmp+fsync+replace writes (container seal, stripe put,
    # mirror-segment put) leave *.tmp orphans; the scrubber reclaims ones
    # older than this (young tmps may still be mid-replace).
    scrub_tmp_age_s: float = 300.0
    reduction: ReductionConfig = field(default_factory=ReductionConfig)


@dataclass
class ClientConfig:
    packet_size: int = 64 * 1024
    # Outstanding un-acked packets in the write pipeline (DataStreamer window).
    max_inflight_packets: int = 16
    read_retries: int = 3
    # Short-circuit local reads: fd passing over the DN's unix socket
    # (dfs.client.read.shortcircuit analog).
    short_circuit: bool = True
    # Encrypt block data on the wire (dfs.encrypt.data.transfer analog);
    # needs block tokens enabled — the token signature keys the handshake.
    encrypt_data_transfer: bool = False
    # Fetch a delegation token at connect and attach it to every NameNode
    # RPC (the kerberos-bootstrapped token flow, minus kerberos).
    use_delegation_tokens: bool = False
    # End-to-end deadline budget (seconds) bound around each write/read op
    # and propagated hop-by-hop as the _deadline header (utils/retry.py).
    # None = no client-imposed budget (budgets are strictly opt-in).
    op_deadline_s: float | None = None
    # Hedged replica reads (utils/retry.hedged_quorum): when a block has
    # >1 location, the second location launches as a tied request once the
    # first exceeds (rolling-window p95 block-read latency) * mult, or
    # immediately on primary failure.  False restores the serial failover
    # loop verbatim.
    hedged_reads: bool = True
    read_hedge_p95_mult: float = 3.0
    # Hedge-delay floor/fallback (s): used before the latency window has
    # samples, and as a lower bound so a cold window never hedges at ~0 s.
    read_hedge_floor_s: float = 0.05
    # Observer reads (ObserverReadProxyProvider analog): route read-only
    # NameNode RPCs to observer endpoints first, carrying last_seen_txid
    # for read-your-writes.  No-op when the endpoint list has no observer.
    observer_reads: bool = True
    # Client-side metadata cache (block locations + stats, LRU with TTL)
    # invalidated by txid generation: an entry is served only while the
    # client has observed NO newer journal txid than at insert time, so
    # any mutation this client sees (its own writes included — replies
    # piggyback the txid) invalidates at once.  ttl <= 0 disables (the
    # default: block locations are soft state, so caching is opt-in for
    # read-hot workloads that tolerate bounded staleness).
    metadata_cache_ttl_s: float = 0.0
    metadata_cache_entries: int = 256


@dataclass
class HdrfConfig:
    namenode: NameNodeConfig = field(default_factory=NameNodeConfig)
    datanode: DataNodeConfig = field(default_factory=DataNodeConfig)
    client: ClientConfig = field(default_factory=ClientConfig)

    # ---- layered loading -------------------------------------------------

    @staticmethod
    def load(path: str | None = None, env: dict[str, str] | None = None,
             overrides: dict[str, Any] | None = None) -> "HdrfConfig":
        cfg = HdrfConfig()
        if path:
            with open(path, "rb") as f:  # explicit path must exist
                cfg._apply_mapping(tomllib.load(f))
        cfg._apply_env(os.environ if env is None else env)
        if overrides:
            for k, v in overrides.items():
                cfg.set(k, v)
        return cfg

    def _apply_mapping(self, m: dict[str, Any], prefix: str = "") -> None:
        for k, v in m.items():
            key = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
            if isinstance(v, dict):
                self._apply_mapping(v, key)
            else:
                self.set(key, v)

    def _apply_env(self, env: dict[str, str]) -> None:
        # HDRF_DATANODE_REDUCTION_DEFAULT_SCHEME=zstd -> datanode.reduction.default_scheme
        for name, raw in env.items():
            if not name.startswith(ENV_PREFIX):
                continue
            key = name[len(ENV_PREFIX):].lower().replace("_", ".")
            try:
                self.set(key, _parse_scalar(raw))
            except KeyError:
                continue  # unknown env keys are ignored, like Hadoop's

    def set(self, dotted_key: str, value: Any) -> None:
        """Set a value by dotted key.

        Env-style keys can't distinguish '.' from '_' (both arrive as '.'), so
        matching greedily joins leading segments against field names:
        ``datanode.reduction.default.scheme`` resolves to
        ``datanode.reduction.default_scheme``.
        """
        _dotted_set(self, dotted_key.split("."), dotted_key, value)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _dotted_set(obj: Any, parts: list[str], full_key: str, value: Any) -> None:
    fields = {f.name for f in dataclasses.fields(obj)}
    for j in range(len(parts), 0, -1):
        cand = "_".join(parts[:j])
        if cand not in fields:
            continue
        cur = getattr(obj, cand)
        if j == len(parts):
            if dataclasses.is_dataclass(cur):
                raise KeyError(f"{full_key!r} names a section, not a value")
            setattr(obj, cand, _coerce(value, type(cur)))
            return
        if dataclasses.is_dataclass(cur):
            return _dotted_set(cur, parts[j:], full_key, value)
    raise KeyError(f"unknown config key: {full_key!r}")


def _coerce(value: Any, typ: type | None) -> Any:
    if typ is None or isinstance(value, typ):
        return value
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if typ in (int, float, str):
        return typ(value)
    return value


def _parse_scalar(raw: str) -> Any:
    for conv in (int, float):
        try:
            return conv(raw)
        except ValueError:
            pass
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    return raw


def default_config() -> HdrfConfig:
    return HdrfConfig()

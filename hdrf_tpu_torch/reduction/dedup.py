"""Content-defined-chunking deduplication pipeline (port of
hdrf_tpu/reduction/dedup.py: ``dedup_commit``, the batched committer
``CommitPipeline``, ``DedupScheme``).

On the ``cuda`` backend the write's CDC + SHA-256 run on the card through
ops/dispatch.chunk_and_fingerprint, each container roll seals through the
store's ``compress_fn`` (the DataNode wires the device LZ4 there), and
reads of at least ``DEVICE_RECON_MIN`` bytes gather chunks from
device-resident container images (ops/reconstruct.DeviceReconstructor).

The write side re-expresses DataDeduplicator.java's per-block pipeline
(ctor :108-217): CDC chunking (:264-307) -> fingerprint (:312-332 via JNI SHA)
-> duplicate check (:338-367) -> container append with compress-on-rollover
(threadedStorer :652-845) -> index commit (:372-392).  The read side
re-expresses DataConstructor.java: hash-list fetch (:222-235), metadata batch
lookup + group-by-container (quickBuildMT :360-417), container read/decompress
and scatter (threadedConstructor :430-567).

Deliberate fixes over the reference:

- **Intra-block dedup actually works.** The reference keys a
  ``HashMap<byte[],...>`` on array identity, so duplicate chunks within one
  block are never detected (DataDeduplicator.java:340-358).  Here fingerprints
  are ``bytes`` keys; first occurrence wins.
- **Atomic commit.** Chunk bytes are fsync'd into containers *before* the
  single-WAL-record index commit, so a crash can orphan container bytes
  (reclaimed by compaction) but never index a chunk without bytes.  The
  reference's pipelined Redis SETs have no such ordering.
- **Chunk-granular reads.** ``reconstruct(offset, length)`` touches only the
  containers overlapping the requested range; the reference always
  materializes the full 128 MB block (BlockSender.java:612-623).
- **Refcounts + GC** (the reference's missing "Table #3",
  DataDeduplicator.java:61-62).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future

import numpy as np

from hdrf_tpu_torch.ops import dispatch
from hdrf_tpu_torch.reduction import accounting, scheme as scheme_mod
from hdrf_tpu_torch.reduction.scheme import ReductionContext, ReductionScheme
from hdrf_tpu_torch.server import read_plane as read_plane_mod
from hdrf_tpu_torch.utils import fault_injection, metrics, profiler, tracing

_M = metrics.registry("dedup")

# Reads at least this large take the device reconstruction path when a
# DeviceReconstructor is attached (smaller reads: dispatch overhead wins).
DEVICE_RECON_MIN = 1 << 20


def _block_prep(data, cuts: np.ndarray, digests: np.ndarray):
    """Shared host prep: (memoryview, ordered hash list, first-occurrence
    byte ranges).  Vectorized: one tobytes() for all digests and the
    first-occurrence map via np.unique over a void view, in place of a
    per-chunk dict-probe loop."""
    mv = memoryview(data)
    starts = np.concatenate([[0], cuts[:-1]]).astype(np.int64)
    n = len(cuts)
    blob = np.ascontiguousarray(digests).tobytes()
    hashes = [blob[i << 5:(i + 1) << 5] for i in range(n)]
    if n:
        uniq_idx = np.sort(np.unique(digests.view("V32").reshape(-1),
                                     return_index=True)[1])
    else:
        uniq_idx = []
    first_range = {hashes[i]: (int(starts[i]), int(cuts[i] - starts[i]))
                   for i in uniq_idx}
    return mv, hashes, first_range


def _append_new(containers, data, first_range: dict, new_hashes: list,
                on_seal, sync: bool = True):
    """Container append of the new-chunk byte ranges as one native gather
    per container segment (threadedStorer's byte shuffling,
    DataDeduplicator.java:652-845, off the Python interpreter)."""
    if not new_hashes:
        return []
    rng = np.array([first_range[h] for h in new_hashes], dtype=np.uint64)
    arr = (data if isinstance(data, np.ndarray)
           else np.frombuffer(data, dtype=np.uint8))
    return containers.append_ranges(arr, rng[:, 0], rng[:, 1],
                                    on_seal=on_seal, sync=sync)


def dedup_commit(block_id: int, data: bytes, cuts: np.ndarray,
                 digests: np.ndarray, index, containers,
                 on_seal=None, probe=None) -> tuple[int, int]:
    """The host half of the write pipeline, given device/native reduction
    results: ordered hash list, first-occurrence ranges, index lookup,
    container append of unique bytes, single-record index commit
    (DataDeduplicator.java checkChunk :338-367 + storeChunksMT :511-532 +
    storeDB :372-392).  Shared by DedupScheme.reduce and the full-path
    benchmark so the timed path IS the product path.  ``probe`` (a set of
    fingerprints the mesh plane's device bucket table flagged as
    possibly-known) narrows the host index walk to probe POSITIVES: a
    stale-table false positive is resolved right here by the authoritative
    lookup, a false negative just re-appends bytes that ``commit_block``'s
    first-commit-wins rule turns into compactable orphans — never
    corruption.  Returns (chunk_count, new_unique_count, new_unique_bytes)."""
    with profiler.phase("dedup_lookup"):
        mv, hashes, first_range = _block_prep(data, cuts, digests)
        n = len(cuts)
        if index.get_block(block_id) is not None:
            # Supersede (append rewrote the block under a new gen stamp):
            # release the old entry's chunk refs before committing the new
            # one — CDC makes the rewrite dedup against its own old chunks,
            # so the released refs are mostly re-taken by the commit below.
            index.delete_block(block_id)
        if probe is None:
            known = index.lookup_chunks(list(first_range))
            new_hashes = [h for h, loc in known.items() if loc is None]
        else:
            cand = [h for h in first_range if h in probe]
            _M.incr("probe_skipped_lookups", len(first_range) - len(cand))
            known = index.lookup_chunks(cand)
            confirmed = sum(1 for loc in known.values() if loc is not None)
            _M.incr("probe_confirmed", confirmed)
            _M.incr("probe_false_positive", len(cand) - confirmed)
            new_hashes = [h for h in first_range if known.get(h) is None]
    with profiler.phase("container_io"):
        # ordering probe: tests park block K here and assert block K+1's
        # device dispatch is already enqueued (pipeline overlap contract)
        fault_injection.point("dedup.container_append", block_id=block_id)
        locs = _append_new(containers, data, first_range, new_hashes,
                           on_seal or index.seal_container)
    losers = index.commit_block(block_id, len(data), hashes,
                                dict(zip(new_hashes, locs)))
    if probe is not None and losers:
        # stale-table false negatives that raced a concurrent first commit:
        # their container bytes are orphans (reclaimed by compaction)
        _M.incr("probe_stale_appends", len(losers))
    _M.incr("chunks_total", n)
    _M.incr("chunks_new", len(new_hashes))
    new_bytes = sum(ln for _, _, ln in locs)
    _M.incr("bytes_new", new_bytes)
    accounting.record_dedup_block(n, len(new_hashes))
    return n, len(new_hashes), new_bytes


class CommitPipeline:
    """Asynchronous batched commit stage of the dedup write path.

    The reference runs container append + Redis SET in dedicated storer
    threads off the ingest thread (threadedStorer,
    DataDeduplicator.java:652-845) with NO durability barrier at all; here
    one worker thread keeps container layout deterministic while batching
    the durability cost: chunk bytes for up to ``batch`` queued blocks are
    appended unsynced, then ONE ``containers.sync_lanes()`` + ONE group
    WAL commit (``ChunkIndex.commit_blocks``) cover the whole batch, and
    only then do the blocks' futures resolve.  The index WAL record is
    always fsync'd; whether the chunk BYTES are fsync'd before it follows
    the store's ``fsync_containers`` policy (default off = HDFS block-data
    semantics: page-cache flush only, an OS crash loses the bytes and
    replication + the scanner recover the block).  A resolved future means
    "as durable as this deployment's policy makes a finalized replica",
    not an unconditional disk barrier."""

    def __init__(self, index, containers, batch: int = 4, on_seal=None):
        self._index = index
        self._containers = containers
        self._batch = batch
        self._on_seal = on_seal or index.seal_container
        # Seal compression runs on the store's seal worker, not this commit
        # thread: an unlucky 32 MiB rollover compress otherwise stalls every
        # group-committed block queued behind it.
        if hasattr(containers, "enable_async_seals"):
            containers.enable_async_seals()
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run,
                                        name="dedup-commit", daemon=True)
        self._thread.start()

    def submit(self, block_id: int, data, cuts: np.ndarray,
               digests: np.ndarray) -> Future:
        fut: Future = Future()
        self._q.put((block_id, data, cuts, digests, fut))
        profiler.counter_set("wal_queue_depth", self._q.qsize())
        return fut

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if hasattr(self._containers, "drain_seals"):
            self._containers.drain_seals()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            items = [item]
            while len(items) < self._batch:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._commit_batch(items)
                    return
                items.append(nxt)
            self._commit_batch(items)

    def _commit_batch(self, items: list) -> None:
        profiler.counter_set("wal_queue_depth", self._q.qsize())
        try:
            recs = []
            # chunks first seen earlier IN this batch: visible to later
            # blocks' dedup even though the index hasn't applied them yet
            pending_new: dict[bytes, tuple[int, int, int]] = {}
            for block_id, data, cuts, digests, _ in items:
                with profiler.phase("dedup_lookup"):
                    mv, hashes, first_range = _block_prep(data, cuts, digests)
                    if self._index.get_block(block_id) is not None:
                        self._index.delete_block(block_id)
                    probe = [h for h in first_range if h not in pending_new]
                    known = self._index.lookup_chunks(probe)
                new_hashes = [h for h in probe if known[h] is None]
                with profiler.phase("container_io"):
                    locs = _append_new(self._containers, data, first_range,
                                       new_hashes, self._on_seal, sync=False)
                new = dict(zip(new_hashes, locs))
                pending_new.update(new)
                recs.append((block_id, len(data), hashes, new))
                _M.incr("chunks_total", len(hashes))
                _M.incr("chunks_new", len(new_hashes))
                accounting.record_dedup_block(len(hashes), len(new_hashes))
            with profiler.phase("container_io"):
                self._containers.sync_lanes()  # bytes at least as durable as
                # the store's policy allows BEFORE the index references them
            self._index.commit_blocks(recs)
            for *_, fut in items:
                fut.set_result(None)
        except Exception as e:  # noqa: BLE001 — surface at the caller
            for *_, fut in items:
                if not fut.done():
                    fut.set_exception(e)


class DedupScheme(ReductionScheme):
    """CDC dedup; ``container_codec`` tells the DataNode how to build its
    ContainerStore (the rollover compression stage — reference mode 1 rolls
    containers uncompressed, mode 2 LZ4-compresses them)."""

    def __init__(self, name: str, container_codec: str):
        self.name = name
        self.container_codec = container_codec

    # --------------------------------------------------------------- write

    def reduce(self, block_id: int, data: bytes, ctx: ReductionContext) -> bytes:
        assert ctx.index is not None and ctx.containers is not None
        tr = tracing.current_context()
        with tracing.tracer("dedup").span("reduce", parent=tr) as sp:
            cuts = digests = None
            if ctx.worker is not None:
                from hdrf_tpu_torch.server.reduction_worker import WorkerError

                try:
                    cuts, digests = ctx.worker.reduce(data, ctx.config.cdc)
                except WorkerError:
                    _M.incr("worker_fallbacks")  # dead worker: compute here
            if cuts is None:
                buf = np.frombuffer(data, dtype=np.uint8)
                cuts, digests = dispatch.chunk_and_fingerprint(
                    buf, ctx.config.cdc, ctx.backend)
            n, new, new_bytes = dedup_commit(block_id, data, cuts, digests,
                                             ctx.index, ctx.containers)
            sp.annotate("chunks", n)
            sp.annotate("unique_new", new)
            _M.incr("blocks_reduced")
            _M.incr("bytes_logical", len(data))
            accounting.record_reduce(self.name, len(data), new_bytes)
        return b""  # replica data file stays empty by design

    def reduce_with(self, block_id: int, data: bytes, cuts, digests,
                    ctx: ReductionContext, probe=None) -> bytes:
        """Commit with PRECOMPUTED device results — the streaming worker
        path: the DN already forwarded the packet stream to the worker and
        holds (cuts, digests) and, from the mesh plane, the on-device
        dedup-probe verdict set."""
        assert ctx.index is not None and ctx.containers is not None
        _, _, new_bytes = dedup_commit(block_id, data, cuts, digests,
                                       ctx.index, ctx.containers,
                                       probe=probe)
        _M.incr("blocks_reduced")
        _M.incr("bytes_logical", len(data))
        accounting.record_reduce(self.name, len(data), new_bytes)
        return b""

    # ---------------------------------------------------------------- read

    def reconstruct(self, block_id: int, stored: bytes, logical_len: int,
                    ctx: ReductionContext, offset: int = 0,
                    length: int = -1, plan=None) -> bytes:
        """Chunk-granular range read.  ``plan`` is a pre-resolved
        read_plane.ChunkPlan (the serving engine resolves once per request
        and threads it through); None resolves here — same index walk,
        same result."""
        assert ctx.index is not None and ctx.containers is not None
        if plan is None:
            with profiler.phase("index_lookup"):
                plan = read_plane_mod.resolve_chunk_plan(ctx.index, block_id,
                                                         offset, length)
        if plan.out_len == 0:
            return b""
        out = bytearray(plan.out_len)
        accounting.record_read_logical(self.name, plan.out_len)
        with accounting.read_scope(self.name):
            if ctx.recon is not None and plan.out_len >= DEVICE_RECON_MIN:
                # device read path (DataConstructor's scatter as a device
                # gather): chunks gather from device-resident container
                # images; host pays one ordered copy pass
                with profiler.phase("container_decode"):
                    ctx.recon.gather(
                        plan.wanted,
                        lambda cid: ctx.containers.read_container(cid),
                        plan.spans, out)
                _M.incr("blocks_reconstructed_device")
                return bytes(out)
            if ctx.read_plane is not None:
                # shared decoded-chunk cache + coalesced container decodes
                # (the coalescer records its own container_decode spans)
                chunks = ctx.read_plane.fetch_chunks(plan)
                for chunk, (out_at, lo, n) in zip(chunks, plan.spans):
                    out[out_at:out_at + n] = chunk[lo:lo + n]
            else:
                with profiler.phase("container_decode"):
                    chunks = ctx.containers.read_chunks(plan.wanted)
                    for chunk, (out_at, lo, n) in zip(chunks, plan.spans):
                        out[out_at:out_at + n] = chunk[lo:lo + n]
        _M.incr("blocks_reconstructed")
        return bytes(out)

    def delete(self, block_id: int, ctx: ReductionContext) -> None:
        assert ctx.index is not None
        dead = ctx.index.delete_block(block_id)
        _M.incr("chunks_dead", len(dead))


scheme_mod.register(DedupScheme("dedup", container_codec="none"))
scheme_mod.register(DedupScheme("dedup_lz4", container_codec="lz4"))
scheme_mod.register(DedupScheme("dedup_zstd", container_codec="zstd"))

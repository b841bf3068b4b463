"""Chunk-granular read-serving plane: range resolution, a DN-wide decoded-
chunk cache, and coalesced container decodes (port of
hdrf_tpu/server/read_plane.py: ``resolve_chunk_plan``, ``ChunkCache``,
``ReadCoalescer``, ``ReadPlane``).

Re-expression of the reference read path one layer above the container
store.  DataConstructor.java's hash-list fetch (:222-235) and metadata
batch lookup + group-by-container (quickBuildMT, DataConstructor.java
:360-417) become an explicit :class:`ChunkPlan` — the position→chunk-range
resolver that lets a ranged read touch ONLY the containers overlapping
the requested range (the reference always materializes the full block,
BlockSender.java:612-623).  The decoded-chunk LRU is keyed by
FINGERPRINT, so hits serve cross-file exactly as far as dedup reached,
and a hit books zero decode bytes in the read-amplification ledger
(reduction/accounting.record_container_decode never fires).

The :class:`ReadCoalescer` groups concurrent readers' container-decode
misses into ONE ``ops/dispatch.block_decompress_batch`` call per window
(bounded admission, drain-up-to-depth, the lead reader's timeline bound
in the coalescer thread for the real ``container_decode`` spans and the
window mirrored to every other member), so a container wanted by N
readers decodes once.  LZ4 decode is byte-serial host work on every
backend, as in the reference.  The coalescer thread runs on the card's
backend (``cuda``, or the reference's name ``tpu``); on ``cpu`` and
``native``, or at depth 1, it decodes inline on the caller's thread —
bit-identical results, no extra hops.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

from hdrf_tpu_torch.ops import dispatch
from hdrf_tpu_torch.utils import metrics, profiler, qos

_M = metrics.registry("read_plane")


def chunk_cache_hit_ratio() -> float:
    """Decoded-chunk cache hit ratio over the process's cumulative
    ``chunk_cache_hit``/``chunk_cache_miss`` counters (0.0 before any
    probe) — the /prom + /health gauge, the chunk-granular sibling of
    storage/container_store.py:38 cache_hit_ratio."""
    hits, misses = _M.counter("chunk_cache_hit"), _M.counter("chunk_cache_miss")
    total = hits + misses
    return hits / total if total else 0.0


def _gauge_hit_ratio() -> None:
    _M.gauge("chunk_cache_hit_ratio", chunk_cache_hit_ratio())


# ------------------------------------------------------- chunk-range plans


@dataclass
class ChunkPlan:
    """A resolved read: which chunks, from which containers, land where.

    ``wanted[i]`` is the (container_id, offset, length) of the i-th needed
    chunk, ``hashes[i]`` its fingerprint (the chunk-cache key), and
    ``spans[i]`` the (out_at, src_lo, n) scatter into the output buffer —
    the same three-list shape DedupScheme.reconstruct built inline before
    this plane existed (reduction/dedup.py:289)."""

    block_id: int
    offset: int
    end: int
    logical_len: int
    wanted: list = field(default_factory=list)   # (cid, off, len) per chunk
    hashes: list = field(default_factory=list)   # fingerprint per chunk
    spans: list = field(default_factory=list)    # (out_at, src_lo, n)

    @property
    def out_len(self) -> int:
        return max(self.end - self.offset, 0)

    def containers(self) -> list:
        """Distinct containers the plan touches, in first-use order."""
        return list(dict.fromkeys(cid for cid, _, _ in self.wanted))


def resolve_chunk_plan(index, block_id: int, offset: int = 0,
                       length: int = -1) -> ChunkPlan:
    """Position→chunk-range resolution over the chunk index: walk the
    block's ordered hash list accumulating logical positions and keep only
    the chunks overlapping [offset, offset+length) (quickBuildMT's
    group-by-container lookup, DataConstructor.java:360-417, with the
    range cut the reference never does).  ``length=-1`` means to EOF;
    a zero-length / past-EOF request resolves to an empty plan.  Raises
    KeyError for an unindexed block and IOError for a chunk missing from
    the index or a length-sum mismatch (index corruption)."""
    entry = index.get_block(block_id)
    if entry is None:
        raise KeyError(f"block {block_id} not in chunk index")
    end = entry.logical_len if length < 0 else min(offset + length,
                                                   entry.logical_len)
    plan = ChunkPlan(block_id=block_id, offset=offset, end=end,
                     logical_len=entry.logical_len)
    if offset >= end:
        return plan
    locmap = index.lookup_chunks(list(set(entry.hashes)))
    pos = 0
    for h in entry.hashes:
        loc = locmap[h]
        if loc is None:
            raise IOError(f"block {block_id}: chunk {h.hex()} missing "
                          f"from index")
        c_start, c_len = pos, loc.length
        pos += c_len
        if c_start >= end or c_start + c_len <= offset:
            continue
        lo = max(offset, c_start) - c_start
        hi = min(end, c_start + c_len) - c_start
        plan.wanted.append((loc.container_id, loc.offset, loc.length))
        plan.hashes.append(h)
        plan.spans.append((max(offset, c_start) - offset, lo, hi - lo))
    if pos != entry.logical_len:
        raise IOError(f"block {block_id}: chunk lengths sum to {pos}, "
                      f"index says {entry.logical_len}")
    return plan


# ------------------------------------------------------ decoded-chunk LRU


class ChunkCache:
    """Byte-budgeted true-LRU of decoded chunks keyed by fingerprint.

    Sits ABOVE the decoded-container LRU (container_store.py:120): a hit
    here never reaches ``read_container``, so no decode bytes book in the
    read-amplification ledger and the hit serves any file that dedup'd the
    chunk.  Each entry remembers the container it was sliced from so a
    quarantine/delete invalidation (scrubber interplay) can drop exactly
    the entries whose backing bytes are gone."""

    def __init__(self, capacity_bytes: int):
        self._cap = max(int(capacity_bytes), 0)
        self._lock = threading.Lock()
        self._data: dict[bytes, bytes] = {}      # fp -> chunk (LRU order)
        self._cid_of: dict[bytes, int] = {}      # fp -> source container
        self._by_cid: dict[int, set] = {}        # cid -> {fp, ...}
        self._bytes = 0

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def get(self, fp: bytes) -> bytes | None:
        with self._lock:
            data = self._data.pop(fp, None)
            if data is None:
                _M.incr("chunk_cache_miss")
            else:
                # true LRU: re-insert on hit (same discipline as the
                # container LRU — FIFO evicts the hottest under cycles)
                self._data[fp] = data
                _M.incr("chunk_cache_hit")
        _gauge_hit_ratio()
        return data

    def put(self, fp: bytes, data: bytes, cid: int) -> None:
        if self._cap <= 0 or len(data) > self._cap:
            return  # disabled, or a chunk that would evict everything
        with self._lock:
            if fp in self._data:
                self._drop_locked(fp)
            self._data[fp] = data
            self._cid_of[fp] = cid
            self._by_cid.setdefault(cid, set()).add(fp)
            self._bytes += len(data)
            while self._bytes > self._cap:
                victim = next(iter(self._data))
                self._drop_locked(victim)
                _M.incr("chunk_cache_evict")
            _M.gauge("chunk_cache_bytes", self._bytes)

    def _drop_locked(self, fp: bytes) -> None:
        data = self._data.pop(fp, None)
        if data is None:
            return
        self._bytes -= len(data)
        cid = self._cid_of.pop(fp)
        peers = self._by_cid.get(cid)
        if peers is not None:
            peers.discard(fp)
            if not peers:
                del self._by_cid[cid]

    def invalidate_container(self, cid: int) -> int:
        """Drop every cached chunk sliced from ``cid`` — wired to the
        store's quarantine/delete retirement hook so a scrub-condemned or
        compacted-away container can never serve another chunk from this
        cache.  Returns entries dropped."""
        with self._lock:
            fps = list(self._by_cid.get(cid, ()))
            for fp in fps:
                self._drop_locked(fp)
            if fps:
                _M.incr("chunk_cache_invalidated", len(fps))
                _M.gauge("chunk_cache_bytes", self._bytes)
        return len(fps)


# ---------------------------------------------------------- read coalescer


class _Req:
    __slots__ = ("cids", "future", "timeline", "tenant")

    def __init__(self, cids: list, future: Future, timeline,
                 tenant: str | None = None) -> None:
        self.cids = cids
        self.future = future
        self.timeline = timeline
        self.tenant = tenant


class ReadCoalescer:
    """Bounded batching of container-decode misses (write_pipeline.py's
    coalescer + group-commit window, applied to reads): concurrent
    readers' misses that land within one ``read_batch_window_ms`` window
    decode through ONE grouped ``block_decompress_batch`` dispatch, each
    distinct container once.  Admission is bounded by the
    ``read_max_inflight`` semaphore (the same bounded-slots discipline as
    pipeline_max_inflight).  ``batched=False`` (depth 1 / a host backend)
    decodes inline on the caller's thread."""

    def __init__(self, containers, window_ms: float = 2.0,
                 max_inflight: int = 16, depth: int = 8,
                 backend: str = "native", batched: bool | None = None,
                 qos_ctrl=None):
        self._containers = containers
        self._window_s = max(window_ms, 0.0) / 1000.0
        self._depth = max(depth, 1)
        self._backend = backend
        self._qos = qos_ctrl
        self._sem = threading.BoundedSemaphore(max(max_inflight, 1))
        # weighted-fair dequeue across tenants (utils/qos.py FairQueue) —
        # a flooding tenant's queued decode groups cannot starve a light
        # tenant's (the coalescer window still batches across lanes)
        self._q = qos.FairQueue()
        self._thread: threading.Thread | None = None
        if batched is None:
            batched = (dispatch.resolve_backend(backend) == "cuda"
                       and window_ms > 0 and max_inflight > 1)
        if batched:
            self._thread = threading.Thread(target=self._loop,
                                            name="read-plane", daemon=True)
            self._thread.start()

    def _decomp(self, codec_names, blobs, usizes):
        return dispatch.block_decompress_batch(codec_names, blobs, usizes,
                                               self._backend)

    def fetch(self, cids: list, timeline=None,
              tenant: str | None = None) -> dict:
        """Decoded payloads for ``cids`` (cid -> bytes).  Blocks at the
        admission bound; in batched mode the call parks on the group's
        future while the worker decodes under the lead member's timeline.
        Sheds (qos.ShedError) BEFORE acquiring a permit when the ambient
        tenant is over rate or the deadline cannot cover the estimate."""
        if tenant is None:
            tenant = qos.current_tenant()
        # unattributed callers (scrub, EC reconstruction, compaction) are
        # internal housekeeping — never shed them, only client traffic
        if self._qos is not None and tenant is not None:
            self._qos.admit(tenant, "read")
        if not self._sem.acquire(timeout=300):
            raise TimeoutError("read plane admission timeout")
        try:
            if self._thread is None:
                _M.incr("inline_decodes")
                with profiler.phase("container_decode"):
                    return self._containers.read_containers(
                        cids, decompress_batch=self._decomp)
            fut: Future = Future()
            self._q.put(_Req(list(cids), fut,
                             timeline or profiler.current_timeline(),
                             tenant))
            with profiler.phase("decode_wait"):
                return fut.result(timeout=300)
        finally:
            self._sem.release()

    def close(self) -> None:
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        while True:
            req = self._q.get()
            if req is None:
                return
            group = [req]
            deadline = time.monotonic() + self._window_s
            stopping = False
            while len(group) < self._depth:
                remain = deadline - time.monotonic()
                if remain <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remain)
                except queue.Empty:
                    break
                if nxt is None:
                    stopping = True
                    break
                group.append(nxt)
            self._serve(group)
            if stopping:
                return

    def _serve(self, group: list) -> None:
        cids = list(dict.fromkeys(c for r in group for c in r.cids))
        lead = group[0].timeline
        t0 = profiler.mark()
        try:
            # the lead reader's timeline is ambient for the real decode
            # spans; the shared window is mirrored to the rest below — the
            # same attribution contract as write_pipeline's device batches
            with profiler.bind_timeline(lead), \
                    profiler.phase("container_decode"):
                datas = self._containers.read_containers(
                    cids, decompress_batch=self._decomp)
        except BaseException as e:  # noqa: BLE001 — readers unwrap
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        t1 = profiler.mark()
        _M.incr("read_batches")
        _M.observe("read_batch_containers", len(cids))
        if len(group) > 1:
            _M.incr("coalesced_reads", len(group))
        for i, r in enumerate(group):
            if r.timeline is not None and i > 0:
                r.timeline.add_span("container_decode", t0, t1, 0)
            r.future.set_result({c: datas[c] for c in r.cids})


# ------------------------------------------------------------- the facade


class ReadPlane:
    """The DN's chunk-granular serving engine: plan → cache → coalescer.

    ``fetch_chunks(plan)`` probes the decoded-chunk cache per fingerprint,
    groups the misses by container, decodes those containers through the
    coalescer (once each, batched across concurrent readers), slices the
    missed chunks out and back-fills the cache.  Per-plan decode fan-out is
    exported as ``containers_decoded_per_read`` — the acceptance gauge that
    a range read touches exactly the containers overlapping its range."""

    def __init__(self, containers, chunk_cache_mb: float = 8,
                 window_ms: float = 2.0, max_inflight: int = 16,
                 backend: str = "native", batched: bool | None = None,
                 qos_ctrl=None):
        self.cache = ChunkCache(int(chunk_cache_mb * (1 << 20)))
        self.coalescer = ReadCoalescer(containers, window_ms=window_ms,
                                       max_inflight=max_inflight,
                                       backend=backend, batched=batched,
                                       qos_ctrl=qos_ctrl)
        self._containers = containers

    def attach_store(self, containers) -> None:
        """Install the cache-invalidation hook on the store (quarantine or
        delete retires a container → its cached chunks drop)."""
        containers._on_retire = self.cache.invalidate_container

    def fetch_chunks(self, plan: ChunkPlan) -> list:
        """Decoded chunk bytes, one per ``plan.wanted`` entry."""
        out: list = [None] * len(plan.wanted)
        misses: list[int] = []
        with profiler.phase("cache_probe"):
            for i, fp in enumerate(plan.hashes):
                data = self.cache.get(fp)
                if data is not None:
                    out[i] = data
                else:
                    misses.append(i)
        decoded = 0
        if misses:
            need: dict[int, list[int]] = {}
            for i in misses:
                need.setdefault(plan.wanted[i][0], []).append(i)
            datas = self.coalescer.fetch(list(need))
            decoded = len(need)
            for cid, idxs in need.items():
                payload = datas[cid]
                for i in idxs:
                    _, off, ln = plan.wanted[i]
                    chunk = payload[off:off + ln]
                    out[i] = chunk
                    self.cache.put(plan.hashes[i], chunk, cid)
        _M.incr("plans_served")
        _M.incr("containers_fetched", decoded)
        _M.observe("containers_decoded_per_read", decoded)
        return out

    def close(self) -> None:
        self.coalescer.close()

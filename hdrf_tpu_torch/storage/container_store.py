"""Chunk-container store: append-only container files with seal-on-rollover
(port of hdrf_tpu/storage/container_store.py, the same files on disk).

Re-expression of the reference's chunk store (threadedStorer,
DataDeduplicator.java:652-845): chunks append to flat files
``<chunkDir>/<containerID>`` up to 32 MB (DataNode.java:434 ``maxSize=2^25``),
and a container is LZ4-compressed when it rolls over
(DataDeduplicator.java:770-781).  Reads group chunks by container, decompress
sealed containers, and slice chunks out (DataConstructor.threadedConstructor,
DataConstructor.java:430-567, open-container fast path :482-490).

Differences by design:

- **Lanes, not threads-with-bit-tricks.** The reference namespaces container
  ids with a 2-bit writer-thread field packed into 3 bytes
  (utilities.java:36-75).  Here container ids are a flat monotonic counter;
  concurrency comes from N independent *lanes*, each owning one open container
  and its own lock.
- **Sealed-ness is self-describing**: ``<cid>.raw`` (open) vs ``<cid>.sealed``
  (codec-framed), no external state needed to read.
- **Compaction exists** (the reference can never reclaim dead chunks).
"""

from __future__ import annotations

import contextlib
import os
import queue
import struct
import threading
from dataclasses import dataclass

from hdrf_tpu_torch.utils import codec as codecs
from hdrf_tpu_torch.utils import fault_injection, metrics

_M = metrics.registry("container_store")


def cache_hit_ratio() -> float:
    """Decoded-container LRU hit ratio over the process's cumulative
    ``cache_hit``/``cache_miss`` counters (0.0 before any probe) — the
    /prom + /health gauge ROADMAP item 1 asks for (the counters existed
    since the true-LRU landed but were never surfaced as a ratio)."""
    hits, misses = _M.counter("cache_hit"), _M.counter("cache_miss")
    total = hits + misses
    return hits / total if total else 0.0


def _gauge_hit_ratio() -> None:
    _M.gauge("cache_hit_ratio", cache_hit_ratio())

_SEAL_HDR = struct.Struct("<IQI")  # magic, usize, codec id
_SEAL_MAGIC = 0x48435452  # "RTCH"
# Open (.raw) containers carry a same-width placeholder header so sealing an
# incompressible container is a header stamp + rename, not a data rewrite.
# The distinct magic makes a mis-framed file a loud error, never a silent
# 16-byte shift of every chunk.
_RAW_MAGIC = 0x48435257  # "WRCH"


@dataclass
class _Lane:
    lock: threading.Lock
    container_id: int = -1
    size: int = 0
    fh: object | None = None
    image: bytearray | None = None  # in-memory mirror of the open container


class ContainerStore:
    """Append-only chunk containers with compress-on-seal and compaction."""

    def __init__(self, directory: str, container_size: int = 1 << 25,
                 lanes: int = 4, codec: str = "lz4", cache_containers: int = 4,
                 compress_fn=None, on_roll=None, fsync: bool = False,
                 id_base: int = 0, compress_batch_fn=None):
        """``compress_fn`` overrides the seal-time compressor while keeping
        the frame codec id (the device LZ4 stage produces format-identical
        output, so readers decode with the stock codec either way).
        ``compress_batch_fn(list[bytes]) -> list[bytes]`` is its grouped
        form: when set, ``flush_open`` seals all open lanes through ONE
        call (one device batch on the card) instead of a compressor round trip per lane.
        ``on_roll(cid, payload)`` observes each container's full
        uncompressed payload at seal time (from the open-lane memory
        mirror) — the hook an async seal pipeline hangs off, sparing a disk
        read-back."""
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self._container_size = container_size
        self._codec = codec
        self._compress_fn = compress_fn
        self._compress_batch_fn = compress_batch_fn
        self._on_roll = on_roll
        # fsync policy for container DATA (HDFS parity: block data is not
        # fsync'd on finalize — replication is the durability story; see
        # ReductionConfig.fsync_containers).  Seal-time writes of NEW files
        # still fsync regardless (rename barrier).
        self._fsync = fsync
        # observer for container deletion (compaction/GC): lets a device
        # reconstructor drop its stale device image
        self._on_delete = None
        # observer for container RETIREMENT (delete OR quarantine): the
        # read plane's decoded-chunk cache drops entries sliced from the
        # container.  Separate from _on_delete because quarantine keeps the
        # container logically present (no device-image/EC teardown) yet its bytes
        # must never serve again, cached slices included.
        self._on_retire = None
        # EC cold tier hooks (storage/stripe_store.py): when a sealed file
        # is gone because the container was demoted to stripes,
        # ``_stripe_fallback(cid)`` returns the reconstructed sealed FILE
        # bytes (header + compressed payload) or None, and
        # ``_stripe_probe(cid)`` returns the uncompressed payload size
        # recorded in the striping manifest (for has_container) or None.
        self._stripe_fallback = None
        self._stripe_probe = None
        self._alloc_lock = threading.Lock()
        # ``id_base`` namespaces this store's container ids (multi-volume
        # DNs: vol_id << CID_SHIFT — the same trick the reference uses to
        # namespace container ids by writer thread, the 2-bit threadID
        # field packed into its 3-byte ids at utilities.java:36-75), so
        # one DN-wide chunk index can route any cid to its volume.
        self._id_base = id_base
        self._next_id = max(self._scan_next_id(), id_base)
        self._lanes = [_Lane(threading.Lock()) for _ in range(lanes)]
        self._rr = 0
        # Tiny LRU of decompressed sealed containers (read amplification guard;
        # the reference re-decompresses the whole container per read).
        self._cache: dict[int, bytes] = {}
        self._cache_cap = cache_containers
        self._cache_lock = threading.Lock()
        # Async seal stage (enable_async_seals): rollover compression moves
        # off the appending thread onto one worker; None = inline seals.
        self._seal_q: queue.Queue | None = None
        self._seal_thread: threading.Thread | None = None
        self._seal_exc: BaseException | None = None

    def _scan_next_id(self) -> int:
        mx = -1
        for name in os.listdir(self._dir):
            stem = name.split(".")[0]
            if stem.isdigit():
                mx = max(mx, int(stem))
        return mx + 1

    def _raw_path(self, cid: int) -> str:
        return os.path.join(self._dir, f"{cid}.raw")

    def _sealed_path(self, cid: int) -> str:
        return os.path.join(self._dir, f"{cid}.sealed")

    # -------------------------------------------------------------- writing

    def append_chunks(self, chunks: list[bytes], on_seal=None,
                      sync: bool = True) -> list[tuple[int, int, int]]:
        """Append chunks to one lane's open container; returns
        (container_id, offset, length) per chunk.  ``on_seal(cid)`` fires after
        a rollover compresses+seals a container (index notification).
        ``sync=False`` skips the fsync — the batched commit pipeline calls
        ``sync_lanes()`` once per group instead, BEFORE the covering index
        commit (same durability ordering, amortized)."""
        if not chunks:  # fully-deduplicated block: nothing new to store
            return []
        with self._alloc_lock:
            lane = self._lanes[self._rr % len(self._lanes)]
            self._rr += 1
        out: list[tuple[int, int, int]] = []
        with lane.lock:
            pending: list[bytes] = []

            def drain():
                if pending:
                    blob = b"".join(pending)
                    if lane.fh is not None:
                        lane.fh.write(blob)
                    lane.image += blob
                    pending.clear()

            for chunk in chunks:
                if lane.image is None or (
                        lane.size + len(chunk) > self._container_size and lane.size > 0):
                    if lane.image is not None:
                        drain()  # before rollover seals the container
                        self._seal_locked(lane, on_seal)
                    self._open_locked(lane)
                off = lane.size
                pending.append(chunk)
                lane.size += len(chunk)
                out.append((lane.container_id, off, len(chunk)))
            # One write per batch, not per chunk.
            drain()
            if lane.fh is not None:
                lane.fh.flush()
                if sync and self._fsync:
                    os.fsync(lane.fh.fileno())
        _M.incr("chunks_appended", len(chunks))
        return out

    def append_ranges(self, data, starts, lens, on_seal=None,
                      sync: bool = True) -> list[tuple[int, int, int]]:
        """``append_chunks`` for chunks that are RANGES of one buffer (the
        dedup commit's shape): byte movement runs as one native
        gather_ranges per container segment instead of n memoryview
        slices + list appends + a join — the commit half's Python byte
        shuffling.  Rollover semantics identical to
        append_chunks: a chunk that doesn't fit seals the open container
        first; an oversized chunk lands alone in an empty one."""
        import numpy as np

        from hdrf_tpu_torch import native

        n = int(len(starts))
        if n == 0:
            return []
        starts = np.ascontiguousarray(starts, dtype=np.uint64)
        lens = np.ascontiguousarray(lens, dtype=np.uint64)
        with self._alloc_lock:
            lane = self._lanes[self._rr % len(self._lanes)]
            self._rr += 1
        out_cid = np.empty(n, np.int64)
        out_off = np.empty(n, np.int64)
        csum = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])
        with lane.lock:
            i = 0
            while i < n:
                if lane.image is None:
                    self._open_locked(lane)
                cap = self._container_size - lane.size
                j = int(np.searchsorted(csum, csum[i] + cap,
                                        side="right")) - 1
                if j <= i:
                    if lane.size > 0:
                        self._seal_locked(lane, on_seal)
                        self._open_locked(lane)
                        continue
                    j = i + 1
                blob = native.gather_ranges(data, starts[i:j],
                                            lens[i:j]).tobytes()
                if lane.fh is not None:
                    lane.fh.write(blob)
                out_cid[i:j] = lane.container_id
                out_off[i:j] = lane.size + (csum[i:j] - csum[i])
                lane.image += blob
                lane.size += int(csum[j] - csum[i])
                i = j
            if lane.fh is not None:
                lane.fh.flush()
                if sync and self._fsync:
                    os.fsync(lane.fh.fileno())
        _M.incr("chunks_appended", n)
        return [(int(c), int(o), int(ln))
                for c, o, ln in zip(out_cid, out_off, lens)]

    def sync_lanes(self) -> None:
        """Flush (and, under the fsync policy, fsync) every open lane — the
        group-commit durability barrier.  A no-op in memory-resident mode,
        where open containers reach disk once, at seal."""
        for lane in self._lanes:
            with lane.lock:
                if lane.fh is not None:
                    lane.fh.flush()
                    if self._fsync:
                        os.fsync(lane.fh.fileno())

    def _open_locked(self, lane: _Lane) -> None:
        with self._alloc_lock:
            cid = self._next_id
            self._next_id += 1
        lane.container_id = cid
        lane.size = 0
        lane.image = bytearray()
        # Write-through WITHOUT fsync (unless the strict policy is on):
        # process death loses nothing (the page cache survives), OS-crash
        # durability comes from replication — HDFS's own block-data story.
        # Raw files are unlinked at seal, so under steady rollover their
        # data blocks are mostly never written back at all (ext4 ordered
        # mode skips deleted data): container bytes effectively hit the
        # platter once, compressed.
        lane.fh = open(self._raw_path(cid), "wb")
        # Placeholder header: chunk data starts at _SEAL_HDR.size, so sealing
        # an incompressible (or codec "none") container is a header stamp +
        # rename instead of a full data rewrite.
        lane.fh.write(_SEAL_HDR.pack(_RAW_MAGIC, 0, 0))

    def _seal_locked(self, lane: _Lane, on_seal, comp=None) -> None:
        had_raw = lane.fh is not None
        if had_raw:
            lane.fh.close()
        # the in-memory mirror spares the seal a full read-back of the file
        payload = bytes(lane.image)
        if self._on_roll is not None:
            self._on_roll(lane.container_id, payload)
        if self._seal_q is not None:
            # Async stage: hand the payload to the seal worker and return —
            # the appending (commit) thread never pays the compressor.  Safe
            # because sealed-ness is self-describing: the raw file stays
            # readable (read_container's raw fallback) until the worker's
            # seal renames it, and the cid is retired from the lane HERE, so
            # no later append can touch it.
            self._seal_q.put((lane.container_id, payload, had_raw, on_seal,
                              comp))
            _M.incr("async_seals")
        else:
            self.seal(lane.container_id, data=payload, have_raw=had_raw,
                      comp=comp)
            if on_seal is not None:
                on_seal(lane.container_id)
        lane.fh = None
        lane.image = None

    def seal(self, cid: int, data: bytes | None = None,
             have_raw: bool | None = None, comp: bytes | None = None) -> None:
        """Compress a raw container into the sealed format (the rollover LZ4
        pass, DataDeduplicator.java:770-781).  ``data`` carries the
        container's chunk bytes when the caller already holds them (the
        open-lane mirror); otherwise they are read from the raw file.
        ``have_raw=False`` (memory-resident lane) writes the sealed file
        directly — there is no raw file to stamp or remove.  ``comp`` is
        the already-compressed payload when the caller ran the compressor
        itself (the grouped flush_open seal)."""
        raw = self._raw_path(cid)
        if have_raw is None:
            have_raw = os.path.exists(raw)
        if have_raw:
            with open(raw, "r+b") as f:
                magic = _SEAL_HDR.unpack(f.read(_SEAL_HDR.size))[0]
                if magic != _RAW_MAGIC:
                    raise IOError(f"container {cid}: bad raw magic {magic:#x}")
                if data is None:
                    data = f.read()
                fault_injection.point("container.seal")
                if comp is None:
                    comp = self._compress(data)
                if len(comp) >= len(data):
                    # Incompressible or codec "none": stamp the placeholder
                    # header in place and rename — no data copy.  The fsync
                    # (forcing the full container's writeback NOW) follows
                    # the block-data durability policy.
                    f.seek(0)
                    f.write(_SEAL_HDR.pack(_SEAL_MAGIC, len(data),
                                           codecs.CODEC_IDS["none"]))
                    f.flush()
                    if self._fsync:
                        os.fsync(f.fileno())
                    os.replace(raw, self._sealed_path(cid))
                    _M.incr("sealed")
                    return
        else:
            assert data is not None, "memory-resident seal needs the payload"
            fault_injection.point("container.seal")
            if comp is None:
                comp = self._compress(data)
        codec = self._codec if len(comp) < len(data) else "none"
        out = comp if len(comp) < len(data) else data
        tmp = self._sealed_path(cid) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_SEAL_HDR.pack(_SEAL_MAGIC, len(data),
                                   codecs.CODEC_IDS[codec]))
            f.write(out)
            f.flush()
            if self._fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self._sealed_path(cid))
        if have_raw:
            os.unlink(raw)
        _M.incr("sealed")

    def _compress(self, data: bytes) -> bytes:
        if self._codec == "none":
            return data
        if self._compress_fn is not None:
            return self._compress_fn(data)
        return codecs.compress(self._codec, data)

    def flush_open(self, on_seal=None, cids=None) -> int:
        """Seal every open lane (shutdown/test hook), or with ``cids`` only
        the lanes whose open container is one of them (a cold-tier
        demotion sealing the containers of a block idle past
        ``ec_demote_after_s``); returns the number of containers sealed.
        Either way every queued async seal is on disk on return.

        With ``compress_batch_fn`` set, every sealable lane's payload is
        compressed through ONE batched call before sealing — on the card
        one device batch instead of a round trip per lane."""
        with contextlib.ExitStack() as stack:
            sealable = []
            for lane in self._lanes:
                stack.enter_context(lane.lock)
                if cids is not None and lane.container_id not in cids:
                    continue
                if lane.image is not None and lane.size > 0:
                    sealable.append(lane)
                elif lane.image is not None:
                    if lane.fh is not None:
                        lane.fh.close()
                        os.unlink(self._raw_path(lane.container_id))
                        lane.fh = None
                    lane.image = None
            comps = None
            if (self._compress_batch_fn is not None and len(sealable) > 1
                    and self._codec != "none"):
                comps = self._compress_batch_fn(
                    [bytes(l.image) for l in sealable])
                _M.incr("batch_seals", len(sealable))
            for lane, comp in zip(sealable, comps or [None] * len(sealable)):
                self._seal_locked(lane, on_seal, comp=comp)
        self.drain_seals()
        return len(sealable)

    # --------------------------------------------------------- async sealing

    def enable_async_seals(self) -> None:
        """Move rollover compression off the appending thread onto a single
        seal worker (the write pipeline's commit stage must not stall on an
        unlucky 32 MiB compress).  Idempotent.  Durability is unchanged:
        the raw file persists (and serves reads) until the worker's sealed
        file is in place, exactly the ordering ``seal`` already guarantees
        for concurrent readers."""
        if self._seal_q is not None:
            return
        self._seal_q = queue.Queue()
        self._seal_thread = threading.Thread(
            target=self._seal_worker, name="container-seal", daemon=True)
        self._seal_thread.start()

    def _seal_worker(self) -> None:
        while True:
            item = self._seal_q.get()
            if item is None:
                self._seal_q.task_done()
                return
            cid, payload, had_raw, on_seal, comp = item
            try:
                self.seal(cid, data=payload, have_raw=had_raw, comp=comp)
                if on_seal is not None:
                    on_seal(cid)
            except BaseException as e:  # noqa: BLE001 — re-raised at drain
                self._seal_exc = e
            finally:
                self._seal_q.task_done()

    def drain_seals(self) -> None:
        """Barrier: every enqueued async seal is on disk (or its error is
        raised here).  No-op with async seals disabled."""
        if self._seal_q is None:
            return
        self._seal_q.join()
        if self._seal_exc is not None:
            exc, self._seal_exc = self._seal_exc, None
            raise exc

    def close_async_seals(self) -> None:
        """Drain, then stop the seal worker (shutdown hook)."""
        if self._seal_q is None:
            return
        self.drain_seals()
        self._seal_q.put(None)
        self._seal_thread.join()
        self._seal_q = None
        self._seal_thread = None

    # -------------------------------------------------------------- reading

    def _cache_probe(self, cid: int) -> bytes | None:
        with self._cache_lock:
            if cid in self._cache:
                _M.incr("cache_hit")
                # true LRU: re-insert on hit so eviction drops the least
                # RECENTLY used container, not the oldest insertion (FIFO
                # evicted the hottest container under cyclic read sets)
                data = self._cache.pop(cid)
                self._cache[cid] = data
                _gauge_hit_ratio()
                return data
            _M.incr("cache_miss")
        _gauge_hit_ratio()
        return None

    def _read_undecoded(self, cid: int) -> bytes | None:
        """Open-lane memory image or raw-file bytes — the no-decompress
        sources; None when the container is sealed (or gone)."""
        from hdrf_tpu_torch.reduction import accounting  # storage->reduction: leaf-only

        for lane in self._lanes:
            with lane.lock:
                if lane.container_id == cid and lane.image is not None:
                    accounting.record_container_decode(len(lane.image))
                    return bytes(lane.image)  # open lane: serve from memory
        try:
            # Still-open container: read raw bytes directly
            # (DataConstructor.java:482-490's skip-decompress path).  Open
            # without an exists() pre-check: a concurrent seal unlinks the raw
            # file only *after* the sealed file is in place, so on ENOENT the
            # sealed path below is guaranteed readable.
            with open(self._raw_path(cid), "rb") as f:
                magic, _usize, codec_id = _SEAL_HDR.unpack(
                    f.read(_SEAL_HDR.size))
                if magic == _SEAL_MAGIC and \
                        codecs.CODEC_NAMES.get(codec_id) == "none":
                    # an incompressible seal stamped this file in place
                    # and is renaming it: the bytes behind the header are
                    # the payload either way (the reference raises here)
                    pass
                elif magic != _RAW_MAGIC:
                    raise IOError(f"container {cid}: bad raw magic {magic:#x}")
                data = f.read()
                accounting.record_container_decode(len(data))
                return data
        except FileNotFoundError:
            return None

    def _sealed_parse(self, cid: int) -> tuple[str, int, bytes]:
        """(codec name, uncompressed size, compressed payload) of the
        sealed container — the decode deferred so the read coalescer can
        run a whole window's payloads through one batched dispatch."""
        try:
            with open(self._sealed_path(cid), "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            # Demoted to the EC cold tier: the sealed file was replaced by
            # k+m stripes.  The DN-installed fallback reassembles the exact
            # sealed-file bytes from any k survivors (degraded read path).
            if self._stripe_fallback is None:
                raise
            blob = self._stripe_fallback(cid)
            if blob is None:
                raise
        magic, usize, codec_id = _SEAL_HDR.unpack(blob[:_SEAL_HDR.size])
        if magic != _SEAL_MAGIC:
            raise IOError(f"container {cid}: bad magic {magic:#x}")
        return codecs.CODEC_NAMES[codec_id], usize, blob[_SEAL_HDR.size:]

    def _cache_insert(self, cid: int, data: bytes) -> None:
        with self._cache_lock:
            self._cache.pop(cid, None)  # keep the re-insert most-recent
            self._cache[cid] = data
            while len(self._cache) > self._cache_cap:
                self._cache.pop(next(iter(self._cache)))
                _M.incr("cache_evict")

    def read_container(self, cid: int) -> bytes:
        """Full uncompressed container bytes (open or sealed)."""
        data = self._cache_probe(cid)
        if data is not None:
            return data
        data = self._read_undecoded(cid)
        if data is not None:
            return data
        codec_name, usize, payload = self._sealed_parse(cid)
        data = codecs.decompress(codec_name, payload, usize)
        from hdrf_tpu_torch.reduction import accounting

        accounting.record_container_decode(len(data))
        self._cache_insert(cid, data)
        return data

    def read_containers(self, cids: list[int],
                        decompress_batch=None) -> dict[int, bytes]:
        """Grouped form of ``read_container``: every distinct cid resolved
        once, and the sealed payloads that actually need decompression run
        through ONE ``decompress_batch(codec_names, blobs, usizes)`` call
        (the read coalescer passes ops/dispatch.block_decompress_batch) —
        the read-side sibling of flush_open's compress_batch_fn grouping.
        LRU probes, open/raw fast paths and decode accounting are
        identical to the per-cid path."""
        out: dict[int, bytes] = {}
        pending: list[tuple[int, str, int, bytes]] = []
        for cid in dict.fromkeys(cids):
            data = self._cache_probe(cid)
            if data is None:
                data = self._read_undecoded(cid)
            if data is not None:
                out[cid] = data
                continue
            codec_name, usize, payload = self._sealed_parse(cid)
            pending.append((cid, codec_name, usize, payload))
        if pending:
            if decompress_batch is not None:
                datas = decompress_batch([p[1] for p in pending],
                                         [p[3] for p in pending],
                                         [p[2] for p in pending])
            else:
                datas = [codecs.decompress(c, b, u)
                         for _, c, u, b in pending]
            from hdrf_tpu_torch.reduction import accounting

            for (cid, _c, _u, _b), data in zip(pending, datas):
                accounting.record_container_decode(len(data))
                self._cache_insert(cid, data)
                out[cid] = data
        return out

    def read_chunks(self, locs: list[tuple[int, int, int]]) -> list[bytes]:
        """Fetch many chunks, grouping by container so each container is read
        and decompressed once (quickBuildMT's grouping,
        DataConstructor.java:375-395)."""
        by_cid: dict[int, list[int]] = {}
        for i, (cid, _, _) in enumerate(locs):
            by_cid.setdefault(cid, []).append(i)
        out: list[bytes | None] = [None] * len(locs)
        for cid, idxs in by_cid.items():
            data = self.read_container(cid)
            for i in idxs:
                _, off, ln = locs[i]
                out[i] = data[off:off + ln]
        return out  # type: ignore[return-value]

    # ----------------------------------------------------------- compaction

    def copy_live(self, cid: int, live: dict[bytes, tuple[int, int]],
                  on_seal=None) -> dict[bytes, tuple[int, int, int]]:
        """Copy a container's *live* chunks into the current open lane.
        ``live`` maps fingerprint -> (offset, len) within ``cid``.  Returns
        fingerprint -> new (cid, off, len).

        Compaction protocol (crash-safe ordering): ``copy_live`` (bytes
        durable in new container) -> ``ChunkIndex.record_moves`` (index commit)
        -> ``delete_container(cid)``.  A crash before the index commit leaves
        only orphan copies; the old container is deleted strictly after the
        index stops referencing it."""
        data = self.read_container(cid)
        hashes = list(live.keys())
        chunks = [data[off:off + ln] for off, ln in (live[h] for h in hashes)]
        new_locs = self.append_chunks(chunks, on_seal=on_seal)
        return dict(zip(hashes, new_locs))

    def sealed_file_bytes(self, cid: int) -> bytes | None:
        """Raw sealed FILE bytes (header + compressed payload) — the EC
        cold tier's striping unit (stripe_store.py encodes exactly these
        bytes, so reassembly needs no re-compression).  None when the
        container is open or already striped."""
        try:
            with open(self._sealed_path(cid), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def drop_sealed_file(self, cid: int) -> int:
        """Unlink just the sealed file (EC demotion: the stripes + manifest
        now carry the bytes).  Unlike delete_container this keeps the LRU
        entry (the decompressed payload is still valid) and does NOT fire
        ``_on_delete`` — the container remains logically present.  Returns
        bytes freed."""
        path = self._sealed_path(cid)
        try:
            size = os.path.getsize(path)
            os.unlink(path)
            return size
        except OSError:
            return 0

    def quarantine(self, cid: int) -> int:
        """Rename the container's files aside (``.quar`` suffix) so it can
        never be served again — a scrub-confirmed corrupt container must
        not satisfy another read, across restarts included
        (markBlockAsCorrupt's never-serve guarantee applied to the shared
        container).  A rename, not an unlink: the corrupt bytes stay on
        disk for forensics and are censused as
        ``garbage_bytes|class=quarantined`` until GC reclaims them.  Does
        NOT fire ``_on_delete`` (the container remains logically present;
        re-replication restores its blocks elsewhere).  Returns bytes
        quarantined."""
        moved = 0
        for p in (self._raw_path(cid), self._sealed_path(cid)):
            try:
                size = os.path.getsize(p)
                os.rename(p, p + ".quar")
                moved += size
            except OSError:
                continue
        with self._cache_lock:
            self._cache.pop(cid, None)
        if self._on_retire is not None:
            self._on_retire(cid)
        return moved

    def delete_container(self, cid: int) -> None:
        for p in (self._raw_path(cid), self._sealed_path(cid)):
            if os.path.exists(p):
                os.unlink(p)
        with self._cache_lock:
            self._cache.pop(cid, None)
        if self._on_retire is not None:
            self._on_retire(cid)
        if self._on_delete is not None:
            self._on_delete(cid)

    def has_container(self, cid: int, need_bytes: int = 0) -> bool:
        """True if the container's bytes are reachable AND cover at least
        ``need_bytes`` of payload.  The extent check matters: the typical
        fsync_containers=False crash artifact is a TRUNCATED raw file (the
        un-fsync'd tail lost to writeback), not a missing one.  Sources:
        an open lane's memory image, the raw file (size minus header), or
        the sealed file (uncompressed size from its fsync'd header)."""
        for lane in self._lanes:
            with lane.lock:
                if lane.container_id == cid and lane.image is not None:
                    return len(lane.image) >= need_bytes
        try:
            sz = os.path.getsize(self._raw_path(cid))
            return sz - _SEAL_HDR.size >= need_bytes
        except OSError:
            pass
        try:
            with open(self._sealed_path(cid), "rb") as f:
                hdr = f.read(_SEAL_HDR.size)
                if len(hdr) < _SEAL_HDR.size:
                    return False
                magic, usize, _codec = _SEAL_HDR.unpack(hdr)
                return magic == _SEAL_MAGIC and usize >= need_bytes
        except OSError:
            pass
        if self._stripe_probe is not None:
            usize = self._stripe_probe(cid)
            if usize is not None:  # striped: manifest records payload size
                return usize >= need_bytes
        return False

    def container_ids(self) -> list[int]:
        ids = set()
        for name in os.listdir(self._dir):
            stem = name.split(".")[0]
            if stem.isdigit() and (name.endswith(".raw") or name.endswith(".sealed")):
                ids.add(int(stem))
        return sorted(ids)

    def _size_or_zero(self, name: str) -> int:
        """Size of a container file, 0 when it vanished after the listing
        (an async seal removes the ``.raw`` once its ``.sealed`` is in
        place; the reference's stat here races it and raises, failing
        the write that asked for a volume's free space)."""
        try:
            return os.path.getsize(os.path.join(self._dir, name))
        except FileNotFoundError:
            return 0

    def physical_bytes(self) -> int:
        total = 0
        for name in os.listdir(self._dir):
            if name.endswith(".raw") or name.endswith(".sealed"):
                total += self._size_or_zero(name)
        return total

    def container_sizes(self) -> dict[int, int]:
        """cid -> bytes on disk (raw + sealed forms summed) — the
        denominator of the utilization accounting
        (reduction/accounting.py:utilization_hist).  stat() calls only;
        never opens the files."""
        out: dict[int, int] = {}
        for name in os.listdir(self._dir):
            stem = name.split(".")[0]
            if stem.isdigit() and (name.endswith(".raw")
                                   or name.endswith(".sealed")):
                cid = int(stem)
                out[cid] = out.get(cid, 0) + self._size_or_zero(name)
        return out

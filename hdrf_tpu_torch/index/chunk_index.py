"""Durable chunk/fingerprint index — the owned replacement for Redis (port
of hdrf_tpu/index/chunk_index.py: WAL, snapshot, group commit, refcounts).

The WAL and snapshot bytes are the reference's: records are packed and
read back by the port's own msgpack codec (proto/rpc.packb /
``unpackb(raw=True)``, byte-compatible with ``msgpack``; the port does not
need the ``msgpack`` package), so an index directory written by either
package reopens in the other.

The reference keeps all reduction metadata in an external Redis at
localhost:6379 with no auth, no durability guarantees, and no recovery path
(SURVEY.md §5: "Redis or chunk-store loss = silent data loss"):

- Table 1: 4-byte HDFS block ID -> [4-byte filesize | N x hash]
  (DataDeduplicator.java:372-392, read back DataConstructor.java:91-100)
- Table 2: hash -> 11-byte packed chunkMeta {nCopy, containerID, start, stop}
  (chunkMeta.java:35-77, written DataDeduplicator.java:803)
- per-block writer-thread container cursors (utilities.java:66-75)

Here the same two tables are an in-process store with an append-only WAL,
periodic checkpoints, and crash recovery = checkpoint + WAL replay.  Chunks are
refcounted and deletable — the reference's "Table #3 for later"
(DataDeduplicator.java:61-62) — so containers can be compacted.

Durability discipline:

- WAL record framing: [u32 payload_len][u32 crc32c(payload)][msgpack payload];
  a torn final record (crash mid-append) is detected by CRC and dropped.
- **Log before apply**: a failed WAL append leaves memory untouched, so later
  records can never reference state the log doesn't contain.
- **Sequence numbers make replay idempotent**: every record carries a
  monotonically increasing seqno and the checkpoint stores the last seqno it
  folded in; recovery skips WAL records <= that seqno, so a crash between
  checkpoint publish and WAL truncation cannot double-apply refcounts.
- **Bounded group-commit window** (the FSEditLog.java:1648 ``logSync``
  batching discipline): when armed (``group_window_s`` > 0), concurrent
  ``commit_block`` callers elect a leader that waits up to the window (or
  until ``group_max`` entries queue) and flushes the whole batch through
  one WAL append + ONE fsync.  Each caller still returns only after its
  record is durable AND applied — log-before-apply holds per block, and a
  crash mid-window loses only blocks whose callers were never acked.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass

from hdrf_tpu_torch.proto import rpc
from hdrf_tpu_torch.utils import fault_injection, metrics, profiler, wal as walmod

_M = metrics.registry("chunk_index")

WAL_NAME = "index.wal"
CKPT_NAME = "index.ckpt"
CKPT_TMP = "index.ckpt.tmp"


def _norm_manifest(m: dict) -> dict:
    """Normalize a striping manifest read back through ``unpackb(raw=True)``:
    dict keys and string values arrive as bytes — decode them so live-path
    and recovered manifests compare equal (the replay idempotence bar the
    WAL discipline sets)."""
    out = {}
    for key, v in m.items():
        key = key.decode() if isinstance(key, bytes) else key
        if isinstance(v, bytes):
            v = v.decode()
        elif isinstance(v, (list, tuple)):
            v = [[x.decode() if isinstance(x, bytes) else x for x in e]
                 if isinstance(e, (list, tuple))
                 else (e.decode() if isinstance(e, bytes) else e)
                 for e in v]
        out[key] = v
    return out


@dataclass
class ChunkLocation:
    """Where a chunk's bytes live.  Fixed-width equivalent of the reference's
    11-byte chunkMeta record (chunkMeta.java:35-60): container id, byte range
    within the *uncompressed* container, and the refcount (nCopy)."""

    container_id: int
    offset: int
    length: int
    refcount: int = 1


@dataclass
class BlockEntry:
    """Table-1 row: logical length + ordered chunk fingerprints."""

    logical_len: int
    hashes: list[bytes]


class _GCEntry:
    """One caller's block parked in the group-commit window."""

    __slots__ = ("block", "done", "losers", "exc")

    def __init__(self, block: tuple) -> None:
        self.block = block
        self.done = False
        self.losers: list[bytes] = []
        self.exc: BaseException | None = None


class ChunkIndex:
    """Thread-safe durable index with WAL + checkpoint recovery."""

    def __init__(self, directory: str, checkpoint_every: int = 10000,
                 group_window_s: float = 0.0, group_max: int = 8):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._blocks: dict[int, BlockEntry] = {}
        self._chunks: dict[bytes, ChunkLocation] = {}
        self._sealed: set[int] = set()  # container ids sealed (compressed)
        self._stripes: dict[int, dict] = {}  # cid -> EC striping manifest
        self._seq = 0  # last seqno applied
        self._pending_recs: list[list] = []  # advisory recs awaiting a flush
        self._ops_since_ckpt = 0
        self._checkpoint_every = checkpoint_every
        # group-commit window: 0 = every commit_block fsyncs on its own
        # (the serial pipeline_depth=1 behavior)
        self._group_window_s = group_window_s
        self._group_max = max(group_max, 1)
        self._gc_cv = threading.Condition()
        self._gc_entries: list[_GCEntry] = []
        self._gc_leader = False
        # commit listeners fire inside _apply's b"blk" branch with the
        # record's first-seen fingerprints (the sharded bucket table's
        # incremental refresh feed) — registered before _recover() so
        # replay-applied records also notify.
        self._listeners: list = []
        # dedup-race loser bytes per container: both writers appended the
        # chunk, one commit won, the loser's container bytes are orphans.
        # In-memory advisory accounting (not WAL'd — a restart folds prior
        # orphans into the generic dead-bytes delta); the scrubber's
        # garbage census splits `garbage_bytes|class=orphan_append` out of
        # the payload-minus-live delta with it.
        self._orphans: dict[int, int] = {}
        self._recover()
        self._wal = open(os.path.join(directory, WAL_NAME), "ab")

    # ------------------------------------------------------------- recovery

    def _recover(self) -> None:
        ckpt = os.path.join(self._dir, CKPT_NAME)
        if os.path.exists(ckpt):
            with open(ckpt, "rb") as f:
                snap = rpc.unpackb(f.read(), raw=True)
            self._blocks = {
                bid: BlockEntry(e[0], list(e[1])) for bid, e in snap[b"blocks"].items()
            }
            self._chunks = {
                h: ChunkLocation(*loc) for h, loc in snap[b"chunks"].items()
            }
            self._sealed = set(snap[b"sealed"])
            self._stripes = {cid: _norm_manifest(m)
                             for cid, m in snap.get(b"stripes", {}).items()}
            self._seq = snap.get(b"seq", 0)
        # recover() truncates any torn tail so the append handle continues at
        # the good prefix (otherwise post-crash records land behind garbage).
        for payload in walmod.recover(os.path.join(self._dir, WAL_NAME)):
            seq, *rec = rpc.unpackb(payload, raw=True)
            if seq > self._seq:  # skip records the checkpoint already folded in
                self._apply(rec)
                self._seq = seq

    def _apply(self, rec: list) -> None:
        op = rec[0]
        if op == b"blk":  # [op, block_id, logical_len, [hashes], {hash: [cid,off,len]}]
            _, bid, llen, hashes, new_chunks = rec
            for h, loc in new_chunks.items():
                self._chunks[h] = ChunkLocation(loc[0], loc[1], loc[2], 0)
            for h in hashes:
                self._chunks[h].refcount += 1
            self._blocks[bid] = BlockEntry(llen, list(hashes))
            if self._listeners and new_chunks:
                fps = list(new_chunks)
                for fn in self._listeners:
                    try:
                        fn(fps)
                    except Exception:  # noqa: BLE001 — advisory feed; a bad
                        pass  # listener must never fail the durable commit
        elif op == b"del":  # [op, block_id]
            entry = self._blocks.pop(rec[1], None)
            if entry:
                for h in entry.hashes:
                    loc = self._chunks.get(h)
                    if loc:
                        loc.refcount -= 1
                        if loc.refcount <= 0:
                            del self._chunks[h]
        elif op == b"seal":  # [op, container_id]
            self._sealed.add(rec[1])
        elif op == b"moved":  # [op, {hash: [cid, off, len]}] — compaction result
            for h, loc in rec[1].items():
                c = self._chunks.get(h)
                if c is not None:
                    c.container_id, c.offset, c.length = loc[0], loc[1], loc[2]
        elif op == b"unseal":  # [op, container_id] — container deleted by GC
            self._sealed.discard(rec[1])
        elif op == b"stripe":  # [op, container_id, manifest] — EC demotion
            self._stripes[rec[1]] = _norm_manifest(rec[2])
        elif op == b"unstripe":  # [op, container_id] — promoted back / deleted
            self._stripes.pop(rec[1], None)

    # ------------------------------------------------------------------ WAL

    def _commit(self, rec: list) -> None:
        self._commit_many([rec])

    def _commit_many(self, recs: list[list]) -> None:
        """Log all, fsync ONCE, then apply, then maybe checkpoint (group
        commit — the FSEditLog.logSync batching idea applied to the chunk
        index).  Caller holds the lock.  A failed append raises *before*
        any in-memory mutation.  Buffered advisory records (seal markers)
        ride along, already applied."""
        if self._pending_recs:
            pending, self._pending_recs = self._pending_recs, []
            for rec in pending:
                payload = rpc.packb([self._seq + 1, *rec])
                self._wal.write(walmod.frame(payload))
                self._seq += 1
            # note: pending records were applied at buffer time; only the
            # WAL bytes were deferred
        with profiler.phase("wal_commit"):
            buf = bytearray()
            for i, rec in enumerate(recs):
                buf += walmod.frame(rpc.packb([self._seq + 1 + i, *rec]))
            fault_injection.point("index.wal_append")
            self._wal.write(bytes(buf))
            self._wal.flush()
            os.fsync(self._wal.fileno())
            for rec in recs:
                self._seq += 1
                self._apply(rec)
        self._ops_since_ckpt += len(recs)
        if self._ops_since_ckpt >= self._checkpoint_every:
            self._checkpoint_locked()

    # ------------------------------------------------------------- mutation

    def add_commit_listener(self, fn) -> None:
        """Register ``fn(fingerprints: list[bytes])`` to run on every block
        commit with that record's FIRST-SEEN chunk fingerprints (after the
        record is durable + applied).  Advisory: exceptions are swallowed,
        delivery is at-least-once across recovery replay.  Feeds the mesh
        plane's device-resident bucket table (parallel/sharded.py)."""
        with self._lock:
            self._listeners.append(fn)

    def lookup_chunks(self, hashes: list[bytes]) -> dict[bytes, ChunkLocation | None]:
        """Batch fingerprint probe — the reference's per-thread Redis MULTI GET
        (DataDeduplicator.java:588-610).  Returns copies: callers may hold the
        results across a concurrent compaction commit."""
        with self._lock:
            return {h: dataclasses.replace(loc) if (loc := self._chunks.get(h))
                    else None for h in hashes}

    def commit_blocks(self, blocks: list[tuple]) -> list[bytes]:
        """Group commit of several reduced blocks: one WAL write + ONE
        fsync covers every record (the latency/throughput lever the
        per-block fsync lacks).  ``blocks`` is a list of
        (block_id, logical_len, hashes, new_chunks) tuples with the same
        semantics as commit_block; returns the union of race-loser
        fingerprints."""
        losers: list[bytes] = []
        with profiler.phase("wal_commit"), self._lock:
            recs = []
            seen_new: set[bytes] = set()
            for block_id, logical_len, hashes, new_chunks in blocks:
                fresh = {}
                for h, loc in new_chunks.items():
                    if h in self._chunks or h in seen_new:
                        losers.append(h)
                        self._note_orphan_locked(loc)
                    else:
                        fresh[h] = loc
                        seen_new.add(h)
                for h in hashes:
                    if h not in self._chunks and h not in fresh \
                            and h not in seen_new:
                        raise ValueError(
                            f"hash {h.hex()} neither known nor new")
                recs.append([b"blk", block_id, logical_len, hashes,
                             {h: [c, o, ln]
                              for h, (c, o, ln) in fresh.items()}])
            self._commit_many(recs)
            _M.incr("group_commit_batches")
            _M.observe("group_commit_blocks", len(recs))
            return losers

    def commit_block(self, block_id: int, logical_len: int, hashes: list[bytes],
                     new_chunks: dict[bytes, tuple[int, int, int]]) -> list[bytes]:
        """Atomically commit a reduced block: register first-seen chunks at
        their container locations, bump refcounts for every reference, and
        write the Table-1 row.  One WAL record; replaces the reference's
        unordered Redis SET pipeline (DataDeduplicator.java:372-392,803).

        Two writers may race dedup'ing the same never-seen chunk: both will
        have appended its bytes and both declare it in ``new_chunks``.  The
        first commit wins; later commits keep the existing location and the
        loser's container bytes become orphans (reclaimed by compaction).
        Returns the fingerprints that lost such races.

        With the group-commit window armed, concurrent callers park in the
        window and share one fsync (leader/follower election); validation
        failures stay PER CALLER — one bad block raises to its own writer
        and the rest of the window commits."""
        if self._group_window_s > 0:
            return self._commit_block_grouped(
                (block_id, logical_len, hashes, new_chunks))
        with profiler.phase("wal_commit"), self._lock:
            losers = [h for h in new_chunks if h in self._chunks]
            for h in losers:
                self._note_orphan_locked(new_chunks[h])
            fresh = {h: loc for h, loc in new_chunks.items() if h not in self._chunks}
            for h in hashes:
                if h not in self._chunks and h not in fresh:
                    raise ValueError(f"hash {h.hex()} neither known nor new")
            self._commit([b"blk", block_id, logical_len, hashes,
                          {h: [c, o, ln] for h, (c, o, ln) in fresh.items()}])
            return losers

    # --------------------------------------------------- group-commit window

    def _commit_block_grouped(self, block: tuple) -> list[bytes]:
        """Park ``block`` in the group-commit window; return once its record
        is fsync'd + applied (or raise its per-caller validation error).
        First arrival with no leader becomes the leader, waits out the
        window (early-out at ``group_max``), and commits the whole batch
        with one fsync; followers just wait on their entry."""
        entry = _GCEntry(block)
        with profiler.phase("wal_commit"):
            with self._gc_cv:
                self._gc_entries.append(entry)
                profiler.counter_set("wal_queue_depth",
                                     len(self._gc_entries))
                self._gc_cv.notify_all()  # window-waiting leader may early-out
                while not entry.done:
                    if not self._gc_leader:
                        self._gc_leader = True
                        self._lead_group_locked()
                    else:
                        self._gc_cv.wait()
        if entry.exc is not None:
            raise entry.exc
        return entry.losers

    def _lead_group_locked(self) -> None:
        """Leader body.  Called with ``_gc_cv`` held and ``_gc_leader`` set;
        returns with both restored and every batch entry done-flagged."""
        deadline = time.monotonic() + self._group_window_s
        while len(self._gc_entries) < self._group_max:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            self._gc_cv.wait(timeout=remaining)
        batch, self._gc_entries = self._gc_entries, []
        profiler.counter_set("wal_queue_depth", 0)
        # drop the cv while fsyncing so late arrivals queue the NEXT window
        self._gc_cv.release()
        try:
            self._commit_group(batch)
        finally:
            self._gc_cv.acquire()
            self._gc_leader = False
            for e in batch:
                e.done = True
            self._gc_cv.notify_all()

    def _commit_group(self, batch: list[_GCEntry]) -> None:
        """Validate each entry (per-caller isolation: a bad block gets its
        exception set and is EXCLUDED), then push the valid records through
        one ``_commit_many`` — one WAL append, one fsync, apply after.  A
        failed append leaves memory untouched and raises to every valid
        caller (log-before-apply, now per window)."""
        with self._lock:
            recs: list[list] = []
            committing: list[_GCEntry] = []
            seen_new: set[bytes] = set()
            for e in batch:
                block_id, logical_len, hashes, new_chunks = e.block
                fresh = {}
                losers = []
                try:
                    for h, loc in new_chunks.items():
                        if h in self._chunks or h in seen_new:
                            losers.append(h)
                            self._note_orphan_locked(loc)
                        else:
                            fresh[h] = loc
                    for h in hashes:
                        if h not in self._chunks and h not in fresh \
                                and h not in seen_new:
                            raise ValueError(
                                f"hash {h.hex()} neither known nor new")
                except ValueError as exc:
                    e.exc = exc
                    continue
                seen_new.update(fresh)
                e.losers = losers
                recs.append([b"blk", block_id, logical_len, hashes,
                             {h: [c, o, ln]
                              for h, (c, o, ln) in fresh.items()}])
                committing.append(e)
            if not recs:
                return
            try:
                self._commit_many(recs)
            except BaseException as exc:  # each caller re-raises its own
                for e in committing:
                    e.exc = exc
                return
            _M.incr("group_commit_batches")
            _M.observe("group_commit_blocks", len(recs))

    def delete_block(self, block_id: int) -> list[bytes]:
        """Drop a block's Table-1 row and decref its chunks.  Returns the
        fingerprints whose refcount reached zero (now dead; eligible for
        container compaction)."""
        with self._lock:
            entry = self._blocks.get(block_id)
            if entry is None:
                return []
            dead: list[bytes] = []
            counts: dict[bytes, int] = {}
            for h in entry.hashes:
                counts[h] = counts.get(h, 0) + 1
            for h, n in counts.items():
                loc = self._chunks.get(h)
                if loc and loc.refcount - n <= 0:
                    dead.append(h)
            self._commit([b"del", block_id])
            return dead

    def seal_container(self, container_id: int) -> None:
        """Record that a container rolled over and was compressed
        (DataDeduplicator.java:770-781's LZ4-on-rollover).  The record is
        BUFFERED and rides the next group commit's fsync: sealed-ness is
        self-describing on disk (.sealed vs .raw), so the index copy is
        advisory (compaction planning) and needs no immediate barrier,
        where an inline fsync here would sit inside a hot container
        rollover."""
        with self._lock:
            self._pending_recs.append([b"seal", container_id])
            self._apply([b"seal", container_id])

    def record_stripe(self, container_id: int, manifest: dict) -> None:
        """Durably record an EC striping manifest for a sealed container
        (the cold-tier demotion commit point: after this fsync the sealed
        file may be deleted — the manifest + any k stripes reproduce it).
        One WAL record, immediate fsync: unlike seal markers this is NOT
        advisory — losing it orphans remote stripes."""
        with self._lock:
            self._commit([b"stripe", container_id, dict(manifest)])

    def drop_stripe(self, container_id: int) -> None:
        """Forget a container's striping manifest (container deleted, or
        re-replicated back to the hot tier)."""
        with self._lock:
            if container_id in self._stripes:
                self._commit([b"unstripe", container_id])

    def stripe_manifest(self, container_id: int) -> dict | None:
        with self._lock:
            m = self._stripes.get(container_id)
            return dict(m) if m is not None else None

    def stripe_manifests(self) -> dict[int, dict]:
        with self._lock:
            return {cid: dict(m) for cid, m in self._stripes.items()}

    def record_moves(self, moves: dict[bytes, tuple[int, int, int]],
                     dropped_container: int | None = None) -> None:
        """Commit a compaction: chunks relocated to new container positions.
        MUST be called after the new bytes are durably appended and *before*
        the old container file is deleted (see ContainerStore.copy_live)."""
        with self._lock:
            self._commit([b"moved",
                          {h: [c, o, ln] for h, (c, o, ln) in moves.items()}])
            if dropped_container is not None:
                self._commit([b"unseal", dropped_container])

    # --------------------------------------------------------------- lookup

    def get_block(self, block_id: int) -> BlockEntry | None:
        with self._lock:
            e = self._blocks.get(block_id)
            return BlockEntry(e.logical_len, list(e.hashes)) if e else None

    def has_block(self, block_id: int) -> bool:
        with self._lock:
            return block_id in self._blocks

    def block_ids(self) -> list[int]:
        with self._lock:
            return sorted(self._blocks)

    def chunk_location(self, h: bytes) -> ChunkLocation | None:
        with self._lock:
            loc = self._chunks.get(h)
            return dataclasses.replace(loc) if loc else None

    def is_sealed(self, container_id: int) -> bool:
        with self._lock:
            return container_id in self._sealed

    def container_live_bytes(self) -> dict[int, int]:
        """Live (referenced) bytes per container — compaction planning input."""
        with self._lock:
            out: dict[int, int] = {}
            for loc in self._chunks.values():
                out[loc.container_id] = out.get(loc.container_id, 0) + loc.length
            return out

    def live_chunks_in(self, container_id: int) -> dict[bytes, tuple[int, int]]:
        """fingerprint -> (offset, length) for live chunks of one container."""
        with self._lock:
            return {h: (c.offset, c.length) for h, c in self._chunks.items()
                    if c.container_id == container_id}

    def _note_orphan_locked(self, loc) -> None:
        """Attribute one dedup-race loser's appended bytes to its container
        (caller holds ``_lock``); ``loc`` is the loser's declared
        (container_id, offset, length)."""
        cid, _off, ln = loc
        self._orphans[cid] = self._orphans.get(cid, 0) + int(ln)

    def orphan_bytes(self) -> dict[int, int]:
        """container_id -> cumulative dedup-race loser bytes appended since
        startup (advisory, in-memory: restarts fold prior orphans back
        into the generic dead-bytes delta).  The scrubber census subtracts
        this class out of payload-minus-live garbage."""
        with self._lock:
            return dict(self._orphans)

    def stats(self) -> dict:
        with self._lock:
            return {
                "blocks": len(self._blocks),
                "chunks": len(self._chunks),
                "sealed_containers": len(self._sealed),
                "striped_containers": len(self._stripes),
                "logical_bytes": sum(b.logical_len for b in self._blocks.values()),
                "unique_chunk_bytes": sum(c.length for c in self._chunks.values()),
            }

    def accounting(self) -> dict:
        """Reduction-effectiveness snapshot over the live tables
        (reduction/accounting.py's state half): the refcount distribution
        as a power-of-2 histogram {bucket_upper_bound: chunks} — the
        sharing profile the reference's missing "Table #3"
        (DataDeduplicator.java:61-62) would have exposed — plus the exact
        aggregate the cluster dedup ratio is defined by."""
        with self._lock:
            ref_hist: dict[int, int] = {}
            for c in self._chunks.values():
                b = 1 << max(c.refcount - 1, 0).bit_length()
                ref_hist[b] = ref_hist.get(b, 0) + 1
            return {
                "refcount_hist": ref_hist,
                "logical_bytes": sum(b.logical_len
                                     for b in self._blocks.values()),
                "unique_chunk_bytes": sum(c.length
                                          for c in self._chunks.values()),
            }

    # ----------------------------------------------------------- checkpoint

    def checkpoint(self) -> None:
        with self._lock:
            self._checkpoint_locked()

    def _checkpoint_locked(self) -> None:
        snap = {
            "blocks": {bid: [e.logical_len, e.hashes] for bid, e in self._blocks.items()},
            "chunks": {h: [c.container_id, c.offset, c.length, c.refcount]
                       for h, c in self._chunks.items()},
            "sealed": sorted(self._sealed),
            "stripes": {cid: m for cid, m in self._stripes.items()},
            "seq": self._seq,
        }
        tmp = os.path.join(self._dir, CKPT_TMP)
        with open(tmp, "wb") as f:
            f.write(rpc.packb(snap))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self._dir, CKPT_NAME))
        # WAL records <= seq are folded into the checkpoint.  If we crash
        # before the truncate, replay skips them by seqno (idempotent).
        fault_injection.point("index.post_checkpoint")
        wal = getattr(self, "_wal", None)
        if wal is not None:
            wal.truncate(0)
            wal.seek(0)
        else:  # during recovery (no WAL handle yet)
            open(os.path.join(self._dir, WAL_NAME), "wb").close()
        self._ops_since_ckpt = 0

    def close(self) -> None:
        with self._lock:
            if self._pending_recs:
                self._commit_many([])  # flush buffered advisory records
            self._wal.close()

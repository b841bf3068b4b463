"""Replica store: block lifecycle with first-class logical/physical lengths
(port of hdrf_tpu/storage/replica_store.py, whole).

Equivalent of the reference's ``FsDatasetImpl.java`` (replica files, RBW ->
finalized lifecycle, `FsDatasetImpl.finalizeBlock`) — but designed so reduced
blocks need **no shadow-length patches**.  The reference leaves the replica
file at 0 bytes when a block is reduced and patches ~12 length/consistency
checks across HDFS to tolerate it (SURVEY.md §2.3: the getLength Redis
probe FsDatasetImpl.java:735-761, `DirectoryScanner` check disabled :437-438,
`Replica.setNumBytes` spoofing, ...).

Here every replica carries a sidecar ``BlockMeta`` record from creation:

- ``logical_len``  — bytes the client wrote (what reads/reports expose)
- ``physical_len`` — bytes on local disk for THIS replica's data file
  (0 for dedup'd blocks whose bytes live in chunk containers)
- ``scheme``       — which ReductionScheme produced the stored form

``length()`` returns the logical length by construction; the scanner verifies
the *physical* file against ``physical_len`` — so the reference's
"0-byte-file-means-corrupt" false positive cannot occur.

Layout under the volume root::

    rbw/blk_<id>           in-flight replica data (may stay empty for dedup)
    finalized/blk_<id>       finalized data file (direct & compress schemes)
    finalized/blk_<id>.meta  msgpack BlockMeta + packet CRCs (meta file analog)

The meta file is packed with the port's own msgpack codec
(proto/rpc.packb), byte-identical to the reference's ``msgpack.packb``, so
either package reopens the other's replica directory.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

from hdrf_tpu_torch.proto.rpc import packb, unpackb
from hdrf_tpu_torch.utils import fault_injection, metrics

_M = metrics.registry("replica_store")

RBW = "rbw"
FINALIZED = "finalized"


@dataclass
class BlockMeta:
    block_id: int
    gen_stamp: int
    logical_len: int
    physical_len: int
    scheme: str  # reduction scheme name ("direct", "lz4", "dedup_lz4", ...)
    # crc32c per checksum_chunk bytes of the *logical* data
    # (BlockReceiver writes checksums even in reduction mode, :924-986).
    checksum_chunk: int = 64 * 1024
    checksums: list[int] = field(default_factory=list)

    def pack(self) -> bytes:
        return packb([self.block_id, self.gen_stamp, self.logical_len,
                              self.physical_len, self.scheme, self.checksum_chunk,
                              self.checksums])

    @staticmethod
    def unpack(data: bytes) -> "BlockMeta":
        b, g, ll, pl, s, cc, cs = unpackb(data)
        return BlockMeta(b, g, ll, pl, s, cc, list(cs))


class ReplicaWriter:
    """An in-flight (RBW) replica.  Data may be streamed for direct/compress
    schemes; dedup'd blocks finalize with an empty data file by design."""

    def __init__(self, store: "ReplicaStore", block_id: int, gen_stamp: int):
        self._store = store
        self.block_id = block_id
        self.gen_stamp = gen_stamp
        self._path = store._path(RBW, block_id)
        self._fh = open(self._path, "wb")
        self._written = 0

    def write(self, data: bytes) -> None:
        self._fh.write(data)
        self._written += len(data)

    @property
    def bytes_written(self) -> int:
        return self._written

    def flush_visible(self, checksums: list[int],
                      checksum_chunk: int = 64 * 1024,
                      sync: bool = False) -> None:
        """hflush/hsync support (DFSOutputStream.java:573/:580): expose the
        bytes written so far to concurrent readers — the reference's RBW
        visible length (ReplicaInPipeline.setBytesAcked).  ``sync`` also
        fsyncs data + sidecar so the prefix survives a DataNode crash
        (the replica is then promoted to finalized on restart)."""
        self._fh.flush()
        if sync:
            os.fsync(self._fh.fileno())
        meta = BlockMeta(self.block_id, self.gen_stamp, self._written,
                         self._written, "direct", checksum_chunk,
                         list(checksums))
        mp = self._path + ".meta"
        with open(mp + ".tmp", "wb") as f:
            f.write(meta.pack())
            if sync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(mp + ".tmp", mp)
        self._store._set_visible(meta)
        _M.incr("hsyncs" if sync else "hflushes")

    def finalize(self, logical_len: int, scheme: str,
                 checksums: list[int] | None = None,
                 checksum_chunk: int = 64 * 1024) -> BlockMeta:
        """Move RBW -> finalized with authoritative metadata
        (FsDatasetImpl.finalizeBlock analog, invoked from
        BlockReceiver.java:1816)."""
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        fault_injection.point("replica.finalize", block_id=self.block_id)
        meta = BlockMeta(self.block_id, self.gen_stamp, logical_len,
                         self._written, scheme, checksum_chunk, checksums or [])
        dst = self._store._path(FINALIZED, self.block_id)
        os.replace(self._path, dst)
        if os.path.exists(self._path + ".meta"):
            os.unlink(self._path + ".meta")  # rbw-visible sidecar superseded
        # write-replace, never open("wb") the existing meta: on a supersede
        # rewrite (append/recovery finalize) the old meta may be hardlinked
        # into an upgrade snapshot (storage/version.py), and truncating the
        # shared inode would corrupt the rollback image
        with open(dst + ".meta.tmp", "wb") as f:
            f.write(meta.pack())
            f.flush()
            os.fsync(f.fileno())
        os.replace(dst + ".meta.tmp", dst + ".meta")
        self._store._register(meta)
        _M.incr("finalized")
        return meta

    def abort(self) -> None:
        self._fh.close()
        for p in (self._path, self._path + ".meta"):
            if os.path.exists(p):
                os.unlink(p)
        self._store._release_rbw(self.block_id)

    def detach(self) -> None:
        """Close WITHOUT deleting — the crash-simulation teardown: a dead
        process leaves its rbw file and hflush sidecar on disk exactly as
        they were, which is what restart promotion recovers from."""
        self._fh.close()
        self._store._release_rbw(self.block_id)


class ReplicaStore:
    def __init__(self, directory: str):
        self._dir = directory
        for sub in (RBW, FINALIZED):
            os.makedirs(os.path.join(directory, sub), exist_ok=True)
        self._lock = threading.Lock()
        self._replicas: dict[int, BlockMeta] = {}
        self._rbw: set[int] = set()  # block ids with an open writer
        # hflush'd in-flight replicas: block_id -> meta with the VISIBLE
        # length (bytes a concurrent reader may see; ReplicaInPipeline
        # .getVisibleLength analog)
        self._visible: dict[int, BlockMeta] = {}
        self._recover()

    def _path(self, state: str, block_id: int) -> str:
        return os.path.join(self._dir, state, f"blk_{block_id}")

    def _recover(self) -> None:
        """Load finalized replicas from disk; RBW files with an hflush
        sidecar are PROMOTED to finalized at their last synced visible
        length (the reference recovers RBW as RWR with its on-disk bytes,
        FsDatasetImpl.recoverRbw); orphaned RBW files without one are
        dropped (crash mid-write — pipeline recovery re-writes the block)."""
        fdir = os.path.join(self._dir, FINALIZED)
        for name in os.listdir(fdir):
            if name.endswith(".meta"):
                with open(os.path.join(fdir, name), "rb") as f:
                    meta = BlockMeta.unpack(f.read())
                self._replicas[meta.block_id] = meta
        rdir = os.path.join(self._dir, RBW)
        for name in os.listdir(rdir):
            p = os.path.join(rdir, name)
            if name.endswith(".meta") or name.endswith(".tmp"):
                continue
            mp = p + ".meta"
            if not os.path.exists(mp):
                os.unlink(p)
                continue
            try:
                with open(mp, "rb") as f:
                    meta = BlockMeta.unpack(f.read())
            except Exception:  # noqa: BLE001 — torn sidecar (power loss
                # between rename and data reaching disk): drop the pair
                # rather than crash-loop the DataNode on startup
                os.unlink(p)
                os.unlink(mp)
                _M.incr("rbw_sidecar_torn")
                continue
            if meta.block_id in self._replicas:   # superseded already
                os.unlink(p)
                os.unlink(mp)
                continue
            # cut unsynced bytes beyond the last visible length, then
            # finalize in place
            size = os.path.getsize(p)
            if size > meta.physical_len:
                with open(p, "r+b") as f:
                    f.truncate(meta.physical_len)
            elif size < meta.physical_len:
                # crash lost the tail of a non-synced flush: keep the bytes
                # that ARE there, re-deriving the final chunk's checksum
                meta.logical_len = meta.physical_len = size
                nchunks = -(-size // meta.checksum_chunk) if size else 0
                del meta.checksums[nchunks:]
                if meta.checksums:
                    from hdrf_tpu_torch import native
                    with open(p, "rb") as f:
                        f.seek((nchunks - 1) * meta.checksum_chunk)
                        meta.checksums[-1] = native.crc32c(f.read())
                with open(mp, "wb") as f:
                    f.write(meta.pack())
            dst = self._path(FINALIZED, meta.block_id)
            os.replace(p, dst)
            os.replace(mp, dst + ".meta")
            self._replicas[meta.block_id] = meta
            _M.incr("rbw_promoted")
        for name in os.listdir(rdir):             # leftover sidecars/tmps
            os.unlink(os.path.join(rdir, name))

    # -------------------------------------------------------------- lifecycle

    def create_rbw(self, block_id: int, gen_stamp: int = 0,
                   storage_type: str | None = None) -> ReplicaWriter:
        # ``storage_type`` is a volume-routing hint consumed by VolumeSet
        # (storage/volumes.py); a single store has nowhere to route.
        with self._lock:
            existing = self._replicas.get(block_id)
            if existing is not None and gen_stamp <= existing.gen_stamp:
                raise FileExistsError(f"block {block_id} already finalized")
            # gen_stamp > existing: a supersede rewrite (append / recovery) —
            # the old replica keeps serving reads until finalize replaces it
            # atomically (the RBW writes to the rbw/ path, os.replace swaps)
            if block_id in self._rbw:
                raise FileExistsError(f"block {block_id} already being written")
            self._rbw.add(block_id)
        try:
            return ReplicaWriter(self, block_id, gen_stamp)
        except Exception:
            with self._lock:
                self._rbw.discard(block_id)
            raise

    def _register(self, meta: BlockMeta) -> None:
        with self._lock:
            self._replicas[meta.block_id] = meta
            self._rbw.discard(meta.block_id)
            self._visible.pop(meta.block_id, None)

    def _release_rbw(self, block_id: int) -> None:
        with self._lock:
            self._rbw.discard(block_id)
            self._visible.pop(block_id, None)

    def _set_visible(self, meta: BlockMeta) -> None:
        with self._lock:
            self._visible[meta.block_id] = meta

    def get_meta(self, block_id: int) -> BlockMeta | None:
        """Finalized meta, or the hflush'd visible meta for a block still
        in the write pipeline — which is what lets a concurrent reader see
        flushed bytes (BlockSender serves through this)."""
        with self._lock:
            return (self._replicas.get(block_id)
                    or self._visible.get(block_id))

    def is_rbw(self, block_id: int) -> bool:
        """An open in-flight writer exists (replica-being-written): block
        recovery must not conclude "no replica" while the pipeline is still
        alive or its teardown persist is in progress."""
        with self._lock:
            return block_id in self._rbw

    def length(self, block_id: int) -> int:
        """Logical length — authoritative from metadata, never from file size.
        Replaces the patched `FsDatasetImpl.getLength` (:735-761)."""
        meta = self.get_meta(block_id)
        if meta is None:
            raise KeyError(f"block {block_id} not found")
        return meta.logical_len

    def read_data(self, block_id: int, offset: int = 0, length: int = -1) -> bytes:
        """Raw stored bytes of the replica data file (post-reduction form).
        An hflush'd in-flight replica serves its VISIBLE prefix from the
        rbw file (clamped — the writer may be ahead of the last flush)."""
        with self._lock:
            vis = (None if block_id in self._replicas
                   else self._visible.get(block_id))
        if vis is not None:
            end = vis.physical_len if length < 0 \
                else min(offset + length, vis.physical_len)
            try:
                with open(self._path(RBW, block_id), "rb") as f:
                    f.seek(offset)
                    return f.read(max(end - offset, 0))
            except FileNotFoundError:
                pass  # finalize() raced us (os.replace happens before the
                # meta registers): the finalized file below has the bytes
        p = self._path(FINALIZED, block_id)
        with open(p, "rb") as f:
            f.seek(offset)
            return f.read() if length < 0 else f.read(length)

    def data_path(self, block_id: int) -> str:
        return self._path(FINALIZED, block_id)

    def truncate_replica(self, block_id: int, new_len: int,
                         new_gs: int | None = None) -> bool:
        """Cut a DIRECT replica to ``new_len`` logical bytes (the
        BlockRecoveryWorker length-sync truncation).  Reduced replicas are
        all-or-nothing — a committed reduced block never has a divergent
        length, so only equal-length no-ops are legal there.  ``new_gs``
        restamps the replica with the recovery generation stamp (the
        commitBlockSynchronization restamp: without it the next full block
        report would present the old generation and the NN would invalidate
        the just-recovered replica)."""
        with self._lock:
            meta = self._replicas.get(block_id)
            if meta is None:
                return False
            if meta.logical_len <= new_len and \
                    (new_gs is None or new_gs <= meta.gen_stamp):
                return True  # nothing to cut or restamp (recovery retry)
            if meta.logical_len > new_len:
                if meta.scheme != "direct":
                    raise IOError(f"block {block_id}: cannot truncate a "
                                  f"{meta.scheme} replica to {new_len}")
                p = self._path(FINALIZED, block_id)
                # write-replace, never truncate in place: finalized data
                # files are hardlinked into upgrade snapshots
                # (storage/version.py _snapshot), so an in-place mutation
                # would silently corrupt the rollback image
                with open(p, "rb") as f:
                    kept = f.read(new_len)
                with open(p + ".tmp", "wb") as f:
                    f.write(kept)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(p + ".tmp", p)
                nchunks = -(-new_len // meta.checksum_chunk) if new_len else 0
                meta.logical_len = meta.physical_len = new_len
                del meta.checksums[nchunks:]
                if new_len % meta.checksum_chunk and meta.checksums:
                    # re-derive the now-partial final chunk's checksum
                    with open(p, "rb") as f:
                        f.seek((nchunks - 1) * meta.checksum_chunk)
                        from hdrf_tpu_torch import native
                        meta.checksums[-1] = native.crc32c(f.read())
                _M.incr("replicas_truncated")
            if new_gs is not None and new_gs > meta.gen_stamp:
                meta.gen_stamp = new_gs
            mp = self._path(FINALIZED, block_id) + ".meta"
            with open(mp + ".tmp", "wb") as f:
                f.write(meta.pack())
                f.flush()
                os.fsync(f.fileno())
            os.replace(mp + ".tmp", mp)  # write-replace: see above
            return True

    def adopt(self, meta: BlockMeta, data: bytes) -> None:
        """Install a finalized replica wholesale (intra-DN volume move,
        DiskBalancer's movePhysicalBlock analog): data + meta land under
        finalized/ via write-then-rename, then register."""
        dst = self._path(FINALIZED, meta.block_id)
        with open(dst + ".tmp", "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(dst + ".tmp", dst)
        with open(dst + ".meta.tmp", "wb") as f:
            f.write(meta.pack())
            f.flush()
            os.fsync(f.fileno())
        os.replace(dst + ".meta.tmp", dst + ".meta")
        self._register(meta)
        _M.incr("replicas_adopted")

    def delete(self, block_id: int) -> None:
        with self._lock:
            self._replicas.pop(block_id, None)
        for p in (self._path(FINALIZED, block_id),
                  self._path(FINALIZED, block_id) + ".meta"):
            if os.path.exists(p):
                os.unlink(p)
        _M.incr("deleted")

    def block_ids(self) -> list[int]:
        """Block report source (BlockListAsLongs analog)."""
        with self._lock:
            return sorted(self._replicas)

    def block_report(self) -> list[tuple[int, int, int]]:
        """(block_id, gen_stamp, logical_len) triples — lengths are real, not
        the reference's spoofed `setNumBytes` values (BlockListAsLongs.java:547-554)."""
        with self._lock:
            return [(m.block_id, m.gen_stamp, m.logical_len)
                    for m in self._replicas.values()]

    # ---------------------------------------------------------------- scanner

    def scan(self) -> list[str]:
        """DirectoryScanner analog: reconcile memory vs disk.  Because
        physical_len is first-class, a 0-byte data file for a dedup'd block is
        *consistent*, not corrupt (vs DirectoryScanner.java:437-438 which the
        reference had to disable)."""
        problems: list[str] = []
        with self._lock:
            replicas = dict(self._replicas)
        fdir = os.path.join(self._dir, FINALIZED)
        on_disk = {int(n[4:]) for n in os.listdir(fdir)
                   if n.startswith("blk_") and not n.endswith(".meta")}
        for bid, meta in replicas.items():
            if bid not in on_disk:
                problems.append(f"block {bid}: data file missing")
                continue
            size = os.path.getsize(self._path(FINALIZED, bid))
            if size != meta.physical_len:
                problems.append(
                    f"block {bid}: physical length {size} != meta {meta.physical_len}")
        for bid in on_disk - set(replicas):
            problems.append(f"block {bid}: orphan data file (no meta)")
        _M.incr("scans")
        return problems

    def physical_bytes(self) -> int:
        with self._lock:
            return sum(m.physical_len for m in self._replicas.values())

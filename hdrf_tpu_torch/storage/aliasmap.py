"""Provided-storage alias map (block -> external byte range); port of
hdrf_tpu/storage/aliasmap.py ``InMemoryAliasMap`` and ``FileRegion``.  The
map file is packed with the port's own codec (proto/rpc.packb), byte for
byte the reference's msgpack file, so each package reopens the other's.

Re-expression of the reference's provided-storage plumbing —
``server/aliasmap/InMemoryAliasMap.java`` (block -> ProvidedStorageLocation
over LevelDB), ``server/common/FileRegion.java:34`` (the (Block,
ProvidedStorageLocation) pair), and the PROVIDED StorageType whose replicas'
bytes live in an external store rather than on DataNode disks — as a
msgpack-persisted map the DataNode consults when a read misses its local
replica set.

The reference generates alias maps offline with the fsimage image-writer;
here ``dfsadmin -provide`` drives the live flow: the NameNode journals the
namespace half (a complete file whose blocks are provided), the CLI pushes
the FileRegions to every DataNode (the ``alias_add`` op), and DNs persist +
report them as PROVIDED replicas, so reads route like any other block.
Only ``file://`` URIs resolve in this environment; other schemes raise at
read time (the mount is still registered — a deployment with an object-store
fetcher plugs in at ``_open_uri``).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

from hdrf_tpu_torch.proto import rpc
from hdrf_tpu_torch.utils import metrics

_M = metrics.registry("aliasmap")


@dataclass
class FileRegion:
    """One provided block: bytes [offset, offset+length) of ``uri``
    (FileRegion.java:34 / ProvidedStorageLocation)."""

    block_id: int
    uri: str
    offset: int
    length: int

    def pack(self) -> list:
        return [self.block_id, self.uri, self.offset, self.length]

    @staticmethod
    def unpack(v: list) -> "FileRegion":
        return FileRegion(v[0], v[1], v[2], v[3])


class InMemoryAliasMap:
    """block_id -> FileRegion with write-replace persistence
    (InMemoryAliasMap.java's LevelDB role; the write/list/read protocol
    surface of InMemoryAliasMapProtocol)."""

    def __init__(self, path: str, mount_root: str | None = "/"):
        """``mount_root`` confines every ``file://`` region to one
        directory subtree (symlinks resolved): block tokens gate WHO may
        alias blocks, the mount root bounds WHAT they can alias — without
        it a write-token holder aliases a block to any DN-readable local
        file and discloses it through the ordinary read path.  "/" opts
        out of confinement; None/"" disables file:// resolution."""
        self._path = path
        self._mount_root = os.path.realpath(mount_root) if mount_root else None
        self._lock = threading.Lock()
        self._map: dict[int, FileRegion] = {}
        if os.path.exists(path):
            with open(path, "rb") as f:
                for v in rpc.unpackb(f.read(), raw=False):
                    r = FileRegion.unpack(v)
                    self._map[r.block_id] = r

    def _persist_locked(self) -> None:
        blob = rpc.packb([r.pack() for r in self._map.values()])
        with open(self._path + ".tmp", "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(self._path + ".tmp", self._path)

    def write(self, regions: list[FileRegion]) -> None:
        with self._lock:
            for r in regions:
                self._map[r.block_id] = r
            self._persist_locked()
        _M.incr("regions_written", len(regions))

    def remove(self, block_ids: list[int]) -> None:
        with self._lock:
            for bid in block_ids:
                self._map.pop(bid, None)
            self._persist_locked()

    def read(self, block_id: int) -> FileRegion | None:
        with self._lock:
            return self._map.get(block_id)

    def list(self) -> list[FileRegion]:
        with self._lock:
            return list(self._map.values())

    # ------------------------------------------------------------ data path

    def check_uri(self, uri: str) -> None:
        """Raise if ``uri`` is not resolvable inside the mount root.
        Called at alias_add time (reject the region before it persists)
        and again at every read (the file may have become a symlink out
        of the tree since)."""
        if not uri.startswith("file://"):
            raise IOError(f"unsupported provided-storage scheme: {uri}")
        if self._mount_root is None:
            _M.incr("mount_root_rejects")
            raise IOError("provided storage disabled: no mount root "
                          "configured (datanode.provided_mount_root)")
        if self._mount_root == os.sep:
            return
        rp = os.path.realpath(uri[len("file://"):])
        if rp != self._mount_root and not rp.startswith(
                self._mount_root + os.sep):
            _M.incr("mount_root_rejects")
            raise IOError(f"provided uri outside mount root: {uri}")

    def _open_uri(self, uri: str):
        self.check_uri(uri)
        return open(uri[len("file://"):], "rb")

    def read_bytes(self, block_id: int, offset: int = 0,
                   length: int = -1) -> bytes | None:
        """Logical bytes of a provided block (None = not provided here).
        Range semantics match ReplicaStore.read_data."""
        region = self.read(block_id)
        if region is None:
            return None
        end = region.length if length < 0 else min(offset + length,
                                                   region.length)
        if offset >= end:
            return b""
        with self._open_uri(region.uri) as f:
            f.seek(region.offset + offset)
            out = f.read(end - offset)
        if len(out) != end - offset:
            raise IOError(f"provided block {block_id}: external store "
                          f"returned {len(out)} of {end - offset} bytes")
        _M.incr("provided_reads")
        return out

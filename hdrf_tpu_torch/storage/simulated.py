"""Simulated replica store: in-memory FsDataset for protocol tests at scale
(port of hdrf_tpu/storage/simulated.py ``SimulatedReplicaStore``).

The SimulatedFSDataset analog (server/datanode/SimulatedFSDataset.java:91,
1.5 kLoC in the reference): implements the ReplicaStore surface with bytes in
RAM — no disk I/O — so NameNode-logic and wire-protocol tests can run
thousands of blocks per DN cheaply.  Enabled via
``DataNodeConfig.simulated_dataset`` (the reference injects it with
SimulatedFSDataset.setFactory).
"""

from __future__ import annotations

import threading

from hdrf_tpu_torch.storage.replica_store import BlockMeta
from hdrf_tpu_torch.utils import metrics

_M = metrics.registry("simulated_dataset")


class SimulatedWriter:
    def __init__(self, store: "SimulatedReplicaStore", block_id: int,
                 gen_stamp: int):
        self._store = store
        self._block_id = block_id
        self._gen_stamp = gen_stamp
        self._parts: list[bytes] = []

    def write(self, data: bytes) -> None:
        self._parts.append(bytes(data))

    @property
    def bytes_written(self) -> int:
        return sum(len(p) for p in self._parts)

    def finalize(self, logical_len: int, scheme: str, checksums: list[int],
                 checksum_chunk: int) -> BlockMeta:
        data = b"".join(self._parts)
        meta = BlockMeta(block_id=self._block_id, gen_stamp=self._gen_stamp,
                         logical_len=logical_len, physical_len=len(data),
                         scheme=scheme, checksums=list(checksums),
                         checksum_chunk=checksum_chunk)
        with self._store._lock:
            self._store._data[self._block_id] = data
            self._store._meta[self._block_id] = meta
            self._store._rbw.discard(self._block_id)
        _M.incr("blocks_finalized")
        return meta

    def abort(self) -> None:
        with self._store._lock:
            self._store._rbw.discard(self._block_id)


class SimulatedReplicaStore:
    """Drop-in for storage.replica_store.ReplicaStore, RAM-backed."""

    def __init__(self, directory: str = ""):
        self._lock = threading.Lock()
        self._data: dict[int, bytes] = {}
        self._meta: dict[int, BlockMeta] = {}
        self._rbw: set[int] = set()

    def create_rbw(self, block_id: int, gen_stamp: int = 0,
                   storage_type: str | None = None) -> SimulatedWriter:
        with self._lock:
            # same contract as the real store: finalized OR in-flight
            # duplicates are rejected
            if block_id in self._rbw or block_id in self._meta:
                raise FileExistsError(f"block {block_id} already exists")
            self._rbw.add(block_id)
        return SimulatedWriter(self, block_id, gen_stamp)

    def get_meta(self, block_id: int) -> BlockMeta | None:
        return self._meta.get(block_id)

    def is_rbw(self, block_id: int) -> bool:
        with self._lock:
            return block_id in self._rbw

    def length(self, block_id: int) -> int:
        return self._meta[block_id].logical_len  # KeyError like the real store

    def read_data(self, block_id: int, offset: int = 0,
                  length: int = -1) -> bytes:
        if block_id not in self._data:  # FileNotFoundError like the real store
            raise FileNotFoundError(f"no replica data for block {block_id}")
        data = self._data[block_id]
        end = len(data) if length < 0 else min(offset + length, len(data))
        return data[offset:end]

    def data_path(self, block_id: int) -> str:
        raise OSError("simulated dataset has no on-disk paths "
                      "(short-circuit reads are disabled)")

    def truncate_replica(self, block_id: int, new_len: int,
                         new_gs: int | None = None) -> bool:
        """Length-sync truncation + recovery restamp (same contract as
        ReplicaStore.truncate_replica)."""
        with self._lock:
            meta = self._meta.get(block_id)
            if meta is None:
                return False
            if meta.logical_len > new_len:
                if meta.scheme != "direct":
                    raise IOError(f"block {block_id}: cannot truncate a "
                                  f"{meta.scheme} replica to {new_len}")
                self._data[block_id] = self._data[block_id][:new_len]
                nchunks = -(-new_len // meta.checksum_chunk) if new_len else 0
                meta.logical_len = meta.physical_len = new_len
                del meta.checksums[nchunks:]
                if new_len % meta.checksum_chunk and meta.checksums:
                    from hdrf_tpu_torch import native
                    meta.checksums[-1] = native.crc32c(
                        self._data[block_id][(nchunks - 1)
                                             * meta.checksum_chunk:])
            if new_gs is not None and new_gs > meta.gen_stamp:
                meta.gen_stamp = new_gs
            return True

    def delete(self, block_id: int) -> None:
        with self._lock:
            self._data.pop(block_id, None)
            self._meta.pop(block_id, None)

    def block_ids(self) -> list[int]:
        return list(self._meta)

    def block_report(self) -> list[tuple[int, int, int]]:
        return [(m.block_id, m.gen_stamp, m.logical_len)
                for m in self._meta.values()]

    def scan(self) -> list[str]:
        return []  # nothing on disk to reconcile

    def physical_bytes(self) -> int:
        return sum(len(d) for d in self._data.values())

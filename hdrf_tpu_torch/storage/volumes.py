"""Multi-volume DataNode storage (FsVolumeImpl / FsVolumeList analog) (port of
hdrf_tpu/storage/volumes.py, whole).

Re-expresses the reference's per-volume dataset layer —
``fsdataset/impl/FsVolumeImpl.java`` (one volume per configured data dir,
each with its own storage type), ``FsVolumeList`` (round-robin +
available-space placement across volumes), ``DataNode.handleVolumeFailures``
(a failed volume is ejected, the node survives) — and a DiskBalancer-lite
intra-node move planner (``server/diskbalancer/``'s GreedyPlanner, scoped
to replica files).

Layout (storage layout v2, storage/version.py)::

    <data_dir>/volumes/vol-<i>/replicas/...     one ReplicaStore per volume
    <data_dir>/volumes/vol-<i>/containers/...   one ContainerStore per volume
    <data_dir>/index/                           ONE chunk index per DN

Container ids are namespaced per volume (``vol_id << CID_SHIFT``) so the
DN-wide chunk index routes any cid to its volume with a shift — the same
trick the reference uses to namespace container ids by writer thread
(``utilities.java:36-75``'s 2-bit threadID field in its 3-byte ids).

Volume failure semantics: ``eject(vol_id)`` drops the volume's replicas
from reports (the NameNode re-replicates them from healthy peers) and
fails reads of its bytes loudly; the DataNode keeps serving from the
surviving volumes and exits only when the LAST volume dies — the
reference's ``dfs.datanode.failed.volumes.tolerated`` behavior.
"""

from __future__ import annotations

import os
import threading

from hdrf_tpu_torch.storage.container_store import ContainerStore
from hdrf_tpu_torch.storage.replica_store import BlockMeta, ReplicaStore
from hdrf_tpu_torch.utils import metrics

_M = metrics.registry("volumes")

CID_SHIFT = 24          # volume id lives above bit 24 of a container id


class Volume:
    def __init__(self, vol_id: int, root: str, storage_type: str,
                 container_kw: dict):
        self.vol_id = vol_id
        self.storage_type = storage_type
        self.failed = False
        if storage_type == "RAM_DISK" and os.access("/dev/shm", os.W_OK):
            # shm-backed volume (RamDiskReplicaTracker.java:38's tmpfs
            # requirement): bytes live in RAM, persist across DN restarts,
            # vanish on machine reboot — which is why the lazy writer
            # exists.  The dir is keyed to the CONFIGURED root so a
            # restarted DN finds its RAM replicas; an ``origin`` marker
            # lets test harnesses reclaim leaked segments.
            import hashlib
            tag = hashlib.sha1(os.path.abspath(root).encode()).hexdigest()[:16]
            shm = os.path.join("/dev/shm", f"hdrf-ram-{tag}")
            os.makedirs(shm, exist_ok=True)
            with open(os.path.join(shm, "origin"), "w") as f:
                f.write(os.path.abspath(root))
            root = shm
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.replicas = ReplicaStore(os.path.join(root, "replicas"))
        self.containers = ContainerStore(
            os.path.join(root, "containers"),
            id_base=vol_id << CID_SHIFT, **container_kw)

    def free_estimate(self) -> int:
        """Free bytes on the volume's filesystem (capacity heuristic for
        placement; volumes sharing one fs in tests just compare usage)."""
        try:
            st = os.statvfs(self.root)
            free = st.f_bavail * st.f_frsize
        except OSError:
            free = 0
        # subtract what THIS volume already holds so same-fs volumes
        # still spread by usage
        return free - self.used_bytes()

    def used_bytes(self) -> int:
        return (self.replicas.physical_bytes()
                + self.containers.physical_bytes())


class VolumeSet:
    """The DataNode's dataset over N volumes: ReplicaStore-compatible
    surface routed by a block -> volume map, type-aware placement for new
    replicas, container routing by cid namespace, ejection, and the
    intra-DN balancer."""

    def __init__(self, data_dir: str, types: list[str], container_kw: dict):
        assert types, "at least one volume"
        assert len(types) < (1 << 8), "volume count bounded by cid namespace"
        self._lock = threading.Lock()
        self.volumes = [
            Volume(i, os.path.join(data_dir, "volumes", f"vol-{i}"), t,
                   container_kw)
            for i, t in enumerate(types)]
        self._where: dict[int, int] = {}     # block_id -> vol_id
        self._rr = 0
        best_gs: dict[int, int] = {}
        for v in self.volumes:
            for bid, gs, _ln in v.replicas.block_report():
                # the lazy writer leaves shadow copies on DISK: ownership
                # after restart goes to the HIGHEST generation (scan-order
                # would let a stale shadow win and the next lazy tick
                # would then delete the newer RAM copy as "stale")
                if bid not in best_gs or gs > best_gs[bid]:
                    best_gs[bid] = gs
                    self._where[bid] = v.vol_id
        self._containers = MultiContainerStore(self)

    # ------------------------------------------------------------ routing

    def _vol_of(self, block_id: int) -> Volume | None:
        vid = self._where.get(block_id)
        if vid is None or self.volumes[vid].failed:
            return None
        return self.volumes[vid]

    def _alive(self) -> list[Volume]:
        return [v for v in self.volumes if not v.failed]

    def volume_of_cid(self, cid: int) -> Volume:
        vid = cid >> CID_SHIFT
        if vid >= len(self.volumes):
            # the DN-wide index persists cids across restarts; a DN
            # reconfigured with FEWER volumes must degrade (block treated
            # as lost -> re-replicated), not crash on the stale namespace
            raise IOError(f"container {cid}: volume {vid} not configured")
        v = self.volumes[vid]
        if v.failed:
            # an ejected volume's bytes may be corrupt — refuse loudly so
            # the read path degrades to "chunk lost" instead of serving them
            raise IOError(f"container {cid}: volume {vid} is ejected")
        return v

    # ----------------------------------------------------- replica surface

    def _choose_volume(self, storage_type: str | None,
                       exclude_ram: bool = False) -> Volume:
        """Type match first (the NameNode's slot hint), then the volume
        with the most free space among candidates; round-robin breaks
        ties (FsVolumeList's AvailableSpaceVolumeChoosingPolicy over the
        round-robin default)."""
        alive = self._alive()
        if exclude_ram:
            alive = [v for v in alive if v.storage_type != "RAM_DISK"]
            if not alive:
                # NEVER fall back to RAM for shared chunk containers: a
                # reboot would corrupt every referencing block — refuse
                # and let the write degrade to re-replication elsewhere
                raise IOError("no non-RAM volume available for containers")
        if not alive:
            raise IOError("all volumes failed")
        cands = [v for v in alive if v.storage_type == storage_type] or alive
        with self._lock:
            self._rr += 1
            start = self._rr
        best = max(cands, key=lambda v: (v.free_estimate(),
                                         -((start + v.vol_id) % len(cands))))
        return best

    def create_rbw(self, block_id: int, gen_stamp: int = 0,
                   storage_type: str | None = None):
        vol = self._vol_of(block_id) or self._choose_volume(storage_type)
        writer = vol.replicas.create_rbw(block_id, gen_stamp)
        with self._lock:
            self._where[block_id] = vol.vol_id
        return writer

    def get_meta(self, block_id: int) -> BlockMeta | None:
        v = self._vol_of(block_id)
        return v.replicas.get_meta(block_id) if v else None

    def is_rbw(self, block_id: int) -> bool:
        v = self._vol_of(block_id)
        return v.replicas.is_rbw(block_id) if v else False

    def read_data(self, block_id: int, offset: int = 0,
                  length: int = -1) -> bytes:
        for attempt in range(2):
            v = self._vol_of(block_id)
            if v is None:
                raise IOError(f"block {block_id}: no live volume holds it")
            try:
                return v.replicas.read_data(block_id, offset, length)
            except FileNotFoundError:
                # lazy-persist eviction raced us: _where already points at
                # the disk copy — re-resolve once
                if attempt:
                    raise
        raise IOError(f"block {block_id}: unreadable")  # pragma: no cover

    def data_path(self, block_id: int) -> str:
        v = self._vol_of(block_id)
        if v is None:
            raise IOError(f"block {block_id}: no live volume holds it")
        return v.replicas.data_path(block_id)

    def truncate_replica(self, block_id: int, new_len: int,
                         new_gs: int | None = None) -> bool:
        v = self._vol_of(block_id)
        return v.replicas.truncate_replica(block_id, new_len,
                                           new_gs=new_gs) if v else False

    def delete(self, block_id: int) -> None:
        # sweep EVERY volume, not just the owner: the lazy writer keeps
        # shadow disk copies of RAM replicas, and an owner-only delete
        # would orphan them
        for v in self._alive():
            if v.replicas.get_meta(block_id) is not None \
                    or v.replicas.is_rbw(block_id):
                v.replicas.delete(block_id)
        with self._lock:
            self._where.pop(block_id, None)

    def block_ids(self) -> list[int]:
        out: list[int] = []
        for v in self._alive():
            out.extend(bid for bid in v.replicas.block_ids()
                       if self._where.get(bid) == v.vol_id)
        return out

    def block_report(self) -> list[tuple[int, int, int, str]]:
        """(block_id, gen_stamp, logical_len, storage_type) per replica —
        the reference reports per-storage (DatanodeStorageInfo), which is
        what lets the NameNode see each replica's actual type on
        multi-type nodes.  Only the OWNING volume's copy is reported: the
        lazy writer keeps shadow disk copies of RAM replicas, and a
        double row for one block would confuse the NN's replica count."""
        out = []
        for v in self._alive():
            out.extend((bid, gs, ln, v.storage_type)
                       for bid, gs, ln in v.replicas.block_report()
                       if self._where.get(bid) == v.vol_id)
        return out

    def scan(self) -> list[str]:
        out: list[str] = []
        for v in self._alive():
            out.extend(v.replicas.scan())
        return out

    def physical_bytes(self) -> int:
        return sum(v.replicas.physical_bytes() for v in self._alive())

    # --------------------------------------------------- container surface

    @property
    def containers(self) -> "MultiContainerStore":
        return self._containers

    # ------------------------------------------------------------ failure

    def eject(self, vol_id: int) -> list[int]:
        """Volume died (DataNode.handleVolumeFailures): drop it from
        service.  Its replicas vanish from subsequent reports — the
        NameNode re-replicates them from healthy peers; its containers'
        chunks surface as lost through the scanner/read path.  Returns
        the block ids that went away."""
        v = self.volumes[vol_id]
        if v.failed:
            return []
        v.failed = True
        with self._lock:
            affected = [bid for bid, vid in self._where.items()
                        if vid == vol_id]
            lost = []
            for bid in affected:
                # a lazy-persisted shadow on a surviving volume rescues
                # the block (RAM volume death is the exact scenario the
                # lazy writer exists for) — fail ownership over instead
                # of declaring it lost.  Only a CURRENT-generation shadow
                # counts: serving a stale pre-append copy silently would
                # be worse than re-replicating from a healthy peer.
                lost_meta = v.replicas.get_meta(bid)
                lost_gs = lost_meta.gen_stamp if lost_meta else 0
                for sv in self.volumes:
                    if sv.failed or sv.vol_id == vol_id:
                        continue
                    sm = sv.replicas.get_meta(bid)
                    if sm is not None and sm.gen_stamp >= lost_gs:
                        self._where[bid] = sv.vol_id
                        _M.incr("blocks_rescued_by_shadow")
                        break
                else:
                    self._where.pop(bid, None)
                    lost.append(bid)
        _M.incr("volumes_ejected")
        _M.incr("blocks_lost_to_volume_failure", len(lost))
        return lost

    def alive_count(self) -> int:
        return len(self._alive())

    # ------------------------------------------------------- lazy persist

    def lazy_persist_tick(self, ram_capacity: int) -> tuple[int, int]:
        """One lazy-writer pass (RamDiskReplicaTracker.java:38 +
        LazyWriter semantics): every finalized replica on a RAM_DISK
        volume gets a shadow copy on a DISK volume (the durability half);
        then, while the RAM volume exceeds ``ram_capacity``, persisted
        replicas are EVICTED — ownership flips to the disk copy and the
        RAM bytes are reclaimed.  Reads keep hitting RAM until eviction
        (the fast-read half).  Returns (persisted, evicted)."""
        rams = [v for v in self._alive() if v.storage_type == "RAM_DISK"]
        disks = [v for v in self._alive() if v.storage_type != "RAM_DISK"]
        if not rams or not disks:
            return (0, 0)
        persisted = evicted = 0
        for rv in rams:
            for bid, gs, _ln in rv.replicas.block_report():
                if self._where.get(bid) != rv.vol_id:
                    # stale RAM copy (evicted or superseded): reclaim
                    rv.replicas.delete(bid)
                    continue
                if rv.replicas.is_rbw(bid):
                    continue
                meta = rv.replicas.get_meta(bid)
                if meta is None:
                    continue
                # an up-to-date shadow on ANY disk satisfies persistence —
                # re-checking only the currently-most-free disk would
                # duplicate the shadow each time that choice flips
                if any(dm is not None and dm.gen_stamp >= meta.gen_stamp
                       for dm in (dv.replicas.get_meta(bid)
                                  for dv in disks)):
                    continue
                dv = max(disks, key=lambda v: v.free_estimate())
                dv.replicas.adopt(meta, rv.replicas.read_data(bid))
                persisted += 1
                _M.incr("lazy_persisted")
            while rv.used_bytes() > ram_capacity:
                flipped = False
                for bid, gs, _ln in rv.replicas.block_report():
                    if self._where.get(bid) != rv.vol_id:
                        continue
                    for dv in disks:
                        dm = dv.replicas.get_meta(bid)
                        if dm is not None and dm.gen_stamp >= gs:
                            with self._lock:
                                self._where[bid] = dv.vol_id
                            rv.replicas.delete(bid)
                            evicted += 1
                            flipped = True
                            _M.incr("lazy_evicted")
                            break
                    if flipped:
                        break
                if not flipped:
                    break   # nothing evictable yet (unpersisted writes)
        return persisted, evicted

    # ----------------------------------------------------- disk balancer

    def plan_moves(self, threshold: float = 0.10) -> list[tuple[int, int, int]]:
        """GreedyPlanner-lite: while the spread between the fullest and
        emptiest live volume exceeds ``threshold`` of the fullest's used
        bytes, move the largest movable replica down the gradient.
        Returns (block_id, from_vol, to_vol) steps.  Only replicas with
        physical bytes move (dedup'd replicas are 0-byte pointers; their
        bytes live in chunk containers)."""
        vols = self._alive()
        if len(vols) < 2:
            return []
        used = {v.vol_id: float(v.used_bytes()) for v in vols}
        sizes: dict[int, list[tuple[int, int]]] = {}
        for v in vols:
            rows = []
            for m in v.replicas.block_report():
                meta = v.replicas.get_meta(m[0])  # may race a delete
                if meta is not None and meta.physical_len > 0:
                    rows.append((m[2], m[0]))
            sizes[v.vol_id] = sorted(rows, reverse=True)
        plan: list[tuple[int, int, int]] = []
        for _ in range(1000):
            hi = max(used, key=lambda k: used[k])
            lo = min(used, key=lambda k: used[k])
            if used[hi] <= 0 or (used[hi] - used[lo]) <= threshold * used[hi]:
                break
            movable = sizes[hi]
            if not movable:
                break
            size, bid = movable.pop(0)
            if size > (used[hi] - used[lo]) / 2 and len(movable):
                # moving the biggest would overshoot: try the best fit
                fit = next((i for i, (s, _) in enumerate(movable)
                            if s <= (used[hi] - used[lo]) / 2), None)
                if fit is not None:
                    movable.insert(0, (size, bid))
                    size, bid = movable.pop(fit + 1)
            plan.append((bid, hi, lo))
            used[hi] -= size
            used[lo] += size
            sizes[lo].append((size, bid))
        return plan

    def execute_moves(self, plan: list[tuple[int, int, int]]) -> int:
        """Apply planner steps: copy data+meta into the target volume,
        flip the routing map, delete the source copy.  Readers route by
        the map, so the switch is atomic from their view."""
        done = 0
        for bid, src_vid, dst_vid in plan:
            src, dst = self.volumes[src_vid], self.volumes[dst_vid]
            if src.failed or dst.failed:
                continue
            meta = src.replicas.get_meta(bid)
            if meta is None or src.replicas.is_rbw(bid):
                continue
            data = src.replicas.read_data(bid)
            dst.replicas.adopt(meta, data)
            with self._lock:
                self._where[bid] = dst_vid
            src.replicas.delete(bid)
            done += 1
            _M.incr("replicas_moved_intra_dn")
        return done


class MultiContainerStore:
    """ContainerStore surface over all live volumes, routing by the cid's
    volume namespace; appends go to the volume with the most free space."""

    def __init__(self, vs: VolumeSet):
        self._vs = vs

    def append_chunks(self, chunks, on_seal=None, sync: bool = True):
        # chunk containers hold SHARED dedup bytes: never place them on a
        # RAM_DISK volume (a reboot would corrupt every referencing block)
        vol = self._vs._choose_volume(None, exclude_ram=True)
        return vol.containers.append_chunks(chunks, on_seal=on_seal,
                                            sync=sync)

    def append_ranges(self, data, starts, lens, on_seal=None,
                      sync: bool = True):
        vol = self._vs._choose_volume(None, exclude_ram=True)
        return vol.containers.append_ranges(data, starts, lens,
                                            on_seal=on_seal, sync=sync)

    def sync_lanes(self) -> None:
        for v in self._vs._alive():
            v.containers.sync_lanes()

    def read_container(self, cid: int) -> bytes:
        return self._vs.volume_of_cid(cid).containers.read_container(cid)

    def read_chunks(self, locs):
        by_vol: dict[int, list[int]] = {}
        for i, (cid, _, _) in enumerate(locs):
            by_vol.setdefault(cid >> CID_SHIFT, []).append(i)
        out = [None] * len(locs)
        for vid, idxs in by_vol.items():
            # route through volume_of_cid so stale cid namespaces and
            # ejected volumes raise IOError (treat-as-lost), not IndexError
            vol = self._vs.volume_of_cid(vid << CID_SHIFT)
            got = vol.containers.read_chunks([locs[i] for i in idxs])
            for i, b in zip(idxs, got):
                out[i] = b
        return out

    def read_containers(self, cids, decompress_batch=None):
        by_vol: dict[int, list[int]] = {}
        for cid in cids:
            by_vol.setdefault(cid >> CID_SHIFT, []).append(cid)
        out: dict[int, bytes] = {}
        for vid, ids in by_vol.items():
            vol = self._vs.volume_of_cid(vid << CID_SHIFT)
            out.update(vol.containers.read_containers(
                ids, decompress_batch=decompress_batch))
        return out

    def copy_live(self, cid: int, live, on_seal=None):
        # live chunks move into the OWNING volume's open lane (compaction
        # stays intra-volume so cids keep routing correctly)
        return self._vs.volume_of_cid(cid).containers.copy_live(
            cid, live, on_seal=on_seal)

    def delete_container(self, cid: int) -> None:
        self._vs.volume_of_cid(cid).containers.delete_container(cid)

    def quarantine(self, cid: int) -> int:
        return self._vs.volume_of_cid(cid).containers.quarantine(cid)

    def sealed_file_bytes(self, cid: int) -> bytes | None:
        return self._vs.volume_of_cid(cid).containers.sealed_file_bytes(cid)

    def drop_sealed_file(self, cid: int) -> int:
        return self._vs.volume_of_cid(cid).containers.drop_sealed_file(cid)

    def has_container(self, cid: int, need_bytes: int = 0) -> bool:
        try:
            v = self._vs.volume_of_cid(cid)
        except IOError:
            return False   # stale namespace (volume removed): lost
        return (not v.failed) and v.containers.has_container(cid, need_bytes)

    def container_ids(self) -> list[int]:
        out: list[int] = []
        for v in self._vs._alive():
            out.extend(v.containers.container_ids())
        return sorted(out)

    def flush_open(self, on_seal=None, cids=None) -> int:
        return sum(v.containers.flush_open(on_seal=on_seal, cids=cids)
                   for v in self._vs._alive())

    def enable_async_seals(self) -> None:
        for v in self._vs._alive():
            v.containers.enable_async_seals()

    def drain_seals(self) -> None:
        for v in self._vs._alive():
            v.containers.drain_seals()

    def close_async_seals(self) -> None:
        for v in self._vs._alive():
            v.containers.close_async_seals()

    def physical_bytes(self) -> int:
        return sum(v.containers.physical_bytes() for v in self._vs._alive())

    def container_sizes(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for v in self._vs._alive():
            out.update(v.containers.container_sizes())
        return out

    @property
    def _on_delete(self):
        return self._vs.volumes[0].containers._on_delete

    @_on_delete.setter
    def _on_delete(self, fn) -> None:
        for v in self._vs.volumes:
            v.containers._on_delete = fn

    @property
    def _on_retire(self):
        return self._vs.volumes[0].containers._on_retire

    @_on_retire.setter
    def _on_retire(self, fn) -> None:
        # the decoded-chunk cache is DN-wide (server/read_plane.py), so one
        # retirement hook covers every volume's store
        for v in self._vs.volumes:
            v.containers._on_retire = fn

    @property
    def _stripe_fallback(self):
        return self._vs.volumes[0].containers._stripe_fallback

    @_stripe_fallback.setter
    def _stripe_fallback(self, fn) -> None:
        # stripes are DN-wide (stripe_store.py keys by owner dn_id), so one
        # fallback serves every volume's store
        for v in self._vs.volumes:
            v.containers._stripe_fallback = fn

    @property
    def _stripe_probe(self):
        return self._vs.volumes[0].containers._stripe_probe

    @_stripe_probe.setter
    def _stripe_probe(self, fn) -> None:
        for v in self._vs.volumes:
            v.containers._stripe_probe = fn

"""Continuous integrity scrub + garbage census for one DataNode (port of
hdrf_tpu/server/scrubber.py ``Scrubber``; the any-k decode spot-check runs
through ``stripe_store.reconstruct_container`` on the EC tier's device, so
a ``cuda`` DataNode decodes with the RS kernel on the card).

Re-expresses the reference's background verification stack —
VolumeScanner.java:47 (rolling block verification at a throttled byte
rate, dfs.block.scanner.volume.bytes.per.second), DirectoryScanner.java:56
(disk-vs-memory reconciliation sweep), BlockScanner.java:41 (per-volume
scanner lifecycle) — over the reduction layers the shadow-block design
added, where the reference's checks cannot see:

- **Sealed containers** (storage/container_store.py:308): decode and
  re-verify a sampled fraction of live chunk digests against the chunk
  index (index/chunk_index.py:508 ``live_chunks_in`` — fingerprints ARE
  the SHA-256 digests, so one hash per sampled chunk is the whole
  oracle).  One corrupt shared chunk silently poisons every block that
  references it, which is exactly why the sample walks the INDEX, not
  the replica files.
- **EC stripes** (storage/stripe_store.py:139): CRC every local stripe
  (owner stripes against the WAL manifest's ``crcs``; foreign stripes
  against a first-scrub CRC baseline, since the manifest lives with the
  owner), plus a rotating any-k decode spot-check per cycle
  (server/ec_tier.py:280 ``_gather``) proving the group still decodes
  to the manifest geometry.
- **Replica invariants** (storage/replica_store.py): a reduced replica
  must be exactly 0 stored bytes with live index entries behind it; a
  direct replica must match its recorded length + CRCs (one deep
  ``verify_block`` per cycle, rotating — the scanner's rolling cursor,
  VolumeScanner.java:539, at census cadence).
- **Garbage census**: zero-refcount dead chunk bytes (the index's
  ``_apply b"del"`` removes dead chunks outright, so garbage = container
  payload − live bytes), orphan appended bytes from dedup-race loser
  commits (index/chunk_index.py:287 ``commit_block`` returns the losers;
  the index attributes their bytes per container), aged ``*.tmp`` files
  from crashed tmp+fsync+replace writes (container seal, stripe put,
  mirror-segment put), and mirror segments still held after a
  full-replica upgrade (server/mirror_plane.py:470).

Detection turns into response (tentpole c): a scrub-confirmed corrupt
container is **quarantined** (files renamed aside — never served again,
surviving restarts), every block referencing it is invalidated and
``bad_block``-reported so the NN's redundancy monitor re-replicates from
healthy peers (server/namenode.py rpc_bad_block); a corrupt stripe is
quarantined and repaired locally when this DN owns the group's manifest,
else ``bad_stripe``-reported so the NN's ``_check_stripe_repair`` monitor
schedules the owner's re-decode.  Both count ``scrub_repairs_triggered``.

Cadence/veto discipline follows the DN's other background monitors
(server/datanode.py:1382 ``_scanner_loop``): injectable clock, byte-rate
throttle (utils/throttler.py), and a health veto — a cycle is skipped
while the node is reduction-degraded or any of its breaker edges is open
(scrubbing a sick node would add load exactly when it can least afford
it, the DataNode.java:2533 background-work discipline).
"""

from __future__ import annotations

import hashlib
import os
import random
import time

from hdrf_tpu_torch.storage import stripe_store
from hdrf_tpu_torch.utils import fault_injection, metrics, qos, retry
from hdrf_tpu_torch.utils.throttler import Throttler

_S = metrics.registry("scrub")

#: tmp-orphan sweep targets, relative to their owning store roots
_TMP_SUFFIX = ".tmp"
#: quarantined-aside suffix: outside every store's served-name patterns
#: (*.raw / *.sealed / *.stripe), so a quarantined file can never be
#: opened by a read path again, across restarts too
QUAR_SUFFIX = ".quar"


class Scrubber:
    """One DataNode's integrity-scrub plane.  ``run_cycle`` is driven by
    the DN's ``-scrubber`` thread (server/datanode.py start()); tests call
    it directly for determinism (the sample_once pattern of
    utils/flight_recorder.py)."""

    def __init__(self, dn, clock=time.monotonic):
        self._dn = dn
        self._clock = clock
        self._rng = random.Random(0x5C12B)
        self._throttler = Throttler(
            int(dn.config.scrub_rate_mb_s * (1 << 20)))
        # foreign stripes carry no local manifest: first scrub records a
        # CRC baseline, later scrubs detect bit-rot against it
        self._stripe_crcs: dict[tuple[str, int, int], int] = {}
        # rotating cursors (VolumeScanner.java:539's position analog)
        self._decode_cursor = 0
        self._replica_cursor = 0
        # census gauges from the last completed cycle (heartbeat payload)
        self._last_census: dict[str, int] = {}
        self._cycles = 0

    # ------------------------------------------------------------- cycle

    def _vetoed(self) -> bool:
        """Health/breaker veto: never add scrub load to a sick node."""
        if self._dn.reduction_degraded:
            return True
        return any(b.state == "open"
                   for b in retry.all_breakers().values())

    def run_cycle(self) -> dict:
        """One full scrub pass; returns the census it gauged."""
        if self._vetoed():
            _S.incr("scrub_cycles_vetoed")
            return dict(self._last_census)
        t0 = self._clock()
        self._throttler.set_rate(
            int(self._dn.config.scrub_rate_mb_s * (1 << 20)))
        self._scrub_containers()
        self._scrub_stripes()
        self._scrub_replicas()
        census = self._census()
        self._cycles += 1
        _S.incr("scrub_cycles")
        _S.observe("scrub_cycle_us", (self._clock() - t0) * 1e6)
        self._last_census = census
        return census

    # --------------------------------------------------- sealed containers

    def _scrub_containers(self) -> None:
        """Sampled chunk-digest re-verification of every sealed container
        the index references."""
        dn = self._dn
        frac = max(0.0, min(1.0, dn.config.scrub_sample_frac))
        for cid in sorted(dn.index.container_live_bytes()):
            if not dn.index.is_sealed(cid):
                continue  # open lane: still mutating under the writer
            if dn.index.stripe_manifest(cid) is not None:
                # demoted to stripes: the sealed file is gone and reads go
                # through the any-k fallback — one corrupt stripe would
                # read as "container corrupt" here and quarantine a
                # REPAIRABLE group.  The stripe sweep + decode spot-check
                # below own this container's integrity story.
                continue
            live = dn.index.live_chunks_in(cid)
            if not live:
                continue
            sample = [h for h in sorted(live)
                      if frac >= 1.0 or self._rng.random() < frac]
            if not sample:
                sample = [min(live)]  # never skip a container outright
            try:
                fault_injection.point("scrub.container", cid=cid)
                data = dn.containers.read_container(cid)
            except (OSError, IOError, ValueError):
                self._on_corrupt_container(cid)
                continue
            self._throttler.throttle(len(data))
            ok = True
            for h in sample:
                off, ln = live[h]
                if hashlib.sha256(data[off:off + ln]).digest() != h:
                    ok = False
                    break
            _S.incr("scrub_bytes_verified",
                    sum(live[h][1] for h in sample))
            if not ok:
                self._on_corrupt_container(cid)

    def _on_corrupt_container(self, cid: int) -> None:
        """Quarantine + fire the re-replication monitor (tentpole c):
        the container's files are renamed aside (never served again),
        every block referencing it is invalidated here and bad_block-
        reported so the NN re-replicates from healthy peers."""
        dn = self._dn
        _S.incr("scrub_corrupt|class=container")
        dn._log.warning("scrub found corrupt container",
                        dn_id=dn.dn_id, cid=cid)
        dn.containers.quarantine(cid)
        bad = []
        for bid in dn.index.block_ids():
            e = dn.index.get_block(bid)
            if e is None:
                continue
            for h in set(e.hashes):
                loc = dn.index.chunk_location(h)
                if loc is not None and loc.container_id == cid:
                    bad.append(bid)
                    break
        for bid in bad:
            for nn in dn._nns:
                try:
                    nn.call("bad_block", dn_id=dn.dn_id, block_id=bid)
                except (OSError, ConnectionError):
                    _S.incr("scrub_errors")
            dn._invalidate(bid)
            _S.incr("scrub_repairs_triggered")

    # ------------------------------------------------------------ stripes

    def _scrub_stripes(self) -> None:
        """CRC every local stripe; rotate one any-k decode spot-check per
        cycle across this DN's owned stripe groups."""
        dn = self._dn
        for owner, cid, idx, nbytes in dn.ec.store.iter_stripes():
            self._throttler.throttle(nbytes)
            try:
                fault_injection.point("scrub.stripe", owner=owner,
                                      cid=cid, idx=idx)
                data = dn.ec.store.read_stripe(owner, cid, idx)
            except (OSError, IOError):
                self._on_corrupt_stripe(owner, cid, idx)
                continue
            from hdrf_tpu_torch import native

            crc = int(native.crc32c(data))
            want = None
            if owner == dn.dn_id:
                man = dn.index.stripe_manifest(cid)
                if man is not None and idx < len(man["crcs"]):
                    want = int(man["crcs"][idx])
            if want is None:
                key = (owner, cid, idx)
                want = self._stripe_crcs.setdefault(key, crc)
            _S.incr("scrub_bytes_verified", nbytes)
            if crc != want:
                self._on_corrupt_stripe(owner, cid, idx)
        # rotating owner-side any-k decode spot-check: proves the group
        # still reconstructs the exact sealed bytes the manifest describes
        manifests = dn.index.stripe_manifests()
        if manifests:
            cids = sorted(manifests)
            cid = cids[self._decode_cursor % len(cids)]
            self._decode_cursor += 1
            man = manifests[cid]
            with qos.background():
                # scrub gathers are background bulk traffic: the control
                # lane keeps them out of every tenant's admission ledger
                got = dn.ec._gather(cid, man)
            try:
                blob = stripe_store.reconstruct_container(
                    got, man, device=dn.ec.device)
                if len(blob) != int(man["length"]):
                    raise stripe_store.StripeCorrupt(
                        f"decode length {len(blob)} != {man['length']}")
                _S.incr("scrub_decode_checks")
                _S.incr("scrub_bytes_verified", len(blob))
            except (stripe_store.StripeCorrupt, ValueError):
                _S.incr("scrub_corrupt|class=stripe")
                _S.incr("scrub_decode_failures")

    def _on_corrupt_stripe(self, owner: str, cid: int, idx: int) -> None:
        """Quarantine the stripe file; repair locally when this DN owns
        the manifest (server/ec_tier.py repair with ourselves as the
        replacement target), else bad_stripe-report so the NN's
        _check_stripe_repair monitor schedules the owner's re-decode."""
        dn = self._dn
        _S.incr("scrub_corrupt|class=stripe")
        dn._log.warning("scrub found corrupt stripe", dn_id=dn.dn_id,
                        owner=owner, cid=cid, idx=idx)
        dn.ec.store.quarantine(owner, cid, idx)
        self._stripe_crcs.pop((owner, cid, idx), None)
        if owner == dn.dn_id and dn.index.stripe_manifest(cid) is not None:
            host, port = dn.addr
            with qos.background():
                # the scrub-triggered repair response runs on the same
                # control lane as NN-scheduled repairs
                dn.ec.repair({"cid": cid, "missing": [idx],
                              "targets": [[dn.dn_id, host, port]]})
        else:
            for nn in dn._nns:
                try:
                    nn.call("bad_stripe", dn_id=dn.dn_id, owner=owner,
                            cid=cid, idx=idx)
                    break
                except (OSError, ConnectionError):
                    _S.incr("scrub_errors")
        _S.incr("scrub_repairs_triggered")

    # ----------------------------------------------------------- replicas

    def _scrub_replicas(self) -> None:
        """Replica invariants for every finalized replica, plus one deep
        length+CRC verification per cycle (rotating cursor)."""
        dn = self._dn
        bids = sorted(dn.replicas.block_ids())
        for bid in bids:
            if dn.replicas.is_rbw(bid):
                continue
            meta = dn.replicas.get_meta(bid)
            if meta is None:
                continue
            fault_injection.point("scrub.replica", block_id=bid)
            if meta.scheme != "direct" and meta.physical_len == 0:
                # reduced replica: its bytes ARE the index entry — a
                # missing entry or dangling chunk ref is a corrupt replica
                entry = dn.index.get_block(bid)
                dangling = entry is None or any(
                    dn.index.chunk_location(h) is None
                    for h in set(entry.hashes))
                if dangling:
                    self._on_corrupt_replica(bid)
        if bids:
            bid = bids[self._replica_cursor % len(bids)]
            self._replica_cursor += 1
            meta = dn.replicas.get_meta(bid)
            if meta is not None and not dn.replicas.is_rbw(bid):
                self._throttler.throttle(max(1, meta.logical_len))
                try:
                    bad = dn.verify_block(bid)
                except (OSError, IOError, ValueError):
                    bad = True
                _S.incr("scrub_bytes_verified", meta.logical_len)
                if bad:
                    self._on_corrupt_replica(bid)

    def _on_corrupt_replica(self, bid: int) -> None:
        dn = self._dn
        _S.incr("scrub_corrupt|class=replica")
        dn._log.warning("scrub found corrupt replica",
                        dn_id=dn.dn_id, block_id=bid)
        for nn in dn._nns:
            try:
                nn.call("bad_block", dn_id=dn.dn_id, block_id=bid)
            except (OSError, ConnectionError):
                _S.incr("scrub_errors")
        dn._invalidate(bid)
        _S.incr("scrub_repairs_triggered")

    # ------------------------------------------------------------- census

    def _tmp_dirs(self) -> list[str]:
        dn = self._dn
        dirs = [v.containers._dir for v in dn.volumes.volumes
                if not v.failed]
        dirs.append(dn.ec.store._dir)
        dirs.append(dn.mirror._store._root)
        return dirs

    def _census(self) -> dict:
        """Gauge the four garbage classes; reclaim what is safely dead
        (aged tmp orphans, segments shadowed by a full replica)."""
        dn = self._dn
        fault_injection.point("scrub.census", dn_id=dn.dn_id)
        now = time.time()
        age_s = dn.config.scrub_tmp_age_s
        tmp_bytes = 0
        quar_bytes = 0
        for d in self._tmp_dirs():
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for name in names:
                path = os.path.join(d, name)
                if name.endswith(_TMP_SUFFIX):
                    try:
                        st = os.stat(path)
                    except OSError:
                        continue
                    if now - st.st_mtime >= age_s:
                        try:
                            os.unlink(path)
                            _S.incr("scrub_tmp_reclaimed")
                            _S.incr("scrub_tmp_reclaimed_bytes", st.st_size)
                        except OSError:
                            tmp_bytes += st.st_size
                    else:
                        tmp_bytes += st.st_size
                elif name.endswith(QUAR_SUFFIX):
                    try:
                        quar_bytes += os.path.getsize(path)
                    except OSError:
                        continue
        # dead-chunk + orphan-loser bytes: container payload minus live
        # (deleted chunks leave the index entirely, chunk_index._apply
        # b"del", so the delta IS the dead set); the index's per-container
        # loser attribution splits the orphan class out of the delta
        live = dn.index.container_live_bytes()
        orphans = dn.index.orphan_bytes()
        dead_bytes = 0
        orphan_bytes = 0
        for v in dn.volumes.volumes:
            if v.failed:
                continue
            store = v.containers
            for cid in store.container_ids():
                payload = self._payload_size(store, cid)
                garbage = max(0, payload - live.get(cid, 0))
                o = min(garbage, orphans.get(cid, 0))
                orphan_bytes += o
                dead_bytes += garbage - o
        # mirror segments shadowed by a full local replica: PR-10 upgrade
        # leftovers — reclaim now, census anything still pending
        seg_bytes = 0
        store = dn.mirror._store
        for bid in store.blocks():
            meta = dn.replicas.get_meta(bid)
            if meta is not None and not dn.replicas.is_rbw(bid):
                dn.mirror.on_full_replica(bid)
        try:
            for name in os.listdir(store._root):
                if name.endswith(".seg"):
                    seg_bytes += os.path.getsize(
                        os.path.join(store._root, name))
        except OSError:
            pass
        census = {"dead_chunks": dead_bytes, "orphan_append": orphan_bytes,
                  "tmp": tmp_bytes, "mirror_segments": seg_bytes,
                  "quarantined": quar_bytes}
        for cls, v in census.items():
            _S.gauge(f"garbage_bytes|class={cls}", v)
        _S.gauge("garbage_bytes_total", sum(census.values()))
        return census

    @staticmethod
    def _payload_size(store, cid: int) -> int:
        """Uncompressed payload size of a container: the sealed header's
        fsync'd ``usize`` (container_store.py:51 _SEAL_HDR), or the raw
        file's size minus the placeholder header."""
        from hdrf_tpu_torch.storage.container_store import (_SEAL_HDR,
                                                            _SEAL_MAGIC)

        try:
            with open(store._sealed_path(cid), "rb") as f:
                hdr = f.read(_SEAL_HDR.size)
            if len(hdr) == _SEAL_HDR.size:
                magic, usize, _codec = _SEAL_HDR.unpack(hdr)
                if magic == _SEAL_MAGIC:
                    return int(usize)
        except OSError:
            pass
        try:
            return max(0, os.path.getsize(store._raw_path(cid))
                       - _SEAL_HDR.size)
        except OSError:
            return 0

    # -------------------------------------------------------------- stats

    def report(self) -> dict:
        """Heartbeat + /stats census payload (server/datanode.py _stats)."""
        return {
            "cycles": self._cycles,
            "bytes_verified": _S.counter("scrub_bytes_verified"),
            "corrupt_total": self.corrupt_total(),
            "garbage_bytes": sum(self._last_census.values()),
            "garbage": dict(self._last_census),
            "repairs_triggered": _S.counter("scrub_repairs_triggered"),
            "tmp_reclaimed": _S.counter("scrub_tmp_reclaimed"),
        }

    @staticmethod
    def corrupt_total() -> int:
        """Sum of the labelled scrub_corrupt counters (the /prom family
        renders as ``scrub_corrupt_total|class=...``)."""
        snap = metrics.registry("scrub").snapshot()
        return sum(int(v) for k, v in snap.get("counters", {}).items()
                   if k.split("|")[0] == "scrub_corrupt")

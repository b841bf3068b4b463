"""Journal backends for the NameNode edit log (port of
hdrf_tpu/server/journal.py, whole: ``_write_atomic``, ``LocalJournal``,
``JournalNode``, ``QuorumJournal`` and the fencing errors; records are
framed with the port's codec, proto/rpc.packb / unpackb, byte for byte
the reference's).

Two interchangeable transports behind ``EditLog`` (server/editlog.py):

- ``LocalJournal`` — a single shared directory with flock-serialized,
  epoch-fenced appends (the NFS-shared-edits deployment).
- ``QuorumJournal`` + ``JournalNode`` — the re-expression of the reference's
  quorum journal (qjournal/client/QuorumJournalManager.java:55 and
  qjournal/server/JournalNode.java:61, ~6.1 kLoC): N journal daemons, every
  edit batch is durable once a MAJORITY acks, epochs fence stale writers at
  each journal node, and becoming active runs segment recovery (promise
  collection, longest-retained-log selection, re-journaling the tail to
  lagging nodes with divergent-tail truncation).

Protocol invariants the quorum path maintains:

- **Per-node prefix property**: every JournalNode holds a contiguous seq
  range [earliest, last]; batches must chain (``first_seq <= last+1``) or
  the node rejects them as ``behind`` and is caught up from the writer's
  in-memory record cache (or reset past a purge gap).
- **Committed floor**: with per-node prefixes, a record is durable iff it is
  on a majority, so the M-th largest ``last_seq`` (M = majority) bounds what
  a standby may apply — a tailer never applies a record that epoch recovery
  could drop.
- **Divergent tails**: an old epoch's unacked records may survive on a
  minority; a newer-epoch batch overlapping a node's tail truncates that
  tail first (``last_write_epoch`` tracked per node).  Like the reference's
  accepted-recovery, an unacked-but-majority-surviving record may be
  resurrected; an acked record is never lost.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any

from hdrf_tpu_torch.proto.rpc import (RpcClient, RpcError, RpcServer,
                                      packb, unpackb)
from hdrf_tpu_torch.utils import fault_injection, metrics
from hdrf_tpu_torch.utils import wal as walmod

_M = metrics.registry("journal")

EPOCH_NAME = "epoch"
WAL_NAME = "edits.wal"


class FencedError(Exception):
    """This writer's epoch is stale: another NN has transitioned to active
    (QJM epoch fencing — journal writes with an old epoch are rejected)."""


class QuorumLostError(Exception):
    """Fewer than a majority of journal nodes acked; the edit is NOT durable
    and the writer must stop acking clients (the reference aborts the NN)."""


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# --------------------------------------------------------------------- local


class LocalJournal:
    """Shared-directory journal: flock-serialized appends, file-based epoch.

    The fence lock is held across epoch-check + write so a concurrent
    ``claim_epoch`` (same lock) cannot interleave — without it a fenced
    writer could slip one record in between its check and its write."""

    def __init__(self, directory: str):
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self._epoch: int | None = None
        self._lock_f = None
        self._wal = None
        self._epoch_cache: int | None = None
        self._epoch_sig: Any = ()

    # -- fencing

    def _fence_lock(self):
        import fcntl

        if self._lock_f is None or self._lock_f.closed:
            self._lock_f = open(os.path.join(self._dir, "journal.lock"), "a+")

        @contextlib.contextmanager
        def held():
            fcntl.flock(self._lock_f.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(self._lock_f.fileno(), fcntl.LOCK_UN)

        return held()

    def exclusive(self):
        """Checkpoint-scope mutual exclusion (image publish + purge must be
        atomic vs a concurrent claim_epoch in the shared-dir deployment)."""
        return self._fence_lock()

    def read_epoch(self) -> int:
        try:
            with open(os.path.join(self._dir, EPOCH_NAME)) as f:
                return int(f.read().strip() or 0)
        except FileNotFoundError:
            return 0

    def claim_epoch(self) -> int:
        with self._fence_lock():
            e = self.read_epoch() + 1
            _write_atomic(os.path.join(self._dir, EPOCH_NAME),
                          str(e).encode())
        self._epoch = e
        self._epoch_sig = ()
        return e

    def check_fence(self) -> None:
        """Raise FencedError iff another writer claimed a newer epoch.  The
        epoch value is cached against the file's stat signature so the hot
        path pays one stat, not an open+read."""
        if self._epoch is None:
            return
        path = os.path.join(self._dir, EPOCH_NAME)
        try:
            st = os.stat(path)
            sig = (st.st_mtime_ns, st.st_ino)
        except FileNotFoundError:
            sig = None
        if sig != self._epoch_sig:
            self._epoch_cache = self.read_epoch()
            self._epoch_sig = sig
        if self._epoch_cache != self._epoch:
            raise FencedError(
                f"epoch {self._epoch} superseded by {self._epoch_cache}")

    # -- records

    def open_for_append(self) -> None:
        self._wal = open(os.path.join(self._dir, WAL_NAME), "ab")

    def append_frames(self, payloads: list[bytes], first_seq: int) -> None:
        """Durably append a batch: one write + one fsync under the fence
        lock (the group-commit unit)."""
        buf = b"".join(walmod.frame(p) for p in payloads)
        with self._fence_lock():
            self.check_fence()
            self._wal.write(buf)
            self._wal.flush()
            os.fsync(self._wal.fileno())

    def read(self, after_seq: int, readonly: bool = True) -> list[bytes]:
        """All retained payloads (EditLog filters by seq).  ``readonly=False``
        additionally truncates a torn tail — writer-side recovery only: a
        standby must never truncate what may be the active's in-flight
        append."""
        return walmod.recover(os.path.join(self._dir, WAL_NAME),
                              truncate=not readonly)

    def earliest(self) -> int:
        return 0  # a local WAL is only ever truncated at a checkpoint

    def purge(self, upto_seq: int) -> None:
        """Checkpoint truncation; caller holds ``exclusive()`` and has
        published an image covering ``upto_seq``."""
        if self._wal is not None:
            self._wal.truncate(0)
            self._wal.seek(0)

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        if self._lock_f is not None:
            self._lock_f.close()
            self._lock_f = None


# -------------------------------------------------------------- journal node


class JournalNode:
    """One member of the edit-log quorum (JournalNode.java analog).

    Holds a contiguous, CRC-framed record range [earliest, last_seq] plus a
    promised epoch; every accepted batch is fsync'd before the ack (the
    writer's majority-wait is what makes an edit durable)."""

    def __init__(self, directory: str, host: str = "127.0.0.1",
                 port: int = 0):
        self._dir = directory
        from hdrf_tpu_torch.storage import version as storage_version

        storage_version.ensure_layout(directory, "journal",
                                      storage_version.JN_UPGRADERS)
        self._lock = threading.Lock()
        self._promised = self._read_int(EPOCH_NAME, 0)
        self._last_write_epoch = self._read_int("wepoch", 0)
        self._earliest = self._read_int("earliest", 0)  # first retained - 1
        self._records: list[tuple[int, bytes]] = []
        for payload in walmod.recover(os.path.join(directory, WAL_NAME)):
            seq, rec = unpackb(payload, use_list=False)
            self._records.append((seq, rec))
        self._wal = open(os.path.join(directory, WAL_NAME), "ab")
        self._rpc = RpcServer(host, port, self, "journalnode")

    def start(self) -> "JournalNode":
        self._rpc.start()
        return self

    def stop(self) -> None:
        self._rpc.stop()
        with self._lock:
            self._wal.close()

    @property
    def addr(self) -> tuple[str, int]:
        return self._rpc.addr

    def _read_int(self, name: str, default: int) -> int:
        try:
            with open(os.path.join(self._dir, name)) as f:
                return int(f.read().strip() or default)
        except FileNotFoundError:
            return default

    def _persist_int(self, name: str, value: int) -> None:
        _write_atomic(os.path.join(self._dir, name), str(value).encode())

    def _last_seq(self) -> int:
        return self._records[-1][0] if self._records else self._earliest

    def _rewrite_wal(self) -> None:
        self._wal.close()
        tmp = os.path.join(self._dir, WAL_NAME + ".tmp")
        with open(tmp, "wb") as f:
            for seq, rec in self._records:
                f.write(walmod.frame(packb([seq, rec])))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self._dir, WAL_NAME))
        self._wal = open(os.path.join(self._dir, WAL_NAME), "ab")

    # -- rpc surface

    def rpc_jn_state(self) -> dict:
        with self._lock:
            return {"promised": self._promised, "last_seq": self._last_seq(),
                    "earliest": self._earliest,
                    "wepoch": self._last_write_epoch}

    def rpc_jn_new_epoch(self, epoch: int) -> dict:
        """Promise phase: refuse anything not beyond the current promise."""
        with self._lock:
            if epoch <= self._promised:
                raise FencedError(f"promised {self._promised} >= {epoch}")
            self._promised = epoch
            self._persist_int(EPOCH_NAME, epoch)
            return {"last_seq": self._last_seq(), "earliest": self._earliest,
                    "wepoch": self._last_write_epoch}

    def rpc_jn_journal(self, epoch: int, first_seq: int,
                       payloads: list[bytes]) -> dict:
        """Append a batch.  A newer-epoch batch overlapping our tail
        truncates the divergent records first; a batch that would leave a
        gap is refused (the writer catches us up instead)."""
        with self._lock:
            if epoch < self._promised:
                raise FencedError(f"promised {self._promised} > {epoch}")
            self._promised = max(self._promised, epoch)
            last = self._last_seq()
            if first_seq > last + 1 or (
                    epoch != self._last_write_epoch and first_seq == last + 1
                    and self._records):
                # Two refusals share the catch-up path: a genuine gap, and a
                # NON-overlapping first write from a new epoch onto a tail
                # that epoch never validated (missed the claim's recovery) —
                # our tail may hold divergent dead-epoch records, and only
                # an overlapping resend triggers the truncation below.
                # ``wepoch`` tells the writer to resend its whole cache
                # rather than from last+1 (which would preserve the stale
                # prefix under a valid-looking suffix).
                return {"behind": last, "wepoch": self._last_write_epoch}
            if first_seq <= last:
                if epoch == self._last_write_epoch:
                    # same writer resent a durable prefix (catch-up overlap):
                    # drop what we already hold
                    payloads = payloads[last + 1 - first_seq:]
                    first_seq = last + 1
                    if not payloads:
                        return {"last_seq": last}
                else:
                    # divergent tail from a dead epoch: truncate, then accept
                    self._records = [r for r in self._records
                                     if r[0] < first_seq]
                    self._rewrite_wal()
            if epoch != self._last_write_epoch:
                self._last_write_epoch = epoch
                self._persist_int("wepoch", epoch)
            buf = bytearray()
            for i, p in enumerate(payloads):
                self._records.append((first_seq + i, p))
                buf += walmod.frame(packb([first_seq + i, p]))
            fault_injection.point("journalnode.append")
            self._wal.write(bytes(buf))
            self._wal.flush()
            os.fsync(self._wal.fileno())
            _M.incr("batches_journaled")
            return {"last_seq": self._last_seq()}

    def rpc_jn_read(self, after_seq: int, limit: int = 5000) -> dict:
        with self._lock:
            out = [(s, p) for s, p in self._records if s > after_seq][:limit]
            return {"records": out, "last_seq": self._last_seq(),
                    "earliest": self._earliest}

    def rpc_jn_purge(self, epoch: int, upto_seq: int) -> bool:
        """Drop records <= upto_seq (the writer checkpointed an image
        covering them)."""
        with self._lock:
            if epoch < self._promised:
                raise FencedError(f"promised {self._promised} > {epoch}")
            if upto_seq <= self._earliest:
                return True
            self._records = [r for r in self._records if r[0] > upto_seq]
            self._earliest = max(self._earliest, upto_seq)
            self._persist_int("earliest", self._earliest)
            self._rewrite_wal()
            _M.incr("purges")
            return True

    def rpc_jn_accept(self, epoch: int, upto_seq: int) -> bool:
        """Claim-recovery epilogue: the new writer validated our tail up to
        ``upto_seq`` (it matches the recovered canon), so adopt the epoch as
        our write epoch — future appends chain without the catch-up dance."""
        with self._lock:
            if epoch < self._promised:
                raise FencedError(f"promised {self._promised} > {epoch}")
            if self._last_seq() <= upto_seq and \
                    epoch != self._last_write_epoch:
                self._last_write_epoch = epoch
                self._persist_int("wepoch", epoch)
            return True

    def rpc_jn_reset(self, epoch: int, earliest: int) -> bool:
        """Writer-directed reset past a gap this node can never fill (its
        missing records were purged after an image covered them)."""
        with self._lock:
            if epoch < self._promised:
                raise FencedError(f"promised {self._promised} > {epoch}")
            self._records = [r for r in self._records if r[0] > earliest]
            if self._records and self._records[0][0] != earliest + 1:
                self._records = []  # still gapped: drop and resync from here
            self._earliest = earliest
            self._persist_int("earliest", earliest)
            self._rewrite_wal()
            return True


# ------------------------------------------------------------------- quorum


class QuorumJournal:
    """Writer/reader client over N JournalNodes (QuorumJournalManager
    analog).  Appends go to every node in parallel; durability = majority
    acks.  Laggards are caught up from the in-memory record cache (bounded:
    the cache is dropped at each checkpoint purge)."""

    def __init__(self, addrs: list[tuple[str, int]], timeout: float = 5.0):
        self._addrs = [tuple(a) for a in addrs]
        self._n = len(self._addrs)
        self._majority = self._n // 2 + 1
        self._timeout = timeout
        self._epoch: int | None = None
        self._recovered_hi = 0
        self._cache: list[tuple[int, bytes]] = []  # since last purge
        self._cache_lock = threading.Lock()
        self._clients: dict[tuple, RpcClient] = {}
        self._client_locks = {a: threading.Lock() for a in self._addrs}

    # -- plumbing

    def _call(self, addr: tuple, method: str, **kw):
        with self._client_locks[addr]:
            c = self._clients.get(addr)
            if c is None:
                c = self._clients[addr] = RpcClient(addr,
                                                    timeout=self._timeout)
            try:
                return c.call(method, **kw)
            except (OSError, ConnectionError):
                self._clients.pop(addr, None)
                c.close()
                raise

    def _fanout(self, method: str, **kw) -> dict[tuple, Any]:
        """Call every node in parallel; map addr -> result | Exception."""
        out: dict[tuple, Any] = {}
        threads = []

        def one(a):
            try:
                out[a] = self._call(a, method, **kw)
            except Exception as e:  # noqa: BLE001 — per-node fault isolation
                out[a] = e

        for a in self._addrs:
            t = threading.Thread(target=one, args=(a,), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(self._timeout + 1)
        return out

    @staticmethod
    def _is_fenced(r: Any) -> bool:
        return isinstance(r, RpcError) and r.error == "FencedError"

    # -- writer

    def read_epoch(self) -> int:
        rs = self._fanout("jn_state")
        oks = [r for r in rs.values() if isinstance(r, dict)]
        if len(oks) < self._majority:
            raise QuorumLostError(f"{len(oks)}/{self._n} journal nodes up")
        return max(r["promised"] for r in oks)

    def claim_epoch(self) -> int:
        """Promise + recovery: fence out older writers on a majority, pick
        the longest retained log among promisers, re-journal its tail to the
        laggards (truncating divergent dead-epoch tails)."""
        states = self._fanout("jn_state")
        oks = {a: r for a, r in states.items() if isinstance(r, dict)}
        if len(oks) < self._majority:
            raise QuorumLostError(f"{len(oks)}/{self._n} journal nodes up")
        e = max(r["promised"] for r in oks.values()) + 1
        promises = self._fanout("jn_new_epoch", epoch=e)
        prom = {a: r for a, r in promises.items() if isinstance(r, dict)}
        if len(prom) < self._majority:
            raise QuorumLostError(
                f"only {len(prom)}/{self._n} promised epoch {e}")
        self._epoch = e
        self._recovered_hi = 0
        # Recovery (the accepted-recovery simplification of QJM's paxos):
        # the canonical log is the promiser with the newest write epoch,
        # longest log as tiebreak — any record acked by the dead writer is
        # on a majority, every majority intersects the promisers, and the
        # newest-epoch holder's log contains every acked record (older-epoch
        # logs were validated or rewritten by that epoch's own recovery).
        best_addr, best_state = max(
            prom.items(),
            key=lambda kv: (kv[1]["wepoch"], kv[1]["last_seq"]))
        hi = best_state["last_seq"]
        canon: list[tuple[int, bytes]] = []
        after = best_state["earliest"]
        while after < hi:
            r = self._call(best_addr, "jn_read", after_seq=after)
            recs = [(int(s), p) for s, p in r["records"]]
            if not recs:
                break
            canon.extend(recs)
            after = recs[-1][0]
        for a, st in prom.items():
            if a == best_addr or (st["wepoch"] == best_state["wepoch"]
                                  and st["last_seq"] >= hi):
                continue
            # Divergence can hide anywhere a different write epoch touched,
            # so laggards get the WHOLE retained canon with overlap — the
            # node-side truncation rule rewrites their suffix.  A node whose
            # retained range can't overlap the canon (stale prefix below the
            # purge horizon, or a refused non-overlapping chain) is reset
            # first: everything below the canon is committed, image-covered
            # content.
            try:
                if st["wepoch"] != best_state["wepoch"] or \
                        st["last_seq"] < best_state["earliest"]:
                    self._call(a, "jn_reset", epoch=e,
                               earliest=best_state["earliest"])
                if canon:
                    rr = self._call(a, "jn_journal", epoch=e,
                                    first_seq=canon[0][0],
                                    payloads=[p for _, p in canon])
                    if isinstance(rr, dict) and "behind" in rr:
                        self._call(a, "jn_reset", epoch=e,
                                   earliest=canon[0][0] - 1)
                        self._call(a, "jn_journal", epoch=e,
                                   first_seq=canon[0][0],
                                   payloads=[p for _, p in canon])
            except Exception:  # noqa: BLE001 — laggard recovery best-effort
                _M.incr("recovery_catchup_errors")
        # Validate every promiser's (now canonical) tail for this epoch so
        # plain appends chain without the catch-up dance; a node that missed
        # this (or the whole claim) stays unvalidated and gets the
        # whole-cache resend on first contact.
        self._fanout("jn_accept", epoch=e, upto_seq=hi)
        with self._cache_lock:
            self._cache = canon
        self._recovered_hi = hi
        return e

    def check_fence(self) -> None:
        return  # fencing is enforced by the nodes on every append

    def exclusive(self):
        return contextlib.nullcontext()

    def open_for_append(self) -> None:
        return

    def append_frames(self, payloads: list[bytes], first_seq: int) -> None:
        assert self._epoch is not None, "append before claim_epoch"
        with self._cache_lock:
            self._cache.extend(
                (first_seq + i, p) for i, p in enumerate(payloads))
            cache = list(self._cache)
        rs = self._fanout("jn_journal", epoch=self._epoch,
                          first_seq=first_seq, payloads=payloads)
        acks = 0
        for a, r in rs.items():
            if self._is_fenced(r):
                raise FencedError(str(r))
            if isinstance(r, dict) and "behind" in r:
                # Laggard: replay the missing suffix from the cache, then
                # count it if the catch-up covered this batch.  A node whose
                # last write came from an OLDER epoch gets the whole cache —
                # its tail below `behind` may hold divergent dead-epoch
                # records, and only an overlapping batch triggers the
                # node-side truncation that replaces them.
                try:
                    floor = (r["behind"] if r.get("wepoch") == self._epoch
                             else -1)
                    send = [(s, p) for s, p in cache if s > floor]
                    if send:
                        rr = self._call(a, "jn_journal", epoch=self._epoch,
                                        first_seq=send[0][0],
                                        payloads=[p for _, p in send])
                        if isinstance(rr, dict) and "behind" in rr:
                            # The node's records predate the cache (its
                            # missing range was purged into an image):
                            # reset it past the gap, then resend.  Safe —
                            # everything below the cache is committed and
                            # image-covered.
                            self._call(a, "jn_reset", epoch=self._epoch,
                                       earliest=send[0][0] - 1)
                            rr = self._call(a, "jn_journal",
                                            epoch=self._epoch,
                                            first_seq=send[0][0],
                                            payloads=[p for _, p in send])
                        if isinstance(rr, dict) and "behind" not in rr:
                            acks += 1
                except Exception as e:  # noqa: BLE001
                    if self._is_fenced(e):
                        raise FencedError(str(e)) from None
                    _M.incr("catchup_errors")
            elif isinstance(r, dict):
                acks += 1
        if acks < self._majority:
            raise QuorumLostError(
                f"{acks}/{self._n} journal acks for seq {first_seq}")

    # -- reader

    def read(self, after_seq: int, readonly: bool = True) -> list[bytes]:
        """Payloads after ``after_seq``.  A readonly tailer stops at the
        committed floor — the majority-th largest last_seq (with per-node
        prefixes, a record on a majority is exactly one at or below it), so
        it never applies a record epoch recovery could drop.  The writer
        path runs post-claim and is bounded by the RECOVERY CANON, not the
        max reachable last_seq: a node that was down through the claim and
        rejoined may carry unvalidated dead-epoch records above the canon,
        which the writer must not replay (its next append overwrites them
        via the node-side truncation rule instead)."""
        rs = self._fanout("jn_state")
        oks = {a: r for a, r in rs.items() if isinstance(r, dict)}
        if len(oks) < self._majority:
            raise QuorumLostError(f"{len(oks)}/{self._n} journal nodes up")
        # Only nodes on the NEWEST write-epoch lineage are trustworthy: a
        # node that was down through epoch recovery can rejoin holding
        # divergent dead-epoch records at the same seqs (its tail is only
        # truncated by the writer's next overlapping append).  Counting its
        # last_seq toward the floor — or reading from it — would let a
        # standby apply uncommitted records that contradict what the active
        # acked.  Epochs are monotone, so max(wepoch) identifies the canon.
        wmax = max(r["wepoch"] for r in oks.values())
        canon = {a: r for a, r in oks.items() if r["wepoch"] == wmax}
        if readonly:
            if len(canon) < self._majority:
                # can't certify a committed floor from this view (e.g. a
                # brand-new epoch caught up only a minority before we
                # polled): make no progress this tick rather than risk
                # applying an uncommitted record
                return []
            lasts = sorted((r["last_seq"] for r in canon.values()),
                           reverse=True)
            floor = lasts[self._majority - 1]
        else:
            assert self._epoch is not None, "writer read before claim_epoch"
            floor = self._recovered_hi
        out: list[bytes] = []
        cands = [(a, r) for a, r in canon.items() if r["last_seq"] >= floor]
        if not cands:
            # writer path only (readonly floors come FROM canon): a newer
            # claimant's write epoch appeared and none of its nodes cover
            # our recovered range — we are superseded, not merely degraded
            if not readonly and self._epoch is not None \
                    and wmax > self._epoch:
                raise FencedError(
                    f"epoch {self._epoch} superseded by write epoch {wmax}")
            raise QuorumLostError("no journal node holds the committed range")
        src = max(cands, key=lambda kv: kv[1]["last_seq"])[0]
        after = after_seq
        while after < floor:
            r = self._call(src, "jn_read", after_seq=after)
            if r["earliest"] > after:
                # records (after, earliest] were purged into an image this
                # reader doesn't have — silently skipping them would corrupt
                # the replayed namespace
                raise JournalGapError(r["earliest"])
            recs = [(int(s), p) for s, p in r["records"] if int(s) <= floor]
            if not recs:
                break
            out.extend(p for _, p in recs)
            after = recs[-1][0]
        return out

    def earliest(self) -> int:
        rs = self._fanout("jn_state")
        es = [r["earliest"] for r in rs.values() if isinstance(r, dict)]
        if not es:
            raise QuorumLostError("no journal nodes reachable")
        return min(es)

    def purge(self, upto_seq: int) -> None:
        assert self._epoch is not None
        with self._cache_lock:
            self._cache = [(s, p) for s, p in self._cache if s > upto_seq]
        self._fanout("jn_purge", epoch=self._epoch, upto_seq=upto_seq)

    def close(self) -> None:
        for c in self._clients.values():
            c.close()
        self._clients.clear()


class JournalGapError(Exception):
    """The journal's earliest retained record is past what this reader has:
    it must fetch a newer fsimage (from the active peer) before tailing."""

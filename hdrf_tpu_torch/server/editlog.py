"""NameNode persistence: edit log + fsimage checkpoints (port of
hdrf_tpu/server/editlog.py ``EditLog``, whole; records and images are
packed and read with the port's codec, proto/rpc.packb / unpackb, so both
packages read and write the same bytes).

Analog of the reference's FSEditLog (FSEditLog.java:124 — WAL of namespace
mutations, group-committed) and FSImage (FSImage.java:85 — periodic protobuf
snapshot; fsimage.proto).  Same durability discipline as the chunk index
(index/chunk_index.py): log-before-apply, seqno-idempotent replay so
a crash between image publish and WAL truncation cannot double-apply, torn
tails dropped via CRC framing (utils/wal.py).

Two pieces compose here:

- a **journal backend** (server/journal.py): either the flock-fenced shared
  directory (``LocalJournal``) or the JournalNode quorum (``QuorumJournal``,
  the qjournal re-expression) — selected by ``journal_addrs``.
- **group commit** (the reference's ``FSEditLog.logSync`` design,
  FSEditLog.java:124): mutations buffer under the namesystem lock via
  ``append_async`` and become durable in batches via ``sync`` — the first
  thread to need durability becomes the sync leader and flushes everyone's
  buffered records with ONE backend append (one fsync locally / one quorum
  round), while followers wait on the condition.  Callers that cannot
  tolerate the restructure use ``append`` (= append_async + sync).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

from hdrf_tpu_torch.proto.rpc import packb, unpackb
from hdrf_tpu_torch.server.journal import (  # noqa: F401  (re-exported API)
    FencedError, JournalGapError, LocalJournal, QuorumJournal,
    QuorumLostError, _write_atomic)
from hdrf_tpu_torch.utils import fault_injection

IMG_NAME = "fsimage"
IMG_TMP = "fsimage.tmp"


class EditLog:
    def __init__(self, directory: str, checkpoint_every: int = 1000,
                 journal_addrs: list | None = None):
        """``directory`` holds the fsimage (and, without ``journal_addrs``,
        the shared journal); with ``journal_addrs`` the edits live on that
        JournalNode quorum and only the image is local."""
        self._dir = directory
        os.makedirs(directory, exist_ok=True)
        self.seq = 0            # last seqno applied (image seq after load)
        self._ops_since_ckpt = 0
        self._checkpoint_every = checkpoint_every
        self._snapshot_fn: Callable[[], Any] | None = None
        self.journal = (QuorumJournal(journal_addrs) if journal_addrs
                        else LocalJournal(directory))
        self._appendable = False
        # group-commit state
        self._buf_lock = threading.Lock()
        self._sync_cond = threading.Condition()
        self._buffered: list[bytes] = []
        self._buf_first_seq = 0   # seq of _buffered[0]
        self._buffered_seq = 0    # last buffered seq
        self._durable_seq = 0
        self._syncing = False

    # ----------------------------------------------------------- HA fencing

    def read_epoch(self) -> int:
        return self.journal.read_epoch()

    def claim_epoch(self) -> int:
        return self.journal.claim_epoch()

    # -------------------------------------------------------------- recovery

    def load_image(self) -> Any | None:
        """Returns the fsimage snapshot (or None) and primes ``seq``."""
        img = os.path.join(self._dir, IMG_NAME)
        if not os.path.exists(img):
            return None
        with open(img, "rb") as f:
            seq, snapshot = unpackb(f.read())
        self.seq = seq
        return snapshot

    def replay(self, apply_fn: Callable[[list], None],
               readonly: bool = False) -> int:
        """Replay journal records newer than the image; returns count
        applied.  Call once, after load_image, before open_for_append.  The
        writer path (``readonly=False``) also truncates a torn local tail so
        appends continue at the good prefix; a standby tailer passes
        ``readonly`` — it must never truncate the active's journal and never
        applies past the quorum's committed floor."""
        n = 0
        for payload in self.journal.read(self.seq, readonly=readonly):
            seq, *rec = unpackb(payload)
            if seq > self.seq:
                apply_fn(rec)
                self.seq = seq
                n += 1
        if not readonly:
            self._durable_seq = self._buffered_seq = self.seq
            self._buf_first_seq = self.seq + 1
        return n

    def tail(self, apply_fn: Callable[[list], None],
             reload_fn: Callable[[Any], None] | None = None,
             readonly: bool = True) -> int:
        """Standby-side incremental catch-up (EditLogTailer.java:74 analog):
        if a newer fsimage is visible locally (shared-dir deployments: the
        active's checkpoint truncated the journal), reload it first, then
        apply records past ``seq``.

        The final catch-up during promotion passes ``readonly=False``: the
        caller has claimed the epoch and is the sole journal writer (local
        mode additionally truncates a torn tail, without which every
        subsequently acked edit would be unreachable to replay)."""
        img = os.path.join(self._dir, IMG_NAME)
        if os.path.exists(img) and reload_fn is not None:
            with open(img, "rb") as f:
                seq, snapshot = unpackb(f.read())
            if seq > self.seq:
                reload_fn(snapshot)
                self.seq = seq
        return self.replay(apply_fn, readonly=readonly)

    def open_for_append(self, snapshot_fn: Callable[[], Any]) -> None:
        """``snapshot_fn`` is called at checkpoint time to capture the
        current namespace state."""
        self._snapshot_fn = snapshot_fn
        self.journal.open_for_append()
        self._appendable = True
        self._durable_seq = self._buffered_seq = self.seq
        self._buf_first_seq = self.seq + 1

    # --------------------------------------------------------------- logging

    def append_async(self, rec: list) -> int:
        """Assign the next seqno and buffer the record; durable only after
        ``sync`` covers the returned seq.  Called under the namesystem lock;
        does NOT touch the journal (that's the whole point: the fsync leaves
        the lock hold time)."""
        fault_injection.point("editlog.append")
        self.journal.check_fence()  # cheap (stat-cached locally; no-op quorum)
        with self._buf_lock:
            seq = self._buffered_seq + 1
            self._buffered.append(packb([seq, *rec]))
            self._buffered_seq = seq
        self.seq = seq
        self._ops_since_ckpt += 1
        return seq

    def sync(self, seq: int) -> None:
        """Group commit (logSync): wait until records <= seq are durable.
        The first waiter becomes the leader and appends the WHOLE buffer as
        one backend batch; concurrent waiters ride the same fsync/quorum
        round.  Raises FencedError/QuorumLostError if durability cannot be
        promised — the caller must stop acking and demote."""
        while True:
            with self._sync_cond:
                if self._durable_seq >= seq:
                    return
                if seq > self._buffered_seq:
                    # This instance never buffered `seq` — the caller holds
                    # a pending seq from a PREVIOUS editlog (demotion swap).
                    # Without this check the leader round below would find
                    # an empty buffer and spin forever.
                    raise FencedError(
                        f"seq {seq} was never buffered here (demoted?)")
                if self._syncing:
                    self._sync_cond.wait(timeout=30)
                    continue
                self._syncing = True
            try:
                with self._buf_lock:
                    batch = self._buffered
                    first = self._buf_first_seq
                    last = self._buffered_seq
                    self._buffered = []
                    self._buf_first_seq = last + 1
                if batch:
                    try:
                        self.journal.append_frames(batch, first)
                    except Exception:
                        # Not durable: put the batch back so a retry (or a
                        # later leader) still covers these seqs in order.
                        with self._buf_lock:
                            self._buffered = batch + self._buffered
                            self._buf_first_seq = first
                        raise
                with self._sync_cond:
                    self._durable_seq = max(self._durable_seq, last)
            finally:
                with self._sync_cond:
                    self._syncing = False
                    self._sync_cond.notify_all()

    def append(self, rec: list) -> None:
        """Durably log one mutation (append_async + sync — the non-batched
        compatibility path for callers outside the RPC fast path)."""
        self.sync(self.append_async(rec))

    # ----------------------------------------------------------- checkpoints

    def should_checkpoint(self) -> bool:
        return self._appendable and \
            self._ops_since_ckpt >= self._checkpoint_every

    def checkpoint(self) -> None:
        """Publish an fsimage covering everything durable, then drop the
        covered journal prefix.  MUST be called with all applied records
        already synced (the namespace snapshot must not embed edits the
        journal could lose).  Local mode holds the journal's exclusive lock
        across check + image publish + truncate so a just-fenced old active
        cannot erase edits the new active acked; quorum mode needs no
        global lock — the purge itself is epoch-checked at every node."""
        self.sync(self._buffered_seq)
        with self.journal.exclusive():
            self.journal.check_fence()
            snapshot = self._snapshot_fn() if self._snapshot_fn else None
            self.write_image(self.seq, snapshot)
            fault_injection.point("editlog.post_checkpoint")
            self.journal.purge(self.seq)
        self._ops_since_ckpt = 0

    def write_image(self, seq: int, snapshot: Any) -> None:
        _write_atomic(os.path.join(self._dir, IMG_NAME),
                      packb([seq, snapshot]))

    def read_image_bytes(self) -> bytes | None:
        """Raw fsimage bytes (standby bootstrap fetch, rpc_fetch_image)."""
        try:
            with open(os.path.join(self._dir, IMG_NAME), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def write_image_bytes(self, data: bytes) -> None:
        """Install a peer's fsimage (quorum-mode standby that fell behind
        the journal's purge horizon); primes ``seq`` on next load_image."""
        _write_atomic(os.path.join(self._dir, IMG_NAME), data)

    def close(self) -> None:
        self.journal.close()

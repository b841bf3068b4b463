"""Automatic failover controller (the ZKFC analog, minus ZooKeeper; port of
hdrf_tpu/server/failover.py ``FailoverController``, whole).

The reference's DFSZKFailoverController watches NN health via RPC and uses a
ZooKeeper leader lock to coordinate who promotes whom
(DFSZKFailoverController.java:63; HAZKInfo.proto).  Here
the shared journal's epoch IS the lock (editlog.claim_epoch fences the old
writer), so the controller only needs health checking + a promote call:
poll every NN's ha_state; once the active is settled-dead, transition the
reachable STANDBY with the highest applied txid (the most-caught-up
replica — promoting a lagged one forfeits quorum-committed edits until its
catch-up tail runs, and in shared-dir mode forfeits them for good).
Observers are never candidates: they are read replicas by contract
(ObserverReadProxyProvider semantics) and keep serving staleness-bounded
reads THROUGH the failover window.  Safe under split brain by
construction — two controllers racing both call transition_to_active, the
second claim_epoch wins, the first active gets fenced on its next append.

Miss tracking is per NN endpoint, not global: a flaky probe target that
happens to be polled alongside a healthy active must not age the global
counter toward a spurious failover, and — the inverse failure the global
counter had — one reachable-but-slow endpoint resetting a shared counter
must not mask an active that is actually down.
"""

from __future__ import annotations

import threading

from hdrf_tpu_torch.proto.rpc import RpcClient
from hdrf_tpu_torch.utils import metrics

_M = metrics.registry("failover")


class FailoverController:
    def __init__(self, nn_addrs: list[tuple[str, int]],
                 probe_interval_s: float = 1.0, grace: int = 3):
        self._addrs = [tuple(a) for a in nn_addrs]
        self._interval = probe_interval_s
        self._grace = grace
        # per-endpoint consecutive probe misses + the last addr seen in the
        # active role: "the active is dead" requires ITS endpoint to have
        # missed `grace` straight probes (or to answer in a demoted role),
        # not merely `grace` rounds with no active in sight.
        self._misses: dict[tuple, int] = {a: 0 for a in self._addrs}
        self._active_addr: tuple | None = None
        self._rounds_without_active = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="zkfc",
                                        daemon=True)

    def start(self) -> "FailoverController":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def probe(self) -> tuple[bool, list[tuple[tuple, str, int]]]:
        """(active_alive, [(addr, role, applied_txid) per reachable NN])."""
        states = []
        active_alive = False
        for addr in self._addrs:
            try:
                with RpcClient(addr, timeout=2.0) as c:
                    st = c.call("ha_state")
            except (OSError, ConnectionError):
                self._misses[addr] = self._misses.get(addr, 0) + 1
                continue
            self._misses[addr] = 0
            txid = int(st.get("applied_txid", st.get("seq", 0)) or 0)
            states.append((addr, st["role"], txid))
            if st["role"] == "active":
                active_alive = True
                self._active_addr = addr
        return active_alive, states

    @staticmethod
    def _choose_candidate(states: list[tuple[tuple, str, int]]
                          ) -> tuple | None:
        """The reachable standby with the highest applied txid; observers
        are read replicas, never failover candidates."""
        best: tuple | None = None
        best_txid = -1
        for addr, role, txid in states:
            if role != "standby":
                continue
            if txid > best_txid:
                best, best_txid = addr, txid
        return best

    def _active_settled_dead(self, states) -> bool:
        """True once the evidence points at the ACTIVE being down, not at a
        flaky probe path: its endpoint missed `grace` straight probes, or
        it answered in a non-active role (demoted/fenced — no grace
        needed), or no active was ever seen for `grace` rounds."""
        known = self._active_addr
        if known is None:
            return self._rounds_without_active >= self._grace
        if any(addr == known for addr, _role, _txid in states):
            return True  # reachable but no longer active: already fenced
        return self._misses.get(known, 0) >= self._grace

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                active_alive, states = self.probe()
                if active_alive:
                    self._rounds_without_active = 0
                    continue
                self._rounds_without_active += 1
                _M.incr("active_misses")
                if not self._active_settled_dead(states):
                    continue
                cand = self._choose_candidate(states)
                if cand is None:
                    continue  # only observers/nothing reachable: keep probing
                with RpcClient(cand, timeout=5.0) as c:
                    c.call("transition_to_active")
                _M.incr("failovers_triggered")
                self._rounds_without_active = 0
                self._active_addr = cand
            except Exception:  # noqa: BLE001 — controller must survive
                _M.incr("controller_errors")

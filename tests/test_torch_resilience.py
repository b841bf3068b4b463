"""The crash points and the degraded paths of the port (utils/fault_injection,
utils/retry, index/chunk_index.py and its WAL, storage/container_store.py
seals, storage/replica_store.py finalize, server/journal.py,
server/namenode.py's monitor, the DataNode's mirror health and worker
breaker) against the reference (tests/test_resilience.py).

Each case drives both packages through the same steps on the same seeded
bytes, with the same fault injected at the same point
(``fault_injection.inject``), and collects what each observes into a
dict: the state after the crash and after the restart or retry — WAL
and checkpoint bytes, container files, refcounts, replica ids, journal
sequence numbers, counter deltas, the breaker's states and transition
counters.  The port's dict must equal the reference's, exactly; where a
value depends on the scheduler (which DataNode heads a pipeline, how
many monitor ticks a fault spans) the dict holds what does not: the
count, the set, or whether it happened.  ``Deadline``,
``call_with_retries``, ``CircuitBreaker`` and ``bind_remaining`` are held
against the reference in tests/test_torch_index.py, test_torch_ec.py and
test_torch_worker.py; the full-jitter sequence is compared here.

Also here: a block write that outlasts the NameNode's lease
(``LeaseManager.expiry_s``): the reference's client, which renews only
between blocks, loses the file to lease recovery; the port's
``LeaseRenewer`` keeps the lease and the file completes.
"""

from __future__ import annotations

import importlib
import os
import random
import socket
import threading
import time

import numpy as np
import pytest

from _dn_standin import data_files, guard_reference_stat_race

PKGS = ["ref", "port"]


def _mod(pkg: str, path: str):
    return importlib.import_module(
        ("hdrf_tpu." if pkg == "ref" else "hdrf_tpu_torch.") + path)


def _bytes(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, np.uint8).tobytes()


def _counter(pkg: str, reg: str, name: str) -> int:
    return _mod(pkg, "utils.metrics").registry(reg).counter(name)


def _client(mc, pkg: str, name: str):
    return mc.client(name, **({"device": "cpu"} if pkg == "port" else {}))


class Boom(Exception):
    pass


def _raise(exc):
    def fire(**kw):
        raise exc
    return fire


def _once(exc):
    """A fault that fires on the first call only; ``.fired`` says so."""
    fired = threading.Event()

    def fire(**kw):
        if not fired.is_set():
            fired.set()
            raise exc
    fire.fired = fired
    return fire


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    guard_reference_stat_race(monkeypatch)
    for pkg in PKGS:
        _mod(pkg, "utils.retry").reset_breakers()
    yield
    for pkg in PKGS:
        _mod(pkg, "utils.retry").reset_breakers()
        _mod(pkg, "utils.fault_injection").clear()


def test_full_jitter_sequence_equal():
    """``backoff_delays`` with one seeded rng: the same delays in both
    packages, each in ``[0, min(cap, base * 2**i)]``."""
    seqs = [list(_mod(pkg, "utils.retry").backoff_delays(
        6, base_s=1.0, cap_s=4.0, rng=random.Random(7))) for pkg in PKGS]
    assert len(seqs[0]) == 6
    assert all(0.0 <= d <= min(4.0, 2.0 ** i) for i, d in enumerate(seqs[0]))
    assert seqs[1] == seqs[0]


# ------------------------------------------------ the chunk index's WAL


def h(i: int) -> bytes:
    return bytes([i]) * 32


def _index_case(pkg: str, case: str, root: str) -> dict:
    """One crash-ordering script on ``pkg``'s ChunkIndex in ``root``; what
    it observes, and every file it leaves."""
    ChunkIndex = _mod(pkg, "index.chunk_index").ChunkIndex
    fi = _mod(pkg, "utils.fault_injection")
    obs: list = []

    def ref(idx, i):
        loc = idx.chunk_location(h(i))
        return None if loc is None else loc.refcount

    if case == "wal_append_leaves_memory":
        # test_wal_append_crash_leaves_memory_untouched
        idx = ChunkIndex(root)
        with fi.inject("index.wal_append", _raise(OSError("disk full"))):
            with pytest.raises(OSError, match="disk full"):
                idx.commit_block(1, 10, [h(1)], {h(1): (0, 0, 10)})
        obs += [idx.has_block(1), ref(idx, 1)]
        idx.commit_block(1, 10, [h(1)], {h(1): (0, 0, 10)})   # the retry
        obs.append(ref(idx, 1))
        idx.close()
        idx = ChunkIndex(root)
        obs.append(ref(idx, 1))
    elif case == "wal_append_keeps_prior_blocks":
        # test_wal_append_crash_preserves_prior_blocks
        idx = ChunkIndex(root)
        idx.commit_block(1, 10, [h(1)], {h(1): (0, 0, 10)})
        with fi.inject("index.wal_append", _raise(Boom())):
            with pytest.raises(Exception):
                idx.commit_block(2, 20, [h(2)], {h(2): (0, 10, 20)})
        idx.close()
        idx = ChunkIndex(root)
        obs += [idx.has_block(1), idx.has_block(2), ref(idx, 1)]
        idx.commit_block(2, 20, [h(2)], {h(2): (0, 10, 20)})
        obs.append(ref(idx, 2))
    elif case == "post_checkpoint_crash":
        # test_auto_checkpoint_post_crash_no_double_apply
        idx = ChunkIndex(root, checkpoint_every=2)
        idx.commit_block(1, 10, [h(1)], {h(1): (0, 0, 10)})
        with fi.inject("index.post_checkpoint", _raise(Boom())):
            with pytest.raises(Exception):
                idx.commit_block(2, 20, [h(2)], {h(2): (0, 10, 20)})
        idx.close()
        idx = ChunkIndex(root)
        obs += [ref(idx, 1), ref(idx, 2), idx.delete_block(1),
                idx.delete_block(2)]
    elif case == "torn_final_record":
        # test_torn_final_wal_record_dropped_after_checkpoint
        idx = ChunkIndex(root)
        idx.commit_block(1, 10, [h(1)], {h(1): (0, 0, 10)})
        idx.checkpoint()
        idx.commit_block(2, 20, [h(2)], {h(2): (0, 10, 20)})
        idx.commit_block(3, 30, [h(3)], {h(3): (0, 30, 30)})
        idx.close()
        wal = os.path.join(root, "index.wal")
        with open(wal, "rb") as f:
            body = f.read()
        with open(wal, "wb") as f:
            f.write(body[:-3])                  # died mid-append of block 3
        idx = ChunkIndex(root)
        obs += [idx.has_block(1), idx.has_block(2), idx.has_block(3),
                ref(idx, 1), ref(idx, 2)]
        idx.commit_block(3, 30, [h(3)], {h(3): (0, 30, 30)})
        obs.append(idx.has_block(3))
    idx.close()
    return {"observed": obs, "files": data_files(root)}


INDEX_EXPECTED = {
    "wal_append_leaves_memory": [False, None, 1, 1],
    "wal_append_keeps_prior_blocks": [True, False, 1, 1],
    "post_checkpoint_crash": [1, 1, [h(1)], [h(2)]],
    "torn_final_record": [True, True, False, 1, 1, True],
}


@pytest.mark.parametrize("case", sorted(INDEX_EXPECTED))
def test_index_crash_ordering(tmp_path, case):
    """Log before apply: a failed WAL append mutates nothing and its retry
    lands once; a crash after an automatic checkpoint's publish replays
    without applying twice; a torn last record is dropped and the log
    goes on.  The reference's observations are the reference test's
    assertions; the port's, and its WAL and checkpoint bytes, equal
    them."""
    ref, port = (_index_case(pkg, case, str(tmp_path / pkg)) for pkg in PKGS)
    assert ref["observed"] == INDEX_EXPECTED[case]
    assert port["observed"] == ref["observed"]
    assert port["files"] == ref["files"]


# ------------------------------------------------------- the seal crash


def _seal_crash(pkg: str, root: str) -> dict:
    """test_seal_crash_loses_no_chunks: a crash inside ``seal`` before the
    sealed file is published; the raw container survives, every chunk
    reads, and the retried seal completes."""
    ContainerStore = _mod(pkg, "storage.container_store").ContainerStore
    fi = _mod(pkg, "utils.fault_injection")
    store = ContainerStore(root, container_size=1 << 20, lanes=1)
    chunks = [_bytes(100 + i, 3000) for i in range(5)]
    locs = store.append_chunks(chunks)
    cid = locs[0][0]
    with fi.inject("container.seal", _raise(Boom())):
        with pytest.raises(Boom):
            store.seal(cid)
    out = {"raw_after_crash": os.path.exists(store._raw_path(cid)),
           "sealed_after_crash": os.path.exists(store._sealed_path(cid)),
           "chunks_after_crash": store.read_chunks(locs) == chunks,
           "files_after_crash": data_files(root)}
    store.seal(cid)
    out.update(sealed=os.path.exists(store._sealed_path(cid)),
               chunks=store.read_chunks(locs) == chunks,
               files=data_files(root), locs=[tuple(x) for x in locs])
    return out


def test_seal_crash_loses_no_chunks(tmp_path):
    ref, port = (_seal_crash(pkg, str(tmp_path / pkg)) for pkg in PKGS)
    assert (ref["raw_after_crash"], ref["sealed_after_crash"],
            ref["chunks_after_crash"], ref["sealed"], ref["chunks"]) == \
        (True, False, True, True, True)
    assert port == ref


# --------------------------------------------- the daemons' crash points


def _monitor_fault(pkg: str) -> dict:
    """test_namenode_monitor_survives_injected_fault."""
    MiniCluster = _mod(pkg, "testing.minicluster").MiniCluster
    fi = _mod(pkg, "utils.fault_injection")
    out = {}
    with MiniCluster(n_datanodes=1, replication=1, heartbeat_s=0.1,
                     dead_node_s=0.6) as mc:
        errors0 = _counter(pkg, "namenode", "monitor_errors")
        ticks = threading.Event()

        def boom(**kw):
            ticks.set()
            raise Boom()

        with fi.inject("namenode.monitor_tick", boom):
            out["ticked"] = ticks.wait(5.0)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and _counter(
                    pkg, "namenode", "monitor_errors") <= errors0:
                time.sleep(0.02)
        out["counted"] = _counter(pkg, "namenode", "monitor_errors") > errors0
        mc.kill_datanode(0)
        with _client(mc, pkg, "mt") as c:
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and not all(
                    not d["alive"] for d in c.datanode_report()):
                time.sleep(0.05)
            # a dead DataNode is reported not alive until the monitor
            # drops it from the report: either way none is alive
            out["declared_dead"] = all(not d["alive"]
                                       for d in c.datanode_report())
    return out


def test_namenode_monitor_survives_injected_fault():
    ref, port = (_monitor_fault(pkg) for pkg in PKGS)
    assert ref == {"ticked": True, "counted": True, "declared_dead": True}
    assert port == ref


def _journal_fault(pkg: str) -> dict:
    """test_one_journalnode_append_fault_quorum_survives: one JournalNode's
    append fails once; the edit lands on the other two and the mkdir is
    acknowledged.  Every JournalNode holds the same records in memory
    (the failed one appended them before its write failed)."""
    from hdrf_tpu_torch.proto.rpc import unpackb

    MiniCluster = _mod(pkg, "testing.minicluster").MiniCluster
    fi = _mod(pkg, "utils.fault_injection")
    fault = _once(OSError("jn disk error"))
    with MiniCluster(n_datanodes=1, replication=1, journal_nodes=3) as mc:
        with fi.inject("journalnode.append", fault):
            with _client(mc, pkg, "jn") as c:
                c.mkdir("/jn/survives")
                listed = [e["name"] for e in c.ls("/jn")]
        # each JournalNode's records: sequence number, txid, edit op
        # (the edits' own fields carry the clock, which differs)
        records = sorted(tuple((s, *unpackb(p)[:2]) for s, p in jn._records)
                         for jn in mc.journalnodes)
    return {"fired": fault.fired.is_set(), "listed": listed,
            "jn_records": records}


def test_one_journalnode_append_fault_quorum_survives():
    ref, port = (_journal_fault(pkg) for pkg in PKGS)
    assert ref["fired"] and ref["listed"] == ["survives"]
    assert all(r and r[-1][2] == "mkdir" for r in ref["jn_records"])
    assert port == ref


def _finalize_crash(pkg: str) -> dict:
    """test_replica_finalize_crash_client_retries: a crash between the
    data fsync and the meta write; the pipeline aborts, the client retries
    the block on a new allocation, and the file reads back whole."""
    MiniCluster = _mod(pkg, "testing.minicluster").MiniCluster
    fi = _mod(pkg, "utils.fault_injection")
    data = _bytes(5, 200_000)
    fault = _once(Boom())
    with MiniCluster(n_datanodes=2, replication=1) as mc:
        with fi.inject("replica.finalize", fault):
            with _client(mc, pkg, "rf") as c:
                c.write("/rf/f", data, scheme="direct")
                read = c.read("/rf/f") == data
                blocks = [b["block_id"] for b in c._call(
                    "get_block_locations", path="/rf/f")["blocks"]]
        finalized = sorted(bid for dn in mc.datanodes
                           for bid in dn.replicas.block_ids()
                           if dn.replicas.get_meta(bid) is not None)
    return {"fired": fault.fired.is_set(), "read": read, "blocks": blocks,
            "finalized": finalized}


def test_replica_finalize_crash_client_retries():
    ref, port = (_finalize_crash(pkg) for pkg in PKGS)
    assert ref["fired"] and ref["read"]
    assert ref["finalized"] == ref["blocks"]
    assert port == ref


def _broken_mirror(pkg: str) -> dict:
    """test_broken_mirror_flagged_within_two_heartbeats: every mirror
    ingest (op ``write_reduced``) raises; the primary attributes the peer
    and the next heartbeats carry it to the NameNode's health report."""
    MiniCluster = _mod(pkg, "testing.minicluster").MiniCluster
    fi = _mod(pkg, "utils.fault_injection")
    data = _bytes(6, 300_000)

    def refuse(**kw):
        if kw.get("op") == "write_reduced":
            raise Boom()
    out = {}
    with MiniCluster(n_datanodes=2, replication=2, block_size=1 << 20) as mc:
        with fi.inject("datanode.op", refuse):
            with _client(mc, pkg, "mf") as c:
                c.write("/mf/f", data, scheme="dedup_lz4")
                out["read"] = c.read("/mf/f") == data
        flagged = {peer: n for dn in mc.datanodes if dn is not None
                   for peer, n in dn._mirror_fail.items()}
        out["flagged"] = sorted(flagged.values())
        with _client(mc, pkg, "mf") as c:
            deadline = time.monotonic() + 10.0
            health = {}
            while time.monotonic() < deadline:
                health = c._call("slow_nodes_report")
                if health.get("mirror_failures"):
                    break
                time.sleep(0.05)
        mf = health.get("mirror_failures", {})
        out["reported_peers_flagged"] = sorted(p in flagged for p in mf)
        out["reported_counts"] = sorted(mf.values())
        out["slow_peer_rule"] = sorted(
            health["slow_peers"][p]["mirror_failures"] >= 1 for p in mf)
    return out


def test_broken_mirror_flagged_within_two_heartbeats():
    ref, port = (_broken_mirror(pkg) for pkg in PKGS)
    assert ref["read"] and ref["flagged"]
    assert ref["reported_peers_flagged"] == [True] * len(ref["flagged"])
    assert ref["slow_peer_rule"] == [True] * len(ref["flagged"])
    assert port == ref


# ------------------------------------------ the worker's deadline and breaker


class _HangingServer:
    """Accepts connections and never answers (a wedged worker)."""

    def __init__(self):
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(16)
        self.addr = self._srv.getsockname()
        self._conns: list[socket.socket] = []
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                c, _ = self._srv.accept()
            except OSError:
                return
            self._conns.append(c)

    def close(self):
        self._srv.close()
        for c in self._conns:
            c.close()


def _hung_worker_write(pkg: str) -> dict:
    """test_write_path_unblocks_and_degrades: a DataNode pointed at a hung
    worker completes the ``dedup_lz4`` write in process within the
    worker's deadline."""
    MiniCluster = _mod(pkg, "testing.minicluster").MiniCluster
    hang = _HangingServer()
    data = _bytes(7, 400_000)
    try:
        with MiniCluster(n_datanodes=1, replication=1, block_size=1 << 20,
                         reduction_overrides={
                             "worker_addr": list(hang.addr),
                             "worker_deadline_s": 0.6,
                             "worker_deadline_s_per_mb": 0.0,
                             "worker_breaker_failures": 100}) as mc:
            fb0 = _counter(pkg, "block_receiver", "worker_fallbacks")
            dg0 = _counter(pkg, "block_receiver", "degraded_writes")
            t0 = time.monotonic()
            with _client(mc, pkg, "hung") as c:
                c.write("/hung/f", data, scheme="dedup_lz4")
                read = c.read("/hung/f") == data
            return {"read": read, "within_60s": time.monotonic() - t0 < 60,
                    "fallbacks": _counter(pkg, "block_receiver",
                                          "worker_fallbacks") - fb0,
                    "degraded": _counter(pkg, "block_receiver",
                                         "degraded_writes") - dg0}
    finally:
        hang.close()


def test_write_path_unblocks_and_degrades():
    ref, port = (_hung_worker_write(pkg) for pkg in PKGS)
    assert ref["read"] and ref["within_60s"]
    assert ref["fallbacks"] > 0 and ref["degraded"] > 0
    assert port == ref


BREAKER_COUNTERS = (("block_receiver", "worker_reduces"),
                    ("block_receiver", "worker_fallbacks"),
                    ("block_receiver", "degraded_writes"),
                    ("reduction_worker", "connect_attempts"),
                    ("resilience", "breaker_open_total"),
                    ("resilience", "breaker_close_total"))


def _kill9_cycle(pkg: str) -> list:
    """test_kill9_breaker_opens_then_halfopen_recovers: the worker killed
    mid-write, the breaker opened by a second failure, degraded writes
    making no connect attempt, the degradation at the NameNode, then the
    worker restarted and the breaker driven half-open by its clock: the
    probe write closes it.  Each step records the breaker's state, the
    counter deltas since the step before, and the bytes read back.  Both
    packages' workers run the host library (``worker_backend="native"``):
    the breaker, not the device, is under test."""
    MiniCluster = _mod(pkg, "testing.minicluster").MiniCluster
    fi = _mod(pkg, "utils.fault_injection")
    metrics = _mod(pkg, "utils.metrics")
    steps = []
    last = {k: 0 for k in BREAKER_COUNTERS}

    def step(name, breaker, dn, read):
        now = {k: metrics.registry(k[0]).counter(k[1])
               for k in BREAKER_COUNTERS}
        steps.append((name, breaker.state, dn.reduction_degraded, read,
                      {f"{r}.{n}": now[(r, n)] - last[(r, n)]
                       for r, n in BREAKER_COUNTERS}))
        last.update(now)

    with MiniCluster(n_datanodes=1, replication=1, block_size=1 << 20,
                     tpu_worker=True, worker_backend="native",
                     reduction_overrides={
                         "worker_deadline_s": 20.0,
                         "worker_breaker_failures": 2,
                         "worker_breaker_reset_s": 3600.0}) as mc:
        dn = mc.datanodes[0]
        breaker = dn._worker_breaker
        last.update({k: metrics.registry(k[0]).counter(k[1])
                     for k in BREAKER_COUNTERS})

        def write(path, data):
            with _client(mc, pkg, "fo") as c:
                c.write(path, data, scheme="dedup_lz4")
                return c.read(path) == data

        step("healthy", breaker, dn, write("/fo/a", _bytes(10, 400_000)))
        fired = threading.Event()

        def kill_once(**kw):
            if not fired.is_set():
                fired.set()
                mc.kill_worker()
        with fi.inject("block_receiver.packet", kill_once):
            ok = write("/fo/b", _bytes(11, 400_000))
        step("killed_mid_write", breaker, dn, ok and fired.is_set())
        step("refused_opens", breaker, dn, write("/fo/c", _bytes(12, 300_000)))
        step("open_no_connect", breaker, dn,
             write("/fo/d", _bytes(13, 300_000)))
        gauge = metrics.registry("resilience").snapshot()["gauges"][
            f"breaker_state.{breaker.name}"]
        with _client(mc, pkg, "fo") as c:
            deadline = time.monotonic() + 10.0
            cs = {}
            while time.monotonic() < deadline:
                cs = c._call("cluster_status")
                if cs.get("reduction_degraded"):
                    break
                time.sleep(0.05)
        steps.append(("at_namenode", gauge, cs.get("reduction_degraded"),
                      cs.get("degraded_nodes") == [dn.dn_id]))
        mc.restart_worker()
        breaker._opened_at = breaker._clock() - breaker.reset_s - 1.0
        steps.append(("half_open", breaker.state))
        step("probe_closes", breaker, dn, write("/fo/e", _bytes(14, 300_000)))
        with _client(mc, pkg, "fo") as c:
            steps.append(("degraded_files_read",
                          c.read("/fo/b") == _bytes(11, 400_000),
                          c.read("/fo/c") == _bytes(12, 300_000)))
    return steps


def test_kill9_breaker_opens_then_halfopen_recovers():
    ref, port = (_kill9_cycle(pkg) for pkg in PKGS)
    states = [s[1] for s in ref]
    assert states == ["closed", "closed", "open", "open", 2, "half_open",
                      "closed", True]
    assert ref[0][4]["block_receiver.worker_reduces"] == 1
    assert ref[1][4]["block_receiver.worker_fallbacks"] == 1
    assert ref[3][4]["reduction_worker.connect_attempts"] == 0
    assert ref[6][4]["resilience.breaker_close_total"] == 1
    assert port == ref


# -------------------------------------------------- a write past the lease


def test_write_longer_than_the_lease():
    """One block whose write takes 2.5 s against a lease that expires
    after 0.5 s, on one port cluster, by each package's client.  The
    reference's client renews only between blocks: the NameNode's lease
    recovery closes the file without the block, and ``complete`` is
    refused.  The port's renews every 0.1 s while the write is open
    (``LeaseRenewer``): the file completes with its bytes."""
    from hdrf_tpu_torch.client import filesystem as port_fs
    from hdrf_tpu_torch.proto.rpc import RpcError
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    data = _bytes(8, 200_000)
    out = {}
    with MiniCluster(n_datanodes=1, replication=1) as mc, \
            pytest.MonkeyPatch.context() as mp:
        nn = mc.namenode
        nn._leases.expiry_s = 0.5
        mp.setattr(nn, "RECOVERY_GRACE_S", 0.5)
        mp.setattr(port_fs.LeaseRenewer, "INTERVAL_S", 0.1)
        for pkg in PKGS:
            fs = _mod(pkg, "client.filesystem")
            stream = fs.HdrfClient._stream_block

            def slow(self, alloc, block, stream=stream):
                time.sleep(2.5)
                return stream(self, alloc, block)
            mp.setattr(fs.HdrfClient, "_stream_block", slow)
            renewals0 = _counter(pkg, "client", "lease_renewals")
            kw = {"device": "cpu"} if pkg == "port" else {}
            with fs.HdrfClient(nn.addr, name=f"lease-{pkg}", **kw) as c:
                try:
                    c.write(f"/lease/{pkg}", data, scheme="dedup_lz4")
                    got = ("completed", c.read(f"/lease/{pkg}") == data)
                except Exception as e:    # noqa: BLE001 — either package
                    got = ("raised", type(e).__name__, str(e))
            st = nn.rpc_stat(f"/lease/{pkg}")
            out[pkg] = (got, st["complete"], st["length"], st["blocks"],
                        _counter(pkg, "client", "lease_renewals")
                        - renewals0 > 0)
    assert out["ref"] == (
        ("raised", RpcError.__name__,
         "PermissionError: lease-ref does not hold the lease on /lease/ref"),
        True, 0, 0, False)
    assert out["port"] == (("completed", True), True, len(data), 1, True)

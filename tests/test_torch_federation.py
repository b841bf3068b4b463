"""Federation on the port (testing/minicluster.py ``nameservices=``,
server/datanode.py's per-nameservice reports, server/namenode.py's pool
guard) against the reference (tests/test_federation.py).

Two nameservices over one DataNode set, each with its own block pool:
block ids are ``(pool_index << 48) | seq``, a DataNode splits its reports
by ``block_id >> 48``, and each NameNode ignores replicas of another
pool, so one namespace's "replica of a deleted file" rule never
invalidates the other's.  Each flow runs on clusters and clients of
either package (the ``cluster_pkg`` / ``client_pkg`` pairings of
tests/test_torch_client.py; the port client on ``device="cpu"``) and on
the reference's own cluster and client, and the two outcomes must be
equal: the same bytes read back, the same block ids in each pool, the
same locations counted, no replica invalidated.  The mixed case runs the
port's DataNodes under the reference's NameNodes.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest

from _dn_standin import guard_reference_stat_race

COMBOS = [("port", "port"), ("ref", "port"), ("port", "ref")]
IDS = [f"cluster_{c}-client_{k}" for c, k in COMBOS]
MB = 1 << 20


@pytest.fixture(autouse=True)
def _reference_stat_race(monkeypatch):
    guard_reference_stat_race(monkeypatch)


def _mod(pkg: str, path: str):
    return importlib.import_module(
        ("hdrf_tpu." if pkg == "ref" else "hdrf_tpu_torch.") + path)


def _payload(seed: int, n: int = 250_000) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, np.uint8).tobytes()


def _client(mc, client_pkg: str, name: str, nsi: int):
    """A client of ``client_pkg`` mounted on nameservice ``nsi``."""
    addrs = mc.nn_addrs(nsi)
    kw = {"device": "cpu"} if client_pkg == "port" else {}
    return _mod(client_pkg, "client.filesystem").HdrfClient(
        addrs if len(addrs) > 1 else addrs[0], name=name, **kw)


def _invalidated(pkg: str) -> int:
    return _mod(pkg, "utils.metrics").registry("datanode").counter(
        "blocks_invalidated")


def _pools(mc) -> list[list[int]]:
    return [sorted(ns["active"]._blocks) for ns in mc.ns]


def _shared_dn_set(mc, cluster_pkg: str, client_pkg: str) -> dict:
    """tests/test_federation.py::test_two_nameservices_share_one_dn_set."""
    d0, d1 = _payload(0), _payload(1)
    out = {}
    with _client(mc, client_pkg, "a", 0) as c0, \
            _client(mc, client_pkg, "b", 1) as c1:
        c0.write("/shared/f", d0)
        c1.write("/shared/f", d1)          # same path, other namespace
        out["reads"] = [c0.read("/shared/f") == d0,
                        c1.read("/shared/f") == d1]
        out["ns0_listing"] = sorted(e["name"] for e in c0.ls("/"))
        c1.mkdir("/only-ns1")
        try:
            c0.stat("/only-ns1")
            out["ns1_dir_in_ns0"] = True
        except Exception:                  # noqa: BLE001 — either package
            out["ns1_dir_in_ns0"] = False
    out["pools"] = _pools(mc)
    out["pool_of_id"] = [sorted({b >> 48 for b in p}) for p in out["pools"]]
    inv0 = _invalidated(cluster_pkg)
    for dn in mc.datanodes:
        dn._send_block_report()            # a full report to BOTH
    time.sleep(0.8)
    out["invalidated"] = _invalidated(cluster_pkg) - inv0
    out["pools_after_reports"] = _pools(mc)
    with _client(mc, client_pkg, "a2", 0) as c0, \
            _client(mc, client_pkg, "b2", 1) as c1:
        out["reads_after_reports"] = [c0.read("/shared/f") == d0,
                                      c1.read("/shared/f") == d1]
    return out


def _run_shared(cluster_pkg: str, client_pkg: str) -> dict:
    MiniCluster = _mod(cluster_pkg, "testing.minicluster").MiniCluster
    with MiniCluster(n_datanodes=3, replication=2, nameservices=2,
                     block_size=MB) as mc:
        return _shared_dn_set(mc, cluster_pkg, client_pkg)


@pytest.fixture(scope="module")
def reference():
    """The reference cluster and client's outcome of each flow, run once
    (``_run_*`` with ``("ref", "ref")``)."""
    made: dict = {}

    def get(flow: str, run):
        if flow not in made:
            made[flow] = run("ref", "ref")
        return made[flow]
    return get


def test_reference_outcomes_hold_the_invariants(reference):
    """What the comparisons below hold the port to: each namespace reads
    its own bytes, the pools are disjoint with ids ``>> 48`` equal to the
    pool index, and a full report cycle invalidates nothing."""
    ref = reference("shared", _run_shared)
    assert ref["reads"] == ref["reads_after_reports"] == [True, True]
    assert ref["ns0_listing"] == ["shared"] and not ref["ns1_dir_in_ns0"]
    assert ref["pools"][0] and ref["pools"][1]
    assert not set(ref["pools"][0]) & set(ref["pools"][1])
    assert ref["pool_of_id"] == [[0], [1]]
    assert ref["invalidated"] == 0
    assert ref["pools_after_reports"] == ref["pools"]


@pytest.mark.parametrize("cluster_pkg,client_pkg", COMBOS, ids=IDS)
def test_two_nameservices_share_one_dn_set(reference, cluster_pkg,
                                           client_pkg):
    assert _run_shared(cluster_pkg, client_pkg) == \
        reference("shared", _run_shared)


def _run_failover(cluster_pkg: str, client_pkg: str) -> dict:
    """tests/test_federation.py::test_independent_failover: one namespace
    fails over while the other keeps serving; then the other does."""
    MiniCluster = _mod(cluster_pkg, "testing.minicluster").MiniCluster
    d0, d1 = _payload(10), _payload(11)
    out = {}
    with MiniCluster(n_datanodes=2, replication=2, ha=True, nameservices=2,
                     block_size=MB) as mc:
        with _client(mc, client_pkg, "a", 0) as c0, \
                _client(mc, client_pkg, "b", 1) as c1:
            c0.write("/f0", d0)
            c1.write("/f1", d1)
            time.sleep(0.8)                # the standbys tail the edits
            old1 = mc.ns[1]["active"]
            new1 = mc.failover(nsi=1)
            out["ns1_promoted"] = new1 is not old1 and new1.role == "active"
            out["ns0_during"] = c0.read("/f0") == d0
            out["ns1_after"] = c1.read("/f1") == d1
            c1.write("/f2", d1)
            out["ns1_new_file"] = c1.read("/f2") == d1
            mc.failover(nsi=0)
            out["ns0_after"] = c0.read("/f0") == d0
        out["pools"] = _pools(mc)
    return out


@pytest.mark.parametrize("cluster_pkg,client_pkg", COMBOS, ids=IDS)
def test_independent_failover(reference, cluster_pkg, client_pkg):
    ref = reference("failover", _run_failover)
    assert all(v for k, v in ref.items() if k != "pools")
    assert _run_failover(cluster_pkg, client_pkg) == ref


def _healthy(nn, dead: str) -> bool:
    return all(len({d for d in i.locations
                    if d in nn._datanodes and d != dead}) >= 2
               for i in nn._blocks.values())


def _run_rereplication(cluster_pkg: str, client_pkg: str) -> dict:
    """tests/test_federation.py::test_dn_re_replication_stays_within_pool:
    a dead DataNode is re-replicated in both namespaces, each by its own
    NameNode, and every replica a DataNode holds is in the block map of
    its pool's NameNode alone."""
    MiniCluster = _mod(cluster_pkg, "testing.minicluster").MiniCluster
    d0, d1 = _payload(20), _payload(21)
    out = {}
    with MiniCluster(n_datanodes=3, replication=2, nameservices=2,
                     block_size=MB) as mc:
        with _client(mc, client_pkg, "a", 0) as c0, \
                _client(mc, client_pkg, "b", 1) as c1:
            c0.write("/r0", d0)
            c1.write("/r1", d1)
            mc.kill_datanode(0)
            deadline = time.monotonic() + 15
            nns = [ns["active"] for ns in mc.ns]
            while time.monotonic() < deadline and not all(
                    _healthy(nn, "dn-0") for nn in nns):
                time.sleep(0.2)
            out["healthy"] = [_healthy(nn, "dn-0") for nn in nns]
            out["reads"] = [c0.read("/r0") == d0, c1.read("/r1") == d1]
        out["pools"] = _pools(mc)
        out["live_locations"] = [
            sorted(len({d for d in i.locations if d != "dn-0"})
                   for i in nn._blocks.values()) for nn in nns]
        # a replica of pool p is known to nameservice p, never to another
        out["cross_pool"] = [
            bid for dn in mc.datanodes if dn is not None
            for bid in dn.replicas.block_ids()
            for p, nn in enumerate(nns)
            if (bid >> 48) != p and bid in nn._blocks]
    return out


@pytest.mark.parametrize("cluster_pkg,client_pkg", COMBOS, ids=IDS)
def test_dn_re_replication_stays_within_pool(reference, cluster_pkg,
                                             client_pkg):
    ref = reference("rereplication", _run_rereplication)
    assert ref["healthy"] == ref["reads"] == [True, True]
    assert ref["cross_pool"] == []
    assert _run_rereplication(cluster_pkg, client_pkg) == ref


def test_port_datanodes_under_reference_namenodes(reference, monkeypatch):
    """The mixed deployment: the port's MiniCluster with the reference's
    NameNode (and its config) in place of the port's, so the port's
    DataNodes register, report and are commanded per pool by reference
    NameNodes; the port client drives it.  The same outcome as the
    reference's own cluster."""
    import hdrf_tpu_torch.testing.minicluster as port_mc
    from hdrf_tpu.config import NameNodeConfig
    from hdrf_tpu.server.namenode import NameNode

    monkeypatch.setattr(port_mc, "NameNode", NameNode)
    monkeypatch.setattr(port_mc, "NameNodeConfig", NameNodeConfig)
    with port_mc.MiniCluster(n_datanodes=3, replication=2, nameservices=2,
                             block_size=MB) as mc:
        assert all(type(ns["active"]) is NameNode for ns in mc.ns)
        assert all(type(dn).__module__.startswith("hdrf_tpu_torch.")
                   for dn in mc.datanodes)
        got = _shared_dn_set(mc, "port", "port")
    assert got == reference("shared", _run_shared)

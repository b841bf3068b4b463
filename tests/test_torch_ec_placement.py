"""Where the NameNode puts a block's RS(6,3) stripes, and what it does when
a group has lost too many of them: the reference against the port, each
case run on a cluster of each package.

Each cluster is one NameNode and four DataNodes of one package
(``native`` backend, 64 KiB containers), the NameNode at its default
policy (k 6, m 3) and replication 3.  Nothing runs on a timer: the
NameNode's monitor and the DataNodes' heartbeats are parked at an hour,
and :meth:`Cluster.tick` runs one monitor pass, then one heartbeat of
every running DataNode in the test's thread (its commands included), so
a ``stripe_demote`` or ``stripe_repair`` scheduled in a pass has run
when the pass returns.  A stopped DataNode is declared dead by moving its
last heartbeat back past the dead-node interval.  The replicas' places
are fixed by starting the DataNodes that must hold them first and the
rest after the write.  Only the reports a case injects reach the
NameNode's health report (``quiet_health``): a DataNode that reports
mirror failures to a peer makes that peer a slow peer, left out of the
stripes' placement pool.

The reference places stripe i on pool[i % len(pool)] whatever the
pool's width, doubles repaired stripes up on survivors, and re-commands
a group that cannot be decoded at every pending timeout
(``hdrf_tpu/server/namenode.py:4341``, ``:4351``).  The port keeps no
more than m stripes of a group on one DataNode wherever the pool allows
it, defers a demotion where it does not (``ec_demotions_deferred``), and
commands no repair of a group with fewer than k stripes left
(``stripe_groups_unrecoverable``).  Each case asserts both outcomes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

from _dn_standin import (guard_reference_stat_race, one_heartbeat, port_dn,
                         ref_dn)
from _nn_standin import MONITOR_TICK

HOUR = 3600.0
BLOCK = 1 << 20
K, M = 6, 3


@pytest.fixture(autouse=True)
def _reference_stat_race(monkeypatch):
    guard_reference_stat_race(monkeypatch)


def _pkg_modules(pkg: str):
    if pkg == "port":
        from hdrf_tpu_torch.client.filesystem import HdrfClient
        from hdrf_tpu_torch.config import NameNodeConfig
        from hdrf_tpu_torch.server.namenode import NameNode
        from hdrf_tpu_torch.utils import metrics, retry
        return (NameNode, NameNodeConfig, metrics, retry,
                lambda addr: HdrfClient(addr, name="ecp", device="cpu"))
    from hdrf_tpu.client.filesystem import HdrfClient
    from hdrf_tpu.config import NameNodeConfig
    from hdrf_tpu.server.namenode import NameNode
    from hdrf_tpu.utils import metrics, retry
    return (NameNode, NameNodeConfig, metrics, retry,
            lambda addr: HdrfClient(addr, name="ecp"))


def quiet_health(dn) -> None:
    """Leave each heartbeat's peer latencies and disk probes out of what
    ``dn`` reports, so that only a case's injected mirror failures can
    make the NameNode's health report veto a DataNode."""
    stats = dn._stats

    def quiet():
        st = stats()
        st["peer_transfer"] = {}
        for v in (st.get("volumes") or {}).values():
            v["probe_median_s"] = None
        return st
    dn._stats = quiet


class Cluster:
    """A NameNode of ``pkg`` and its DataNodes ``dn-0`` ..., every one
    stepped by :meth:`tick`."""

    def __init__(self, root, pkg: str) -> None:
        (NameNode, NameNodeConfig, self.metrics, self.retry,
         self._client) = _pkg_modules(pkg)
        self.root, self.pkg = str(root), pkg
        # pending timeout 0: a command not yet answered is sent again at
        # the next pass (the reference's "every pending timeout")
        self.nn = NameNode(NameNodeConfig(
            meta_dir=os.path.join(self.root, "name"), replication=3,
            block_size=BLOCK, heartbeat_interval_s=HOUR,
            dead_node_interval_s=HOUR,
            pending_replication_timeout_s=0.0)).start()
        self.dns: dict[str, object] = {}

    def start(self, *names: str) -> None:
        make = port_dn if self.pkg == "port" else ref_dn
        for name in names:
            dn = make(os.path.join(self.root, name), self.nn.addr, name,
                      red={"container_size": 64 << 10},
                      dn={"heartbeat_interval_s": HOUR,
                          "block_report_interval_s": HOUR})
            quiet_health(dn)
            self.dns[name] = dn
            one_heartbeat(dn)

    def stop(self, *names: str) -> None:
        """Stop DataNodes and declare them dead at the next pass."""
        for name in names:
            self.dns.pop(name).stop()
            with self.nn._lock:
                self.nn._datanodes[name].last_heartbeat -= 2 * HOUR

    def tick(self) -> None:
        for name in MONITOR_TICK:
            getattr(self.nn, name)()
        for name in sorted(self.dns):
            one_heartbeat(self.dns[name])

    def write(self, path: str, data: bytes) -> int:
        """One block of ``data``, once every replica's IBR is in (sent on
        each DataNode's own thread) and every container sealed."""
        with self._client(self.nn.addr) as c:
            c.write(path, data, scheme="dedup_lz4")
            (blk,) = c._call("get_block_locations", path=path)["blocks"]
        bid = blk["block_id"]
        t_end = time.monotonic() + 60.0
        while len(self.locations(bid)) < 3 and time.monotonic() < t_end:
            time.sleep(0.05)
        for dn in self.dns.values():
            dn.containers.flush_open()
            dn.containers.drain_seals()
        return bid

    def read(self, path: str):
        """The file's bytes, or the error's type name."""
        try:
            with self._client(self.nn.addr) as c:
                return c.read(path)
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            return type(e).__name__

    def locations(self, bid: int) -> list[str]:
        with self.nn._lock:
            return sorted(self.nn._blocks[bid].locations)

    def veto(self, reporter: str, *peers: str) -> None:
        """``reporter`` reports a mirror failure to each peer; after its
        heartbeat the NameNode counts them slow peers."""
        for p in peers:
            self.dns[reporter].note_mirror_failure(p)
        one_heartbeat(self.dns[reporter])
        with self.nn._lock:
            assert sorted(self.nn._health_report()["slow_peers"]) == \
                sorted(peers)

    def demote(self) -> None:
        self.nn.config.ec_demote_after_s = 1e-6
        for _ in range(3):
            self.tick()
        self.nn.config.ec_demote_after_s = 0.0

    def stripes(self, owner: str) -> list[dict]:
        """Each stripe group of ``owner``: its stripes a DataNode."""
        out = []
        for man in self.dns[owner].index.stripe_manifests().values():
            held: dict[str, int] = {}
            for h in man["holders"]:
                held[h[0]] = held.get(h[0], 0) + 1
            out.append(held)
        return out

    def nn_count(self, key: str) -> int:
        return self.metrics.registry("namenode").counter(key)

    def ec_count(self, key: str) -> int:
        return self.metrics.registry("ec").counter(key)

    def close(self) -> None:
        for dn in self.dns.values():
            dn.stop()
        self.nn.stop()
        self.retry.reset_breakers()


@pytest.fixture
def cluster(tmp_path):
    made = []

    def make(pkg: str) -> Cluster:
        made.append(Cluster(tmp_path / pkg, pkg))
        return made[-1]
    yield make
    for cl in made:
        cl.close()


def _data(seed: int, size: int = 200_000) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _one(groups: list[dict]) -> dict:
    """The stripes a DataNode of the block's groups: every container of a
    block is striped to the same targets."""
    assert groups and all(g == groups[0] for g in groups), groups
    return groups[0]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_two_vetoed_datanodes(cluster, pkg):
    """Replicas on dn-0..dn-2 (dn-0 owns the block), dn-3 started after
    the write; dn-0 reports dn-1 and dn-2 as failed mirrors, which leaves
    a placement pool of dn-0 and dn-3; then dn-3 is stopped.  The
    reference stripes 5 and 4 on the two, so that dn-3's loss leaves five
    stripes: every ``stripe_repair`` fails and the block cannot be read.
    The port defers the demotion and reads the block from its replicas."""
    cl = cluster(pkg)
    cl.start("dn-0", "dn-1", "dn-2")
    data = _data(1)
    bid = cl.write("/c/f", data)
    cl.start("dn-3")
    assert cl.locations(bid) == ["dn-0", "dn-1", "dn-2"]
    cl.veto("dn-0", "dn-1", "dn-2")
    deferred0 = cl.nn_count("ec_demotions_deferred")
    cl.demote()
    sched0 = cl.nn_count("stripe_repairs_scheduled")
    fail0, rep0 = cl.ec_count("repair_failures"), cl.ec_count(
        "stripes_repaired")
    cl.stop("dn-3")
    for _ in range(3):
        cl.tick()
    groups = len(cl.stripes("dn-0"))
    scheduled = cl.nn_count("stripe_repairs_scheduled") - sched0
    got = {"demoted": bid in cl.nn._ec_demoted,
           "stripes": _one(cl.stripes("dn-0")) if cl.stripes("dn-0")
           else {}, "replicas": cl.locations(bid),
           "repairs_scheduled": scheduled / max(groups, 1),
           "repairs_failed": (cl.ec_count("repair_failures") - fail0)
           / max(groups, 1),
           "stripes_repaired": (cl.ec_count("stripes_repaired") - rep0)
           / max(groups, 1),
           "read_equal": cl.read("/c/f") == data}
    if pkg == "ref":
        assert got == {"demoted": True, "stripes": {"dn-0": 5, "dn-3": 4},
                       "replicas": ["dn-0"], "repairs_scheduled": 3.0,
                       "repairs_failed": 3.0, "stripes_repaired": 0.0,
                       "read_equal": False}
    else:
        assert got == {"demoted": False, "stripes": {},
                       "replicas": ["dn-0", "dn-1", "dn-2"],
                       "repairs_scheduled": 0.0, "repairs_failed": 0.0,
                       "stripes_repaired": 0.0, "read_equal": True}
        assert cl.nn_count("ec_demotions_deferred") - deferred0 == 1
        assert cl.nn.rpc_ec_status()["demotions_deferred"] == 1


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_one_vetoed_datanode(cluster, pkg):
    """dn-2 vetoed: a pool of three, three stripes each, so the port
    places them as the reference does.  dn-3 (no replica) is stopped: six
    stripes survive and both repair the group and read the block back.
    The two healthy survivors have no room for three more at m a
    DataNode: the reference doubles up on them (5 and 4); the port puts
    the three on dn-2, vetoed but live (3, 3, 3)."""
    cl = cluster(pkg)
    cl.start("dn-0", "dn-1", "dn-2")
    data = _data(2)
    bid = cl.write("/c/f", data)
    cl.start("dn-3")
    cl.veto("dn-0", "dn-2")
    cl.demote()
    demoted = _one(cl.stripes("dn-0"))
    rep0 = cl.ec_count("stripes_repaired")
    over0 = cl.nn_count("stripe_repairs_over_m")
    cl.stop("dn-3")
    cl.tick()
    groups = len(cl.stripes("dn-0"))
    got = {"demoted": demoted, "repaired": _one(cl.stripes("dn-0")),
           "stripes_repaired": (cl.ec_count("stripes_repaired") - rep0)
           / groups,
           "read_equal": cl.read("/c/f") == data}
    assert got == {"demoted": {"dn-0": 3, "dn-1": 3, "dn-3": 3},
                   "repaired": ({"dn-0": 5, "dn-1": 4} if pkg == "ref"
                                else {"dn-0": 3, "dn-1": 3, "dn-2": 3}),
                   "stripes_repaired": 3.0, "read_equal": True}
    assert cl.locations(bid) == ["dn-0"]
    assert cl.nn_count("stripe_repairs_over_m") == over0


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_repair_fills_the_least_loaded_first(cluster, pkg):
    """Replicas on dn-1..dn-3 (dn-1 owns the block), dn-0 started after:
    no veto, so dn-0 holds stripes 0, 4 and 8 and the others two each.
    dn-2 is lost.  The reference sends its two stripes to dn-0 and dn-1,
    so dn-0 holds 4 and its loss next leaves five: the repair fails and
    the block cannot be read.  The port sends them to dn-1 and dn-3
    (the fewest stripes), 3, 3, 3, and the group survives dn-0's loss,
    repaired onto the two left (``stripe_repairs_over_m``)."""
    cl = cluster(pkg)
    cl.start("dn-1", "dn-2", "dn-3")
    data = _data(3)
    bid = cl.write("/c/f", data)
    cl.start("dn-0")
    assert cl.locations(bid) == ["dn-1", "dn-2", "dn-3"]
    cl.demote()
    demoted = _one(cl.stripes("dn-1"))
    cl.stop("dn-2")
    cl.tick()
    first = _one(cl.stripes("dn-1"))
    rep0, fail0 = cl.ec_count("stripes_repaired"), cl.ec_count(
        "repair_failures")
    over0 = cl.nn_count("stripe_repairs_over_m")
    cl.stop("dn-0")
    cl.tick()
    groups = len(cl.stripes("dn-1"))
    got = {"demoted": demoted, "first_repair": first,
           "second_repaired": (cl.ec_count("stripes_repaired") - rep0)
           / groups,
           "second_failed": (cl.ec_count("repair_failures") - fail0)
           / groups,
           "read_equal": cl.read("/c/f") == data}
    # two live DataNodes have no room for nine stripes at m each: the
    # port's second repair doubles up as the reference's would, and says so
    assert (cl.nn_count("stripe_repairs_over_m") - over0) / groups == \
        (1.0 if pkg == "port" else 0.0)
    assert demoted == {"dn-0": 3, "dn-1": 2, "dn-2": 2, "dn-3": 2}
    if pkg == "ref":
        assert got["first_repair"] == {"dn-0": 4, "dn-1": 3, "dn-3": 2}
        assert (got["second_repaired"], got["second_failed"],
                got["read_equal"]) == (0.0, 1.0, False)
    else:
        assert got["first_repair"] == {"dn-0": 3, "dn-1": 3, "dn-3": 3}
        assert (got["second_repaired"], got["second_failed"],
                got["read_equal"]) == (3.0, 0.0, True)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_unrecoverable_group(cluster, capfd, pkg):
    """The placement of the case above, then dn-0 and dn-2 lost at once:
    four stripes left.  The reference commands a ``stripe_repair`` at
    every pass and each fails; the port commands none, its gauge and
    ``ec_status`` count the group, and it logs the group once."""
    cl = cluster(pkg)
    cl.start("dn-1", "dn-2", "dn-3")
    bid = cl.write("/c/f", _data(4))
    cl.start("dn-0")
    cl.demote()
    assert bid in cl.nn._ec_demoted
    sched0 = cl.nn_count("stripe_repairs_scheduled")
    fail0 = cl.ec_count("repair_failures")
    capfd.readouterr()
    cl.stop("dn-0", "dn-2")
    for _ in range(3):
        cl.tick()
    logged = capfd.readouterr().err.count("stripe group unrecoverable")
    groups = len(cl.stripes("dn-1"))
    got = ((cl.nn_count("stripe_repairs_scheduled") - sched0) / groups,
           (cl.ec_count("repair_failures") - fail0) / groups)
    if pkg == "ref":
        assert (got, logged) == ((3.0, 3.0), 0)
    else:
        assert (got, logged) == ((0.0, 0.0), groups)
        assert cl.nn.rpc_ec_status()["stripe_groups_unrecoverable"] == \
            groups
        assert cl.metrics.registry("namenode").snapshot()["gauges"][
            "stripe_groups_unrecoverable"] == groups

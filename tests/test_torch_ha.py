"""NameNode HA across packages: a standby of one package tails the active
of the other (shared meta dir, or a quorum of JournalNodes of both
packages), takes over on failover and fences the old active; a port
observer serves the reference client's reads after ``msync``; the port
FailoverController promotes a standby when the active dies.

Two port DataNodes (``native`` backend) report to every NameNode; the
reference ``HdrfClient`` writes and reads through its HA proxy.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pytest

from _dn_standin import port_dn


def _wait(pred, timeout=40.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg}")


def _nn(pkg: str, **cfg):
    if pkg == "port":
        from hdrf_tpu_torch.config import NameNodeConfig
        from hdrf_tpu_torch.server.namenode import NameNode
    else:
        from hdrf_tpu.config import NameNodeConfig
        from hdrf_tpu.server.namenode import NameNode
    base = dict(replication=2, block_size=64 << 10, heartbeat_interval_s=0.2,
                dead_node_interval_s=1.5, tail_interval_s=0.05)
    base.update(cfg)
    return NameNode(NameNodeConfig(**base)).start()


class Ha:
    """An active, its standby/observers and two port DataNodes."""

    def __init__(self, root: str, active: str, others: list[tuple],
                 quorum: list[str] | None = None):
        self.root = root
        self.jns = []
        shared = {"meta_dir": os.path.join(root, "name")}
        if quorum:
            from hdrf_tpu.server.journal import JournalNode as RefJN
            from hdrf_tpu_torch.server.journal import JournalNode as PortJN

            self.jns = [(PortJN if p == "port" else RefJN)(
                os.path.join(root, f"jn{i}")).start()
                for i, p in enumerate(quorum)]
            shared = {"journal_addrs": [list(j.addr) for j in self.jns]}
        cfg = dict(shared)
        if quorum:
            cfg["meta_dir"] = os.path.join(root, "name-a")
        self.active = _nn(active, **cfg)
        self.others = []
        for i, (pkg, role) in enumerate(others):
            c = dict(shared, role=role)
            if quorum:
                c.update(meta_dir=os.path.join(root, f"name-{i}"),
                         peers=[list(self.active.addr)])
            self.others.append(_nn(pkg, **c))
        self.nns = [self.active, *self.others]
        addrs = [list(n.addr) for n in self.nns]
        self.dns = [port_dn(os.path.join(root, f"dn{i}"), addrs, f"dn-{i}",
                            dn={"heartbeat_interval_s": 0.2})
                    for i in range(2)]
        _wait(lambda: all(len(n._datanodes) == 2 for n in self.nns),
              msg="registration with every NameNode")

    def addrs(self) -> list:
        return [n.addr for n in self.nns]

    def caught_up(self, nn) -> bool:
        return nn.rpc_ha_state()["seq"] >= self.active.rpc_ha_state()["seq"]

    def stop(self) -> None:
        for dn in self.dns:
            dn.stop()
        for nn in self.nns:
            try:
                nn.stop()
            except Exception:  # noqa: BLE001 — may already be stopped
                pass
        for jn in self.jns:
            try:
                jn.stop()
            except Exception:  # noqa: BLE001
                pass
        from hdrf_tpu.utils import retry as ref_retry
        from hdrf_tpu_torch.utils import retry as port_retry

        ref_retry.reset_breakers()
        port_retry.reset_breakers()


PAIRS = [("ref", "port"), ("port", "ref")]


@pytest.mark.parametrize("active,standby", PAIRS,
                         ids=["ref-active", "port-active"])
@pytest.mark.parametrize("journal", ["shared", "quorum"])
def test_standby_tails_and_takes_over(tmp_path, active, standby, journal):
    """A standby of the other package tails the active's journal, refuses
    mutations, knows the block map, and after failover serves the same
    namespace and new writes through the same client."""
    from hdrf_tpu.client.filesystem import HdrfClient
    from hdrf_tpu.proto.rpc import RpcClient, RpcError

    ha = Ha(str(tmp_path), active, [(standby, "standby")],
            quorum=["port", "ref", "port"] if journal == "quorum" else None)
    sb = ha.others[0]
    payload = np.random.default_rng(3).integers(
        0, 256, size=150_000, dtype=np.uint8).tobytes()
    try:
        with HdrfClient(ha.addrs(), name="ha-x") as c:
            c.write("/ha/f", payload, scheme="dedup_lz4")
            c.mkdir("/ha/d")
            _wait(lambda: ha.caught_up(sb), msg="tail catch-up")
            assert sb.rpc_stat("/ha/f")["length"] == len(payload)
            assert sb.rpc_listing("/ha") == ha.active.rpc_listing("/ha")
            with RpcClient(sb.addr) as sc:
                with pytest.raises(RpcError, match="Standby"):
                    sc.call("mkdir", path="/nope")

            def located():
                try:
                    return all(b["locations"] for b in
                               sb.rpc_get_block_locations("/ha/f")["blocks"])
                except FileNotFoundError:
                    return False
            _wait(located, msg="standby block map")
            ha.active.stop()
            assert sb.rpc_transition_to_active()
            assert sb.role == "active"
            assert c.read("/ha/f") == payload
            c.write("/ha/g", b"after failover" * 100)
            assert c.read("/ha/g") == b"after failover" * 100
    finally:
        ha.stop()


@pytest.mark.parametrize("active,standby", PAIRS,
                         ids=["ref-active", "port-active"])
def test_old_active_fenced(tmp_path, active, standby):
    """Split brain: the standby is promoted while the old active still
    runs; the old active's next mutation is fenced (StandbyError, it
    demotes) and never reaches the shared journal."""
    ha = Ha(str(tmp_path), active, [(standby, "standby")])
    nn, sb = ha.active, ha.others[0]
    try:
        nn.rpc_mkdir("/fence/a")
        _wait(lambda: ha.caught_up(sb), msg="tail catch-up")
        assert sb.rpc_transition_to_active()
        with pytest.raises(Exception) as ei:
            nn.rpc_mkdir("/fence/old-active-write")
        assert type(ei.value).__name__ == "StandbyError"
        assert nn.role == "standby"
        assert sb.rpc_transition_to_active()       # idempotent
        with pytest.raises(FileNotFoundError):
            sb.rpc_stat("/fence/old-active-write")
        assert sb.rpc_stat("/fence/a")["type"] == "dir"
    finally:
        ha.stop()


def test_port_observer_serves_reads_after_msync(tmp_path):
    """A port observer beside a reference active: the reference client's
    HA proxy routes reads to it after msync (read-your-writes), the
    observer refuses mutations and can never be promoted."""
    from hdrf_tpu.client.filesystem import HdrfClient
    from hdrf_tpu.proto.rpc import RpcClient, RpcError
    from hdrf_tpu.utils import metrics as ref_metrics

    ha = Ha(str(tmp_path), "ref", [("port", "observer")])
    ob = ha.others[0]
    reads = ref_metrics.registry("client.ha")
    r0 = reads.snapshot()["counters"].get("observer_reads", 0)
    try:
        with HdrfClient(ha.addrs(), name="obs") as c:
            c.mkdir("/obs/m")
            c.msync(wait_s=5.0)
            assert c.stat("/obs/m")["type"] == "dir"
            c.write("/obs/m/f", b"v1" * 4096)
            c.msync(wait_s=5.0)
            assert c.stat("/obs/m/f")["length"] == 8192
            assert c.read("/obs/m/f") == b"v1" * 4096
            c.rename("/obs/m/f", "/obs/m/g")
            c.msync(wait_s=5.0)
            assert c.exists("/obs/m/g") and not c.exists("/obs/m/f")
        assert reads.snapshot()["counters"].get("observer_reads", 0) > r0
        assert ob.rpc_ha_state()["role"] == "observer"
        with RpcClient(ob.addr) as oc:
            assert oc.call("stat", path="/obs/m")["type"] == "dir"
            with pytest.raises(RpcError, match="Standby"):
                oc.call("mkdir", path="/obs/nope")
            with pytest.raises(RpcError, match="observer"):
                oc.call("transition_to_active")
            st = oc.call("msync", txid=ha.active.rpc_ha_state()["seq"],
                         wait_s=5.0)
            assert st["caught_up"] and st["role"] == "observer"
    finally:
        ha.stop()


def test_port_failover_controller_promotes_standby(tmp_path):
    """The port FailoverController over [reference active, port
    standby]: the active dies and the standby is promoted."""
    from hdrf_tpu.client.filesystem import HdrfClient
    from hdrf_tpu_torch.server.failover import FailoverController

    ha = Ha(str(tmp_path), "ref", [("port", "standby")])
    sb = ha.others[0]
    assert FailoverController._choose_candidate(
        [(("h", 1), "standby", 5), (("h", 2), "standby", 9),
         (("h", 3), "observer", 50)]) == ("h", 2)
    fc = FailoverController(ha.addrs(), probe_interval_s=0.2,
                            grace=2).start()
    try:
        with HdrfClient(ha.addrs(), name="zkfc") as c:
            c.write("/ha/k", b"m" * 10_000)
            _wait(lambda: ha.caught_up(sb), msg="tail catch-up")
            ha.active.stop()
            _wait(lambda: sb.role == "active", msg="automatic failover")
            assert c.read("/ha/k") == b"m" * 10_000
    finally:
        fc.stop()
        ha.stop()


def test_quorum_standby_bootstraps_image_from_peer(tmp_path):
    """A port standby whose journal position fell behind the quorum's
    purge horizon fetches the reference active's fsimage (fetch_image)
    and catches up."""
    from hdrf_tpu.proto.rpc import RpcClient

    ha = Ha(str(tmp_path), "ref", [], quorum=["port", "ref", "port"])
    try:
        nn = ha.active
        for i in range(6):
            nn.rpc_mkdir(f"/boot/d{i}")
        nn.rpc_save_namespace()                     # purges the journal
        nn.rpc_mkdir("/boot/after")
        cfg = dict(meta_dir=os.path.join(str(tmp_path), "name-late"),
                   journal_addrs=[list(j.addr) for j in ha.jns],
                   peers=[list(nn.addr)], role="standby")
        late = _nn("port", **cfg)
        ha.nns.append(late)
        _wait(lambda: ha.caught_up(late), msg="bootstrap + tail")
        assert late.rpc_stat("/boot/d5")["type"] == "dir"
        assert late.rpc_stat("/boot/after")["type"] == "dir"
        with RpcClient(late.addr) as c:
            assert c.call("ha_state")["role"] == "standby"
    finally:
        ha.stop()

"""The port NameNode running a cluster, driven by either package's client.

A started port ``NameNode`` (heartbeats every 0.2 s, dead after 1.5 s)
with six DataNodes of either package (``native`` backend, 32 KiB
containers so they roll and seal while the test writes), and the
reference ``HdrfClient`` or the port's (``device="cpu"``): ``dedup_lz4``
files and an EC file written and
read back equal; a DataNode stopped and its blocks re-replicated by the
NameNode's ``replicate`` commands; ``ec_demote_after_s`` set at runtime,
the blocks demoted through ``stripe_demote`` and read back; a stripe
holder stopped and its stripes repaired through ``stripe_repair``.  This
is the cold-tier flow of the reference's own cluster tests, with the
port NameNode in place of the reference's.  Reference DataNodes get the
port's tolerance of two reference faults for the flow
(``_dn_standin.guard_reference_stat_race`` and
``guard_reference_report_refusal``: a refused full report ends the
reference's heartbeat thread).  Before it stops a stripe holder the flow
waits until every ``stripe_demote`` sent has run (``Cluster.settle``), and
a wait that times out prints the cluster's state
(``Cluster.diagnostics``).

Also here: the port DataNode's flight archive and ``flight_timeseries``
reply against the reference DataNode's.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pytest

from _dn_standin import (StandInNN, guard_reference_report_refusal,
                         guard_reference_stat_race, op_reply, port_dn,
                         ref_dn)

BLOCK = 256 << 10


def _wait(pred, timeout=60.0, interval=0.1, msg="condition", detail=None):
    """Poll ``pred``; a timeout names ``msg`` and, with ``detail``, the
    cluster's state then (``Cluster.diagnostics``)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    more = "" if detail is None else f"; {detail()}"
    raise AssertionError(f"timed out waiting for {msg}{more}")


NN_WATCH = ("dn_declared_dead", "dn_registered", "lifelines",
            "replications_scheduled", "excess_replicas_pruned",
            "ec_demotions_scheduled", "blocks_ec_demoted",
            "stripe_repairs_scheduled", "monitor_errors")
DN_WATCH = ("heartbeat_failures", "command_errors", "op_io_errors",
            "op_errors", "block_report_failures", "blocks_replicated",
            "blocks_invalidated", "replicate_source_missing",
            "lifelines_sent")


class Cluster:
    """A port NameNode and ``n`` DataNodes of one package."""

    def __init__(self, root: str, dn_pkg: str, n: int = 6) -> None:
        from hdrf_tpu_torch.config import NameNodeConfig
        from hdrf_tpu_torch.server.namenode import NameNode

        self.root = root
        self.dn_pkg = dn_pkg
        self.nn = NameNode(NameNodeConfig(
            meta_dir=os.path.join(root, "name"), replication=3,
            block_size=BLOCK, heartbeat_interval_s=0.2,
            dead_node_interval_s=1.5, ec_data_shards=3,
            ec_parity_shards=2, ec_demote_after_s=0.0)).start()
        # heartbeats received, by DataNode (``settle``)
        self._beats: dict[str, int] = {}
        self._beats_lock = threading.Lock()
        beat = self.nn.rpc_heartbeat

        def counted(dn_id, *a, **kw):
            with self._beats_lock:
                self._beats[dn_id] = self._beats.get(dn_id, 0) + 1
            return beat(dn_id, *a, **kw)
        self.nn.rpc_heartbeat = counted
        self.dns = [self._dn(i) for i in range(n)]
        _wait(lambda: len(self.nn._datanodes) == n, msg="registration")

    def _dn(self, i: int):
        make = port_dn if self.dn_pkg == "port" else ref_dn
        return make(os.path.join(self.root, f"dn{i}"), self.nn.addr,
                    f"dn-{i}", red={"container_size": 32 << 10},
                    dn={"heartbeat_interval_s": 0.2,
                        "block_report_interval_s": 5.0})

    def ec_registry(self):
        if self.dn_pkg == "port":
            from hdrf_tpu_torch.utils import metrics
        else:
            from hdrf_tpu.utils import metrics
        return metrics.registry("ec")

    def live_locations(self, c, path: str) -> list[set]:
        return [{loc["dn_id"] for loc in b["locations"]}
                for b in c._call("get_block_locations", path=path)["blocks"]]

    def settle(self, cmd: str) -> None:
        """Wait until no ``cmd`` command is queued at the NameNode and each
        running DataNode has sent two heartbeats since: a DataNode runs
        the commands of a heartbeat's reply before it sends the next, so
        every ``cmd`` sent to it has then run."""
        def queued() -> bool:
            with self.nn._lock:
                return any(x.get("cmd") == cmd
                           for d in self.nn._datanodes.values()
                           for x in d.commands)
        _wait(lambda: not queued(), msg=f"{cmd} commands delivered",
              detail=self.diagnostics)
        with self._beats_lock:
            mark = dict(self._beats)
        running = [dn.dn_id for dn in self.dns if dn is not None]

        def beaten() -> bool:
            with self._beats_lock:
                return all(self._beats.get(d, 0) >= mark.get(d, 0) + 2
                           for d in running)
        _wait(beaten, msg=f"{cmd} commands run", detail=self.diagnostics)

    def diagnostics(self) -> dict:
        """What a timed-out wait reports: the NameNode's scheduling
        counters and EC census, the DataNodes' command and heartbeat
        counters (each package's registry), which DataNodes it holds, and
        every block's locations."""
        from hdrf_tpu_torch.utils import metrics as port_metrics
        if self.dn_pkg == "port":
            dn_metrics = port_metrics
        else:
            from hdrf_tpu.utils import metrics as dn_metrics
        nn_c = port_metrics.registry("namenode").snapshot()["counters"]
        dn_c = dn_metrics.registry("datanode").snapshot()["counters"]
        with self.nn._lock:
            blocks = {bid: sorted(i.locations)
                      for bid, i in self.nn._blocks.items()}
            live = sorted(self.nn._datanodes)
        return {"namenode": {k: nn_c.get(k, 0) for k in NN_WATCH},
                "datanode": {k: dn_c.get(k, 0) for k in DN_WATCH},
                "ec_status": self.nn.rpc_ec_status(), "live": live,
                "running": [dn.dn_id for dn in self.dns if dn is not None],
                "locations": blocks}

    def stop(self) -> None:
        for dn in self.dns:
            if dn is not None:
                dn.stop()
        self.nn.stop()
        from hdrf_tpu.utils import retry as ref_retry
        from hdrf_tpu_torch.utils import retry as port_retry

        ref_retry.reset_breakers()
        port_retry.reset_breakers()


@pytest.mark.parametrize("dn_pkg", ["port", "ref"])
def test_reference_client_on_port_namenode(tmp_path, monkeypatch, dn_pkg):
    from hdrf_tpu.client.filesystem import HdrfClient

    _cluster_flow(tmp_path, monkeypatch, dn_pkg, HdrfClient)


@pytest.mark.parametrize("dn_pkg", ["port", "ref"])
def test_port_client_on_port_namenode(tmp_path, monkeypatch, dn_pkg):
    from hdrf_tpu_torch.client.filesystem import HdrfClient

    _cluster_flow(tmp_path, monkeypatch, dn_pkg,
                  lambda addr, name: HdrfClient(addr, name=name,
                                                device="cpu"))


def _cluster_flow(tmp_path, monkeypatch, dn_pkg, HdrfClient) -> None:
    """Write and read, re-replication, demotion and stripe repair through
    ``HdrfClient(addr, name=...)``."""
    if dn_pkg == "ref":
        guard_reference_stat_race(monkeypatch)
        guard_reference_report_refusal(monkeypatch)
    cl = Cluster(str(tmp_path), dn_pkg)
    nn = cl.nn
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, size=400_000, dtype=np.uint8).tobytes()
    files = {"/w/a": base + base[:200_000],          # 3 blocks, dedup
             "/w/b": rng.integers(0, 256, size=90_000,
                                  dtype=np.uint8).tobytes()}
    ec_data = rng.integers(0, 256, size=50_000, dtype=np.uint8).tobytes()
    try:
        with HdrfClient(nn.addr, name=f"nn-{dn_pkg}") as c:
            # ---- write and read ----------------------------------------
            for p, data in files.items():
                c.write(p, data, scheme="dedup_lz4")
            c.write("/w/ec", ec_data, ec="rs-3-2-4k")
            for p, data in files.items():
                assert c.read(p) == data
                assert c.stat(p)["length"] == len(data)
            assert c.read("/w/ec") == ec_data
            assert c.read("/w/a", offset=300_001, length=77_777) == \
                files["/w/a"][300_001:377_778]
            _wait(lambda: all(len(s) == 3 for p in files
                              for s in cl.live_locations(c, p)),
                  msg="three replicas of every block", detail=cl.diagnostics)

            # ---- re-replication ----------------------------------------
            victim = sorted(cl.live_locations(c, "/w/a")[0])[0]
            vi = int(victim.split("-")[1])
            cl.dns[vi].stop()
            cl.dns[vi] = None
            _wait(lambda: victim not in nn._datanodes, msg="dead node",
                  detail=cl.diagnostics)
            _wait(lambda: all(len(s) == 3 and victim not in s
                              for p in files
                              for s in cl.live_locations(c, p)),
                  msg="re-replication", detail=cl.diagnostics)
            for p, data in files.items():
                assert c.read(p) == data

            # ---- demotion ----------------------------------------------
            nn.config.ec_demote_after_s = 0.3
            # (a block whose chunks all sit in a still-open container has
            # nothing sealed to stripe and stays replicated, as in the
            # reference)
            _wait(lambda: c._call("ec_status")["demoted_blocks"] >= 2,
                  msg="demotion", detail=cl.diagnostics)
            _wait(lambda: c._call("ec_status")["striped_containers"] >= 1,
                  msg="striped-container census", detail=cl.diagnostics)
            # no demotion is scheduled from here on: a block demoted after
            # the stripe owners are read below (a reference DataNode
            # re-commanded after skipping a container still sealing) could
            # make the holder stopped there its owner and only replica
            nn.config.ec_demote_after_s = 0.0
            # nor may one sent before still be running: its DataNode
            # becomes that block's owner and only replica when it ends
            # (seen under load: "block 1 has no live locations" at the
            # last read)
            cl.settle("stripe_demote")
            demoted = set(nn._ec_demoted)

            def owner_only():
                return all(len(b["locations"]) == 1 for p in files
                           for b in c._call("get_block_locations",
                                            path=p)["blocks"]
                           if b["block_id"] in demoted)
            _wait(owner_only, msg="replicas invalidated down to the owner",
                  detail=cl.diagnostics)
            for p, data in files.items():
                assert c.read(p) == data

            # ---- stripe repair -----------------------------------------
            reg = cl.ec_registry()
            owners = {d.dn_id: d for d in cl.dns
                      if d is not None and d.index.stripe_manifests()}
            owner = next(iter(owners.values()))
            man = next(iter(owner.index.stripe_manifests().values()))
            # a stripe holder that owns no group, and if one exists, holds
            # no replica of the files either
            held = {d for p in files for s in cl.live_locations(c, p)
                    for d in s}
            spare = [h[0] for h in man["holders"] if h[0] not in owners]
            lost = next((d for d in spare if d not in held), spare[0])
            repaired0 = reg.counter("stripes_repaired")
            li = int(lost.split("-")[1])
            cl.dns[li].stop()
            cl.dns[li] = None
            _wait(lambda: reg.counter("stripes_repaired") > repaired0,
                  timeout=90.0, msg="stripe repair", detail=cl.diagnostics)
            _wait(lambda: all(h[0] != lost
                              for m in owner.index.stripe_manifests()
                              .values() for h in m["holders"]),
                  msg="holders re-registered", detail=cl.diagnostics)
            for p, data in files.items():
                assert c.read(p) == data
            assert c._call("ec_status")["demoted_blocks"] >= len(demoted)
    finally:
        cl.stop()


def test_flight_archive_matches_reference(tmp_path):
    """A port and a reference DataNode with ``flight_archive_dir``: the
    same archive layout and samples on disk, and the same
    ``flight_timeseries`` reply shape; history survives a restart."""
    nn = StandInNN()
    clock = {"t": 1_700_000_000.0, "m": 50.0}

    def pinned(dn):
        dn.flight._wall = lambda: clock["t"]
        dn.flight._clock = lambda: clock["m"]

    dns = {}
    replies = {}
    try:
        for pkg, make in (("ref", ref_dn), ("port", port_dn)):
            root = str(tmp_path / pkg)
            dn = make(root, nn.addr, f"dn-fa-{pkg}",
                      dn={"flight_archive_dir": "flight",
                          "flight_interval_s": 0.0})
            dns[pkg] = dn
            pinned(dn)
            for _ in range(3):
                clock["t"] += 1.0
                clock["m"] += 1.0
                dn.flight.sample_once()
            dn.flight_archive.sync()
            replies[pkg] = op_reply(dn.addr, "flight_timeseries",
                                    metric=None, limit=10)
            clock["t"] -= 3.0
            clock["m"] -= 3.0
        ref, port = replies["ref"], replies["port"]
        assert port is not None and ref is not None
        assert set(port) == set(ref)
        assert port["archived"] == ref["archived"] == 3
        assert [(s["t"], s["mono"]) for s in port["samples"]] == \
            [(s["t"], s["mono"]) for s in ref["samples"]]
        assert [sorted(s) for s in port["samples"]] == \
            [sorted(s) for s in ref["samples"]]
        files = {pkg: sorted(os.listdir(os.path.join(str(tmp_path / pkg),
                                                     "flight")))
                 for pkg in dns}
        assert files["port"] == files["ref"]
        # restart: the archive replays the three samples
        dns["port"].stop()
        dns["port"] = port_dn(str(tmp_path / "port"), nn.addr,
                              "dn-fa-port",
                              dn={"flight_archive_dir": "flight",
                                  "flight_interval_s": 0.0})
        again = op_reply(dns["port"].addr, "flight_timeseries", limit=10)
        assert again["archived"] == 3
        assert [s["t"] for s in again["samples"]] == \
            [s["t"] for s in port["samples"]]
    finally:
        for dn in dns.values():
            dn.stop()
        nn.stop()


_TICK_SCRIPT = r"""
import json, sys, tempfile
sys.path.insert(0, {tests!r})
from _nn_standin import MONITOR_TICK, close_unstarted
from {pkg}.config import NameNodeConfig
from {pkg}.server.namenode import NameNode

nn = NameNode(NameNodeConfig(meta_dir=tempfile.mkdtemp(), port=0))
before = set(sys.modules)
for name in MONITOR_TICK:
    getattr(nn, name)()
close_unstarted(nn)
print(json.dumps(sorted(set(sys.modules) - before)))
"""


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_monitor_tick_imports_nothing(tmp_path, pkg):
    """The NameNode monitor's body holds the namesystem lock, which every
    heartbeat, lifeline and client call also takes.  Run once in a fresh
    process, the reference's imports ``hdrf_tpu.ops.rs`` there
    (``_check_ec_groups``), loading JAX; the port's first import of its
    ``ops/rs`` loaded torch there, about 2 s on an idle host and past
    the cluster flow's 1.5 s dead-node verdict under the test suite's
    load (every DataNode stale at once: ``no datanodes available``).
    The port's monitor imports nothing."""
    import json
    import subprocess
    import sys

    name = "hdrf_tpu" if pkg == "ref" else "hdrf_tpu_torch"
    script = _TICK_SCRIPT.format(tests=os.path.dirname(__file__), pkg=name)
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu",
                              "PYTHONPATH": os.path.dirname(
                                  os.path.dirname(os.path.abspath(__file__)))})
    assert out.returncode == 0, out.stderr[-2000:]
    imported = json.loads(out.stdout.strip().splitlines()[-1])
    if pkg == "ref":
        assert "hdrf_tpu.ops.rs" in imported and "jax" in imported
    else:
        assert imported == []


def test_port_namenode_loads_no_torch(tmp_path):
    """The port's NameNode parses EC policies with ops/ec_policy, which
    loads no torch: a NameNode started and stopped in a fresh process,
    and its monitor run once, leave torch and the RS kernel's modules
    unloaded."""
    import json
    import subprocess
    import sys

    script = _TICK_SCRIPT.format(tests=os.path.dirname(__file__),
                                 pkg="hdrf_tpu_torch") + (
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] == 'torch'\n"
        "                        or m.endswith(('ops.rs', 'ops.rs_cuda')))))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.path.dirname(
                             os.path.dirname(os.path.abspath(__file__)))})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []

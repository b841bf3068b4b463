"""MiniCluster: in-process NameNode + N DataNodes for tests (port of
hdrf_tpu/testing/minicluster.py, whole).

Every daemon is the port's: NameNodes, JournalNodes, DataNodes, the
reduction worker process (``tpu_worker``) and the clients.  The DataNodes'
in-process reduction backend stays the reference's deterministic
``native`` unless ``backend`` names another; ``worker_backend="auto"``
resolves to ``cuda`` (ops/dispatch.resolve_backend), so
``MiniCluster(tpu_worker=True)`` runs the north-star deployment on the
card: one worker process owns it, and the DataNodes, which have no
device, send it ``reduce`` and the container seals.  ``client()`` gains
``device``, handed to the client's striped path (its RS kernel).

Equivalent of the reference's MiniDFSCluster (MiniDFSCluster.java:141,
3.2 kLoC): boots one real NameNode and N real DataNodes in one process with
per-node data dirs and ephemeral ports, plus restart/kill APIs for failure
testing (restartDataNode/stopDataNode analogs).  Fast config defaults (small
blocks, sub-second heartbeats) keep tests snappy.

``observers=N`` boots N observer NNs per nameservice (read replicas with
bounded staleness, ObserverReadProxyProvider analog) whose addrs join
``nn_addrs()`` — DNs then heartbeat/report to them, keeping their block
maps warm.  ``kill_namenode()``/``restart_namenode()`` mirror the worker
kill/restart knobs, so failover tests and the metadata-storm harness share
one deterministic path.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

from hdrf_tpu_torch.client.filesystem import HdrfClient
from hdrf_tpu_torch.config import DataNodeConfig, NameNodeConfig
from hdrf_tpu_torch.server.datanode import DataNode
from hdrf_tpu_torch.server.namenode import NameNode


class MiniCluster:
    def __init__(self, n_datanodes: int = 3, base_dir: str | None = None,
                 replication: int = 3, block_size: int = 1 << 20,
                 container_size: int = 1 << 22, heartbeat_s: float = 0.2,
                 dead_node_s: float = 1.5, ha: bool = False,
                 observers: int = 0,
                 journal_nodes: int = 0, secure: bool = False,
                 storage_types: list[str] | None = None,
                 volume_types: list[str] | None = None,
                 nameservices: int = 1,
                 tpu_worker: bool = False,
                 worker_backend: str = "auto",
                 backend: str | None = None,
                 dn_config_overrides: dict | None = None,
                 reduction_overrides: dict | None = None):
        """``journal_nodes`` > 0 boots that many JournalNodes and puts the
        edit log on the quorum (MiniQJMHACluster analog); each NN then gets
        its OWN meta_dir (only the shared-dir deployment shares one).
        ``secure`` turns on the whole security matrix: block tokens,
        delegation-token-authenticated RPCs, and encrypted data transfer.
        ``storage_types`` assigns each DN a StorageType (DISK/SSD/ARCHIVE)
        for storage-policy tests.  ``tpu_worker`` spawns ONE co-located
        reduction-worker PROCESS shared by every DN (the north-star
        out-of-process deployment; ``auto`` is the card).
        ``worker_backend`` pins the worker's backend (``"cpu"`` for the
        kernels' plain versions, ``"native"`` for the host library);
        ``backend`` pins the DNs' in-process reduction backend (default
        stays the deterministic native)."""
        self.n_datanodes = n_datanodes
        self.ha = ha
        self.n_journal = journal_nodes
        self.secure = secure
        self.storage_types = storage_types or []
        # per-DN volume types (multi-volume DNs); applies to EVERY DN
        self.volume_types = volume_types
        self.dn_config_overrides = dn_config_overrides or {}
        # knobs applied to every DN's cfg.reduction (deadline/breaker
        # tuning for resilience tests)
        self.reduction_overrides = reduction_overrides or {}
        self.tpu_worker = tpu_worker
        self.worker_backend = worker_backend
        self.backend = backend
        self._worker_proc = None
        self._worker_addr = None
        self._own_dir = base_dir is None
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="hdrf-mini-")
        self.nn_config = NameNodeConfig(
            port=0, meta_dir=os.path.join(self.base_dir, "name"),
            replication=replication, block_size=block_size,
            heartbeat_interval_s=heartbeat_s, dead_node_interval_s=dead_node_s,
            block_tokens=secure, require_token_auth=secure)
        self._dn_kw = dict(container_size=container_size)
        self._heartbeat_s = heartbeat_s
        self.namenode: NameNode | None = None
        self.standby: NameNode | None = None  # MiniQJMHACluster analog
        self.observers_n = observers
        self.observers: list[NameNode] = []   # NS 0's observers
        self._killed: list[NameNode] = []     # abruptly-dead NNs (teardown)
        # Federation (MiniDFSNNTopology analog): ``nameservices`` > 1
        # boots that many independent namespaces over the ONE DN set;
        # each entry of ``self.ns`` is {"active": NN, "standby": NN|None}
        # and NS 0 aliases self.namenode/self.standby.
        self.nameservices_n = nameservices
        assert not (nameservices > 1 and journal_nodes), \
            "per-nameservice journal quorums are not wired in MiniCluster"
        self.ns: list[dict] = []
        self.journalnodes: list = []
        self.datanodes: list[DataNode | None] = [None] * n_datanodes

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "MiniCluster":
        import dataclasses

        if self.tpu_worker:
            from hdrf_tpu_torch.server.reduction_worker import spawn_local_worker

            self._worker_proc, self._worker_addr = spawn_local_worker(
                backend=self.worker_backend)
        if self.n_journal:
            from hdrf_tpu_torch.server.journal import JournalNode

            self.journalnodes = [
                JournalNode(os.path.join(self.base_dir, f"jn{i}")).start()
                for i in range(self.n_journal)]
            self.nn_config = dataclasses.replace(
                self.nn_config,
                meta_dir=os.path.join(self.base_dir, "name-a"),
                journal_addrs=[list(j.addr) for j in self.journalnodes])
        for nsi in range(self.nameservices_n):
            cfg = self.nn_config
            if self.nameservices_n > 1:
                cfg = dataclasses.replace(
                    cfg, nameservice_id=f"ns{nsi}", block_pool_index=nsi,
                    meta_dir=os.path.join(self.base_dir, f"name-ns{nsi}"))
            active = NameNode(cfg).start()
            standby = None
            if self.ha:
                sb_cfg = dataclasses.replace(cfg, role="standby", port=0)
                if self.n_journal:
                    sb_cfg = dataclasses.replace(
                        sb_cfg,
                        meta_dir=os.path.join(self.base_dir,
                                              f"name-b-ns{nsi}"
                                              if self.nameservices_n > 1
                                              else "name-b"),
                        peers=[list(active.addr)])
                standby = NameNode(sb_cfg).start()
                if self.n_journal:
                    # peers must be symmetric: after a failover the DEMOTED
                    # original needs the new active for image bootstrap too
                    active.config.peers = [list(standby.addr)]
            observers = []
            for oi in range(self.observers_n):
                # a snappier tail than the standby default keeps observer
                # staleness (and msync waits) sub-100ms in tests
                ob_cfg = dataclasses.replace(
                    cfg, role="observer", port=0,
                    tail_interval_s=min(cfg.tail_interval_s, 0.05))
                if self.n_journal:
                    ob_cfg = dataclasses.replace(
                        ob_cfg,
                        meta_dir=os.path.join(self.base_dir,
                                              f"name-obs{oi}-ns{nsi}"
                                              if self.nameservices_n > 1
                                              else f"name-obs{oi}"),
                        peers=[list(active.addr)])
                observers.append(NameNode(ob_cfg).start())
            self.ns.append({"active": active, "standby": standby,
                            "observers": observers})
        self.namenode = self.ns[0]["active"]
        self.standby = self.ns[0]["standby"]
        self.observers = self.ns[0]["observers"]
        for i in range(self.n_datanodes):
            self.datanodes[i] = self._make_dn(i).start()
        self.wait_for_datanodes(self.n_datanodes)
        return self

    def stop_journalnode(self, i: int) -> None:
        self.journalnodes[i].stop()

    def nn_addrs(self, nsi: int = 0) -> list:
        """Addrs of ONE nameservice's NNs (active first, then standby,
        then observers — DNs report to all of them; the HA client proxy
        discovers each endpoint's role itself)."""
        ns = self.ns[nsi] if self.ns else {"active": self.namenode,
                                           "standby": self.standby,
                                           "observers": self.observers}
        addrs = [ns["active"].addr] if ns["active"] is not None else []
        if ns["standby"] is not None:
            addrs.append(ns["standby"].addr)
        addrs.extend(o.addr for o in ns.get("observers", []))
        return addrs

    def all_ns_addrs(self) -> list:
        """Nested per-nameservice addr lists (the DN's federation view)."""
        return [self.nn_addrs(i) for i in range(len(self.ns) or 1)]

    def failover(self, nsi: int = 0) -> NameNode:
        """Kill a nameservice's active NN and promote its standby
        (failover drill; other nameservices are untouched)."""
        ns = self.ns[nsi]
        assert ns["standby"] is not None, "not an HA cluster"
        ns["active"].stop()
        ns["standby"].rpc_transition_to_active()
        ns["active"], ns["standby"] = ns["standby"], None
        if nsi == 0:
            self.namenode, self.standby = ns["active"], None
        return ns["active"]

    def _make_dn(self, i: int) -> DataNode:
        cfg = DataNodeConfig(
            port=0, data_dir=os.path.join(self.base_dir, f"dn{i}"),
            heartbeat_interval_s=self._heartbeat_s,
            block_report_interval_s=5.0,
            # tests alias tmp-dir files from anywhere; production keeps the
            # secure default (no mount root = file:// aliasing disabled)
            provided_mount_root="/")
        cfg.reduction.container_size = self._dn_kw["container_size"]
        cfg.reduction.backend = self.backend or "native"  # deterministic
        if self._worker_addr is not None:
            cfg.reduction.worker_addr = list(self._worker_addr)
        cfg.encrypt_data_transfer = self.secure
        if i < len(self.storage_types):
            cfg.storage_type = self.storage_types[i]
        if self.volume_types is not None:
            cfg.volume_types = list(self.volume_types)
        for k, v in self.dn_config_overrides.items():
            setattr(cfg, k, v)
        for k, v in self.reduction_overrides.items():
            setattr(cfg.reduction, k, v)
        addr = (self.all_ns_addrs() if self.nameservices_n > 1
                else self.nn_addrs())
        return DataNode(cfg, addr, dn_id=f"dn-{i}")

    def stop(self) -> None:
        for dn in self.datanodes:
            if dn is not None:
                dn.stop()
        stopped = set()
        for ns in self.ns:
            for nn in [ns["standby"], ns["active"],
                       *ns.get("observers", [])]:
                if nn is not None and id(nn) not in stopped:
                    stopped.add(id(nn))
                    nn.stop()
        for nn in (self.standby, self.namenode, *self.observers):
            if nn is not None and id(nn) not in stopped:
                stopped.add(id(nn))
                nn.stop()
        for nn in self._killed:
            # finish tearing down abruptly-killed NNs (their RPC server is
            # already severed; stop() is idempotent for the rest)
            if id(nn) not in stopped:
                stopped.add(id(nn))
                try:
                    nn.stop()
                except Exception:  # noqa: BLE001 — already half-dead
                    pass
        for jn in self.journalnodes:
            try:
                jn.stop()
            except Exception:  # noqa: BLE001 — may already be stopped
                pass
        if self._worker_proc is not None:
            self._worker_proc.terminate()
            self._worker_proc.wait(timeout=5)
            self._worker_proc = None
        # drop per-edge circuit breakers (process-wide registry): a breaker
        # opened by THIS cluster's faults must not leak into the next test's
        # identically-named dn-N edges
        from hdrf_tpu_torch.utils import retry
        retry.reset_breakers()
        if self._own_dir:
            shutil.rmtree(self.base_dir, ignore_errors=True)
        # reclaim shm segments of RAM_DISK volumes rooted under base_dir
        # (they deliberately survive DN restarts, so sweep by origin)
        import glob
        for marker in glob.glob("/dev/shm/hdrf-ram-*/origin"):
            try:
                with open(marker) as f:
                    if f.read().startswith(
                            os.path.abspath(self.base_dir) + os.sep):
                        shutil.rmtree(os.path.dirname(marker),
                                      ignore_errors=True)
            except OSError:
                pass

    def __enter__(self) -> "MiniCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------- failure APIs

    def stop_datanode(self, i: int) -> None:
        """Clean shutdown (stopDataNode analog)."""
        dn = self.datanodes[i]
        if dn is not None:
            dn.stop()
            self.datanodes[i] = None

    def kill_datanode(self, i: int) -> None:
        """Abrupt death: close sockets without flushing (crash simulation).
        ``_crashed`` is set FIRST so in-flight receivers die without
        touching disk — a dead process cannot finalize partial replicas,
        and a post-kill finalize would race a restarted DN's recovery."""
        dn = self.datanodes[i]
        if dn is not None:
            dn._crashed = True
            dn._stop.set()
            dn._server.shutdown()
            dn._server.server_close()
            dn._sever_connections()
            # in-flight handlers must UNWIND (crashed => no disk writes)
            # before a restart may scan the same directory
            dn.await_xceivers()
            self.datanodes[i] = None

    def kill_worker(self) -> None:
        """SIGKILL the shared reduction worker (kill -9 simulation).  The
        DNs keep its now-dead address: subsequent reduced writes hit
        connection refusals, trip the per-DN worker breaker, and degrade
        to in-process passthrough."""
        assert self._worker_proc is not None, "no tpu_worker in this cluster"
        self._worker_proc.kill()
        self._worker_proc.wait(timeout=5)
        self._worker_proc = None

    def restart_worker(self) -> tuple:
        """Boot a fresh reduction worker (new ephemeral port) and repoint
        every live DN's WorkerClient at it — the out-of-band analog of
        WorkerSupervisor.on_respawn for clusters that own the worker."""
        from hdrf_tpu_torch.server.reduction_worker import spawn_local_worker

        self._worker_proc, self._worker_addr = spawn_local_worker(
            backend=self.worker_backend)
        for dn in self.datanodes:
            if dn is not None and dn._worker is not None:
                dn._worker.set_addr(tuple(self._worker_addr))
                dn.config.reduction.worker_addr = list(self._worker_addr)
        return tuple(self._worker_addr)

    def kill_namenode(self, nsi: int = 0) -> None:
        """Abrupt active-NN death (the kill_datanode/kill_worker idiom for
        the metadata plane): sever the RPC server so clients, DNs and the
        FailoverController all see a dead endpoint — no clean editlog
        close, no role handoff.  Promotion is the controller's job; full
        teardown of the corpse happens at cluster stop()."""
        ns = self.ns[nsi]
        nn = ns["active"]
        assert nn is not None, "active namenode already dead"
        nn._monitor_stop.set()
        nn._rpc.stop()
        self._killed.append(nn)
        ns["active"] = None
        if nsi == 0:
            self.namenode = None

    def restart_namenode(self) -> NameNode:
        """Stop + boot the NameNode over the same meta dir AND the same port
        (so running DNs/clients reconnect) — exercises fsimage+edits recovery.
        After kill_namenode() this reboots the corpse's config; if a
        controller promoted a standby meanwhile, the reboot comes back,
        claims the next epoch on transition only — here it restarts as
        active and the journal-epoch fencing settles who wins."""
        import dataclasses

        prev = self.namenode if self.namenode is not None else self._killed[-1]
        port = prev.addr[1]
        # the RUNNING NN's config, not the base template: with federation
        # ns0's meta_dir/identity were set by dataclasses.replace at start
        # role is forced active: a promoted ex-standby's CONFIG still says
        # standby (transition_to_active flips the runtime role only), and
        # restarting it as a standby would leave the cluster activeless
        cfg = dataclasses.replace(prev.config, port=port, role="active")
        if self.namenode is not None:
            self.namenode.stop()
        self.namenode = NameNode(cfg).start()
        if self.ns:
            self.ns[0]["active"] = self.namenode
        return self.namenode

    def restart_datanode(self, i: int) -> DataNode:
        """Boot a DN over the same data dir (restartDataNode analog) —
        exercises replica/index recovery."""
        assert self.datanodes[i] is None, f"dn{i} still running"
        self.datanodes[i] = self._make_dn(i).start()
        return self.datanodes[i]

    # ------------------------------------------------------------- helpers

    def client(self, name: str | None = None, nsi: int = 0,
               device: str = "cuda") -> HdrfClient:
        """A client of ONE nameservice (federation clients mount specific
        namespaces, viewfs-style; there is no cross-NS client view);
        ``device`` runs its striped path's RS kernel (``cpu``: the plain
        version)."""
        from hdrf_tpu_torch.config import ClientConfig

        addrs = self.nn_addrs(nsi)
        cfg = ClientConfig(encrypt_data_transfer=self.secure,
                           use_delegation_tokens=self.secure)
        return HdrfClient(addrs if len(addrs) > 1 else addrs[0], name=name,
                          config=cfg, device=device)

    def wait_for_datanodes(self, n: int, timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        with self.client("minicluster-probe") as c:
            while time.monotonic() < deadline:
                live = [d for d in c.datanode_report() if d["alive"]]
                if len(live) >= n:
                    return
                time.sleep(0.05)
        raise TimeoutError(f"{n} datanodes not live within {timeout}s")

    def wait_for_replication(self, path: str, want: int,
                             timeout: float = 15.0) -> None:
        """Block until every block of ``path`` has >= want live locations."""
        deadline = time.monotonic() + timeout
        with self.client("minicluster-probe") as c:
            while time.monotonic() < deadline:
                loc = c._nn.call("get_block_locations", path=path)
                if loc["blocks"] and all(len(b["locations"]) >= want
                                         for b in loc["blocks"]):
                    return
                time.sleep(0.1)
        raise TimeoutError(f"{path} not replicated to {want} within {timeout}s")

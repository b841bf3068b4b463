"""Twin NameNodes for the port's differential tests: one op stream run on a
reference ``hdrf_tpu`` NameNode and a port ``hdrf_tpu_torch`` NameNode,
called directly (no ``.start()``), as tests/test_namenode.py drives the
reference.

Determinism.  Before each call on each side the harness pins, for its
own thread only, ``random.shuffle`` to a generator seeded by the step
number (``_choose_targets`` shuffles), ``time.time`` and
``time.monotonic`` to the harness's own clocks (advanced only by
:meth:`Twin.advance`), ``os.urandom`` to a stream seeded by the step
number (delegation-token and block-token secrets, encryption-zone keys
and EDEK ivs) and ``getpass.getuser`` to ``SUPERUSER``.  So both
NameNodes see the same inputs, and every return value (or the exception's
type name and message), every heartbeat's ``commands``, every edit-log
byte and every fsimage byte must be equal.
"""

from __future__ import annotations

import contextlib
import getpass
import os
import random
import shutil
import threading
import time
from typing import Any, Callable

SUPERUSER = "hdfs"
WALL0 = 1_700_000_000.0
MONO0 = 10_000.0

# the body of NameNode._monitor_loop, one tick (both packages)
MONITOR_TICK = ("_check_dead_nodes", "_check_replication",
                "_check_partial_replicas", "_settle_moves", "_check_cache",
                "_recover_leases", "_check_ec_demotion",
                "_check_stripe_repair", "_check_fsck")


# reply keys only the port's NameNode has: counts of a reference
# behaviour the port changes on purpose (ROADMAP C5).  ``Twin.call``
# keeps the port's values in ``Twin.port_only`` and compares the rest.
PORT_ONLY = {"ec_status": ("demotions_deferred",
                           "stripe_groups_unrecoverable")}


class Mismatch(AssertionError):
    pass


def capture(fn: Callable[[], Any]) -> tuple:
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — both sides' errors are compared
        return ("err", type(e).__name__, str(e))


def meta_files(d: str) -> dict[str, bytes]:
    """Every file of a meta dir by relative path, VERSION without its
    ctime (the one field stamped from the wall clock at format time)."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            rel = os.path.relpath(p, d)
            if f == "journal.lock":
                continue  # flock file, empty in both
            with open(p, "rb") as fh:
                data = fh.read()
            if f == "VERSION":
                data = b"\n".join(ln for ln in data.split(b"\n")
                                  if not ln.startswith(b"ctime"))
            out[rel] = data
    return out


def close_unstarted(nn) -> None:
    """Release an unstarted NameNode (its RPC server never served, so
    ``stop()`` would wait for ``serve_forever``)."""
    nn._editlog.close()
    nn._rpc._server.server_close()
    if nn.flight_archive is not None:
        nn.flight_archive.close()


class Twin:
    """A reference and a port NameNode fed the same calls."""

    def __init__(self, root: str, **cfg: Any) -> None:
        self.root = root
        self.cfg = dict(cfg)
        self.wall = WALL0
        self.mono = MONO0
        self.step = 0
        self.dns: dict[str, dict] = {}      # dn_id -> register kwargs
        self.port_only: dict[str, dict] = {}   # method -> PORT_ONLY values
        self.ref_dir = os.path.join(root, "ref")
        self.port_dir = os.path.join(root, "port")
        self.ref = self.port = None
        self.open(self.ref_dir, self.port_dir)

    # ------------------------------------------------------------ plumbing

    @contextlib.contextmanager
    def pinned(self):
        """Pin the placement shuffle, both clocks, ``os.urandom`` and the
        superuser for this thread; any other thread (a daemon left by an
        earlier test in the same process) keeps the real ones."""
        me = threading.get_ident()
        rng = random.Random(self.step)
        urng = random.Random(f"urandom-{self.step}")
        saved = (random.shuffle, time.time, time.monotonic, os.urandom,
                 getpass.getuser)
        pins = (rng.shuffle, lambda: self.wall, lambda: self.mono,
                urng.randbytes, lambda: SUPERUSER)

        def mine(pin, real):
            return lambda *a: (pin if threading.get_ident() == me
                               else real)(*a)
        (random.shuffle, time.time, time.monotonic, os.urandom,
         getpass.getuser) = (mine(p, r) for p, r in zip(pins, saved))
        try:
            yield
        finally:
            (random.shuffle, time.time, time.monotonic, os.urandom,
             getpass.getuser) = saved

    def both(self, fn: Callable[[Any], Any], what: str = "",
             user: tuple | None = None) -> tuple:
        """Run ``fn(nn)`` on the reference, then the port, under the
        same pins (and, with ``user``, the same wire caller); return the
        reference's capture after checking the port's equals it."""
        from hdrf_tpu.server import permissions as ref_perm
        from hdrf_tpu_torch.server import permissions as port_perm

        out = []
        for nn, perm in ((self.ref, ref_perm), (self.port, port_perm)):
            with self.pinned():
                if user is not None:
                    perm.set_caller(*user)
                try:
                    out.append(capture(lambda: fn(nn)))
                finally:
                    if user is not None:
                        perm.set_caller(None, None)
        self.step += 1
        if out[0] != out[1]:
            raise Mismatch(f"step {self.step - 1} {what}:\n ref  {out[0]!r}"
                           f"\n port {out[1]!r}")
        return out[0]

    def call(self, method: str, *, user: tuple | None = None,
             expect_error: str | None = None, **kw: Any) -> Any:
        """One ``rpc_<method>`` on both; returns the result (or, for an
        expected error, the error's message)."""
        extra = PORT_ONLY.get(method, ())

        def run(nn):
            got = getattr(nn, f"rpc_{method}")(**kw)
            if extra and nn is self.port:
                self.port_only[method] = {k: got.pop(k) for k in extra}
            return got
        got = self.both(run, f"{method}({kw})", user=user)
        if expect_error is not None:
            assert got[0] == "err" and got[1] == expect_error, got
            return got[2]
        assert got[0] == "ok", (method, kw, got)
        return got[1]

    def advance(self, seconds: float) -> None:
        self.wall += seconds
        self.mono += seconds

    # ----------------------------------------------------------- datanodes

    def register(self, n: int, racks: list[str] | None = None,
                 start: int = 0, **kw: Any) -> list[str]:
        ids = []
        for i in range(start, start + n):
            dn_id = f"dn-{i}"
            reg = {"dn_id": dn_id, "addr": [f"h{i}", 1000 + i], **kw}
            if racks:
                reg["rack"] = racks[(i - start) % len(racks)]
            self.dns[dn_id] = reg
            self.call("register_datanode", **reg)
            ids.append(dn_id)
        return ids

    def heartbeat(self, dn_id: str, stats: dict | None = None) -> list:
        return self.call("heartbeat", dn_id=dn_id, stats=stats)["commands"]

    def tick(self, stats: dict | None = None) -> dict[str, list]:
        """One monitor tick on both, then a heartbeat from every live
        registered DataNode; returns the commands each one received."""
        def run(nn):
            for name in MONITOR_TICK:
                getattr(nn, name)()
        self.both(run, "monitor tick")
        cmds = {}
        for dn_id in sorted(self.ref._datanodes):
            cmds[dn_id] = self.heartbeat(dn_id, (stats or {}).get(dn_id))
        return cmds

    def ibr(self, alloc: dict, length: int, dns: list[str] | None = None,
            **kw: Any) -> None:
        """Each pipeline target of ``alloc`` (or ``dns``) reports the block."""
        for d in dns or [t["dn_id"] for t in alloc["targets"]]:
            self.call("block_received", dn_id=d, block_id=alloc["block_id"],
                      length=length, **kw)

    def write_file(self, path: str, lengths: list[int], client: str = "c1",
                   **create_kw: Any) -> list[int]:
        """create + (add_block + IBRs) per block + complete; block ids."""
        self.call("create", path=path, client=client, **create_kw)
        bids = {}
        for ln in lengths:
            a = self.call("add_block", path=path, client=client)
            self.ibr(a, ln)
            bids[a["block_id"]] = ln
        assert self.call("complete", path=path, client=client,
                         block_lengths=bids)
        return list(bids)

    # -------------------------------------------------------- persistence

    def open(self, ref_dir: str, port_dir: str) -> None:
        from hdrf_tpu.config import NameNodeConfig as RefCfg
        from hdrf_tpu.server.namenode import NameNode as RefNN
        from hdrf_tpu_torch.config import NameNodeConfig as PortCfg
        from hdrf_tpu_torch.server.namenode import NameNode as PortNN

        with self.pinned():
            self.ref = RefNN(RefCfg(meta_dir=ref_dir, **self.cfg))
        with self.pinned():
            self.port = PortNN(PortCfg(meta_dir=port_dir, **self.cfg))
        self.ref_dir, self.port_dir = ref_dir, port_dir

    def close(self) -> None:
        for nn in (self.ref, self.port):
            if nn is not None:
                close_unstarted(nn)
        self.ref = self.port = None

    def check_files(self) -> None:
        """Edit-log segments, fsimage and every other meta file equal."""
        a, b = meta_files(self.ref_dir), meta_files(self.port_dir)
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name] == b[name], f"{name} differs"

    def state(self, nn) -> dict:
        """Namespace, counters and block map of one NameNode."""
        from hdrf_tpu_torch.proto.rpc import packb

        return {"snapshot": packb(nn._snapshot()),
                "next_inode": nn._next_inode,
                "next_block_id": nn._next_block_id,
                "gen_stamp": nn._gen_stamp,
                "seq": nn._editlog.seq,
                "blocks": {b: (i.length, i.gen_stamp,
                               sorted(i.locations))
                           for b, i in sorted(nn._blocks.items())}}

    def reports(self) -> dict[str, list]:
        """Each live DataNode's full block report rebuilt from the
        reference's block map: the replicas it serves (its locations),
        at their reported generation and length."""
        out: dict[str, list] = {d: [] for d in self.ref._datanodes}
        for bid, info in sorted(self.ref._blocks.items()):
            for d in sorted(info.locations):
                if d in out:
                    gs, ln = info.reported.get(d, (info.gen_stamp,
                                                   info.length))
                    out[d].append([bid, gs, ln])
        return out

    def cross_restart(self) -> None:
        """Reopen each package on a copy of the OTHER's meta dir (the
        reference replays the port's edit log and image, the port the
        reference's), re-register and re-report the DataNodes, and check
        both reach the same namespace, counters and block map as before."""
        before = self.state(self.ref)
        reports = self.reports()
        self.close()
        n = sum(1 for d in os.listdir(self.root) if d.startswith("x"))
        ref_dir = os.path.join(self.root, f"x{n}-ref-on-port")
        port_dir = os.path.join(self.root, f"x{n}-port-on-ref")
        shutil.copytree(self.port_dir, ref_dir)
        shutil.copytree(self.ref_dir, port_dir)
        for d in (ref_dir, port_dir):
            lock = os.path.join(d, "journal.lock")
            if os.path.exists(lock):
                os.remove(lock)
        self.open(ref_dir, port_dir)
        for key in ("snapshot", "next_inode", "next_block_id", "gen_stamp",
                    "seq"):
            assert self.state(self.ref)[key] == before[key], key
            assert self.state(self.port)[key] == before[key], key
        for dn_id in sorted(reports):
            self.call("register_datanode", **self.dns[dn_id])
            self.call("block_report", dn_id=dn_id, blocks=reports[dn_id])
        after_ref, after_port = self.state(self.ref), self.state(self.port)
        assert after_ref == after_port
        assert after_ref["blocks"] == before["blocks"]

    def finish(self, paths: list[str] = ()) -> None:
        """End of a script: logs equal; checkpoint (fsimage equal); replay
        across packages; both continue with the same ops, logs equal."""
        self.check_files()
        if self.call("safemode", action="get"):
            self.call("safemode", action="leave")
        self.call("save_namespace")
        self.check_files()
        self.cross_restart()
        for p in paths:
            self.call("get_block_locations", path=p)
        if self.call("safemode", action="get"):
            # blocks whose every holder is gone keep the threshold unmet
            self.call("safemode", action="leave")
        self.call("mkdir", path="/after-restart/d")
        if self.ref._datanodes:
            self.write_file("/after-restart/f", [700])
        self.check_files()

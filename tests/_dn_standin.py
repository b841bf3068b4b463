"""Shared helpers of the DataNode tests: a stand-in NameNode, a wire client,
DataNode factories for both packages, and data-directory snapshots.

``StandInNN`` answers the DataNode protocol over ``[req_id, method,
kwargs]`` -> ``[req_id, 0, result]`` frames (the reference's RPC wire
shape): ``register_datanode`` (no block keys), ``block_report``,
``heartbeat`` (the commands queued with :meth:`StandInNN.command`),
``lifeline``, ``block_received``, ``bad_block`` and ``commit_block_sync``.
It records every IBR, so two DataNodes given the same op stream can be
held to the same reports.  With ``refuse_reports`` set it refuses full
block reports as a NameNode refuses an unregistered DataNode's (the
error frame ``[req_id, 1, {"error": "KeyError", ...}]``).

The wire client speaks the port's ``proto/datatransfer`` (the same bytes
as the reference's): ``write_block`` streams one block as a client
pipeline does and returns every ack; ``read_block`` and
``block_checksum`` return the replies of ``READ_BLOCK`` and
``BLOCK_CHECKSUM``.  Every socket has a timeout, so no test can hang.
"""

from __future__ import annotations

import os
import socket
import socketserver
import threading

from hdrf_tpu_torch.proto import datatransfer as dt
from hdrf_tpu_torch.proto.rpc import recv_frame, send_frame

TIMEOUT_S = 60.0
SMALL_CDC = dict(mask_bits=10, min_chunk=256, max_chunk=4096)
CONTAINER = 64 << 10


class StandInNN:
    """A NameNode's DataNode-facing RPCs, recorded."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.registered: dict[str, dict] = {}
        self.reports: dict[str, list] = {}
        self.ibrs: list[tuple] = []
        self.commands: dict[str, list] = {}
        self.heartbeats: dict[str, int] = {}
        self.refuse_reports = False
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                sock = self.request
                sock.settimeout(TIMEOUT_S)
                try:
                    while True:
                        req_id, method, kw = recv_frame(sock)
                        try:
                            reply = [req_id, 0, outer._answer(method, kw)]
                        except KeyError as e:
                            reply = [req_id, 1, {"error": "KeyError",
                                                 "message": str(e)}]
                        send_frame(sock, reply)
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def addr(self) -> tuple[str, int]:
        return self._server.server_address

    def _answer(self, method: str, kw: dict):
        with self.lock:
            if method == "register_datanode":
                self.registered[kw["dn_id"]] = kw
                return {"heartbeat_interval_s": 1.0, "block_keys": None,
                        "nameservice_id": "ns0", "block_pool_index": 0}
            if method == "block_report":
                if self.refuse_reports:
                    raise KeyError(f"unregistered datanode {kw['dn_id']}")
                self.reports[kw["dn_id"]] = [list(r) for r in kw["blocks"]]
                return {}
            if method == "heartbeat":
                d = kw["dn_id"]
                self.heartbeats[d] = self.heartbeats.get(d, 0) + 1
                return {"commands": self.commands.pop(d, [])}
            if method == "block_received":
                self.ibrs.append((kw["dn_id"], kw["block_id"], kw["length"],
                                  kw["gen_stamp"], bool(kw["partial"])))
                return {}
            return {}

    def command(self, dn_id: str, cmd: dict) -> None:
        """Queue ``cmd`` for ``dn_id``'s next heartbeat."""
        with self.lock:
            self.commands.setdefault(dn_id, []).append(cmd)

    def ibrs_of(self, dn_id: str) -> list[tuple]:
        with self.lock:
            return sorted(r[1:] for r in self.ibrs if r[0] == dn_id)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


# ------------------------------------------------------------ wire client

def _connect(addr) -> socket.socket:
    s = socket.create_connection(tuple(addr), timeout=TIMEOUT_S)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def write_block(addr, block_id: int, data: bytes, scheme: str = "dedup_lz4",
                targets=(), gen_stamp: int = 1, packet: int = 64 << 10,
                client: str | None = None, before_last=None) -> list:
    """WRITE_BLOCK ``data`` in ``packet``-byte packets, the acks read by a
    second thread as they come (as a client's response processor does);
    returns every ack ``(seqno, status)`` the DataNode sent, the final one
    last (a write that succeeded ends with ``(seqno of the LAST packet,
    0)``: see :func:`write_ok`).  ``before_last()`` runs just before the
    LAST packet is sent."""
    npkt = -(-len(data) // packet)
    acks: list = []
    s = _connect(addr)
    try:
        fields = dict(block_id=block_id, gen_stamp=gen_stamp, scheme=scheme,
                      targets=[dict(t) for t in targets])
        if client is not None:
            fields["_client"] = client
        dt.send_op(s, dt.WRITE_BLOCK, **fields)

        def responder():
            try:
                for _ in range(npkt + 1):
                    acks.append(dt.read_ack(s))
            except (ConnectionError, OSError):
                pass
        rt = threading.Thread(target=responder, daemon=True)
        rt.start()
        try:
            for seq, off in enumerate(range(0, len(data), packet)):
                dt.write_packet(s, seq, data[off:off + packet])
            if before_last is not None:
                before_last()
            dt.write_packet(s, npkt, b"", last=True)
        except (ConnectionError, OSError):
            pass    # the DataNode closed early: its acks tell why
        rt.join(timeout=TIMEOUT_S)
        return acks
    finally:
        s.close()


def write_ok(acks: list, data: bytes, packet: int = 64 << 10) -> bool:
    """Every packet of ``data`` and the LAST one acked, the last with
    status 0."""
    n = -(-len(data) // packet)
    return len(acks) == n + 1 and acks[-1] == (n, 0)


def read_block(addr, block_id: int, offset: int = 0,
               length: int = -1) -> tuple[dict, bytes]:
    """READ_BLOCK: (header frame, bytes of the packet run)."""
    s = _connect(addr)
    try:
        dt.send_op(s, dt.READ_BLOCK, block_id=block_id, offset=offset,
                   length=length)
        hdr = recv_frame(s)
        data = dt.collect_packets(s) if hdr.get("status") == 0 else b""
        return hdr, data
    finally:
        s.close()


def block_checksum(addr, block_id: int) -> dict:
    s = _connect(addr)
    try:
        dt.send_op(s, dt.BLOCK_CHECKSUM, block_id=block_id)
        return recv_frame(s)
    finally:
        s.close()


def op_reply(addr, op: str, **fields):
    """One op and its one reply frame (None if the DataNode closes the
    connection without answering)."""
    s = _connect(addr)
    try:
        dt.send_op(s, op, **fields)
        try:
            return recv_frame(s)
        except ConnectionError:
            return None
    finally:
        s.close()


# ------------------------------------------------- the reference's stat race

def guard_reference_stat_race(monkeypatch) -> None:
    """The reference ContainerStore's ``physical_bytes`` and
    ``container_sizes`` stat every ``.raw`` file they list, while an async
    seal may remove it in between: under concurrent writes the reference
    DataNode then fails a write (``create_rbw`` asks its volume's free
    space).  The port tolerates the vanished file; the reference, used
    here as the oracle of what is stored and answered, gets the same
    tolerance for the duration of a test, so that its unrelated race
    cannot fail a comparison."""
    from hdrf_tpu.storage import container_store as ref_cs

    def size(store, name):
        try:
            return os.path.getsize(os.path.join(store._dir, name))
        except FileNotFoundError:
            return 0

    def physical_bytes(self):
        return sum(size(self, n) for n in os.listdir(self._dir)
                   if n.endswith(".raw") or n.endswith(".sealed"))

    def container_sizes(self):
        out: dict[int, int] = {}
        for n in os.listdir(self._dir):
            stem = n.split(".")[0]
            if stem.isdigit() and (n.endswith(".raw")
                                   or n.endswith(".sealed")):
                out[int(stem)] = out.get(int(stem), 0) + size(self, n)
        return out

    monkeypatch.setattr(ref_cs.ContainerStore, "physical_bytes",
                        physical_bytes)
    monkeypatch.setattr(ref_cs.ContainerStore, "container_sizes",
                        container_sizes)


def guard_reference_report_refusal(monkeypatch) -> None:
    """The reference DataNode's periodic full block report lets an
    ``RpcError`` through: a NameNode that restarted, or declared the
    DataNode dead, refuses an unregistered dn_id's report until the next
    heartbeat re-registers it.  The reference's heartbeat thread then
    ends, and its lifeline keeps it alive at the NameNode with every
    command sent to it undelivered.  The port counts the refusal and goes
    on (tests/test_torch_cold_tier_faults.py).  A cluster of reference
    DataNodes declared dead after 1.5 s meets it under load; the
    reference, there to drive the port NameNode, gets the port's
    tolerance for the duration of a test, so that its own fault cannot
    fail the flow."""
    from hdrf_tpu.proto.rpc import RpcError
    from hdrf_tpu.server import datanode as ref_datanode

    report = ref_datanode.DataNode._send_block_report

    def send_block_report(self, nn=None):
        try:
            report(self, nn)
        except RpcError:
            if nn is not None:
                raise
            ref_datanode._M.incr("block_report_failures")

    monkeypatch.setattr(ref_datanode.DataNode, "_send_block_report",
                        send_block_report)


# -------------------------------------------------------------- factories

def _configure(cfg, root: str, backend: str, red: dict, dn: dict) -> None:
    cfg.data_dir = root
    cfg.reduction.backend = backend
    cfg.reduction.container_size = CONTAINER
    for k, v in red.items():
        setattr(cfg.reduction, k, v)
    for k, v in dn.items():
        setattr(cfg, k, v)


def port_dn(root: str, nn_addr, dn_id: str, backend: str = "native",
            red: dict | None = None, dn: dict | None = None, start=True):
    """A port DataNode on ``root`` (64 KiB containers; the small CDC
    geometry off the ``native`` backend)."""
    from hdrf_tpu_torch.config import CdcConfig, DataNodeConfig
    from hdrf_tpu_torch.server.datanode import DataNode

    cfg = DataNodeConfig()
    if backend != "native":
        cfg.reduction.cdc = CdcConfig(**SMALL_CDC)
    _configure(cfg, root, backend, red or {}, dn or {})
    node = DataNode(cfg, nn_addr, dn_id=dn_id)
    return node.start() if start else node


def ref_dn(root: str, nn_addr, dn_id: str, backend: str = "native",
           red: dict | None = None, dn: dict | None = None, start=True):
    """The reference DataNode configured as :func:`port_dn`."""
    from hdrf_tpu.config import CdcConfig, DataNodeConfig
    from hdrf_tpu.server.datanode import DataNode

    cfg = DataNodeConfig()
    if backend != "native":
        cfg.reduction.cdc = CdcConfig(**SMALL_CDC)
    _configure(cfg, root, backend, red or {}, dn or {})
    node = DataNode(cfg, nn_addr, dn_id=dn_id)
    return node.start() if start else node


def target(dn) -> dict:
    return {"dn_id": dn.dn_id, "addr": list(dn.addr)}


# ---------------------------------------------------------------- snapshots

def data_files(root: str, skip=("sc.sock",)) -> dict[str, bytes]:
    """Every file under ``root`` by relative path; the VERSION file
    without its creation time."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for name in files:
            if name in skip:
                continue
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                body = f.read()
            if name == "VERSION":
                body = b"".join(ln for ln in body.splitlines(True)
                                if not ln.startswith(b"ctime="))
            out[os.path.relpath(p, root)] = body
    return out


class _OneTick:
    """A DataNode's ``_stop`` event that lets the calling thread through
    its heartbeat loop once; every other thread sees the real event."""

    def __init__(self, real: threading.Event) -> None:
        self.real, self.me, self.waits = real, threading.get_ident(), 0

    def wait(self, timeout=None):
        if threading.get_ident() != self.me:
            return self.real.wait(timeout)
        self.waits += 1
        return self.waits > 1

    def __getattr__(self, name):
        return getattr(self.real, name)


def one_heartbeat(dn) -> None:
    """One pass of ``dn``'s heartbeat loop in this thread: the heartbeat,
    every command of its reply, and the periodic full block report."""
    real = dn._stop
    dn._stop = _OneTick(real)
    try:
        dn._heartbeat_loop()
    finally:
        dn._stop = real

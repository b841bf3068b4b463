"""The port's RpcServer and HaRpcClient against the reference on the wire.

A reference and a port ``RpcServer`` serve the same service; the same raw
request frames must get byte-identical reply frames (the state stamp
included), and the reference ``RpcClient`` / ``HaRpcClient`` and the
port's ``RpcClient`` / ``HaRpcClient`` each talk to either server.  The
side channel is checked one key at a time: the retry cache answers a
replayed ``_retry_id`` without running the handler again, a spent
deadline is refused before dispatch, ``_user`` / ``_groups`` reach the
serving package's own permissions module, ``_client`` is stripped, and
``max_handlers`` parks the accept loop past its cap.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

import msgpack
import pytest

from hdrf_tpu.proto import rpc as ref_rpc
from hdrf_tpu_torch.proto import rpc as port_rpc


def _service(perm_mod):
    class Svc:
        def __init__(self):
            self.calls = 0
            self.txid = 41

        def _rpc_state_id(self):
            return {"txid": self.txid, "role": "active", "lag_s": 0.0}

        def rpc_add(self, a, b):
            self.calls += 1
            self.txid += 1
            return a + b

        def rpc_echo(self, **kw):
            return kw

        def rpc_whoami(self):
            return list(perm_mod.caller())

        def rpc_boom(self, kind="ValueError"):
            raise {"ValueError": ValueError, "FileExistsError":
                   FileExistsError, "KeyError": KeyError}[kind]("kapow")

        def rpc_standby(self):
            raise type("StandbyError", (Exception,), {})("namenode is standby")

        def rpc_slow(self, s=0.3):
            time.sleep(s)
            return s

    return Svc()


def _servers(max_handlers=None):
    from hdrf_tpu.server import permissions as ref_perm
    from hdrf_tpu_torch.server import permissions as port_perm

    ref = ref_rpc.RpcServer("127.0.0.1", 0, _service(ref_perm), "namenode",
                            max_handlers=max_handlers).start()
    port = port_rpc.RpcServer("127.0.0.1", 0, _service(port_perm),
                              "namenode", max_handlers=max_handlers).start()
    return ref, port


@pytest.fixture
def servers():
    ref, port = _servers()
    yield ref, port
    ref.stop()
    port.stop()


def _raw(addr, body) -> bytes:
    """Send one request frame, return the raw reply frame's body bytes."""
    with socket.create_connection(addr, timeout=10) as s:
        payload = msgpack.packb(body)
        s.sendall(struct.pack("<I", len(payload)) + payload)
        (n,) = struct.unpack("<I", _recv(s, 4))
        return _recv(s, n)


def _recv(s, n) -> bytes:
    buf = b""
    while len(buf) < n:
        got = s.recv(n - len(buf))
        if not got:
            raise ConnectionError("closed")
        buf += got
    return buf


REQUESTS = {
    "ok": [1, "add", {"a": 2, "b": 3}],
    "bytes": [2, "echo", {"blob": b"\x00\xff" * 40, "n": {"k": [1, 2.5]},
                          "_client": "tenant-a"}],
    "error": [3, "boom", {"kind": "FileExistsError"}],
    "keyerror": [4, "boom", {"kind": "KeyError"}],
    "typed": [5, "standby", {}],
    "no_method": [6, "nope", {}],
    "bad_kwargs": [7, "add", {"a": 1}],
    "deadline": [8, "add", {"a": 1, "b": 1, "_deadline": 0}],
    "trace": [9, "add", {"a": 1, "b": 2, "_trace": [7, 9]}],
    "caller": [10, "whoami", {"_user": "alice", "_groups": ["staff"]}],
    "sid_dtoken": [11, "add", {"a": 0, "b": 0, "_sid": 5, "_dtoken": None}],
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_reply_frames_match_reference(servers, name):
    """The same request frame gets the same reply bytes from both
    servers: result or {"error", "message"}, and the state stamp."""
    ref, port = servers
    a = _raw(ref.addr, REQUESTS[name])
    b = _raw(port.addr, REQUESTS[name])
    assert a == b
    reply = msgpack.unpackb(a, raw=False, strict_map_key=False)
    assert len(reply) == 4 and reply[3]["role"] == "active"


@pytest.mark.parametrize("client", ["ref", "port"])
@pytest.mark.parametrize("server", ["ref", "port"])
def test_clients_talk_to_either_server(servers, client, server):
    """RpcClient of either package against the server of either:
    results, typed errors and the state stamp's txid high-water."""
    srv = servers[0] if server == "ref" else servers[1]
    mod = ref_rpc if client == "ref" else port_rpc
    with mod.RpcClient(srv.addr) as c:
        assert c.call("add", a=2, b=3) == 5
        assert c.last_seen_txid == srv._service.txid
        assert c.call("echo", blob=b"\x01" * 3) == {"blob": b"\x01" * 3}
        with pytest.raises(mod.RpcError) as ei:
            c.call("boom", kind="FileExistsError")
        assert ei.value.error == "FileExistsError"
        with pytest.raises(mod.RpcError) as ei:
            c.call("nope")
        assert ei.value.error == "NoSuchMethod"
        assert c.call("whoami") == [None, []]


@pytest.mark.parametrize("client", ["ref", "port"])
def test_retry_cache_replays_without_rerun(servers, client):
    """A replayed _retry_id is answered from the port server's retry
    cache: the handler runs once, both replies are equal."""
    port = servers[1]
    mod = ref_rpc if client == "ref" else port_rpc
    with mod.RpcClient(port.addr) as c:
        n0 = port._service.calls
        a = c.call("add", a=1, b=2, _retry_id="r-1")
        b = c.call("add", a=1, b=2, _retry_id="r-1")
        assert a == b == 3
        assert port._service.calls == n0 + 1
        c.call("add", a=1, b=2, _retry_id="r-2")
        assert port._service.calls == n0 + 2


def test_spent_deadline_refused_before_dispatch(servers):
    port = servers[1]
    n0 = port._service.calls
    reply = msgpack.unpackb(
        _raw(port.addr, [1, "add", {"a": 1, "b": 1, "_deadline": -0.5}]),
        raw=False)
    assert reply[1] == 1 and reply[2]["error"] == "DeadlineExceeded"
    assert port._service.calls == n0
    ok = msgpack.unpackb(
        _raw(port.addr, [2, "add", {"a": 1, "b": 1, "_deadline": 5.0}]),
        raw=False)
    assert ok[:3] == [2, 0, 2]


def test_max_handlers_backpressure():
    """With max_handlers=1 a second connection waits in the listen queue
    until the first one closes (both packages)."""
    ref, port = _servers(max_handlers=1)
    try:
        for srv, mod in ((ref, ref_rpc), (port, port_rpc)):
            first = mod.RpcClient(srv.addr)
            assert first.call("add", a=1, b=1) == 2
            done = threading.Event()
            out = []

            def second():
                with mod.RpcClient(srv.addr, timeout=10) as c:
                    out.append(c.call("add", a=2, b=2))
                done.set()

            th = threading.Thread(target=second, daemon=True)
            th.start()
            assert not done.wait(0.5)          # parked behind the cap
            assert srv._handler_threads == 1
            first.close()
            assert done.wait(5) and out == [4]
            th.join(5)
    finally:
        ref.stop()
        port.stop()


@pytest.mark.parametrize("client", ["ref", "port"])
def test_ha_client_fails_over_to_the_active(client):
    """HaRpcClient of either package over [standby, active] port servers:
    the StandbyError bounce rotates to the active; a dead first address
    too; one retry id per logical call."""
    from hdrf_tpu_torch.server import permissions as port_perm

    mod = ref_rpc if client == "ref" else port_rpc

    class Standby:
        def _rpc_state_id(self):
            return {"txid": 3, "role": "standby", "lag_s": 0.0}

        def rpc_add(self, a, b):
            raise type("StandbyError", (Exception,), {})("standby")

        def rpc_ha_state(self):
            return {"role": "standby"}

    act = _service(port_perm)
    act.rpc_ha_state = lambda: {"role": "active"}
    sb = port_rpc.RpcServer("127.0.0.1", 0, Standby(), "sb").start()
    ac = port_rpc.RpcServer("127.0.0.1", 0, act, "namenode").start()
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_addr = dead.getsockname()
    dead.close()
    try:
        with mod.HaRpcClient([sb.addr, ac.addr], timeout=5) as c:
            assert c.call("add", a=3, b=4) == 7
            assert c.last_seen_txid == act.txid
        with mod.HaRpcClient([dead_addr, ac.addr], timeout=5) as c:
            assert c.call("add", a=1, b=1) == 2
            n = act.calls
            assert c.call("add", a=1, b=1) == 2
            assert act.calls == n + 1
    finally:
        sb.stop()
        ac.stop()


def test_port_server_profiles_namenode_requests(servers):
    """The namenode-named server keeps per-method latency books and the
    phase decomposition (rpc_p99_ms, contention_summary)."""
    port = servers[1]
    with port_rpc.RpcClient(port.addr) as c:
        for i in range(5):
            c.call("add", a=i, b=i)
    summary = port.contention_summary()
    assert summary["methods"]["add"]["calls"] >= 5
    assert set(summary["methods"]["add"]["phase_us"]) >= {
        "frame_read", "handler", "serialize"}
    assert port.rpc_p99_ms() > 0 and 0 < port.attributed_frac() <= 1.0

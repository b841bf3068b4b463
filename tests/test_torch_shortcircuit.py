"""Short-circuit reads across packages (server/shortcircuit.py).

The port's ``ShortCircuitServer`` in the port DataNode and its
``ShortCircuitCache`` in the port client speak the reference's wire
(JSON, SCM_RIGHTS fd passing, shm slot segments), so each package's
client reads through the other's DataNode:

- a ``direct`` replica answers with its fd, which the client caches
  behind a shm slot; a reduced replica answers with metadata only and the
  client reads it over TCP;
- an append re-finalizes the block and a delete invalidates it: the
  DataNode zeroes the slot, and the next read drops the cached fd instead
  of serving stale bytes;
- a client that dies (killed, or gone mid-handshake) frees its segment;
- with block tokens on, a request without a valid READ token is denied.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from _dn_standin import guard_reference_stat_race

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 256 << 10
RNG = np.random.default_rng(23)


@pytest.fixture(scope="module", autouse=True)
def _reference_stat_race():
    """The reference DataNodes get the port's tolerance of their
    ContainerStore's stat race (``_dn_standin.guard_reference_stat_race``)."""
    with pytest.MonkeyPatch.context() as mp:
        guard_reference_stat_race(mp)
        yield


def _bytes(n: int) -> bytes:
    return RNG.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _mod(pkg: str, path: str):
    import importlib

    return importlib.import_module(
        ("hdrf_tpu." if pkg == "ref" else "hdrf_tpu_torch.") + path)


def _reg(pkg: str, name: str):
    return _mod(pkg, "utils.metrics").registry(name)


def _cluster(pkg: str, **kw):
    """One DataNode: every block, an append's rewrite included, lands on
    the replica the client's cached fd maps."""
    mc = _mod(pkg, "testing.minicluster").MiniCluster(
        n_datanodes=1, replication=1, block_size=BLOCK,
        container_size=32 << 10, **kw)
    return mc.start()


def _client(pkg: str, mc, name: str, **cfg):
    addrs = mc.nn_addrs()
    conf = _mod(pkg, "config").ClientConfig(
        encrypt_data_transfer=mc.secure, use_delegation_tokens=mc.secure,
        **cfg)
    kw = {"device": "cpu"} if pkg == "port" else {}
    return _mod(pkg, "client.filesystem").HdrfClient(addrs[0], name=name,
                                                     config=conf, **kw)


def _stop(mc) -> None:
    mc.stop()
    for pkg in ("ref", "port"):
        _mod(pkg, "utils.retry").reset_breakers()


def _dn_of(mc, addr):
    return next(d for d in mc.datanodes
                if d is not None and tuple(d.addr) == tuple(addr))


def _wait(pred, timeout=20.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


COMBOS = [("port", "port"), ("port", "ref"), ("ref", "port")]
IDS = [f"dn_{d}-client_{c}" for d, c in COMBOS]


@pytest.fixture(scope="module")
def clusters():
    made: dict = {}

    def get(pkg: str):
        if pkg not in made:
            made[pkg] = _cluster(pkg)
        return made[pkg]
    yield get
    for mc in made.values():
        _stop(mc)


@pytest.mark.parametrize("dn_pkg,client_pkg", COMBOS, ids=IDS)
def test_fd_grant_and_metadata_only(clusters, dn_pkg, client_pkg):
    mc = clusters(dn_pkg)
    direct, reduced = _bytes(BLOCK + 70_000), _bytes(90_000)
    creg, dreg = _reg(client_pkg, "client"), _reg(dn_pkg, "shortcircuit")
    csc = _reg(client_pkg, "shortcircuit")
    with _client(client_pkg, mc, f"g-{client_pkg}") as c:
        p = f"/g/{client_pkg}"
        c.write(p + "d", direct, scheme="direct")
        c.write(p + "r", reduced, scheme="dedup_lz4")
        sc0, fd0 = creg.counter("short_circuit_reads"), \
            dreg.counter("fds_passed")
        assert c.read(p + "d") == direct
        assert creg.counter("short_circuit_reads") - sc0 == 2
        # the DataNode counts a grant after its reply is on the wire
        _wait(lambda: dreg.counter("fds_passed") - fd0 == 2,
              what="two fds passed")
        # cached fds serve the next reads, aligned or not
        hits0 = csc.counter("cached_fd_reads")
        assert c.read(p + "d", offset=65_536, length=BLOCK) == \
            direct[65_536:65_536 + BLOCK]
        assert c.read(p + "d", offset=12_345, length=777) == \
            direct[12_345:13_122]
        assert csc.counter("cached_fd_reads") - hits0 == 3
        assert dreg.counter("fds_passed") - fd0 == 2
        # a reduced replica passes no fd: metadata only, then TCP
        md0, sc1 = dreg.counter("metadata_only"), \
            creg.counter("short_circuit_reads")
        assert c.read(p + "r") == reduced
        _wait(lambda: dreg.counter("metadata_only") - md0 == 1,
              what="a metadata-only reply")
        assert creg.counter("short_circuit_reads") == sc1


@pytest.mark.parametrize("dn_pkg,client_pkg", COMBOS, ids=IDS)
def test_append_revokes_cached_fd(clusters, dn_pkg, client_pkg):
    mc = clusters(dn_pkg)
    head, tail = _bytes(100_000), _bytes(50_000)
    csc = _reg(client_pkg, "shortcircuit")
    rev0 = _reg(dn_pkg, "shortcircuit").counter("slots_revoked")
    with _client(client_pkg, mc, f"a-{client_pkg}") as c:
        p = f"/ap/{client_pkg}"
        c.write(p, head, scheme="direct")
        assert c.read(p) == head                  # fd cached
        c.append(p, tail)
        r0 = csc.counter("cached_fd_revoked")
        assert c.read(p) == head + tail           # never the stale replica
        assert csc.counter("cached_fd_revoked") - r0 == 1
        assert _reg(dn_pkg, "shortcircuit").counter("slots_revoked") > rev0


@pytest.mark.parametrize("dn_pkg,client_pkg", COMBOS, ids=IDS)
def test_delete_revokes_cached_fd(clusters, dn_pkg, client_pkg):
    mc = clusters(dn_pkg)
    old, new = _bytes(80_000), _bytes(80_000)
    csc = _reg(client_pkg, "shortcircuit")
    with _client(client_pkg, mc, f"d-{client_pkg}") as c:
        p = f"/del/{client_pkg}"
        c.write(p, old, scheme="direct")
        loc = c._call("get_block_locations", path=p)["blocks"][0]
        bid, sc = loc["block_id"], loc["locations"][0]["sc_path"]
        dn = _dn_of(mc, loc["locations"][0]["addr"])
        assert c.read(p) == old                   # fd cached
        c.delete(p)
        _wait(lambda: dn.replicas.get_meta(bid) is None,
              what="the replica invalidated")
        r0 = csc.counter("cached_fd_revoked")
        assert c._sc_cache.read(sc, bid, 0, -1) is None
        assert csc.counter("cached_fd_revoked") - r0 == 1
        c.write(p, new, scheme="direct")
        assert c.read(p) == new


def _shm_count(dn) -> int:
    return len(dn._sc.registry._shms)


@pytest.mark.parametrize("dn_pkg", ["port", "ref"])
def test_dead_client_frees_segment(clusters, dn_pkg):
    mc = clusters(dn_pkg)
    data = _bytes(60_000)
    reg = _reg(dn_pkg, "shortcircuit")
    with _client("port", mc, "seg") as c:
        c.write("/seg/" + dn_pkg, data, scheme="direct")
        loc = c._call("get_block_locations",
                      path="/seg/" + dn_pkg)["blocks"][0]
    bid, sc = loc["block_id"], loc["locations"][0]["sc_path"]
    dn = _dn_of(mc, loc["locations"][0]["addr"])
    base = _shm_count(dn)
    # a client process of the other package, killed with its segment
    other = "hdrf_tpu" if dn_pkg == "port" else "hdrf_tpu_torch"
    code = (f"import sys, time\n"
            f"from {other}.server.shortcircuit import ShortCircuitCache\n"
            f"cache = ShortCircuitCache()\n"
            f"out = cache.read({sc!r}, {bid}, 0, -1)\n"
            f"print(len(out), flush=True)\n"
            f"time.sleep(120)\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == str(len(data))
        assert _shm_count(dn) == base + 1
        freed0 = reg.counter("shms_freed")
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        _wait(lambda: _shm_count(dn) == base
              and reg.counter("shms_freed") - freed0 == 1,
              what="the segment freed")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    # gone mid-handshake: the request sent, the reply never read
    alloc0, freed0 = reg.counter("shms_allocated"), reg.counter("shms_freed")
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(sc)
    s.sendall(json.dumps({"op": "alloc_shm"}).encode())
    s.close()
    _wait(lambda: reg.counter("shms_freed") - freed0 == 1,
          what="the half-open segment freed")
    assert reg.counter("shms_allocated") - alloc0 == 1
    assert _shm_count(dn) == base


@pytest.mark.parametrize("dn_pkg", ["port", "ref"])
def test_token_denied_without_read_token(dn_pkg):
    mc = _cluster(dn_pkg, secure=True)
    try:
        data = _bytes(70_000)
        other = "ref" if dn_pkg == "port" else "port"
        with _client(other, mc, "tok") as c:
            c.write("/tok/f", data, scheme="direct")
            loc = c._call("get_block_locations", path="/tok/f")["blocks"][0]
            bid, tok = loc["block_id"], loc["token"]
            sc = loc["locations"][0]["sc_path"]
            dreg = _reg(dn_pkg, "shortcircuit")
            rl = _mod(other, "server.shortcircuit").read_local
            rej0 = dreg.counter("token_rejected")
            assert rl(sc, bid, 0, -1, token=None) is None
            forged = dict(tok, sig=bytes(32))
            assert rl(sc, bid, 0, -1, token=forged) is None
            assert dreg.counter("token_rejected") - rej0 == 2
            assert rl(sc, bid, 0, -1, token=tok) == data
            sc0 = _reg(other, "client").counter("short_circuit_reads")
            assert c.read("/tok/f") == data
            assert _reg(other, "client").counter("short_circuit_reads") \
                - sc0 == 1
    finally:
        _stop(mc)

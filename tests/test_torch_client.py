"""The port client (client/filesystem.py ``HdrfClient``) against clusters
of both packages, and the reference client against the port's cluster.

Three pairings, each a cluster package and a client package: the port
client on a port ``MiniCluster``, the port client on a reference one, and
the reference client on a port one (``native`` DataNodes, 256 KiB blocks,
32 KiB containers; the port client on ``device="cpu"``).  Each pairing
runs the same flows, compared only on what is deterministic (client
names, DEKs and the hedge timing are random):

- ``dedup_lz4``, ``direct`` and default-scheme files written and read
  whole and at odd ranges across block boundaries, read back equal by the
  other package's client too; ``get_file_checksum`` equal to ``crc32c``
  of the bytes and to the other client's;
- append within and across blocks, truncate mid-block and to a block
  boundary;
- ``open_for_write`` with ``hflush`` visible to a reader of the other
  package while the file is open, ``hsync``, close;
- rename, delete into the trash and ``expunge``, ``concat``, listing;
- an encryption zone: plaintext back to both clients, ciphertext on the
  DataNodes;
- the metadata cache: a repeated ``stat`` hits, a mutation by the client
  invalidates it;
- on an HA cluster with a journal quorum and an observer: observer reads
  after ``msync``, and a hedged read whose first location is stopped.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import pytest

from _dn_standin import guard_reference_stat_race

BLOCK = 256 << 10
RNG = np.random.default_rng(41)

COMBOS = [("port", "port"), ("ref", "port"), ("port", "ref")]
IDS = [f"cluster_{c}-client_{k}" for c, k in COMBOS]


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
    return importlib.import_module(
        ("hdrf_tpu." if pkg == "ref" else "hdrf_tpu_torch.") + path)


def _reg(pkg: str, name: str):
    return _mod(pkg, "utils.metrics").registry(name)


def _client(pkg: str, addrs, name: str, **cfg):
    conf = _mod(pkg, "config").ClientConfig(**cfg)
    kw = {"device": "cpu"} if pkg == "port" else {}
    return _mod(pkg, "client.filesystem").HdrfClient(
        addrs if len(addrs) > 1 else addrs[0], name=name, config=conf, **kw)


def _other(pkg: str) -> str:
    return "ref" if pkg == "port" else "port"


def _crc(data: bytes) -> int:
    from hdrf_tpu_torch import native

    return native.crc32c(data)


def _reset_breakers() -> None:
    for pkg in ("ref", "port"):
        _mod(pkg, "utils.retry").reset_breakers()


@pytest.fixture(scope="module")
def clusters():
    made: dict = {}

    def get(pkg: str):
        if pkg not in made:
            mc = _mod(pkg, "testing.minicluster").MiniCluster(
                n_datanodes=3, replication=2, block_size=BLOCK,
                container_size=32 << 10).start()
            mc.namenode.rpc_create_encryption_key("zk1")
            mc.namenode.rpc_mkdir("/secure")
            mc.namenode.rpc_create_encryption_zone("/secure", "zk1")
            made[pkg] = mc
        return made[pkg]
    yield get
    for mc in made.values():
        mc.stop()
    _reset_breakers()


@pytest.mark.parametrize("cluster_pkg,client_pkg", COMBOS, ids=IDS)
def test_write_read_and_checksum(clusters, cluster_pkg, client_pkg):
    mc = clusters(cluster_pkg)
    base = _bytes(300_000)
    files = {"dedup_lz4": base + _bytes(200_000) + base,   # 3 blocks, dups
             "direct": _bytes(BLOCK + 1),
             None: _bytes(90_001)}
    addrs = mc.nn_addrs()
    d = f"/rw/{client_pkg}"
    with _client(client_pkg, addrs, f"rw-{client_pkg}") as c, \
            _client(_other(client_pkg), addrs, "rw-other") as o:
        for scheme, data in files.items():
            p = f"{d}/{scheme}"
            c.write(p, data, scheme=scheme)
            assert c.stat(p)["length"] == len(data)
            for reader in (c, o):
                assert reader.read(p) == data
            for off, ln in ((BLOCK - 3, 7), (12_345, 300_000), (0, 1),
                            (len(data) - 5, 100)):
                assert c.read(p, offset=off, length=ln) == data[off:off + ln]
            ck = c.get_file_checksum(p)
            assert ck == o.get_file_checksum(p)
            assert ck["algorithm"] == "COMPOSITE-CRC32C"
            assert ck["crc"] == _crc(data) and ck["length"] == len(data)
        assert sorted(e["name"] for e in c.ls(d)) == \
            sorted(str(s) for s in files)


@pytest.mark.parametrize("cluster_pkg,client_pkg", COMBOS, ids=IDS)
def test_append_and_truncate(clusters, cluster_pkg, client_pkg):
    mc = clusters(cluster_pkg)
    a, b, t = _bytes(200_000), _bytes(100_000), _bytes(400_000)
    with _client(client_pkg, mc.nn_addrs(), f"at-{client_pkg}") as c:
        p = f"/at/{client_pkg}"
        c.write(p, a, scheme="dedup_lz4")
        c.append(p, b)                       # within the last block
        assert c.read(p) == a + b
        c.append(p, t)                       # across a block boundary
        data = a + b + t
        assert c.read(p) == data
        assert c.read(p, offset=BLOCK - 10, length=20) == \
            data[BLOCK - 10:BLOCK + 10]
        assert c.get_file_checksum(p)["crc"] == _crc(data)
        assert c.truncate(p, BLOCK + 12_345)
        assert c.read(p) == data[:BLOCK + 12_345]
        assert c.truncate(p, BLOCK)
        assert c.read(p) == data[:BLOCK]
        assert c.stat(p)["length"] == BLOCK


@pytest.mark.parametrize("cluster_pkg,client_pkg", COMBOS, ids=IDS)
def test_hflush_hsync_visible_to_other_reader(clusters, cluster_pkg,
                                             client_pkg):
    mc = clusters(cluster_pkg)
    parts = [_bytes(70_000), _bytes(BLOCK), _bytes(33_333)]
    addrs = mc.nn_addrs()
    p = f"/wal/{client_pkg}"
    with _client(client_pkg, addrs, f"w-{client_pkg}") as w, \
            _client(_other(client_pkg), addrs, "w-reader") as r:
        out = w.open_for_write(p)
        out.write(parts[0])
        out.hflush()
        assert r.read(p) == parts[0]
        out.write(parts[1])                  # crosses a block boundary
        out.hsync()
        assert r.read(p) == parts[0] + parts[1]
        out.write(parts[2])
        out.close()
        data = b"".join(parts)
        assert r.read(p) == w.read(p) == data
        assert w.stat(p)["length"] == len(data)
        assert _reg(client_pkg, "client").counter("hsyncs") >= 1


@pytest.mark.parametrize("cluster_pkg,client_pkg", COMBOS, ids=IDS)
def test_namespace_trash_and_concat(clusters, cluster_pkg, client_pkg):
    mc = clusters(cluster_pkg)
    d = f"/ns/{client_pkg}"
    parts = [_bytes(BLOCK), _bytes(BLOCK), _bytes(5_000)]
    with _client(client_pkg, mc.nn_addrs(), f"ns-{client_pkg}") as c:
        assert c.mkdir(d + "/sub")
        for i, data in enumerate(parts):
            c.write(f"{d}/p{i}", data, scheme="direct")
        assert c.concat(f"{d}/p0", [f"{d}/p1", f"{d}/p2"])
        assert c.read(f"{d}/p0") == b"".join(parts)
        assert not c.exists(f"{d}/p1")
        assert c.rename(f"{d}/p0", f"{d}/sub/all")
        assert c.exists(f"{d}/sub/all") and not c.exists(f"{d}/p0")
        # delete into the trash: gone from its path, kept under the trash
        assert c.delete(f"{d}/sub/all", skip_trash=False)
        assert not c.exists(f"{d}/sub/all")
        trashed = [e["name"] for e in c.ls(c._trash_root())
                   if e["name"].endswith(f"ns%2F{client_pkg}%2Fsub%2Fall")]
        assert len(trashed) == 1
        got = c.read(f"{c._trash_root()}/{trashed[0]}")
        assert got == b"".join(parts)
        assert c.expunge(older_than_s=0.0) >= 1
        assert not any(e["name"] == trashed[0]
                       for e in c.ls(c._trash_root()))
        assert c.delete(d + "/sub")
        assert c.ls(d) == []


@pytest.mark.parametrize("cluster_pkg,client_pkg", COMBOS, ids=IDS)
def test_encryption_zone(clusters, cluster_pkg, client_pkg):
    from hdrf_tpu_torch.proto import datatransfer as dt

    mc = clusters(cluster_pkg)
    data = _bytes(BLOCK + 10_000)
    addrs = mc.nn_addrs()
    p = f"/secure/{client_pkg}"
    with _client(client_pkg, addrs, f"ez-{client_pkg}") as c, \
            _client(_other(client_pkg), addrs, "ez-other") as o:
        c.write(p, data, scheme="direct")
        assert c.read(p) == o.read(p) == data
        assert c.read(p, offset=99, length=BLOCK) == data[99:99 + BLOCK]
        blocks = c._call("get_block_locations", path=p)["blocks"]
        stored = b"".join(dt.fetch_block(tuple(b["locations"][0]["addr"]),
                                         b["block_id"]) for b in blocks)
        assert len(stored) == len(data) and stored != data
        # the checksum covers what the DataNodes hold
        assert c.get_file_checksum(p)["crc"] == _crc(stored) == \
            o.get_file_checksum(p)["crc"]


@pytest.mark.parametrize("cluster_pkg,client_pkg", COMBOS, ids=IDS)
def test_metadata_cache(clusters, cluster_pkg, client_pkg):
    mc = clusters(cluster_pkg)
    reg = _reg(client_pkg, "client")
    data = _bytes(40_000)
    with _client(client_pkg, mc.nn_addrs(), f"mc-{client_pkg}",
                 metadata_cache_ttl_s=60.0) as c:
        p = f"/mcache/{client_pkg}"
        c.write(p, data, scheme="direct")
        h0, m0 = reg.counter("meta_cache_hits"), \
            reg.counter("meta_cache_misses")
        st = c.stat(p)
        assert c.stat(p) == st and c.read(p) == data and c.read(p) == data
        assert reg.counter("meta_cache_hits") - h0 == 2
        assert reg.counter("meta_cache_misses") - m0 == 2
        # the client's own mutation: the append's read of its last block,
        # the stat and the read after it all miss
        c.append(p, data)
        assert c.stat(p)["length"] == 2 * len(data)
        assert c.read(p) == data + data
        assert reg.counter("meta_cache_misses") - m0 == 5
        assert reg.counter("meta_cache_hits") - h0 == 2


@pytest.mark.parametrize("cluster_pkg,client_pkg", COMBOS, ids=IDS)
def test_observer_and_hedged_reads(cluster_pkg, client_pkg):
    mini = _mod(cluster_pkg, "testing.minicluster")
    ha = _reg(client_pkg, "client.ha")
    creg = _reg(client_pkg, "client")
    data = _bytes(BLOCK + 50_000)
    with mini.MiniCluster(n_datanodes=3, replication=3, block_size=BLOCK,
                          container_size=32 << 10, ha=True,
                          journal_nodes=3, observers=1) as mc:
        addrs = mc.nn_addrs()
        assert len(addrs) == 3
        with _client(client_pkg, addrs, f"ha-{client_pkg}",
                     short_circuit=False) as c:
            c.write("/ha/f", data, scheme="dedup_lz4")
            c.msync(wait_s=5.0)
            r0 = ha.counter("observer_reads")
            assert c.stat("/ha/f")["length"] == len(data)
            deadline = time.monotonic() + 10
            while True:        # observer block maps trail the IBRs
                loc = c._call("get_block_locations", path="/ha/f")
                if all(len(b["locations"]) == 3 for b in loc["blocks"]):
                    break
                assert time.monotonic() < deadline, loc
                time.sleep(0.05)
            assert c.read("/ha/f") == data
            assert ha.counter("observer_reads") > r0
            # hedged: the first location of every block stopped
            first = tuple(loc["blocks"][0]["locations"][0]["addr"])
            i = next(j for j, d in enumerate(mc.datanodes)
                     if tuple(d.addr) == first)
            mc.stop_datanode(i)
            h0, w0 = creg.counter("read_hedges_fired"), \
                creg.counter("read_hedge_wins")
            assert c.read("/ha/f", offset=0, length=BLOCK) == data[:BLOCK]
            assert creg.counter("read_hedges_fired") > h0
            assert creg.counter("read_hedge_wins") > w0
    _reset_breakers()


@pytest.mark.parametrize("close_after", [None, 3])
def test_ack_pump_reads_acks_while_sending(close_after):
    """``datatransfer.stream_acked`` returns every ack in order while the
    packets are still being sent (an ``AckPump``); a receiver that hangs
    up after ``close_after`` packets makes it raise instead of waiting
    for acks that never come."""
    import socket
    import threading

    from hdrf_tpu_torch.proto import datatransfer as dt

    data = _bytes(40 * dt.DEFAULT_PACKET + 5)
    npkts = 42
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def receiver():
        c, _ = srv.accept()
        with c:
            for seq, _d, _last in dt.iter_packets(c):
                if seq == close_after:
                    return
                dt.send_ack(c, seq, dt.ACK_ERROR if seq == 7 else 0)
    t = threading.Thread(target=receiver, daemon=True)
    t.start()
    with socket.create_connection(srv.getsockname(), timeout=30) as s:
        if close_after is None:
            acks = dt.stream_acked(s, data, dt.DEFAULT_PACKET)
            assert [a[0] for a in acks] == list(range(npkts))
            assert max(st for _, st in acks) == dt.ACK_ERROR
        else:
            with pytest.raises((OSError, ConnectionError)):
                dt.stream_acked(s, data, dt.DEFAULT_PACKET)
    t.join(10)
    srv.close()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_pipeline_idle_past_mirror_timeout(clusters, monkeypatch, pkg):
    """An hflush'd stream left idle for longer than the mirror legs'
    socket timeout stays up, on the port's pipeline as on the
    reference's: each DataNode reads its mirror's acks only while some
    are owed, so the next hflush and the close succeed and the bytes read
    back.  The mirror legs' timeout is cut to 0.4 s."""
    br = _mod(pkg, "server.block_receiver")
    connect = br._connect

    def short(*a, **k):
        s = connect(*a, **k)
        s.settimeout(0.4)
        return s
    monkeypatch.setattr(br, "_connect", short)
    mc = clusters(pkg)
    parts = [_bytes(5_000), _bytes(70_000), _bytes(333)]
    p = f"/idle/{pkg}"
    with _client(pkg, mc.nn_addrs(), f"idle-{pkg}") as c:
        out = c.open_for_write(p, replication=3)
        for part in parts[:2]:
            out.write(part)
            out.hflush()
            time.sleep(1.0)
        out.write(parts[2])
        out.close()
        assert c.read(p) == b"".join(parts)

"""Provided and simulated storage on the port (storage/aliasmap.py,
storage/simulated.py, the DataNode's PROVIDED plane) held against the
reference on the CPU: alias-map files byte for byte, each package
reopening the other's; ranged reads and the mount-root check; the
simulated replica store under one op sequence; and a provided file
read, checksummed and deleted through the port's cluster, the CLI's
``-provide`` included."""

import os
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REGIONS = [
    [[7, "file:///x", 0, 100], [8, "file:///x", 100, 50]],
    [[(1 << 40) + 3, "file:///data/ünïcode blob.bin", 1 << 33, 1 << 27],
     [2, "s3://bucket/key", 0, 0], [65_535, "file:///y", 255, 65_536]],
    [[i, f"file:///mnt/part-{i:05d}", i * 4096, 4096] for i in range(40)],
]


def _maps(tmp_path, name):
    from hdrf_tpu.storage import aliasmap as ref
    from hdrf_tpu_torch.storage import aliasmap as port
    return {pkg: (mod, str(tmp_path / f"{name}-{pkg}"))
            for pkg, mod in (("port", port), ("ref", ref))}


@pytest.mark.parametrize("regions", REGIONS, ids=["small", "wide", "many"])
def test_aliasmap_files_equal_and_reopen_across(tmp_path, regions):
    """The same writes and removes leave byte-identical map files, and
    each package reopens the other's map to the same regions."""
    maps = _maps(tmp_path, "amap")
    blobs = {}
    for pkg, (mod, path) in maps.items():
        m = mod.InMemoryAliasMap(path)
        m.write([mod.FileRegion.unpack(v) for v in regions])
        m.remove([regions[0][0]])
        blobs[pkg] = open(path, "rb").read()
    assert blobs["port"] == blobs["ref"]
    for pkg, other in (("port", "ref"), ("ref", "port")):
        mod, _ = maps[pkg]
        m = mod.InMemoryAliasMap(maps[other][1])
        assert sorted(r.pack() for r in m.list()) == \
            sorted(regions[1:], key=lambda v: v)
        assert m.read(regions[0][0]) is None


def test_aliasmap_range_reads_equal(tmp_path):
    ext = tmp_path / "store.bin"
    data = os.urandom(10_000)
    ext.write_bytes(data)
    out = {}
    for pkg, (mod, path) in _maps(tmp_path, "rr").items():
        m = mod.InMemoryAliasMap(path)
        m.write([mod.FileRegion(1, f"file://{ext}", 100, 5000)])
        out[pkg] = [m.read_bytes(1), m.read_bytes(1, offset=10, length=20),
                    m.read_bytes(1, offset=4999, length=100),
                    m.read_bytes(1, offset=5000, length=3),
                    m.read_bytes(99)]
    assert out["port"] == out["ref"]
    assert out["port"][0] == data[100:5100]


def _uri_cases(tmp_path):
    root = tmp_path / "mnt"
    root.mkdir(exist_ok=True)
    return [(str(root), f"file://{root}/sub/data.bin"),
            (str(root), f"file://{root}"),
            (str(root), "file:///etc/hostname"),
            (str(root), f"file://{tmp_path}/mnt-evil/x"),
            (str(root), f"file://{root}/../escape"),
            (None, f"file://{root}/x"),
            ("/", "s3://bucket/key"),
            ("/", "file:///anything")]


def test_mount_root_check_equal(tmp_path):
    """``check_uri`` accepts and refuses alike, with the same message."""
    out = {}
    for pkg, (mod, path) in _maps(tmp_path, "mr").items():
        res = []
        for root, uri in _uri_cases(tmp_path):
            m = mod.InMemoryAliasMap(path + str(len(res)), mount_root=root)
            try:
                m.check_uri(uri)
                res.append("ok")
            except IOError as e:
                res.append(str(e))
        out[pkg] = res
    assert out["port"] == out["ref"]
    assert "ok" in out["port"] and len(set(out["port"])) > 2


def test_simulated_store_equal_reference():
    """The simulated replica store answers one op sequence alike: rbw,
    finalize, reads, truncation (CRC of the cut chunk), delete,
    reports."""
    from hdrf_tpu.storage.simulated import SimulatedReplicaStore as Ref
    from hdrf_tpu_torch.storage.simulated import SimulatedReplicaStore as P

    from hdrf_tpu_torch import native

    def run(cls):
        s = cls()
        out = []
        data = {b: os.urandom(1000 + 777 * b) for b in range(1, 5)}
        for b, d in data.items():
            w = s.create_rbw(b, gen_stamp=b)
            out.append(s.is_rbw(b))
            w.write(d[:500])
            w.write(d[500:])
            crcs = [native.crc32c(d[i:i + 512]) for i in range(0, len(d),
                                                                512)]
            w.finalize(len(d), "direct", crcs, 512) if b != 3 else w.abort()
        for b in range(1, 6):
            m = s.get_meta(b)
            out.append(None if m is None else
                       (m.logical_len, m.gen_stamp, m.scheme, m.checksums))
            out.append(s.is_rbw(b))
        out.append(s.read_data(2, 100, 300))
        out.append(s.truncate_replica(4, 1500, new_gs=9))
        m = s.get_meta(4)
        out.append((m.logical_len, m.gen_stamp, m.checksums))
        s.delete(1)
        out += [sorted(s.block_ids()), sorted(s.block_report()),
                s.physical_bytes(), s.scan()]
        return out, data

    import random
    random.seed(0)
    got, data = run(P)
    state = os.urandom
    try:
        it = iter(list(data.values()))
        os.urandom = lambda n: next(it)
        want, _ = run(Ref)
    finally:
        os.urandom = state
    assert got == want


# ---------------------------------------------------- through the cluster

@pytest.fixture()
def cluster():
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    with MiniCluster(n_datanodes=2, replication=1, heartbeat_s=0.1,
                     block_size=256 * 1024) as mc:
        yield mc


def _eventually(fn, timeout=10.0):
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def _provide(mc, c, local: str, hpath: str):
    from hdrf_tpu_torch.storage.aliasmap import FileRegion

    out = c._call("provide_file", path=hpath, uri=f"file://{local}",
                  length=os.path.getsize(local))
    for dn in mc.datanodes:
        dn.aliasmap.write([FileRegion.unpack(v) for v in out["regions"]])
        for v in out["regions"]:
            dn.notify_block_received(v[0], v[3], 0,
                                     storage_type="PROVIDED")
    return out


def test_provided_file_reads_checksums_and_deletes(cluster, tmp_path):
    """A provided file of three regions reads back through the port's
    DataNodes (whole and ranged), its checksum is the CRC32C of the
    bytes, and a delete purges every DataNode's alias map."""
    from hdrf_tpu_torch import native

    data = os.urandom(700_000)
    ext = tmp_path / "ext.bin"
    ext.write_bytes(data)
    with cluster.client(device="cpu") as c:
        out = _provide(cluster, c, str(ext), "/mnt/a")
        assert len(out["regions"]) == 3
        assert _eventually(lambda: c.read("/mnt/a")) == data
        assert c.read("/mnt/a", offset=300_000, length=12_345) == \
            data[300_000:312_345]
        assert c.get_file_checksum("/mnt/a")["crc"] == native.crc32c(data)
        bids = [v[0] for v in out["regions"]]
        assert c.delete("/mnt/a")
        deadline = time.monotonic() + 10
        while any(dn.aliasmap.read(b) is not None
                  for dn in cluster.datanodes for b in bids):
            assert time.monotonic() < deadline, "alias map not purged"
            time.sleep(0.1)


def test_provide_cli_and_alias_add(cluster, tmp_path):
    """``dfsadmin -provide`` of the port's CLI registers a file whose
    bytes the DataNodes serve; ``alias_add`` refuses a region outside
    the mount root with the reference's error, through ``_dn_call``."""
    from hdrf_tpu_torch.tools.cli import _dn_call

    data = b"provided-by-cli" * 1000
    ext = tmp_path / "cli.bin"
    ext.write_bytes(data)
    addr = f"{cluster.namenode.addr[0]}:{cluster.namenode.addr[1]}"
    out = subprocess.run(
        [sys.executable, "-m", "hdrf_tpu_torch.tools.cli", "dfsadmin",
         "--namenode", addr, "--device", "cpu", "-provide", str(ext),
         "/mnt/cli"], capture_output=True, text=True, cwd=REPO,
        timeout=60)
    assert "provided /mnt/cli" in out.stdout, out.stdout + out.stderr
    with cluster.client(device="cpu") as c:
        assert _eventually(lambda: c.read("/mnt/cli")) == data
    dn = cluster.datanodes[0]
    dn.aliasmap._mount_root = str(tmp_path)
    dn_addr = f"{dn.addr[0]}:{dn.addr[1]}"
    bad = _dn_call(dn_addr, "alias_add",
                   regions=[[777, "file:///etc/hostname", 0, 10]],
                   tokens=None)
    assert not bad["ok"] and "outside mount root" in bad["error"]
    assert dn.aliasmap.read(777) is None
    ok = _dn_call(dn_addr, "alias_add",
                  regions=[[778, f"file://{ext}", 0, 10]], tokens=None)
    assert ok == {"ok": True, "count": 1}

"""Lazy persist on the port (storage/volumes.py ``lazy_persist_tick``, the
RAM_DISK volume's placement, eviction and failover, the DataNode's lazy
writer, the NameNode's ``lazy_persist`` policy, utils/throttler.py)
against the reference (tests/test_lazy_persist.py).

Each of the reference's six cases runs on a ``MiniCluster`` of each
package (one DataNode with a RAM_DISK and a DISK volume, the RAM budget
256 KiB, the lazy writer every 0.2 s), each with its own client, on the
same seeded bytes; what each run observes is collected into a dict, and
the port's must equal the reference's.  The write, the RAM loss and the
volume failover run under two schemes: ``direct``, whose replica file
holds the block's bytes, and the default ``dedup_lz4``, whose replica
file is 0 bytes (its chunks live in containers, which are never placed
on a RAM volume), so its disk shadow is a meta file and an empty file.
"""

from __future__ import annotations

import importlib
import os
import shutil
import time

import numpy as np
import pytest

from _dn_standin import guard_reference_stat_race

PKGS = ["ref", "port"]
SCHEMES = ["direct", "dedup_lz4"]


@pytest.fixture(autouse=True)
def _reference_stat_race(monkeypatch):
    guard_reference_stat_race(monkeypatch)


def _mod(pkg: str, path: str):
    return importlib.import_module(
        ("hdrf_tpu." if pkg == "ref" else "hdrf_tpu_torch.") + path)


def _bytes(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, np.uint8).tobytes()


def _cluster(pkg: str, **kw):
    MiniCluster = _mod(pkg, "testing.minicluster").MiniCluster
    base = dict(n_datanodes=1, replication=1, block_size=1 << 20,
                volume_types=["RAM_DISK", "DISK"],
                dn_config_overrides={"lazy_writer_interval_s": 0.2,
                                     "ram_disk_capacity": 256 * 1024})
    return MiniCluster(**{**base, **kw})


def _client(mc, pkg: str, name: str):
    return mc.client(name, **({"device": "cpu"} if pkg == "port" else {}))


def _ram_vol(dn):
    return next(v for v in dn.volumes.volumes
                if v.storage_type == "RAM_DISK")


def _disk_vol(dn):
    return next(v for v in dn.volumes.volumes
                if v.storage_type != "RAM_DISK")


def _counter(pkg: str, reg: str, name: str) -> int:
    return _mod(pkg, "utils.metrics").registry(reg).counter(name)


def _bid(c, path: str) -> int:
    return c._call("get_block_locations", path=path)["blocks"][0]["block_id"]


def _await_shadow(disk, bid: int, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while disk.replicas.get_meta(bid) is None:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def _replica(vol, bid: int) -> tuple:
    """(generation, logical length, checksums, bytes of the replica
    file) of ``bid`` on ``vol``."""
    meta = vol.replicas.get_meta(bid)
    with open(vol.replicas.data_path(bid), "rb") as f:
        body = f.read()
    return (meta.gen_stamp, meta.logical_len, list(meta.checksums), body)


def _write_hot(c, path: str, data: bytes, scheme: str) -> None:
    c.mkdir("/hot")
    c.set_storage_policy("/hot", "lazy_persist")
    c.write(path, data, scheme=scheme)


def _lands_in_ram(pkg: str, scheme: str) -> dict:
    """test_lazy_persist_write_lands_in_ram_then_disk."""
    data = _bytes(1, 100_000)
    with _cluster(pkg) as mc:
        dn = mc.datanodes[0]
        with _client(mc, pkg, "lp") as c:
            _write_hot(c, "/hot/f", data, scheme)
            bid = _bid(c, "/hot/f")
            ram, disk = _ram_vol(dn), _disk_vol(dn)
            out = {"ram_on_shm": ram.root.startswith("/dev/shm/"),
                   "in_ram": ram.replicas.get_meta(bid) is not None,
                   "shadowed": _await_shadow(disk, bid),
                   "owner_is_ram": dn.volumes._where[bid] == ram.vol_id,
                   "read": c.read("/hot/f") == data}
            out["ram_replica"] = _replica(ram, bid)
            out["disk_replica"] = _replica(disk, bid)
            out["indexed"] = dn.index.get_block(bid) is not None
            out["containers_on_ram"] = os.listdir(
                os.path.join(ram.root, "containers"))
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_lazy_persist_write_lands_in_ram_then_disk(scheme):
    ref, port = (_lands_in_ram(pkg, scheme) for pkg in PKGS)
    assert ref["ram_on_shm"] and ref["in_ram"] and ref["shadowed"]
    assert ref["owner_is_ram"] and ref["read"]
    assert ref["disk_replica"] == ref["ram_replica"]
    assert ref["containers_on_ram"] == []
    if scheme == "dedup_lz4":
        # the reduced form: a 0-byte replica file, the chunks indexed
        assert ref["ram_replica"][3] == b"" and ref["indexed"]
    else:
        assert len(ref["ram_replica"][3]) == 100_000 and not ref["indexed"]
    assert port == ref


def _eviction(pkg: str) -> dict:
    """test_eviction_under_ram_pressure: four 120,000-byte files against
    the 256 KiB RAM budget."""
    blobs = {f"/hot/f{i}": _bytes(10 + i, 120_000) for i in range(4)}
    evicted0 = _counter(pkg, "volumes", "lazy_evicted")
    with _cluster(pkg) as mc:
        dn = mc.datanodes[0]
        with _client(mc, pkg, "ev") as c:
            c.mkdir("/hot")
            c.set_storage_policy("/hot", "lazy_persist")
            for p, b in blobs.items():
                c.write(p, b, scheme="direct")
            ram = _ram_vol(dn)
            deadline = time.monotonic() + 6
            while ram.used_bytes() > dn.config.ram_disk_capacity \
                    and time.monotonic() < deadline:
                time.sleep(0.1)
            return {"within_budget":
                    ram.used_bytes() <= dn.config.ram_disk_capacity,
                    "evicted": _counter(pkg, "volumes", "lazy_evicted")
                    > evicted0,
                    "reads": [c.read(p) == b for p, b in blobs.items()]}


def test_eviction_under_ram_pressure():
    ref, port = (_eviction(pkg) for pkg in PKGS)
    assert ref == {"within_budget": True, "evicted": True,
                   "reads": [True] * 4}
    assert port == ref


def _ram_loss(pkg: str, scheme: str) -> dict:
    """test_survives_simulated_ram_loss: the shm directory wiped while the
    DataNode is down; the disk shadow serves after the restart."""
    data = _bytes(2, 80_000)
    with _cluster(pkg) as mc:
        dn = mc.datanodes[0]
        with _client(mc, pkg, "rl") as c:
            _write_hot(c, "/hot/f", data, scheme)
            bid = _bid(c, "/hot/f")
            out = {"shadowed": _await_shadow(_disk_vol(dn), bid)}
        ram_root = _ram_vol(dn).root
        mc.stop_datanode(0)
        shutil.rmtree(ram_root)
        dn = mc.restart_datanode(0)
        mc.wait_for_datanodes(1)
        out["owner_is_disk"] = \
            dn.volumes._where.get(bid) == _disk_vol(dn).vol_id
        out["ram_empty"] = _ram_vol(dn).replicas.get_meta(bid) is None
        with _client(mc, pkg, "rl2") as c:
            deadline = time.monotonic() + 10
            while True:
                try:
                    out["read"] = c.read("/hot/f") == data
                    break
                except Exception:          # noqa: BLE001 — either package
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
        out["replica"] = _replica(_disk_vol(dn), bid)
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_survives_simulated_ram_loss(scheme):
    ref, port = (_ram_loss(pkg, scheme) for pkg in PKGS)
    assert ref["shadowed"] and ref["owner_is_disk"] and ref["ram_empty"]
    assert ref["read"]
    assert port == ref


def test_throttler_enforces_floor():
    """DataTransferThrottler: 1 MiB through a 2 MiB/s bucket takes at
    least 0.35 s in both packages, with the same bytes counted; a
    disabled throttler never blocks."""
    out = {}
    for pkg in PKGS:
        Throttler = _mod(pkg, "utils.throttler").Throttler
        t = Throttler(2 * 1024 * 1024)
        t0 = time.monotonic()
        for _ in range(16):
            t.throttle(64 * 1024)
        slow = time.monotonic() - t0
        t2 = Throttler(0)
        t0 = time.monotonic()
        for _ in range(16):
            t2.throttle(64 * 1024)
        fast = time.monotonic() - t0
        out[pkg] = (slow >= 0.35, fast < 0.05, t.throttled_bytes,
                    t2.throttled_bytes)
    assert out["ref"][:2] == (True, True)
    assert out["port"] == out["ref"]


def _throttled_rereplication(pkg: str) -> dict:
    """test_rereplication_is_throttled_but_client_io_is_not: the client's
    write gates nothing through the balance throttlers; the re-replication
    after a DataNode's death does."""
    data = _bytes(3, 400_000)
    MiniCluster = _mod(pkg, "testing.minicluster").MiniCluster
    with MiniCluster(n_datanodes=3, replication=2, block_size=1 << 20,
                     heartbeat_s=0.1, dead_node_s=0.8,
                     dn_config_overrides={
                         "balancer_bandwidth": 400 * 1024}) as mc:
        with _client(mc, pkg, "tr") as c:
            c.write("/t/f", data)
            out = {"client_throttled": [dn.balance_throttler.throttled_bytes
                                        for dn in mc.datanodes]}
            loc = c._call("get_block_locations", path="/t/f")
            holders = {d["dn_id"] for b in loc["blocks"]
                       for d in b["locations"]}
            victim = next(i for i in range(3) if f"dn-{i}" in holders)
            mc.kill_datanode(victim)
            deadline = time.monotonic() + 25
            live = set()
            while time.monotonic() < deadline:
                locs = c._call("get_block_locations", path="/t/f")
                live = {d["dn_id"] for b in locs["blocks"]
                        for d in b["locations"]} - {f"dn-{victim}"}
                if len(live) >= 2:
                    break
                time.sleep(0.2)
            out["rereplicated"] = len(live) >= 2
            out["rereplication_throttled"] = sum(
                dn.balance_throttler.throttled_bytes
                for dn in mc.datanodes if dn is not None) > 0
            out["read"] = c.read("/t/f") == data
    return out


def test_rereplication_is_throttled_but_client_io_is_not():
    ref, port = (_throttled_rereplication(pkg) for pkg in PKGS)
    assert ref == {"client_throttled": [0, 0, 0], "rereplicated": True,
                   "rereplication_throttled": True, "read": True}
    assert port == ref


def _volume_death(pkg: str, scheme: str) -> dict:
    """test_ram_volume_death_fails_over_to_disk_shadow: the RAM volume
    ejected after the lazy writer persisted; its block is rescued by the
    disk shadow, not lost."""
    data = _bytes(4, 50_000)
    rescued0 = _counter(pkg, "volumes", "blocks_rescued_by_shadow")
    with _cluster(pkg) as mc:
        dn = mc.datanodes[0]
        with _client(mc, pkg, "vd") as c:
            _write_hot(c, "/hot/f", data, scheme)
            bid = _bid(c, "/hot/f")
            ram, disk = _ram_vol(dn), _disk_vol(dn)
            out = {"shadowed": _await_shadow(disk, bid)}
            lost = dn.volumes.eject(ram.vol_id)
            out["lost"] = lost
            out["owner_is_disk"] = dn.volumes._where[bid] == disk.vol_id
            out["rescued"] = _counter(pkg, "volumes",
                                      "blocks_rescued_by_shadow") - rescued0
            out["read"] = c.read("/hot/f") == data
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_ram_volume_death_fails_over_to_disk_shadow(scheme):
    ref, port = (_volume_death(pkg, scheme) for pkg in PKGS)
    assert ref == {"shadowed": True, "lost": [], "owner_is_disk": True,
                   "rescued": 1, "read": True}
    assert port == ref

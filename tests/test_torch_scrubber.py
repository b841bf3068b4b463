"""The port's integrity scrubber (hdrf_tpu_torch/server/scrubber.py) held
against the reference's on the CPU: the same corruption of the same
store on each package's MiniCluster gives the same outcome — the
quarantined file names, the ``scrub`` counter deltas, the
``bad_block`` / ``bad_stripe`` reports the NameNode books, the garbage
census — and every block reads back equal.  The any-k decode
spot-check decodes through the plain RS version (a ``native`` DataNode's
EC tier runs RS on the CPU).  The sample is ``random`` with the
reference's seed, the cycles are driven by hand (``run_cycle``), and
nothing compares timings.
"""

import os
import random
import time

import pytest

PKGS = ("port", "ref")


def _pkg(name: str):
    if name == "port":
        from hdrf_tpu_torch.server import scrubber
        from hdrf_tpu_torch.testing.minicluster import MiniCluster
        from hdrf_tpu_torch.utils import fault_injection, metrics
    else:
        from hdrf_tpu.server import scrubber
        from hdrf_tpu.testing.minicluster import MiniCluster
        from hdrf_tpu.utils import fault_injection, metrics
    return MiniCluster, scrubber, metrics, fault_injection


def _client(mc, pkg: str, name: str):
    return mc.client(name, device="cpu") if pkg == "port" else \
        mc.client(name)


def blob(seed: int, n: int) -> bytes:
    return random.Random(seed).randbytes(n)


def _wait(pred, timeout=25.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {msg}")


def _cycle(dn, scrub_reg) -> dict:
    deadline = time.monotonic() + 12.0
    while True:
        before = scrub_reg.counter("scrub_cycles")
        census = dn.scrubber.run_cycle()
        if scrub_reg.counter("scrub_cycles") > before:
            return census
        assert time.monotonic() < deadline, "scrub cycle stayed vetoed"
        time.sleep(0.25)


def _seal_all(dn) -> None:
    dn.containers.flush_open(on_seal=dn.index.seal_container)
    dn.containers.drain_seals()


class _Deltas:
    """Counter deltas of a package's registries since construction."""

    def __init__(self, metrics, names: dict[str, tuple[str, ...]]):
        self._m = metrics
        self._names = names
        self._at = self._read()

    def _read(self) -> dict:
        return {f"{r}.{k}": self._m.registry(r).counter(k)
                for r, keys in self._names.items() for k in keys}

    def __call__(self) -> dict:
        now = self._read()
        return {k: now[k] - self._at[k] for k in now}


SCRUB_KEYS = ("scrub_cycles", "scrub_corrupt|class=container",
              "scrub_corrupt|class=stripe", "scrub_corrupt|class=replica",
              "scrub_repairs_triggered", "scrub_decode_checks",
              "scrub_decode_failures", "scrub_errors")


@pytest.fixture(autouse=True)
def _clear_faults():
    for p in PKGS:
        _pkg(p)[3].clear()
    yield
    for p in PKGS:
        _pkg(p)[3].clear()


def _both(run) -> None:
    got = {p: run(p) for p in PKGS}
    assert got["port"] == got["ref"], got


# ---------------------------------------------------------------- clean

def test_clean_cycles_census_and_report_equal():
    """Two cycles over a clean store of direct, dedup and dedup_lz4
    blocks: no corruption, the same census and the same report."""
    def run(pkg):
        MiniCluster, scrubber, metrics, _ = _pkg(pkg)
        with MiniCluster(n_datanodes=1, replication=1,
                         dn_config_overrides={"scrub_sample_frac": 1.0}) \
                as mc:
            dn = mc.datanodes[0]
            with _client(mc, pkg, "clean") as c:
                for i, scheme in enumerate(("direct", "dedup", "dedup_lz4")):
                    c.write(f"/clean/{i}", blob(40 + i, 96_000),
                            scheme=scheme)
            _seal_all(dn)
            d = _Deltas(metrics, {"scrub": SCRUB_KEYS})
            censuses = [_cycle(dn, metrics.registry("scrub"))
                        for _ in range(2)]
            rep = dn.scrubber.report()
            return (censuses, d(), sorted(rep), rep["garbage"],
                    dn._stats()["scrub"]["cycles"] >= 2)
    _both(run)


def test_dead_chunk_census_after_delete_equal():
    """Deleting one of two dedup blocks leaves exactly its chunk bytes
    as dead payload, in both packages."""
    def run(pkg):
        MiniCluster, _, metrics, _ = _pkg(pkg)
        a, b = blob(7, 50_000), blob(8, 30_000)
        with MiniCluster(n_datanodes=1, replication=1) as mc:
            dn = mc.datanodes[0]
            reg = metrics.registry("scrub")
            with _client(mc, pkg, "g") as c:
                c.write("/g/a", a, scheme="dedup")
                before = set(dn.index.block_ids())
                c.write("/g/b", b, scheme="dedup")
                bid_b = (set(dn.index.block_ids()) - before).pop()
                first = _cycle(dn, reg)
                c.delete("/g/b")
                _wait(lambda: dn.index.get_block(bid_b) is None,
                      msg="delete reaching the chunk index")
                second = _cycle(dn, reg)
                assert c.read("/g/a") == a
            return first, second, second["dead_chunks"] == len(b)
    _both(run)


# ------------------------------------------------------------- containers

def test_flipped_container_byte_quarantines_equal():
    """One flipped byte in a sealed container: one cycle quarantines it
    (renamed aside with QUAR_SUFFIX), invalidates and reports its
    blocks, and the census counts the quarantined bytes; on a cluster of
    three at replication 2 the NameNode re-replicates from the healthy
    peer and the read is equal."""
    def run(pkg):
        MiniCluster, scrubber, metrics, _ = _pkg(pkg)
        d = blob(1, 120_000)
        with MiniCluster(n_datanodes=3, replication=2,
                         dn_config_overrides={"scrub_sample_frac": 1.0}) \
                as mc:
            with _client(mc, pkg, "it") as c:
                c.write("/scrub/a", d, scheme="dedup")
            victim = next(dn for dn in mc.datanodes
                          if dn.replicas.block_ids())
            _seal_all(victim)
            cid = sorted(victim.index.container_live_bytes())[0]
            vol = victim.volumes.volume_of_cid(cid)
            path = vol.containers._sealed_path(cid)
            raw = bytearray(open(path, "rb").read())
            raw[max(16, len(raw) // 2)] ^= 0xFF
            with open(path, "wb") as f:
                f.write(raw)
            with vol.containers._cache_lock:
                vol.containers._cache.clear()
            deltas = _Deltas(metrics, {
                "scrub": SCRUB_KEYS,
                "namenode": ("corrupt_replicas_reported",)})
            census = _cycle(victim, metrics.registry("scrub"))
            quar = sorted(n for n in os.listdir(os.path.dirname(path))
                          if n.endswith(scrubber.QUAR_SUFFIX))
            out = (deltas(), quar, census["quarantined"] > 0,
                   cid in victim.containers.container_ids(),
                   victim.replicas.block_ids())
            mc.wait_for_replication("/scrub/a", 2)
            with _client(mc, pkg, "it") as c:
                assert c.read("/scrub/a") == d
            return out
    _both(run)


def test_dangling_reduced_replica_equal():
    """A reduced replica whose index entry is lost is flagged, reported
    and invalidated, and re-replication restores it."""
    def run(pkg):
        MiniCluster, _, metrics, _ = _pkg(pkg)
        d = blob(2, 64_000)
        with MiniCluster(n_datanodes=3, replication=2) as mc:
            with _client(mc, pkg, "it") as c:
                c.write("/scrub/r", d, scheme="dedup")
            victim = next(dn for dn in mc.datanodes
                          if dn.replicas.block_ids())
            bid = victim.replicas.block_ids()[0]
            victim.index.delete_block(bid)
            deltas = _Deltas(metrics, {"scrub": SCRUB_KEYS})
            _cycle(victim, metrics.registry("scrub"))
            out = (deltas(), bid in victim.replicas.block_ids())
            mc.wait_for_replication("/scrub/r", 2)
            with _client(mc, pkg, "it") as c:
                assert c.read("/scrub/r") == d
            return out
    _both(run)


def test_direct_replica_bitrot_equal():
    """The rotating deep verify catches a flipped bit in a direct
    replica against its finalize-time CRCs."""
    def run(pkg):
        MiniCluster, _, metrics, _ = _pkg(pkg)
        d = blob(5, 64_000)
        with MiniCluster(n_datanodes=1, replication=1) as mc:
            dn = mc.datanodes[0]
            with _client(mc, pkg, "it") as c:
                c.write("/scrub/d", d, scheme="direct")
            bid = dn.replicas.block_ids()[0]
            path = dn.replicas.data_path(bid)
            raw = bytearray(open(path, "rb").read())
            raw[len(raw) // 3] ^= 0x40
            with open(path, "wb") as f:
                f.write(raw)
            deltas = _Deltas(metrics, {"scrub": SCRUB_KEYS})
            _cycle(dn, metrics.registry("scrub"))
            return deltas(), dn.replicas.block_ids()
    _both(run)


# ---------------------------------------------------------------- stripes

def _ec_cluster(MiniCluster):
    return MiniCluster(n_datanodes=5, block_size=256 * 1024,
                       container_size=32 * 1024)


def _ec_config(mc) -> None:
    mc.namenode.config.ec_data_shards = 3
    mc.namenode.config.ec_parity_shards = 2
    mc.namenode.config.ec_demote_after_s = 0.0


def _demote(mc, c, path: str, data: bytes) -> None:
    c.write(path, data, scheme="dedup_lz4")
    mc.namenode.config.ec_demote_after_s = 0.3
    _wait(lambda: c._call("ec_status")["demoted_blocks"] >= 1,
          msg="block demotion")
    _wait(lambda: c._call("ec_status")["striped_containers"] >= 1,
          msg="striped-container census")


def _owner(mc):
    return next(dn for dn in mc.datanodes if dn.index.stripe_manifests())


def _flip(path: str) -> None:
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(raw)


def test_owner_stripe_repair_and_spot_check_equal():
    """A CRC-failing stripe on the manifest's owner: quarantined,
    repaired locally (a decode) and spot-checked; the port's decodes run
    through the plain RS version on the CPU."""
    from hdrf_tpu_torch.ops import rs as port_rs

    devices = []
    real = port_rs._apply

    def spy(rows, surv, device):
        devices.append(device)
        return real(rows, surv, device)

    def run(pkg):
        MiniCluster, scrubber, metrics, _ = _pkg(pkg)
        data = blob(21, 200_000)
        with _ec_cluster(MiniCluster) as mc:
            _ec_config(mc)
            with _client(mc, pkg, "ec") as c:
                _demote(mc, c, "/cold/own", data)
                owner = _owner(mc)
                own = sorted(s for s in owner.ec.store.iter_stripes()
                             if s[0] == owner.dn_id)
                _, cid, idx, _ = own[0]
                path = os.path.join(owner.ec.store._dir,
                                    f"{owner.dn_id}.{cid}.{idx}.stripe")
                _flip(path)
                deltas = _Deltas(metrics, {"scrub": SCRUB_KEYS})
                _cycle(owner, metrics.registry("scrub"))
                quar = os.path.exists(path + scrubber.QUAR_SUFFIX)
                _wait(lambda: os.path.exists(path), msg="stripe repair")
                assert c.read("/cold/own") == data
                return deltas(), quar
    port_rs._apply = spy
    try:
        _both(run)
    finally:
        port_rs._apply = real
    assert devices and set(devices) == {"cpu"}


def test_foreign_stripe_reported_and_decoded_equal():
    """A corrupt stripe on a holder that is not the owner: the first
    cycle records its CRC, the second finds the flip, quarantines it and
    reports ``bad_stripe``; the owner's spot-check then decodes past the
    missing stripe, and the monitor's repair restores it."""
    def run(pkg):
        MiniCluster, scrubber, metrics, _ = _pkg(pkg)
        data = blob(23, 200_000)
        with _ec_cluster(MiniCluster) as mc:
            _ec_config(mc)
            with _client(mc, pkg, "ec") as c:
                _demote(mc, c, "/cold/foreign", data)
                owner = _owner(mc)
                cid, man = sorted(owner.index.stripe_manifests().items())[0]
                fidx, f_id = next((i, h[0])
                                  for i, h in enumerate(man["holders"])
                                  if h[0] != owner.dn_id)
                fdn = next(dn for dn in mc.datanodes if dn.dn_id == f_id)
                reg = metrics.registry("scrub")
                _cycle(fdn, reg)
                path = os.path.join(fdn.ec.store._dir,
                                    f"{owner.dn_id}.{cid}.{fidx}.stripe")
                _flip(path)
                deltas = _Deltas(metrics, {
                    "scrub": SCRUB_KEYS,
                    "namenode": ("corrupt_stripes_reported",)})
                _cycle(fdn, reg)
                quar = os.path.exists(path + scrubber.QUAR_SUFFIX)
                first = deltas()
                _wait(lambda: os.path.exists(path), msg="monitor repair")
                assert c.read("/cold/foreign") == data
                return first, quar
    _both(run)

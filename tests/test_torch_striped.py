"""Striped EC files through the port client (client/striped.py).

- ``layout_shards`` / ``assemble`` equal the reference's on seeded
  lengths (tail cells, partial rows, one shard, many).
- On a MiniCluster of either package, the port client (its RS kernel's
  plain version, ``device="cpu"``) and the reference client write the
  same bytes as EC files: every stored internal block (data and parity,
  every group) is byte-identical between the two, and the parity equals
  the numpy oracle ``encode_ref``.
- ``get_file_checksum`` of the EC file equals the replicated copy's, the
  other client's and ``crc32c`` of the bytes.
- With a data-shard holder stopped, both clients' reads (whole and
  ranged) decode the lost shard and return the bytes.
"""

from __future__ import annotations

import numpy as np
import pytest

from _dn_standin import guard_reference_stat_race
from hdrf_tpu.client import striped as ref_striped
from hdrf_tpu_torch.client import striped as port_striped


@pytest.fixture(scope="module", autouse=True)
def _reference_stat_race():
    """The reference DataNodes get the port's tolerance of their
    ContainerStore's stat race (``_dn_standin.guard_reference_stat_race``)."""
    with pytest.MonkeyPatch.context() as mp:
        guard_reference_stat_race(mp)
        yield


GEOMETRIES = [(3, 4096), (6, 1024), (1, 512), (10, 4096)]


def _lengths(seed: int, k: int, cell: int) -> list[int]:
    rng = np.random.default_rng(seed)
    stripe = k * cell
    edge = [0, 1, cell - 1, cell, cell + 1, stripe, stripe + 7,
            3 * stripe - 1]
    return edge + [int(x) for x in rng.integers(1, 8 * stripe, size=6)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k,cell", GEOMETRIES)
def test_layout_and_assemble_match_reference(k, cell, seed):
    rng = np.random.default_rng(100 + seed)
    for n in _lengths(seed, k, cell):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        want = ref_striped.layout_shards(data, k, cell)
        got = port_striped.layout_shards(data, k, cell)
        assert got.dtype == np.uint8 and np.array_equal(got, want), n
        shards = {i: got[i] for i in range(k)}
        assert port_striped.assemble(shards, k, cell, n) == \
            ref_striped.assemble(shards, k, cell, n) == data


POLICY = "rs-3-2-4k"
BLOCK = 64 << 10           # a group holds 3 x 64 KiB: the files span groups


def _stored(mc, loc: dict) -> list[list[bytes]]:
    """Every internal block of an EC file, in group and shard order, read
    whole from its DataNode."""
    from hdrf_tpu_torch.proto import datatransfer as dt

    return [[dt.fetch_block(tuple(b["locations"][0]["addr"]),
                            b["block_id"]) for b in g["blocks"]]
            for g in loc["groups"]]


@pytest.mark.parametrize("cluster_pkg", ["port", "ref"])
def test_shards_identical_and_degraded_read(cluster_pkg):
    import importlib

    from hdrf_tpu import native as ref_native
    from hdrf_tpu.client.filesystem import HdrfClient as RefClient
    from hdrf_tpu_torch.client.filesystem import HdrfClient as PortClient
    from hdrf_tpu_torch.ops import rs
    from hdrf_tpu_torch.utils import metrics

    mini = importlib.import_module(
        ("hdrf_tpu" if cluster_pkg == "ref" else "hdrf_tpu_torch")
        + ".testing.minicluster")
    data = np.random.default_rng(31).integers(
        0, 256, size=450_001, dtype=np.uint8).tobytes()
    with mini.MiniCluster(n_datanodes=5, replication=2, block_size=BLOCK,
                          container_size=32 << 10) as mc:
        addr = mc.nn_addrs()[0]
        with PortClient(addr, name="ec-port", device="cpu") as pc, \
                RefClient(addr, name="ec-ref") as rc:
            pc.write("/ec/p", data, ec=POLICY)
            rc.write("/ec/r", data, ec=POLICY)
            pc.write("/rep", data, scheme="direct")
            lp = pc._call("get_block_locations", path="/ec/p")
            lr = rc._call("get_block_locations", path="/ec/r")
            assert len(lp["groups"]) == 3
            sp, sr = _stored(mc, lp), _stored(mc, lr)
            assert sp == sr
            k, m, cell = rs.parse_policy(POLICY)
            for g in sp:
                d = np.stack([np.frombuffer(b, np.uint8) for b in g[:k]])
                assert np.array_equal(
                    rs.encode_ref(d, m),
                    np.stack([np.frombuffer(b, np.uint8) for b in g[k:]]))
            # COMPOSITE-CRC32C: layout-independent, package-independent
            crc = ref_native.crc32c(data)
            sums = {c.name: {p: c.get_file_checksum(p)["crc"]
                             for p in ("/ec/p", "/ec/r", "/rep")}
                    for c in (pc, rc)}
            assert all(v == crc for s in sums.values() for v in s.values())
            for c in (pc, rc):
                assert c.read("/ec/p") == c.read("/ec/r") == data
            # degraded: the holder of group 0's data shard 1 stopped
            victim = tuple(lp["groups"][0]["blocks"][1]["locations"][0]
                           ["addr"])
            i = next(j for j, d in enumerate(mc.datanodes)
                     if tuple(d.addr) == victim)
            mc.stop_datanode(i)
            reg = metrics.registry("client_ec")
            d0 = reg.counter("ec_degraded_reads")
            assert pc.read("/ec/p") == data
            assert pc.read("/ec/r", offset=5_000, length=20_011) == \
                data[5_000:25_011]
            assert reg.counter("ec_degraded_reads") > d0
            assert rc.read("/ec/p") == data


def test_default_client_runs_rs_on_the_card_without_fallback(monkeypatch):
    """``HdrfClient()`` and ``MiniCluster.client()`` default to
    ``device="cuda"``: with no card (``torch.cuda.is_available()`` false)
    an EC write raises instead of running the plain version, while
    replicated files, which run no client kernel, still work."""
    import torch

    from hdrf_tpu_torch.client.filesystem import HdrfClient
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.random.default_rng(4).integers(
        0, 256, size=50_000, dtype=np.uint8).tobytes()
    with MiniCluster(n_datanodes=5, replication=1, block_size=BLOCK,
                     container_size=32 << 10) as mc:
        with mc.client("nocard") as c, \
                HdrfClient(mc.nn_addrs()[0], name="bare") as b:
            assert c.device == b.device == "cuda"
            for cl, p in ((c, "/ec/a"), (b, "/ec/b")):
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    cl.write(p, data, ec=POLICY)
            c.write("/rep", data, scheme="direct")
            assert b.read("/rep") == data

"""The port's mirror plane (hdrf_tpu_torch/server/mirror_plane.py) and
reduced mirroring (server/block_receiver.py push_reduced /
ingest_reduced) held against the reference's on the CPU: the segment
codec and store, and mixed pipelines of port and reference DataNodes —
the serial relay at ``mirror_parity`` 0 (hash list, need list, chunk
delta across packages) and the coded fan-out at ``mirror_parity`` 1 with
a hedged parity leg and an assemble that decodes.  Byte identity is the
tolerance throughout.
"""

import time

import numpy as np
import pytest

from _dn_standin import (StandInNN, data_files, guard_reference_stat_race,
                         port_dn, read_block, ref_dn, target, write_block,
                         write_ok)
from test_torch_datanode import _blocks, _wal_records, _wait_ibrs

GEOMETRIES = [(1, 1), (2, 1), (3, 2), (4, 2)]


@pytest.fixture(autouse=True)
def _reference_stat_race(monkeypatch):
    guard_reference_stat_race(monkeypatch)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_segment_codec_matches_reference(k, m):
    """``encode_segments`` gives the reference's segments; any k of them
    assemble the payload in either package."""
    from itertools import combinations

    from hdrf_tpu.server import mirror_plane as ref_mp
    from hdrf_tpu_torch.server import mirror_plane as mp

    rng = np.random.default_rng(k * 10 + m)
    for n in (1, 1000, 65_537):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        segs, seg_len = mp.encode_segments(payload, k, m, device="cpu")
        want, want_len = ref_mp.encode_segments(payload, k, m)
        assert seg_len == want_len and segs == want
        for have in combinations(range(k + m), k):
            sub = {i: segs[i] for i in have}
            assert mp.assemble_payload(sub, k, m, n, device="cpu") == payload
            assert ref_mp.assemble_payload(dict(sub), k, m, n) == payload


def test_segment_store_files_match_and_cross_read(tmp_path):
    """A stored segment file is byte-identical to the reference's, and
    each package's store reopens and serves the other's."""
    from hdrf_tpu.server.mirror_plane import SegmentStore as RefStore
    from hdrf_tpu_torch.server.mirror_plane import SegmentStore

    header = {"block_id": 7, "gen_stamp": 3, "scheme": "dedup_lz4",
              "logical_len": 123_456, "checksums": [1, 2, 3 << 30],
              "checksum_chunk": 65536, "hashes": [b"\x01" * 32, b"\x02" * 32],
              "chunk_lens": [100, 200], "k": 2, "m": 1, "seg_len": 150,
              "payload_len": 300, "payload_crc": 99,
              "peers": [["dn-a", "127.0.0.1", 5, 0], [None, "h", 6, 1]]}
    data = bytes(range(150))
    a, b = SegmentStore(str(tmp_path / "p")), RefStore(str(tmp_path / "r"))
    a.put(7, 1, header, data)
    b.put(7, 1, header, data)
    assert data_files(str(tmp_path / "p")) == data_files(str(tmp_path / "r"))
    assert RefStore(str(tmp_path / "p")).get(7) == SegmentStore(
        str(tmp_path / "r")).get(7) == (header, {1: data})
    assert a.count() == 1 and a.blocks() == [7]
    assert a.drop(7) and a.get(7) is None and not a.drop(7)


ORDERS = {"port-ref-port": ("port", "ref", "port"),
          "ref-port-ref": ("ref", "port", "ref")}
MAKERS = {"port": port_dn, "ref": ref_dn}


def _start(tmp_path, kinds, red=None):
    nn = StandInNN()
    dns = [MAKERS[kind](str(tmp_path / f"dn{i}"), nn.addr, f"dn-{i}",
                        red=red)
           for i, kind in enumerate(kinds)]
    return nn, dns


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_mixed_serial_relay_mirrors_reduced_form(tmp_path, order):
    """``mirror_parity`` 0: DN1 reduces once and relays the reduced form
    (``write_reduced``: hash list, need list, chunk delta) through DN2 to
    DN3 across packages.  Every replica reads back, every DataNode reports
    every block, and the three data directories hold the same containers
    and index (each mirror stored exactly the chunks it lacked)."""
    nn, dns = _start(tmp_path, ORDERS[order])
    blocks = _blocks(20, n=3, size=512 << 10)
    try:
        for i, b in enumerate(blocks):
            assert write_ok(write_block(
                dns[0].addr, 900 + i, b,
                targets=[target(dns[1]), target(dns[2])]), b)
            for dn in dns:
                dn.containers.drain_seals()
        for dn in dns:
            for i, b in enumerate(blocks):
                assert read_block(dn.addr, 900 + i)[1] == b
            assert [r[:3] for r in _wait_ibrs(nn, dn.dn_id, 3)] == [
                (900 + i, len(b), 1) for i, b in enumerate(blocks)]
    finally:
        for dn in dns:
            dn.stop()
        nn.stop()
    files = [data_files(str(tmp_path / f"dn{i}")) for i in range(3)]
    for f in files[1:]:
        assert sorted(f) == sorted(files[0])
        for k in f:
            if k.endswith("index.wal"):
                assert _wal_records(f[k]) == _wal_records(files[0][k])
            else:
                assert f[k] == files[0][k], k


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_mixed_coded_mirror_and_assemble(tmp_path, order):
    """``mirror_parity`` 1 with three mirrors (k 2, m 1) across packages:
    the first block's data legs land a segment on each data mirror, with
    partial IBRs; the second block's leg to the second mirror fails, so
    the parity leg is hedged in.  ``mirror_assemble`` (an NN command)
    then upgrades a mirror to a full replica: from two data segments for
    the first block, through the RS decode of the parity for the
    second."""
    kinds = ORDERS[order] + (ORDERS[order][1],)
    nn, dns = _start(tmp_path, kinds, red={"mirror_parity": 1})
    primary = dns[0]
    fi = (__import__("hdrf_tpu_torch.utils.fault_injection", fromlist=["x"])
          if kinds[0] == "port"
          else __import__("hdrf_tpu.utils.fault_injection", fromlist=["x"]))
    blocks = _blocks(21, n=2, size=512 << 10)
    tgts = [target(d) for d in dns[1:]]
    try:
        assert write_ok(write_block(primary.addr, 950, blocks[0],
                                    targets=tgts), blocks[0])

        def fail_second(**kw):
            if kw.get("peer") == dns[2].dn_id:
                raise IOError("leg refused")
        with fi.inject("mirror_plane.leg", fail_second):
            assert write_ok(write_block(primary.addr, 951, blocks[1],
                                        targets=tgts), blocks[1])
        deadline = time.monotonic() + 20
        while dns[3].mirror.report()["segments_held"] < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        held = [d.mirror.report()["segments_held"] for d in dns[1:]]
        assert held[0] == 2 and held[1] == 1 and held[2] >= 1
        partial = [r for r in nn.ibrs_of(dns[1].dn_id) if r[3]]
        assert [r[:2] for r in partial] == [(950, len(blocks[0])),
                                            (951, len(blocks[1]))]
        nn.command(dns[1].dn_id, {"cmd": "mirror_assemble",
                                  "block_id": 951})
        nn.command(dns[2].dn_id, {"cmd": "mirror_assemble",
                                  "block_id": 950})
        deadline = time.monotonic() + 30
        while (dns[1].replicas.get_meta(951) is None
               or dns[2].replicas.get_meta(950) is None) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert read_block(dns[1].addr, 951)[1] == blocks[1]
        assert read_block(dns[2].addr, 950)[1] == blocks[0]
        assert read_block(primary.addr, 951)[1] == blocks[1]
        assert dns[1].mirror.report()["segments_held"] == 1   # 950's
    finally:
        for dn in dns:
            dn.stop()
        nn.stop()

"""The port's DataNode (hdrf_tpu_torch/server/datanode.py) held against the
reference's on the CPU: the reference client and NameNode through a port
DataNode, the same op stream to both packages (acks, replica meta,
container, WAL and index files, READ_BLOCK / BLOCK_CHECKSUM replies,
IBRs), each package reopening the other's data directory, admission
shedding, the NameNode's commands and the planes that are off by default.

Backends: ``native`` (the host library) on both sides, and the
reference's ``tpu`` backend on the JAX CPU device against the port's
``cpu`` backend (the kernels' plain versions) at a small CDC geometry.
Byte identity is the tolerance throughout.
"""

import os
import threading
import time

import numpy as np
import pytest

from _dn_standin import (CONTAINER, StandInNN, block_checksum, data_files,
                         guard_reference_stat_race, op_reply, port_dn,
                         read_block, ref_dn, target, write_block, write_ok)

PAIRS = [("native", "native"), ("tpu", "cpu")]


@pytest.fixture(autouse=True)
def _reference_stat_race(monkeypatch):
    guard_reference_stat_race(monkeypatch)


def _blocks(seed: int, n: int = 4, size: int = 1 << 20) -> list[bytes]:
    """``n`` blocks with cross-block duplicate spans and an unaligned
    tail (dedup hits, partial containers)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    out = [base]
    for i in range(1, n):
        fresh = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        cut = int(rng.integers(size // 4, 3 * size // 4))
        out.append(fresh[:cut] + base[cut:size - 977 * i])
    return out


def _wal_records(body: bytes) -> tuple[list, list]:
    """(commit records in order, seal records sorted) of a chunk-index
    WAL, each without its sequence number."""
    from hdrf_tpu_torch.proto.rpc import unpackb
    from hdrf_tpu_torch.utils import wal

    commits, seals = [], []
    for payload in wal.iter_frames(body):
        rec = unpackb(payload, raw=True)
        (seals if rec[1] == b"seal" else commits).append(rec[1:])
    return commits, sorted(seals)


def _ordered_streams(dn, blocks: list[bytes], first_id: int = 100,
                     client: str | None = None) -> list:
    """Write ``blocks`` on concurrent connections (buffering, acks and
    checksums overlap); each stream sends its LAST packet once the
    previous block is acked and its container seals drained, so the
    commit order — and with it every container byte — is fixed."""
    done = [threading.Event() for _ in blocks]
    acks: list = [None] * len(blocks)

    def stream(i: int) -> None:
        def hold():
            if i:
                assert done[i - 1].wait(120)
                dn.containers.drain_seals()
        try:
            acks[i] = write_block(dn.addr, first_id + i, blocks[i],
                                  client=client, before_last=hold)
        finally:
            done[i].set()

    ts = [threading.Thread(target=stream, args=(i,)) for i in range(len(blocks))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    return acks


def _wait_ibrs(nn: StandInNN, dn_id: str, n: int, timeout: float = 20.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        got = nn.ibrs_of(dn_id)
        if len(got) >= n:
            return got
        time.sleep(0.05)
    return nn.ibrs_of(dn_id)


def _run_stream(mk, root: str, backend: str, blocks, red=None):
    nn = StandInNN()
    dn = mk(root, nn.addr, "dn-a", backend=backend, red=red)
    try:
        acks = _ordered_streams(dn, blocks)
        reads = [read_block(dn.addr, 100 + i) for i in range(len(blocks))]
        ranged = read_block(dn.addr, 101, 300_001, 77_777)
        cks = [block_checksum(dn.addr, 100 + i) for i in range(len(blocks))]
        ibrs = _wait_ibrs(nn, "dn-a", len(blocks))
    finally:
        dn.stop()
        nn.stop()
    return dict(acks=acks, reads=reads, ranged=ranged, cks=cks, ibrs=ibrs,
                files=data_files(root))


@pytest.mark.parametrize("ref_backend,port_backend", PAIRS)
def test_same_op_stream_same_replies_and_files(tmp_path, ref_backend,
                                               port_backend):
    """Four concurrent WRITE_BLOCK streams at ``pipeline_depth`` 4 (a 2 ms
    group commit, async seals): equal acks, reads, checksums and IBRs,
    and every replica meta, container and index file byte-identical.
    The WAL's commit records match in order; its seal records, appended
    by the async seal thread and racing the commits in the reference
    itself, match as a set."""
    blocks = _blocks(1)
    ref = _run_stream(ref_dn, str(tmp_path / "ref"), ref_backend, blocks)
    port = _run_stream(port_dn, str(tmp_path / "port"), port_backend, blocks)
    assert port["acks"] == ref["acks"]
    assert all(write_ok(a, b) for a, b in zip(port["acks"], blocks))
    for (h, d), want in zip(port["reads"], blocks):
        assert h["status"] == 0 and d == want
    assert port["reads"] == ref["reads"]
    assert port["ranged"] == ref["ranged"]
    assert port["ranged"][1] == blocks[1][300_001:300_001 + 77_777]
    assert port["cks"] == ref["cks"]
    assert port["ibrs"] == ref["ibrs"] == [
        (100 + i, len(b), 1, False) for i, b in enumerate(blocks)]
    fr, fp = ref["files"], port["files"]
    assert sorted(fp) == sorted(fr)
    assert any(k.endswith(".meta") for k in fp)
    assert any(".sealed" in k for k in fp)
    for k in fr:
        if k.endswith("index.wal"):
            assert _wal_records(fp[k]) == _wal_records(fr[k])
        else:
            assert fp[k] == fr[k], k


def test_serial_op_stream_wal_byte_identical(tmp_path):
    """``pipeline_depth`` 1 (no coalescer, synchronous seals): the whole
    data directory, WAL included, is byte-identical."""
    blocks = _blocks(2, n=3)
    red = {"pipeline_depth": 1}
    ref = _run_stream(ref_dn, str(tmp_path / "ref"), "native", blocks, red)
    port = _run_stream(port_dn, str(tmp_path / "port"), "native", blocks, red)
    assert port["acks"] == ref["acks"] and port["cks"] == ref["cks"]
    assert port["files"] == ref["files"]


def test_concurrent_streams_coalesce_and_match_reference(tmp_path):
    """Four fully concurrent streams on the ``cpu`` backend: the
    coalescer runs (groups counted), every block reads back, and the
    replica meta files equal the reference's (``tpu`` on the JAX CPU
    device) for the same blocks, whatever the commit order."""
    from hdrf_tpu_torch.utils import metrics

    blocks = _blocks(3, n=4, size=512 << 10)
    reg = metrics.registry("write_pipeline")
    g0 = reg.counter("device_batches")
    metas = {}
    for name, mk, backend in (("ref", ref_dn, "tpu"),
                              ("port", port_dn, "cpu")):
        nn = StandInNN()
        dn = mk(str(tmp_path / name), nn.addr, "dn-c", backend=backend)
        try:
            acks: list = [None] * len(blocks)

            def go(i):
                acks[i] = write_block(dn.addr, 200 + i, blocks[i])
            ts = [threading.Thread(target=go, args=(i,))
                  for i in range(len(blocks))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=300)
            assert all(write_ok(a, b) for a, b in zip(acks, blocks))
            for i, b in enumerate(blocks):
                assert read_block(dn.addr, 200 + i)[1] == b
            assert sorted(r[0] for r in _wait_ibrs(nn, "dn-c", 4)) == \
                [200, 201, 202, 203]
        finally:
            dn.stop()
            nn.stop()
        metas[name] = {k: v for k, v in data_files(
            str(tmp_path / name)).items() if k.endswith(".meta")}
    assert reg.counter("device_batches") > g0
    assert metas["port"] == metas["ref"] and len(metas["port"]) == 4


@pytest.mark.parametrize("first", ["port", "ref"])
def test_each_package_reopens_the_others_directory(tmp_path, first):
    """A data directory written by one package is reopened by the other:
    the index replays, every block reads back and checksums equal; the
    second package writes more blocks that dedup against the first's
    chunks, and the first package reopens the result."""
    mk = {"port": port_dn, "ref": ref_dn}
    other = "ref" if first == "port" else "port"
    root = str(tmp_path / "dn")
    blocks = _blocks(4, n=4, size=256 << 10)
    nn = StandInNN()
    try:
        dn = mk[first](root, nn.addr, "dn-r")
        try:
            for i in range(2):
                assert write_ok(write_block(dn.addr, 300 + i, blocks[i]), blocks[i])
            cks = [block_checksum(dn.addr, 300 + i) for i in range(2)]
        finally:
            dn.stop()
        dn = mk[other](root, nn.addr, "dn-r")
        try:
            for i in range(2):
                assert read_block(dn.addr, 300 + i)[1] == blocks[i]
                assert block_checksum(dn.addr, 300 + i) == cks[i]
            for i in range(2, 4):
                assert write_ok(write_block(dn.addr, 300 + i, blocks[i]), blocks[i])
            st = dn.index.stats()
            assert st["unique_chunk_bytes"] < st["logical_bytes"]
        finally:
            dn.stop()
        dn = mk[first](root, nn.addr, "dn-r")
        try:
            for i in range(4):
                assert read_block(dn.addr, 300 + i)[1] == blocks[i]
        finally:
            dn.stop()
    finally:
        nn.stop()


def test_startup_drops_blocks_of_lost_containers_like_reference(tmp_path):
    """``_verify_index_containers``: a sealed container lost while the
    DataNode was down drops exactly the blocks that reference it, in
    both packages."""
    blocks = _blocks(5, n=3, size=256 << 10)
    kept = {}
    for name, mk in (("ref", ref_dn), ("port", port_dn)):
        root = str(tmp_path / name)
        nn = StandInNN()
        try:
            dn = mk(root, nn.addr, "dn-v", red={"pipeline_depth": 1})
            try:
                for i, b in enumerate(blocks):
                    assert write_ok(write_block(dn.addr, 400 + i, b), b)
            finally:
                dn.stop()
            # the newest container holds only the last block's new chunks
            last = max((k for k in data_files(root) if ".sealed" in k),
                       key=lambda k: int(os.path.basename(k).split(".")[0]))
            os.unlink(os.path.join(root, last))
            dn = mk(root, nn.addr, "dn-v", red={"pipeline_depth": 1})
            try:
                kept[name] = sorted(dn.replicas.block_ids())
            finally:
                dn.stop()
        finally:
            nn.stop()
    assert kept["port"] == kept["ref"]
    assert 0 < len(kept["port"]) < len(blocks)


def test_qos_shed_answers_ack_shed_like_reference(tmp_path):
    """A tenant over its token bucket is refused at admission: every
    packet of the stream is answered ``ACK_SHED`` (retry-after in the
    seqno slot) and nothing is stored, as the reference does."""
    from hdrf_tpu_torch.proto import datatransfer as dt

    blk = _blocks(6, n=1, size=256 << 10)[0]
    got = {}
    red = {"qos_tenant_rate_mb_s": 0.01, "qos_tenant_burst_mb": 0.01}
    for name, mk in (("ref", ref_dn), ("port", port_dn)):
        nn = StandInNN()
        dn = mk(str(tmp_path / name), nn.addr, "dn-q", red=red)
        try:
            first = write_block(dn.addr, 500, blk, client="tenant-a")
            # the bucket is debited just after the final ack: let it land
            deadline = time.monotonic() + 30
            while dn.qos._bucket("tenant-a")._level > 0 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            shed = write_block(dn.addr, 501, blk, client="tenant-a")
            other = write_block(dn.addr, 502, blk, client="tenant-b")
            got[name] = ([s for _, s in first], [s for _, s in shed],
                         [s for _, s in other],
                         sorted(dn.replicas.block_ids()),
                         all(q > 0 for q, _ in shed))
        finally:
            dn.stop()
            nn.stop()
    assert got["port"] == got["ref"]
    assert set(got["port"][1]) == {dt.ACK_SHED}
    assert got["port"][3] == [500, 502] and got["port"][4]


def _http_get(addr, path: str) -> tuple[int, bytes]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(
                f"http://{addr[0]}:{addr[1]}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _status_first(dn, tmp_path) -> dict:
    import json

    out = {}
    for path in ("/timeseries", "/stacks", "/traces", "/contention"):
        code, body = _http_get(dn._status.addr, path)
        doc = json.loads(body)
        out[path] = (code, sorted(doc))
    # each package's own registries, whichever earlier tests created
    code, body = _http_get(dn._status.addr, "/metrics")
    out["/metrics"] = (code, type(json.loads(body)).__name__)
    code, body = _http_get(dn._status.addr, "/traces?format=chrome")
    out["chrome"] = (code, sorted(json.loads(body)))
    code, body = _http_get(dn._status.addr, "/prom")
    out["prom"] = (code, body.startswith(b"# TYPE") or body == b"\n")
    out["404"] = _http_get(dn._status.addr, "/nope")
    return out


def _scrub_first(dn, tmp_path) -> dict:
    blk = _blocks(11, n=1, size=200 << 10)[0]
    assert write_ok(write_block(dn.addr, 700, blk), blk)
    dn.containers.drain_seals()
    deadline = time.monotonic() + 30
    while dn.scrubber.report()["cycles"] < 1 \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    rep = dn.scrubber.report()
    return {"cycles": rep["cycles"] >= 1, "keys": sorted(rep),
            "garbage": rep["garbage"],
            "stats": sorted(dn._stats()["scrub"])}


def _simulated_first(dn, tmp_path) -> dict:
    blk = _blocks(12, n=1, size=150 << 10)[0]
    acks = write_block(dn.addr, 701, blk, scheme="direct")
    return {"acks": write_ok(acks, blk),
            "read": read_block(dn.addr, 701) == blk,
            "info": op_reply(dn.addr, "replica_info", block_id=701),
            "checksum": block_checksum(dn.addr, 701),
            "replicas": type(dn.replicas).__name__,
            "files": sorted(f for f in os.listdir(dn.config.data_dir)
                            if f.endswith(".meta"))}


def _adaptive_first(dn, tmp_path) -> dict:
    calls = [("cdc_max_chunk", 131072), ("cdc_min_chunk", 4096),
             ("cdc_mask_bits", 14), ("cdc_min_chunk", 1 << 20),
             ("cdc_mask_bits", 99), ("cdc_max_chunk", "x"),
             ("scan_interval_s", 0), ("cache_capacity", 1 << 20),
             ("no_such_key", 1), ("scrub_interval_s", 5.0)]
    out = {"keys": op_reply(dn.addr, "get_reconfigurable")}
    for key, value in calls:
        out[f"{key}={value}"] = op_reply(dn.addr, "reconfigure", key=key,
                                         value=value)
    cdc = dn.reduction_ctx.config.cdc
    out["geometry"] = (cdc.mask_bits, cdc.min_chunk, cdc.max_chunk)
    out["controller"] = dn._cdc_controller.emit_range()
    return out


def _provided_first(dn, tmp_path) -> dict:
    mount = tmp_path / "mount"
    mount.mkdir(exist_ok=True)
    src = mount / "region.bin"
    if not src.exists():
        src.write_bytes(np.random.default_rng(5).integers(
            0, 256, 300_000, dtype=np.uint8).tobytes())
    uri = "file://" + str(src)
    out = {"add": op_reply(dn.addr, "alias_add",
                           regions=[[702, uri, 1000, 70_000],
                                    [703, uri, 90_000, 200_000]]),
           "outside": op_reply(dn.addr, "alias_add",
                               regions=[[704, "file:///etc/hostname", 0,
                                         4]])}
    data = src.read_bytes()
    out["read"] = read_block(dn.addr, 702) == data[1000:71_000]
    out["ranged"] = (read_block(dn.addr, 703, offset=7, length=5000)
                     == data[90_007:95_007])
    out["checksum"] = block_checksum(dn.addr, 703)
    dn._send_block_report()
    out["map"] = open(os.path.join(dn.config.data_dir, "aliasmap"),
                      "rb").read()
    return out


PLANES = [
    ("status_port", {"status_port": 0}, _status_first),
    ("scrub_interval_s", {"scrub_interval_s": 0.1}, _scrub_first),
    ("simulated_dataset", {"simulated_dataset": True}, _simulated_first),
    ("cdc_adaptive", {"reduction.cdc_adaptive": True}, _adaptive_first),
    ("provided_mount_root", {"provided_mount_root": "MOUNT"},
     _provided_first),
]


@pytest.mark.parametrize("name,setting,first", PLANES,
                         ids=[p[0] for p in PLANES])
def test_plane_on_matches_reference(tmp_path, name, setting, first):
    """A config that turns on a plane off by default constructs and
    serves on the port, and its first replies and reports equal the
    reference DataNode's under the same op stream."""
    nn = StandInNN()
    got = {}
    try:
        for pkg, make in (("port", port_dn), ("ref", ref_dn)):
            red, dn_kw = {}, {}
            for key, value in setting.items():
                if value == "MOUNT":
                    value = str(tmp_path / "mount")
                if key.startswith("reduction."):
                    red[key.split(".", 1)[1]] = value
                else:
                    dn_kw[key] = value
            dn = make(str(tmp_path / pkg), nn.addr, f"dn-{pkg}", red=red,
                      dn=dn_kw)
            try:
                got[pkg] = first(dn, tmp_path)
                if name == "provided_mount_root":
                    got[pkg]["report"] = sorted(
                        r for r in nn.reports[dn.dn_id] if r[3:] ==
                        ["PROVIDED"])
            finally:
                dn.stop()
    finally:
        nn.stop()
    assert got["port"] == got["ref"]


def test_unknown_op_still_counts(tmp_path):
    """The planes' ops answer; an op neither package knows is answered
    as before: the connection closes without a reply and
    ``unknown_ops`` grows."""
    from hdrf_tpu_torch.utils import metrics

    reg = metrics.registry("datanode")
    nn = StandInNN()
    dn = port_dn(str(tmp_path / "dn"), nn.addr, "dn-u")
    try:
        u0 = reg.counter("unknown_ops")
        assert op_reply(dn.addr, "get_reconfigurable")["keys"]
        assert op_reply(dn.addr, "reconfigure", key="x")["ok"] is False
        assert op_reply(dn.addr, "alias_add", regions=[]) == {
            "ok": True, "count": 0}
        assert op_reply(dn.addr, "no_such_op") is None
        deadline = time.monotonic() + 10
        while reg.counter("unknown_ops") < u0 + 1 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert reg.counter("unknown_ops") == u0 + 1
        # the DataNode still serves
        blk = _blocks(7, n=1, size=64 << 10)[0]
        assert write_ok(write_block(dn.addr, 600, blk), blk)
        assert op_reply(dn.addr, "replica_info", block_id=600) == {
            "length": len(blk), "gen_stamp": 1, "rbw": False}
    finally:
        dn.stop()
        nn.stop()


def test_reference_client_and_namenode_through_port_datanodes(tmp_path):
    """The reference HdrfClient and NameNode write and read a dedup_lz4
    file through two port DataNodes (replication 2: the first mirrors the
    reduced form to the second): equal bytes, dedup caught, a ranged
    read, and the replica on the mirror reads back on its own."""
    from hdrf_tpu.client.filesystem import HdrfClient
    from hdrf_tpu.config import NameNodeConfig
    from hdrf_tpu.server.namenode import NameNode

    nn = NameNode(NameNodeConfig(meta_dir=str(tmp_path / "nn"),
                                 replication=2, block_size=1 << 20)).start()
    dns = [port_dn(str(tmp_path / f"dn{i}"), nn.addr, f"dn-e{i}")
           for i in range(2)]
    try:
        rng = np.random.default_rng(8)
        base = rng.integers(0, 256, size=3 << 20, dtype=np.uint8)
        payload = base.tobytes() + base[:1 << 20].tobytes()
        with HdrfClient(nn.addr, name="port-e2e") as c:
            c.write("/e2e/f", payload, scheme="dedup_lz4")
            assert c.read("/e2e/f") == payload
            assert c.read("/e2e/f", offset=900_001, length=123_456) == \
                payload[900_001:1_023_457]
        for dn in dns:
            st = dn._stats()["index"]
            assert st["logical_bytes"] == len(payload)
            assert st["unique_chunk_bytes"] < st["logical_bytes"]
        for bid in dns[1].replicas.block_ids():
            _, data = read_block(dns[1].addr, bid)
            assert data in (payload[:1 << 20], payload[1 << 20:2 << 20],
                            payload[2 << 20:3 << 20], payload[3 << 20:])
    finally:
        for dn in dns:
            dn.stop()
        nn.stop()


def test_reference_client_through_port_datanode_cpu_backend(tmp_path):
    """The same client path with the port DataNode on its ``cpu``
    backend (the kernels' plain versions): the coalescer runs."""
    from hdrf_tpu.client.filesystem import HdrfClient
    from hdrf_tpu.config import NameNodeConfig
    from hdrf_tpu.server.namenode import NameNode
    from hdrf_tpu_torch.utils import metrics

    reg = metrics.registry("write_pipeline")
    g0 = reg.counter("device_batches")
    nn = NameNode(NameNodeConfig(meta_dir=str(tmp_path / "nn"),
                                 replication=1, block_size=1 << 20)).start()
    dn = port_dn(str(tmp_path / "dn"), nn.addr, "dn-c0", backend="cpu")
    try:
        rng = np.random.default_rng(9)
        base = rng.integers(0, 256, size=2 << 20, dtype=np.uint8)
        payload = base.tobytes() + base[:1 << 20].tobytes()
        with HdrfClient(nn.addr, name="port-e2e-cpu") as c:
            c.write("/e2e/g", payload, scheme="dedup_lz4")
            assert c.read("/e2e/g") == payload
            assert c.read("/e2e/g", offset=1_500_000, length=99_999) == \
                payload[1_500_000:1_599_999]
        st = dn._stats()["index"]
        assert st["unique_chunk_bytes"] < st["logical_bytes"]
        assert reg.counter("device_batches") >= g0 + 3
    finally:
        dn.stop()
        nn.stop()


def test_namenode_commands_replicate_invalidate_cache(tmp_path):
    """Heartbeat commands: ``replicate`` pushes the reduced form to a
    reference DataNode (which reads it back), ``cache`` pins the logical
    bytes, ``balancer_bandwidth`` sets the throttle, ``invalidate`` drops
    the replica; the reference DataNode answers the same commands alike."""
    nn = StandInNN()
    blk = _blocks(10, n=1, size=512 << 10)[0]
    port = port_dn(str(tmp_path / "p"), nn.addr, "dn-p")
    ref = ref_dn(str(tmp_path / "r"), nn.addr, "dn-r")
    try:
        assert write_ok(write_block(port.addr, 700, blk), blk)
        nn.command("dn-p", {"cmd": "replicate", "block_id": 700,
                            "targets": [target(ref)]})
        nn.command("dn-p", {"cmd": "cache", "block_ids": [700]})
        nn.command("dn-p", {"cmd": "balancer_bandwidth",
                            "bytes_per_s": 12345678})
        deadline = time.monotonic() + 20
        while (ref.replicas.get_meta(700) is None
               or port.cache.ids() != [700]) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert read_block(ref.addr, 700)[1] == blk
        assert port.cache.ids() == [700]
        assert port.config.balancer_bandwidth == 12345678
        assert block_checksum(ref.addr, 700) == block_checksum(port.addr, 700)
        nn.command("dn-p", {"cmd": "invalidate", "block_ids": [700]})
        while port.replicas.get_meta(700) is not None \
                and time.monotonic() < deadline + 20:
            time.sleep(0.05)
        assert port.replicas.get_meta(700) is None
        assert read_block(port.addr, 700)[0]["status"] == 1
    finally:
        port.stop()
        ref.stop()
        nn.stop()


def test_direct_scheme_streams_and_recovers_block(tmp_path):
    """The ``direct`` scheme streams packets down a port -> reference ->
    port pipeline with per-packet acks; ``recover_block`` syncs the
    replicas to the shortest and restamps them."""
    nn = StandInNN()
    blk = _blocks(11, n=1, size=300_000)[0]
    a = port_dn(str(tmp_path / "a"), nn.addr, "dn-d0")
    b = ref_dn(str(tmp_path / "b"), nn.addr, "dn-d1")
    c = port_dn(str(tmp_path / "c"), nn.addr, "dn-d2")
    try:
        acks = write_block(a.addr, 800, blk, scheme="direct",
                           targets=[target(b), target(c)])
        assert write_ok(acks, blk) and all(s == 0 for _, s in acks)
        for dn in (a, b, c):
            assert read_block(dn.addr, 800)[1] == blk
        assert c.replicas.truncate_replica(800, 200_000)
        a._recover_block({"block_id": 800, "gen_stamp": 5, "path": "/f",
                          "peers": [{"dn_id": d.dn_id, "addr": list(d.addr)}
                                    for d in (a, b, c)]})
        for dn in (a, b, c):
            meta = dn.replicas.get_meta(800)
            assert (meta.logical_len, meta.gen_stamp) == (200_000, 5)
            assert read_block(dn.addr, 800)[1] == blk[:200_000]
    finally:
        for dn in (a, b, c):
            dn.stop()
        nn.stop()


def test_container_size_is_the_configured_one(tmp_path):
    """The helper's DataNodes roll 64 KiB containers (the tests above
    rely on several seals a block)."""
    nn = StandInNN()
    dn = port_dn(str(tmp_path / "dn"), nn.addr, "dn-s")
    try:
        assert dn.config.reduction.container_size == CONTAINER
        assert dn.write_pipeline is not None
        assert dn.write_pipeline._thread is None   # native: inline
    finally:
        dn.stop()
        nn.stop()


def test_small_ops_answer_like_reference(tmp_path):
    """The xceiver's small ops answer as the reference's: ``replica_info``
    and ``BLOCK_CHECKSUM`` of a known and an unknown block, READ_BLOCK's
    error frame for an unknown block, ``truncate_replica`` of a direct
    replica, and ``disk_balance``."""
    blk = _blocks(12, n=1, size=200_000)[0]
    got = {}
    for name, mk in (("ref", ref_dn), ("port", port_dn)):
        nn = StandInNN()
        dn = mk(str(tmp_path / name), nn.addr, "dn-o")
        try:
            assert write_ok(write_block(dn.addr, 1, blk, scheme="direct"),
                            blk)
            out = [op_reply(dn.addr, "replica_info", block_id=b)
                   for b in (1, 2)]
            out += [block_checksum(dn.addr, b) for b in (1, 2)]
            out.append(read_block(dn.addr, 2))
            out.append(op_reply(dn.addr, "truncate_replica", block_id=1,
                                length=100_000, new_gen_stamp=3))
            out.append(read_block(dn.addr, 1))
            bal = op_reply(dn.addr, "disk_balance", threshold=0.1)
            out.append({k: v for k, v in bal.items() if k != "volumes"})
            out.append([(v["vol"], v["type"], v["failed"])
                        for v in bal["volumes"]])
            got[name] = out
        finally:
            dn.stop()
            nn.stop()
    assert got["port"] == got["ref"]
    assert got["port"][-3][1] == blk[:100_000]


def test_ec_reconstruct_command_like_reference(tmp_path):
    """``ec_reconstruct`` (DNA_ERASURE_CODING_RECONSTRUCTION): a DataNode
    fetches k surviving shards of an RS(3,2) block group from its peers
    (reference and port DataNodes), decodes the lost one and stores it as
    a direct replica: the same bytes and checksums in both packages."""
    from hdrf_tpu_torch.ops import rs

    rng = np.random.default_rng(13)
    k, m, n = 3, 2, 70_000
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    shards = list(data) + list(rs.rs_encode(data, k, m, device="cpu"))
    nn = StandInNN()
    holders = [(ref_dn if i % 2 else port_dn)(str(tmp_path / f"h{i}"),
                                              nn.addr, f"dn-h{i}")
               for i in range(k + m)]
    got = {}
    try:
        for i, h in enumerate(holders):
            if i != 1:   # shard 1 is lost
                assert write_ok(write_block(h.addr, 50 + i,
                                            shards[i].tobytes(),
                                            scheme="direct"),
                                shards[i].tobytes())
        cmd = {"cmd": "ec_reconstruct", "policy": "rs-3-2-64k",
               "block_id": 51, "index": 1, "gen_stamp": 1,
               "survivors": [{"index": i, "block_id": 50 + i,
                              "locations": [{"addr": list(h.addr)}]}
                             for i, h in enumerate(holders) if i != 1]}
        for name, mk in (("ref", ref_dn), ("port", port_dn)):
            dn = mk(str(tmp_path / name), nn.addr, f"dn-{name}")
            try:
                dn._ec_reconstruct(cmd)
                got[name] = (read_block(dn.addr, 51),
                             block_checksum(dn.addr, 51))
            finally:
                dn.stop()
    finally:
        for h in holders:
            h.stop()
        nn.stop()
    assert got["port"] == got["ref"]
    assert got["port"][0][1] == shards[1].tobytes()

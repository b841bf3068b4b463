"""The port's DataNode storage and its leaves held against the reference's
on the CPU: storage/replica_store.py (meta files packed with the port's
own msgpack codec), storage/volumes.py, storage/version.py, security.py
(block tokens and the encrypted data-transfer handshake, across
packages), utils/watchdog.py, utils/log.py, utils/flight_recorder.py,
utils/tenants.py and the profiler's ``timed_iter`` / ``thread_phase``.
Byte identity is the tolerance.
"""

import io
import os
import socket
import threading
import time

import numpy as np
import pytest

from _dn_standin import data_files


def _meta_cases():
    rng = np.random.default_rng(0)
    return [
        (1, 0, 0, 0, "dedup_lz4", 65536, []),
        (2**48 + 5, 7, 128 << 20, 0, "dedup_lz4", 65536,
         [int(v) for v in rng.integers(0, 2**32, 2048)]),
        (9, 1, 300_000, 300_000, "direct", 65536, [0, 1, 2**32 - 1]),
        (10, 2**40, 1, 1, "lz4", 512, [127, 128, 255, 256, 65535, 65536]),
    ]


@pytest.mark.parametrize("case", _meta_cases(), ids=lambda c: str(c[0]))
def test_block_meta_bytes_equal_reference(case):
    from hdrf_tpu.storage.replica_store import BlockMeta as RefMeta
    from hdrf_tpu_torch.storage.replica_store import BlockMeta

    mine, ref = BlockMeta(*case), RefMeta(*case)
    assert mine.pack() == ref.pack()
    assert RefMeta.unpack(mine.pack()) == ref
    assert BlockMeta.unpack(ref.pack()) == mine


def _lifecycle(mod, root: str) -> dict:
    """One op sequence over a ReplicaStore: finalize (reduced and direct),
    abort, hflush + detach (an RBW left for restart promotion), a
    supersede, a truncation with restamp, a delete."""
    st = mod.ReplicaStore(root)
    w = st.create_rbw(1, 1)
    m1 = w.finalize(4096, "dedup_lz4", [11, 22], 65536)
    w = st.create_rbw(2, 1)
    w.write(b"a" * 150_000)
    w.finalize(150_000, "direct", [1, 2, 3], 65536)
    w = st.create_rbw(3, 1)
    w.write(b"x" * 10)
    assert st.is_rbw(3)
    w.abort()
    assert not st.is_rbw(3)
    with pytest.raises(FileExistsError):
        st.create_rbw(1, 1)
    w = st.create_rbw(4, 3)
    w.write(b"y" * 70_000)
    w.flush_visible([5, 6], 65536, sync=True)
    vis = st.get_meta(4)
    w.write(b"z" * 1000)           # beyond the visible length: dropped
    w.detach()
    w = st.create_rbw(2, 2)        # supersede the direct replica
    w.write(b"b" * 140_000)
    w.finalize(140_000, "direct", [7, 8, 9], 65536)
    assert st.truncate_replica(2, 100_000, new_gs=9)
    w = st.create_rbw(5, 1)
    w.finalize(0, "dedup_lz4", [], 65536)
    st.delete(5)
    return {"report": sorted(st.block_report()), "m1": m1.pack(),
            "vis": (vis.logical_len, vis.physical_len),
            "read": st.read_data(2, 5, 50), "scan": st.scan(),
            "phys": st.physical_bytes()}


def test_replica_store_lifecycle_and_files_match_reference(tmp_path):
    from hdrf_tpu.storage import replica_store as ref
    from hdrf_tpu_torch.storage import replica_store as port

    a = _lifecycle(port, str(tmp_path / "p"))
    b = _lifecycle(ref, str(tmp_path / "r"))
    assert a == b
    assert data_files(str(tmp_path / "p")) == data_files(str(tmp_path / "r"))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_replica_store_reopens_the_others_directory(tmp_path, writer):
    """Restart recovery across packages: finalized replicas load, the
    hflush'd RBW is promoted at its visible length, the orphan RBW goes."""
    from hdrf_tpu.storage import replica_store as ref
    from hdrf_tpu_torch.storage import replica_store as port

    mods = {"port": port, "ref": ref}
    reader = mods["ref" if writer == "port" else "port"]
    root = str(tmp_path / "d")
    _lifecycle(mods[writer], root)
    w = mods[writer].ReplicaStore(root).create_rbw(6, 1)
    w.write(b"orphan")
    w.detach()
    got = reader.ReplicaStore(root)
    again = mods[writer].ReplicaStore(str(tmp_path / "d"))
    assert sorted(got.block_report()) == sorted(again.block_report())
    assert got.get_meta(4).logical_len == 70_000
    assert got.read_data(4) == b"y" * 70_000
    assert got.get_meta(6) is None
    assert got.read_data(2) == b"b" * 100_000


def _volume_ops(mod, root: str) -> dict:
    from hdrf_tpu_torch.utils import codec  # noqa: F401 (host codecs)

    vs = mod.VolumeSet(root, ["DISK", "SSD", "DISK"],
                       container_kw=dict(container_size=1 << 16,
                                         codec="lz4"))
    placed = {}
    for bid, stype, n in ((1, None, 1000), (2, "SSD", 2000), (3, None, 500),
                          (4, "DISK", 40_000), (5, None, 0)):
        w = vs.create_rbw(bid, 1, storage_type=stype)
        w.write(b"q" * n)
        w.finalize(n, "direct", [n], 65536)
        placed[bid] = vs._where[bid]
    locs = vs.containers.append_chunks([b"c" * 100, b"d" * 200])
    plan = vs.plan_moves(0.0)
    moved = vs.execute_moves(plan)
    lost = vs.eject(1)
    return {"placed": placed, "locs": [tuple(x) for x in locs],
            "plan": plan, "moved": moved, "lost": sorted(lost),
            "report": sorted(vs.block_report()), "alive": vs.alive_count(),
            "where": dict(sorted(vs._where.items()))}


def test_volume_set_matches_reference(tmp_path, monkeypatch):
    """Placement across typed volumes, container ids namespaced per
    volume, the intra-node balancer's plan and moves, and a volume
    ejection: the same decisions as the reference's.  Placement follows
    each volume's free space (``free_estimate`` reads ``os.statvfs``), so
    both runs see the same fixed free space: other processes writing to
    the same filesystem between the two runs cannot move it."""
    from types import SimpleNamespace

    from hdrf_tpu.storage import volumes as ref
    from hdrf_tpu_torch.storage import volumes as port

    monkeypatch.setattr(os, "statvfs", lambda _path: SimpleNamespace(
        f_bavail=1 << 20, f_frsize=4096))

    assert _volume_ops(port, str(tmp_path / "p")) == \
        _volume_ops(ref, str(tmp_path / "r"))


def test_version_layout_and_upgrade_match_reference(tmp_path):
    """A flat pre-volume directory is upgraded to the volume layout with
    a rollback snapshot, and finalized, as the reference does."""
    from hdrf_tpu.storage import version as ref
    from hdrf_tpu_torch.storage import version as port

    out = []
    for name, mod in (("p", port), ("r", ref)):
        root = str(tmp_path / name)
        os.makedirs(os.path.join(root, "finalized"))
        os.makedirs(os.path.join(root, "containers"))
        with open(os.path.join(root, "finalized", "blk_1"), "wb") as f:
            f.write(b"data")
        with open(os.path.join(root, "containers", "0.raw"), "wb") as f:
            f.write(b"raw")
        layout = mod.ensure_layout(root, "datanode", mod.DN_UPGRADERS)
        before = data_files(root)
        fin = mod.finalize_upgrade(root)
        out.append((layout, before, data_files(root), fin,
                    mod.read_version(root)["layoutVersion"]))
    assert out[0] == out[1]
    assert out[0][0] == 2 and out[0][3]
    assert any(k.startswith("previous") for k in out[0][1])


def test_block_tokens_cross_verify():
    """Tokens minted by either package verify in the other; a wrong mode,
    a wrong block and an expired token are refused by both."""
    from hdrf_tpu import security as ref
    from hdrf_tpu_torch import security as port

    keys = [os.urandom(32), os.urandom(32)]
    mine, theirs = port.BlockTokenVerifier(), ref.BlockTokenVerifier()
    assert not mine.enabled
    mine.update_keys(keys)
    theirs.update_keys(keys)
    assert mine.enabled and theirs.enabled
    for minter, checker in ((mine, theirs), (theirs, mine)):
        tok = minter.mint(42, "rw")
        checker.verify(tok, 42, "r")
        checker.verify(tok, 42, "w")
        for bad in ((tok, 43, "r"), (minter.mint(42, "r"), 42, "w"),
                    (minter.mint(42, "r", lifetime_s=-5), 42, "r")):
            with pytest.raises(PermissionError):
                checker.verify(*bad)
    mgr = ref.BlockTokenSecretManager()
    mine.update_keys(mgr.keys())
    mine.verify(mgr.mint(7, "r"), 7, "r")


@pytest.mark.parametrize("client", ["port", "ref"])
def test_encrypted_handshake_across_packages(client):
    """The token-keyed handshake and the AEAD record channel interoperate:
    one package's client against the other's server, frames both ways."""
    from hdrf_tpu import security as ref
    from hdrf_tpu.proto import datatransfer as ref_dt
    from hdrf_tpu.proto import rpc as ref_rpc
    from hdrf_tpu_torch import security as port
    from hdrf_tpu_torch.proto import datatransfer as port_dt
    from hdrf_tpu_torch.proto import rpc as port_rpc

    mods = {"port": (port, port_dt, port_rpc), "ref": (ref, ref_dt, ref_rpc)}
    c_sec, c_dt, c_rpc = mods[client]
    s_sec, s_dt, s_rpc = mods["ref" if client == "port" else "port"]
    keys = [os.urandom(32)]
    v = s_sec.BlockTokenVerifier()
    v.update_keys(keys)
    tok = v.mint(5, "r")
    a, b = socket.socketpair()
    a.settimeout(30)
    b.settimeout(30)
    got = {}

    def serve():
        op, fields = s_dt.recv_op(b)
        assert op == s_sec.HANDSHAKE_OP
        sock, hs_token = s_sec.server_handshake(b, fields, v._keys)
        got["op"] = s_dt.recv_op(sock)
        got["token"] = hs_token
        s_rpc.send_frame(sock, {"pong": b"\x00" * 70_000})

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        sec_sock = c_dt.secure_socket(a, tok, True)
        c_dt.send_op(sec_sock, "read_block", block_id=5, blob=b"z" * 5000)
        reply = c_rpc.recv_frame(sec_sock)
        t.join(timeout=30)
    finally:
        a.close()
        b.close()
    assert got["op"][0] == "read_block" and got["op"][1]["block_id"] == 5
    assert got["op"][1]["blob"] == b"z" * 5000
    assert reply == {"pong": b"\x00" * 70_000}
    assert got["token"]["block_id"] == 5


def test_stall_watchdog_flags_like_reference():
    """An op past its budget is flagged once, with the thread's open
    profiler phase, a stall record and a synthetic span; the reference's
    watchdog does the same on the same schedule."""
    from hdrf_tpu.utils import profiler as ref_prof
    from hdrf_tpu.utils import watchdog as ref_wd
    from hdrf_tpu_torch.utils import metrics, profiler, tracing
    from hdrf_tpu_torch.utils import watchdog as wd

    results = []
    for mod, prof in ((wd, profiler), (ref_wd, ref_prof)):
        reg = (metrics.registry("wd_test") if mod is wd else None)
        w = mod.StallWatchdog("wd_test", budget_s=10.0, registry=reg)
        inside = threading.Event()
        release = threading.Event()

        def op():
            with w.track("xceiver.write_block"), prof.phase("container_io"):
                inside.set()
                release.wait(30)

        t = threading.Thread(target=op, daemon=True)
        t.start()
        assert inside.wait(30)
        now = time.monotonic()
        flagged = [w.scan(now), w.scan(now + 11), w.scan(now + 12),
                   w.scan(now + 22)]
        inflight = [e["op"] for e in w.inflight()]
        release.set()
        t.join(timeout=30)
        rec = w.stalls()[0]
        results.append((flagged, inflight, rec["op"], rec["phase"],
                        w.stall_count(), w.inflight()))
    assert results[0] == results[1]
    assert results[0][0] == [0, 1, 0, 1] and results[0][3] == "container_io"
    assert any(s["name"] == "stall:xceiver.write_block"
               for s in tracing.tracer("watchdog").snapshot())


def test_timed_iter_and_thread_phase_like_reference():
    from hdrf_tpu.utils import profiler as ref_prof
    from hdrf_tpu_torch.utils import profiler

    for prof in (profiler, ref_prof):
        seen = []
        for x in prof.timed_iter("recv", iter([1, 2, 3])):
            seen.append((x, prof.thread_phase()))
            with prof.phase("checksum"):
                seen.append(prof.thread_phase())
        assert seen == [(1, None), "checksum", (2, None), "checksum",
                        (3, None), "checksum"]
        with prof.block_timeline(77) as tl:
            list(prof.timed_iter("recv", iter(range(4))))
        assert [s[0] for s in tl.spans].count("recv") == 4   # one a next()


def test_log_lines_match_reference(monkeypatch):
    from hdrf_tpu.utils import log as ref_log
    from hdrf_tpu_torch.utils import log

    for fmt in ("text", "json"):
        monkeypatch.setenv("HDRF_LOG_FORMAT", fmt)
        lines = []
        for mod in (log, ref_log):
            buf = io.StringIO()
            lg = mod.get_logger("dn", stream=buf)
            lg.info("datanode started", dn_id="dn-1", addr="h:1")
            lg.debug("hidden")
            lg.warning("stall", op="x", elapsed_s=1.5)
            lines.append([ln.split(" ", 1)[1] if fmt == "text"
                          else {k: v for k, v in __import__("json").loads(
                              ln).items() if k != "ts"}
                          for ln in buf.getvalue().splitlines()])
        assert lines[0] == lines[1] and len(lines[0]) == 2


def test_flight_recorder_and_tenants_like_reference():
    from hdrf_tpu.utils import flight_recorder as ref_fr
    from hdrf_tpu.utils import tenants as ref_ten
    from hdrf_tpu_torch.utils import flight_recorder as fr
    from hdrf_tpu_torch.utils import tenants as ten

    out = []
    for frm, tm in ((fr, ten), (ref_fr, ref_ten)):
        vals = iter(range(100))
        rec = frm.FlightRecorder("dn", lambda: {"g": next(vals)},
                                 interval_s=0, capacity=3)
        for _ in range(5):
            rec.sample_once()
        snap = rec.snapshot()
        tr = tm.TenantTracker(clock=lambda: 100.0)
        for i in range(20):
            tr.note_op("a" if i % 3 else None, "write", 10 * i,
                       latency_s=0.001 * i)
        out.append(([s["g"] for s in snap["samples"]], tr.tenant_count(),
                    tr.summaries()))
    assert out[0] == out[1]
    assert out[0][0] == [2, 3, 4]


def test_container_read_during_in_place_seal(tmp_path):
    """An incompressible container is sealed by stamping the sealed
    header into its raw file and renaming it.  A read between the two
    finds the sealed magic in the raw file: the port serves the payload
    (the bytes behind the header are the same); the reference raises."""
    from hdrf_tpu.storage import container_store as ref_cs
    from hdrf_tpu_torch.storage import container_store as cs
    from hdrf_tpu_torch.utils import codec

    payload = np.random.default_rng(3).integers(
        0, 256, 5000, dtype=np.uint8).tobytes()
    for mod, root in ((cs, tmp_path / "p"), (ref_cs, tmp_path / "r")):
        store = mod.ContainerStore(str(root), container_size=1 << 16)
        with open(store._raw_path(7), "wb") as f:
            f.write(mod._SEAL_HDR.pack(mod._SEAL_MAGIC, len(payload),
                                       codec.CODEC_IDS["none"]) + payload)
        if mod is cs:
            assert store.read_container(7) == payload
            assert store.read_chunks([(7, 10, 20)]) == [payload[10:30]]
        else:
            with pytest.raises(IOError, match="bad raw magic"):
                store.read_container(7)

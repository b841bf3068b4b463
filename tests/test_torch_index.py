"""The port's index, WAL, codec and store leaves against the reference's.

- The port's msgpack codec in ``raw=True`` mode (proto/rpc.py) against
  ``msgpack`` on the chunk index's WAL record and snapshot shapes: the
  same bytes packed, the same values read back.
- WAL frames (utils/wal.py) and torn-tail recovery.
- ``ChunkIndex`` driven directly by the same operations on both sides:
  byte-identical WAL and snapshot files, equal tables, both directions
  of reopen.
- ``ContainerStore.append_ranges`` (the native range gather) and seals:
  byte-identical container files.
- ``reduction/accounting``, ``utils/profiler`` counters and the QoS
  admission pieces: the same observable results.
"""

import os

import msgpack
import numpy as np
import pytest

from hdrf_tpu.index import chunk_index as ref_ci
from hdrf_tpu.reduction import accounting as ref_acc
from hdrf_tpu.storage import container_store as ref_cs
from hdrf_tpu.utils import profiler as ref_prof
from hdrf_tpu.utils import qos as ref_qos
from hdrf_tpu.utils import wal as ref_wal
from hdrf_tpu_torch import native
from hdrf_tpu_torch.index import chunk_index
from hdrf_tpu_torch.proto import rpc
from hdrf_tpu_torch.reduction import accounting
from hdrf_tpu_torch.storage import container_store
from hdrf_tpu_torch.utils import profiler, qos, wal

H = [bytes([i]) * 32 for i in range(40)]

RECORDS = [
    [1, b"blk", 7, 1 << 27, H[:5], {h: [3, 1 << 20, 8192] for h in H[:3]}],
    [70_000, b"blk", 1 << 40, 0, [], {}],
    [2, b"del", 7],
    [3, b"seal", 1 << 20],
    [4, b"moved", {H[0]: [9, 0, 65536]}],
    [5, b"unseal", 0],
    [6, b"stripe", 4, {"k": 6, "m": 3, "holders": [["dn-1", 5], ["x", 6]],
                       "codec": "lz4"}],
    [7, b"unstripe", 4],
    [8, b"blk", 1, 3, H * 3, {h: [i, i * 100, 4096] for i, h in
                              enumerate(H)}],
]
SNAPSHOTS = [
    {"blocks": {}, "chunks": {}, "sealed": [], "stripes": {}, "seq": 0},
    {"blocks": {7: [1 << 27, H[:20]], 1 << 33: [5, [H[0]]]},
     "chunks": {h: [i, i << 10, 8192, i % 5] for i, h in enumerate(H)},
     "sealed": list(range(20)), "stripes": {3: {"k": 6, "m": 3}},
     "seq": 123_456},
]


@pytest.mark.parametrize("obj", RECORDS + SNAPSHOTS,
                         ids=[f"rec{i}" for i in range(len(RECORDS))]
                         + [f"snap{i}" for i in range(len(SNAPSHOTS))])
def test_raw_codec_matches_msgpack(obj):
    packed = msgpack.packb(obj)
    assert rpc.packb(obj) == packed
    assert rpc.unpackb(packed, raw=True) == msgpack.unpackb(
        packed, raw=True, strict_map_key=False)
    assert rpc.unpackb(packed) == msgpack.unpackb(
        packed, raw=False, strict_map_key=False)


def test_wal_frames_and_torn_tail(tmp_path):
    payloads = [rpc.packb(r) for r in RECORDS]
    blob = b"".join(wal.frame(p) for p in payloads)
    assert blob == b"".join(ref_wal.frame(p) for p in payloads)
    assert list(wal.iter_frames(blob)) == payloads
    path = str(tmp_path / "w")
    with open(path, "wb") as f:
        f.write(blob + wal.frame(b"torn")[:-2])
    assert wal.recover(path) == payloads
    assert os.path.getsize(path) == len(blob)


def _drive(mod, d: str) -> None:
    """One sequence of index operations: commits (single and grouped),
    seals, a delete, a supersede, a checkpoint, moves and stripes."""
    idx = mod.ChunkIndex(d)
    idx.commit_block(1, 300, H[:3], {h: (0, i * 100, 100)
                                     for i, h in enumerate(H[:3])})
    idx.seal_container(0)
    idx.commit_blocks([(2, 200, [H[0], H[3]], {H[3]: (1, 0, 100)}),
                       (3, 300, [H[3], H[4], H[4]], {H[4]: (1, 100, 100),
                                                     H[3]: (1, 200, 100)})])
    assert idx.delete_block(1) == [H[1], H[2]]
    idx.checkpoint()
    idx.record_moves({H[3]: (5, 0, 100)}, dropped_container=1)
    idx.record_stripe(5, {"k": 6, "m": 3, "holders": [["dn", 1]]})
    idx.drop_stripe(5)
    idx.seal_container(5)
    idx.commit_block(4, 100, [H[9]], {H[9]: (6, 0, 100)})
    idx.close()


def _tables(idx):
    return ({b: (e.logical_len, e.hashes) for b, e in idx._blocks.items()},
            {h: (c.container_id, c.offset, c.length, c.refcount)
             for h, c in idx._chunks.items()},
            sorted(idx._sealed), idx._stripes, idx._seq)


def test_chunk_index_files_byte_identical(tmp_path):
    _drive(ref_ci, str(tmp_path / "ref"))
    _drive(chunk_index, str(tmp_path / "port"))
    for name in (chunk_index.WAL_NAME, chunk_index.CKPT_NAME):
        with open(tmp_path / "ref" / name, "rb") as f:
            want = f.read()
        with open(tmp_path / "port" / name, "rb") as f:
            assert f.read() == want, name
    got = chunk_index.ChunkIndex(str(tmp_path / "ref"))
    back = ref_ci.ChunkIndex(str(tmp_path / "port"))
    assert _tables(got) == _tables(back)
    assert got.stats() == back.stats()
    assert got.accounting() == back.accounting()
    assert got.orphan_bytes() == back.orphan_bytes() == {}
    got.close()
    back.close()


def test_chunk_index_validation_and_losers(tmp_path):
    for mod, d in ((ref_ci, "ref"), (chunk_index, "port")):
        idx = mod.ChunkIndex(str(tmp_path / d))
        with pytest.raises(ValueError):
            idx.commit_block(1, 5, [H[0]], {})
        idx.commit_block(1, 100, [H[0]], {H[0]: (0, 0, 100)})
        assert idx.commit_block(2, 100, [H[0]], {H[0]: (0, 100, 100)}) \
            == [H[0]]
        assert idx.orphan_bytes() == {0: 100}
        idx.close()


def test_container_store_files_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 400_000, dtype=np.uint8)
    data[100_000:200_000] = 7           # a compressible stretch
    starts = np.arange(0, 390_000, 9_000, dtype=np.uint64)
    lens = np.full(starts.size, 8_500, dtype=np.uint64)
    lens[5] = 70_000                    # an oversized chunk lands alone
    outs = []
    for mod, d in ((ref_cs, "ref"), (container_store, "port")):
        cs = mod.ContainerStore(str(tmp_path / d), container_size=1 << 16,
                                lanes=2)
        sealed = []
        locs = cs.append_ranges(data, starts, lens, on_seal=sealed.append)
        locs += cs.append_chunks([bytes(300), bytes(70_000)],
                                 on_seal=sealed.append)
        cs.flush_open(on_seal=sealed.append)
        chunks = cs.read_chunks(locs)
        files = {n: open(tmp_path / d / n, "rb").read()
                 for n in sorted(os.listdir(tmp_path / d))}
        outs.append((locs, sealed, files, chunks))
    assert outs[0] == outs[1]
    assert outs[1][3][0] == data[:8_500].tobytes()
    assert native.gather_ranges(data, starts[:3], lens[:3]).tobytes() \
        == b"".join(data[int(s):int(s + n)].tobytes()
                    for s, n in zip(starts[:3], lens[:3]))


def test_accounting_matches_reference():
    """The same observation points move the same counters (deltas: the
    registries are process-wide)."""
    def counters(m):
        return dict(m.snapshot()["counters"])
    deltas = []
    for m in (ref_acc, accounting):
        c0 = counters(m)
        m.record_reduce("dedup_lz4", 1000, 300)
        m.record_dedup_block(10, 4)
        m.record_worker_bytes("compress", 1 << 20)
        with m.read_scope("dedup_lz4"):
            m.record_read_logical("dedup_lz4", 500)
            m.record_container_decode(2000)
        m.record_container_decode(7)
        c1 = counters(m)
        deltas.append({k: v - c0.get(k, 0) for k, v in c1.items()
                       if v != c0.get(k, 0)})
    assert deltas[0] == deltas[1]
    assert deltas[1]["read_physical_bytes__dedup_lz4"] == 2000
    assert accounting.dedup_ratio(10, 4) == ref_acc.dedup_ratio(10, 4)


def test_profiler_counters_and_window_match_reference():
    for m in (ref_prof, profiler):
        m.counter_add("inflight_blocks", 2)
        m.counter_set("wal_queue_depth", 3)
        m.counter_add("inflight_blocks", -2)
    got = profiler.counters_snapshot()[-3:]
    want = ref_prof.counters_snapshot()[-3:]
    assert [sorted(s) for s in got] == [sorted(s) for s in want]
    assert [(s["name"], s["value"]) for s in got] \
        == [(s["name"], s["value"]) for s in want]
    spans = [("device_wait", 0.0, 4.0), ("dedup_lookup", 1.0, 2.0),
             ("recv", 3.0, 6.0), ("container_decode", 7.0, 8.0)]
    assert profiler.profile_spans(spans, 0.0, 10.0, nbytes=1 << 20) \
        == ref_prof.profile_spans(spans, 0.0, 10.0, nbytes=1 << 20)


def test_bind_timeline_lands_phases_in_the_bound_request():
    import threading

    with profiler.read_timeline(1) as lead:
        pass
    seen = []

    def worker():
        with profiler.bind_timeline(lead), profiler.phase("container_decode"):
            seen.append(profiler.current_timeline())
    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert seen == [lead]
    assert [s[0] for s in lead.spans] == ["container_decode"]


def test_qos_admission_and_fair_queue_match_reference():
    clock = [0.0]
    for m in (ref_qos, qos):
        ctl = m.AdmissionController(rate_mb_s=1.0, burst_mb=1.0,
                                    clock=lambda: clock[0])
        ctl.admit("t1", "read")
        ctl.charge("t1", "read", nbytes=3 << 20)
        with pytest.raises(m.ShedError) as e:
            ctl.admit("t1", "read")
        assert e.value.retry_after_s == pytest.approx(2.0)
        ctl.admit(m.BACKGROUND_TENANT, "read")
        # a deadline that cannot cover 3 x the p95 service estimate
        for _ in range(5):
            ctl.note_latency("write", 1.0)
        with m.retry.bind(m.retry.Deadline(2.0, clock=lambda: clock[0])):
            with pytest.raises(m.ShedError) as e:
                ctl.admit("t2", "write")
        assert e.value.retry_after_s == pytest.approx(3.0)
        ctl.admit("t2", "write")          # no deadline: admitted
    order = []
    for m in (ref_qos, qos):
        q = m.FairQueue()

        class It:
            def __init__(self, t, i):
                self.tenant, self.i = t, i
        for i in range(3):
            q.put(It("flood", i))
        q.put(It("light", 9))
        q.put(None)
        order.append([(x.tenant, x.i) if x is not None else None
                      for x in (q.get() for _ in range(5))])
    assert order[0] == order[1]
    assert order[1][1] == ("light", 9) and order[1][-1] is None

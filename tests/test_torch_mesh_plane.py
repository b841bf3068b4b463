"""The port's mesh plane (MeshReducer, ShardedBucketTable and the sharded
LZ4 scan of hdrf_tpu_torch.parallel.sharded) on the CPU.

The reference's own MeshReducer fails on this machine, so the oracles are
the native C++ library, the port's serial ``ResidentReducer``, the
reference ``ShardedBucketTable``'s numpy mirror (``host_probe``, which
needs no device) and, for the LZ4 streams, ``DeviceLz4.compress_many``
and the reference ``TpuLz4`` with one history.  The port's mesh is ``cpu``
repeated, each shard with its own tensors; every stage runs its kernel's
plain version.
"""

import jax
import numpy as np
import pytest
import torch

from hdrf_tpu import native as ref_native
from hdrf_tpu.ops.lz4_tpu import TpuLz4
from hdrf_tpu.parallel import sharded as ref_sharded
from hdrf_tpu_torch import native
from hdrf_tpu_torch.config import CdcConfig
from hdrf_tpu_torch.ops import dispatch
from hdrf_tpu_torch.ops.lz4_device import _S
from hdrf_tpu_torch.ops.resident import ResidentReducer
from hdrf_tpu_torch.parallel import sharded
from hdrf_tpu_torch.utils import device_ledger, fault_injection, metrics


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are per-op bound on small tensors; one intra-op
    thread keeps them off the cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear_port_faults():
    yield
    fault_injection.clear()


def _corpora():
    """The 7 standard CDC corpora of tests/test_mesh_plane.py (seed 7, text
    drawn first: draw order is part of the corpus identity)."""
    rng = np.random.default_rng(7)
    text = rng.integers(97, 123, size=200_000, dtype=np.uint8)
    yield "random", rng.integers(0, 256, 150_000, dtype=np.uint8), \
        0x1FFF, 2048, 65536
    yield "text-low-entropy", text, 0x1FFF, 2048, 65536
    yield "forced-max-runs", rng.integers(0, 256, 120_000, dtype=np.uint8), \
        0xFFFFFF, 512, 4096
    yield "dense", rng.integers(0, 256, 30_000, dtype=np.uint8), 0x7, 8, 64
    yield "tail-short-chunk", rng.integers(0, 256, 65536 + 37,
                                           dtype=np.uint8), \
        0x1FFF, 2048, 65536
    yield "single-tile", rng.integers(0, 256, 65536, dtype=np.uint8), \
        0x3FF, 256, 8192
    yield "sub-tile", rng.integers(0, 256, 300, dtype=np.uint8), 0x3F, 16, 128


def _count(key: str) -> int:
    return metrics.registry("mesh_plane").snapshot()["counters"].get(key, 0)


def _oracle(a: np.ndarray, mask: int, mn: int, mx: int):
    a = np.ascontiguousarray(a)
    cuts = ref_native.cdc_chunk(a, mask, mn, mx)
    starts = np.concatenate([[0], cuts[:-1]]).astype(np.uint64)
    return cuts, ref_native.sha256_batch(a, starts, cuts - starts)


def _cdc(mask: int, mn: int, mx: int) -> CdcConfig:
    return CdcConfig(mask_bits=max(bin(mask).count("1"), 1), min_chunk=mn,
                     max_chunk=mx)


def _mesh(n_data: int = 8) -> sharded.Mesh:
    return sharded.make_mesh(n_data, 1, ["cpu"] * n_data)


def _mesh_reducer(mask: int, mn: int, mx: int, n_data: int = 8, **kw):
    return sharded.MeshReducer(_cdc(mask, mn, mx), _mesh(n_data), mask=mask,
                               **kw)


@pytest.mark.parametrize("name,a,mask,mn,mx", list(_corpora()),
                         ids=[c[0] for c in _corpora()])
def test_mesh_step_equals_native_and_serial(name, a, mask, mn, mx):
    """A group of the corpus and a truncated sibling (lane binning, digest
    row reconstruction and mesh-width padding all engage) against the
    native oracle and the port's serial ResidentReducer with the same
    mask."""
    r = _mesh_reducer(mask, mn, mx)
    group = [a, np.ascontiguousarray(a[: max(len(a) // 2, 1)])]
    res = r.reduce_many(group)
    serial = ResidentReducer(_cdc(mask, mn, mx), device="cpu")
    serial.mask = mask
    want = serial.reduce_many(group)
    assert len(res) == len(group)
    for blk, (cuts, digs, probe), (sc, sd) in zip(group, res, want):
        ref_cuts, ref_digs = _oracle(blk, mask, mn, mx)
        np.testing.assert_array_equal(cuts, ref_cuts)
        np.testing.assert_array_equal(digs, ref_digs)
        np.testing.assert_array_equal(cuts, sc)
        np.testing.assert_array_equal(digs, sd)
        assert probe == frozenset()   # empty bucket table: no hits


def test_mixed_size_group_and_big_lanes_equal_serial():
    """One step over blocks of different lengths and more blocks than the
    mesh is wide (Kl > 1), with a geometry whose big-chunk leg is live
    (b_small < b_big)."""
    rng = np.random.default_rng(17)
    for cdc, n_data in ((CdcConfig(mask_bits=10, min_chunk=256,
                                   max_chunk=4096), 8),
                        (CdcConfig(mask_bits=6, min_chunk=16,
                                   max_chunk=4096), 2)):
        group = [rng.integers(0, 256, n, np.uint8)
                 for n in (20_000, 9_999, 33_333, 300, 5_000)]
        r = sharded.MeshReducer(cdc, _mesh(n_data), lanes_per_device=3)
        assert r.max_group() == 3 * n_data
        res = r.reduce_many(group)
        want = ResidentReducer(cdc, device="cpu").reduce_many(group)
        for (c, d, _p), (wc, wd) in zip(res, want):
            np.testing.assert_array_equal(c, wc)
            np.testing.assert_array_equal(d, wd)
    assert r._b_small < r._b_big


def test_one_step_is_one_ledger_dispatch():
    r = _mesh_reducer(0x3FF, 256, 4096)
    group = [np.random.default_rng(5).integers(0, 256, 20_000, np.uint8)
             for _ in range(8)]
    evs = device_ledger.events_snapshot()
    id0 = evs[-1]["id"] if evs else 0
    steps0 = _count("steps")
    r.finish_many(r.submit_many(group))
    enq = [e["op"] for e in device_ledger.events_snapshot()
           if e["id"] > id0 and e["kind"] == "enqueue"]
    assert enq == ["sharded.step"], enq
    assert _count("steps") == steps0 + 1


def test_device_probe_equals_host_probe():
    r = _mesh_reducer(0x3FF, 256, 4096, bucket_slots=1 << 9)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, 40_000, np.uint8)
    _c, digs, probe = r.reduce_many([a])[0]
    assert probe == frozenset()
    r.table.note_new([digs[i].tobytes() for i in range(0, len(digs), 2)])
    b = np.concatenate([a[:20_000], rng.integers(0, 256, 20_000, np.uint8)])
    for blk in (a, b):
        _c, d, probe2 = r.reduce_many([blk])[0]
        hm = r.table.host_probe(d)
        assert probe2 == frozenset(d[i].tobytes() for i in np.nonzero(hm)[0])
    assert probe2   # the shared prefix hits


def test_refresh_failure_requeues_and_recovers():
    """A failed device refresh (the port's fault point
    "sharded.bucket_refresh") leaves the step probing the stale table: old
    verdicts hold, the pending rows re-queue, and the next healthy flush
    lands them."""
    r = _mesh_reducer(0x3FF, 256, 4096)
    a = np.random.default_rng(3).integers(0, 256, 40_000, np.uint8)
    _cuts, digs, probe = r.reduce_many([a])[0]
    assert probe == frozenset()
    half = [digs[i].tobytes() for i in range(0, len(digs), 2)]
    r.table.note_new(half)
    _c, _d, probe2 = r.reduce_many([a])[0]
    assert probe2 == frozenset(half)
    rest = [digs[i].tobytes() for i in range(1, len(digs), 2)]
    r.table.note_new(rest)
    fails0 = _count("bucket_refresh_failures")

    def boom(**_kw):
        raise RuntimeError("refresh transport down")

    with fault_injection.inject("sharded.bucket_refresh", boom):
        _c, _d, probe3 = r.reduce_many([a])[0]
    assert probe3 == frozenset(half), "stale table must keep verdicts"
    assert _count("bucket_refresh_failures") == fails0 + 1
    _c, _d, probe4 = r.reduce_many([a])[0]   # healthy flush: re-queued
    assert probe4 == frozenset(d.tobytes() for d in digs)


def test_from_reference_bucket_table_probes_alike():
    """A port table built from a reference table's state (rows flushed and
    rows still pending) answers every probe as the reference does, on the
    host mirror and on the mesh."""
    jmesh = ref_sharded.make_mesh(8, 1, devices=jax.devices()[:8])
    ref = ref_sharded.ShardedBucketTable(jmesh, slots=1 << 10)
    rng = np.random.default_rng(19)
    fps = rng.integers(0, 256, (600, 32), np.uint8)
    ref.note_new([f.tobytes() for f in fps[:400]])
    ref.flush()
    ref.note_new([f.tobytes() for f in fps[400:500]])
    port = sharded.from_reference_bucket_table(_mesh(), ref._np, ref.slots,
                                               ref._pending)
    np.testing.assert_array_equal(port.host_probe(fps), ref.host_probe(fps))
    ref.flush()
    port.flush()
    np.testing.assert_array_equal(port.host_probe(fps), ref.host_probe(fps))
    assert ref.host_probe(fps)[:500].sum() > 400
    # the mesh probe of real chunks against the carried-over table
    r = _mesh_reducer(0x3FF, 256, 4096, bucket_slots=1 << 10)
    a = rng.integers(0, 256, 30_000, np.uint8)
    _c, digs, _p = r.reduce_many([a])[0]
    ref.note_new([d.tobytes() for d in digs[::3]])
    r.table = sharded.from_reference_bucket_table(r.mesh, ref._np,
                                                  ref.slots, ref._pending)
    _c, digs, probe = r.reduce_many([a])[0]
    ref.flush()
    hm = ref.host_probe(digs)
    assert probe == frozenset(digs[i].tobytes() for i in np.nonzero(hm)[0])
    assert probe
    with pytest.raises(ValueError):
        sharded.from_reference_bucket_table(_mesh(4), ref._np, ref.slots, [])


def test_mesh_plane_rejects_a_seq_axis():
    with pytest.raises(ValueError):
        sharded.MeshReducer(CdcConfig(), sharded.make_mesh(1, 2,
                                                           ["cpu"] * 2))


# ---------------------------------------------------------- sharded LZ4

def _text(n: int, rng) -> np.ndarray:
    vocab = [rng.integers(97, 123, size=rng.integers(2, 9),
                          dtype=np.uint8).tobytes() for _ in range(300)]
    out = b" ".join(vocab[i] for i in rng.integers(0, 300, size=n // 5))
    return np.frombuffer(out[:n], np.uint8)


def _twin(**state):
    """A reference TpuLz4 and two port DeviceLz4s (CPU), all in one state."""
    ref = TpuLz4(stride=2)
    for k, v in state.items():
        setattr(ref, k, v)
    d = {f: getattr(ref, f) for f in dispatch._LZ4_FIELDS}
    return (ref, dispatch.from_reference_lz4(d, device="cpu"),
            dispatch.from_reference_lz4(d, device="cpu"))


def test_lz4_sharded_equals_compress_many_and_reference():
    rng = np.random.default_rng(43)
    equal = [_text(2 * _S, rng) for _ in range(3)]
    mixed = [_text(2 * _S, rng), rng.integers(0, 256, 3 * _S, np.uint8),
             np.zeros(2 * _S, np.uint8), _text(3 * _S, rng)]
    mesh = _mesh(2)
    steps0 = _count("lz4_steps")
    for group in (equal, mixed):
        ref, port, twin = _twin()
        got = sharded.lz4_compress_many_sharded(port, group, mesh)
        assert got == twin.compress_many(group)
        assert got == ref.compress_many(group)
        for g, a in zip(got, group):
            assert native.lz4_decompress(g, a.size) == a.tobytes()
    assert _count("lz4_steps") == steps0 + 2
    # a pending bypass covers the group exactly as compress_many's does
    ref, port, twin = _twin(_bypass_left=1)
    assert sharded.lz4_compress_many_sharded(port, mixed, mesh) \
        == twin.compress_many(mixed) == ref.compress_many(mixed)
    assert port._bypass_left == ref._bypass_left


@pytest.mark.parametrize("case", ["seq axis", "one payload", "small payload"])
def test_lz4_sharded_declines_where_the_reference_does(case):
    rng = np.random.default_rng(44)
    group = [_text(2 * _S, rng), _text(2 * _S, rng)]
    mesh = _mesh(2)
    if case == "seq axis":
        mesh = sharded.make_mesh(1, 2, ["cpu"] * 2)
    elif case == "one payload":
        group = group[:1]
    else:
        group[1] = group[1][:_S]
    _ref, port, twin = _twin()
    assert sharded.lz4_submit_many_sharded(port, group, mesh) is None
    assert sharded.lz4_compress_many_sharded(port, group, mesh) \
        == twin.compress_many(group)

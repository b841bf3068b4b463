"""The port's sharded reduction (hdrf_tpu_torch.parallel.sharded) against
the JAX package on the CPU.

The reference runs its meshes on 8 virtual XLA:CPU devices
(tests/conftest.py); the port's mesh of the same shape repeats the ``cpu``
device, each shard with its own tensors, so halos, all-gathers and psums
really run and every stage takes its kernel's plain version.  The JAX
oracle is the XLA per-shard scan (``candidate_words_sharded(mesh,
fused="off")``) and the sharded functions built on it; the native C++
library is the second oracle.  Inputs are numpy-seeded; outputs are
integers, compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from hdrf_tpu import native as ref_native
from hdrf_tpu.config import CdcConfig as RefCdc
from hdrf_tpu.ops.dispatch import gear_mask as ref_gear_mask
from hdrf_tpu.parallel import sharded as ref_sharded
from hdrf_tpu_torch import native
from hdrf_tpu_torch.config import CdcConfig
from hdrf_tpu_torch.ops import cdc_cuda, dispatch
from hdrf_tpu_torch.ops.dispatch import gear_mask
from hdrf_tpu_torch.ops.gear import words_to_positions as \
    gear_words_to_positions
from hdrf_tpu_torch.parallel import sharded

# the plain SHA-256 steps once per 64-byte block of the longest chunk:
# a small geometry keeps it quick
SMALL = dict(mask_bits=10, min_chunk=256, max_chunk=4096)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are per-op bound on small tensors; one intra-op
    thread keeps them off the cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n: int, seed: int = 3) -> np.ndarray:
    """tests/test_sharding.py's generator: random bytes with a zero run and
    a repeat."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=n, dtype=np.uint8)
    a[n // 3:n // 3 + 4096] = 0
    a[n // 2:n // 2 + 2048] = a[:2048]
    return a


def _meshes(n_data: int, n_seq: int):
    """The reference mesh on the virtual devices and the port's of the same
    shape over ``cpu`` repeated."""
    return (ref_sharded.make_mesh(n_data, n_seq,
                                  devices=jax.devices()[:n_data * n_seq]),
            sharded.make_mesh(n_data, n_seq, ["cpu"] * (n_data * n_seq)))


def _oracle(a: np.ndarray, cdc: CdcConfig):
    cuts = ref_native.cdc_chunk(a, gear_mask(cdc), cdc.min_chunk,
                                cdc.max_chunk)
    starts = np.concatenate([[0], cuts[:-1]]).astype(np.uint64)
    return cuts, ref_native.sha256_batch(a, starts, cuts - starts)


# ------------------------------------------------------------ the shard scan

@pytest.mark.parametrize("n_data,n_seq", [(1, 8), (2, 4), (1, 2)])
def test_shard_scan_equals_jax_candidate_words(n_data, n_seq):
    """Words and count of the port's sharded scan (the kernel's plain
    version per shard, halos from the neighbour shards) against the JAX
    XLA route, bit for bit."""
    jmesh, pmesh = _meshes(n_data, n_seq)
    mask = gear_mask(CdcConfig(mask_bits=10))
    a = _data(1 << 18)
    jw, jc = ref_sharded.candidate_words_sharded(jmesh, fused="off")(
        jax.device_put(a, NamedSharding(jmesh, P("seq"))), jnp.uint32(mask))
    block = sharded._put_global(a, pmesh, ("seq",))
    pw, pc = sharded.candidate_words_sharded(pmesh)(block, mask)
    got = sharded._fetch_global(pw, pmesh, ("seq",), (a.size // 32,),
                                torch.int32).view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jw))
    assert int(pc) == int(jc)
    assert int(pc) == ref_native.gear_candidates(a, mask).size


def test_shard_scan_plain_halo_and_position_rule():
    """One shard alone: the halo is its history, the whole-block rule
    ``pos1 >= WINDOW`` applies at its base, and the zero pad past the
    true length is counted (no ``<= n`` clamp, no min-chunk floor)."""
    a = _data(4096, seed=8)
    mask = 0x3F
    full = cdc_cuda.shard_scan_plain(torch.from_numpy(a),
                                     torch.zeros(31, dtype=torch.uint8), 0,
                                     mask)
    w1, c1 = cdc_cuda.shard_scan_plain(torch.from_numpy(a[2048:]),
                                       torch.from_numpy(a[2048 - 31:2048]),
                                       2048, mask)
    w0, c0 = cdc_cuda.shard_scan_plain(torch.from_numpy(a[:2048]),
                                       torch.zeros(31, dtype=torch.uint8), 0,
                                       mask)
    assert torch.equal(torch.cat([w0, w1]), full[0])
    assert int(c0 + c1) == int(full[1])
    assert int(full[1]) == ref_native.gear_candidates(a, mask).size
    zeros = cdc_cuda.shard_scan_plain(torch.zeros(256, dtype=torch.uint8),
                                      torch.zeros(31, dtype=torch.uint8), 0,
                                      0x3F)
    assert int(zeros[1]) == 256 - 31   # every pos1 >= 32 of the zero pad


SHARD_MODEL_CASES = [  # (m, n_seq, lanes, span): shards of 256 B, one
    (256, 4, 32, 1),      # 1 KiB tile +- 256 B, many tiles, narrow lanes
    (768, 3, 32, 1), (1280, 3, 32, 1), (1280, 2, 32, 2),
    (8192 + 256, 4, 32, 3), (4096, 4, 4, 2), (2816, 3, 2, 5),
]


@pytest.mark.parametrize("mask", [0, 0x3F, 0x1FFF])
@pytest.mark.parametrize("m,n_seq,lanes,span", SHARD_MODEL_CASES)
def test_shard_scan_model_equals_reference(m, n_seq, lanes, span, mask):
    """The shard-scan kernel's decomposition (tests/test_torch_cdc.py's
    model: the 31-byte halo as the first tile's history, read by bytes;
    the rule ``pos1 >= 32`` of the whole block, hoisted to the tiles that
    hold it) gives, shard by shard, the reference's whole-block
    ``candidate_bitmap_words`` slice, the plain version's words and
    count, and ``native.gear_candidates``, tolerance zero."""
    from test_torch_cdc import _scan_model
    from hdrf_tpu.ops import gear as ref_gear
    a = np.random.default_rng(m + n_seq).integers(0, 256, m * n_seq,
                                                  dtype=np.uint8)
    a[m - 40:m + 40] = 0        # a zero run across the first shard edge
    ref = np.asarray(ref_gear.candidate_bitmap_words(jnp.asarray(a),
                                                     jnp.uint32(mask)))
    words = []
    for s in range(n_seq):
        base = s * m
        local = a[base:base + m]
        halo = a[base - 31:base] if s else np.zeros(31, np.uint8)
        got, _, _ = _scan_model(local, np.concatenate([[0], halo]).astype(
            np.uint8), 32 - base, m, mask, lanes, span)
        np.testing.assert_array_equal(got, ref[base // 32:(base + m) // 32])
        pw, pc = cdc_cuda.shard_scan_plain(torch.from_numpy(local),
                                           torch.from_numpy(halo.copy()),
                                           base, mask)
        np.testing.assert_array_equal(got, pw.numpy().view(np.uint32))
        assert int(pc) == int(np.unpackbits(got.view(np.uint8)).sum())
        words.append(got)
    wv = np.concatenate(words)
    (idx,) = np.nonzero(wv)
    np.testing.assert_array_equal(
        gear_words_to_positions(idx, wv[idx], a.size),
        ref_native.gear_candidates(a, mask))


def test_shard_scan_wrapper_runs_plain_only_on_the_cpu():
    a = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, 512, dtype=np.uint8))
    halo = torch.zeros(31, dtype=torch.uint8)
    n0 = cdc_cuda.shard_scan_launches
    w, c = cdc_cuda.shard_scan(a, halo, 0, 0xFF)
    pw, pc = cdc_cuda.shard_scan_plain(a, halo, 0, 0xFF)
    assert torch.equal(w, pw) and torch.equal(c, pc)
    assert cdc_cuda.shard_scan_launches == n0


# --------------------------------------------------- host-facing candidates

@pytest.mark.parametrize("n_data,n_seq", [(1, 8), (2, 4), (1, 2)])
def test_gear_candidates_sharded_equal_jax_and_native(n_data, n_seq):
    jmesh, pmesh = _meshes(n_data, n_seq)
    mask = gear_mask(CdcConfig(mask_bits=10))
    a = _data(1 << 18)
    got = sharded.gear_candidates_sharded(a, mask, pmesh)
    np.testing.assert_array_equal(
        got, ref_sharded.gear_candidates_sharded(a, mask, jmesh))
    np.testing.assert_array_equal(got, native.gear_candidates(a, mask))


def test_gear_candidates_sharded_unaligned_length():
    jmesh, pmesh = _meshes(1, 8)
    mask = gear_mask(CdcConfig(mask_bits=9))
    a = _data(100_001, seed=5)  # forces zero padding to the shard grid
    got = sharded.gear_candidates_sharded(a, mask, pmesh)
    np.testing.assert_array_equal(
        got, ref_sharded.gear_candidates_sharded(a, mask, jmesh))
    np.testing.assert_array_equal(got, ref_native.gear_candidates(a, mask))


# ------------------------------------------------ SHA lanes, reduction step

def test_sha256_lanes_sharded_equal_jax():
    jmesh, pmesh = _meshes(8, 1)
    L, seg = 1024, 192
    rng = np.random.default_rng(9)
    msgs = rng.integers(0, 256, size=(L, seg), dtype=np.uint8)
    buf = np.concatenate([msgs, np.broadcast_to(
        ref_sharded._segment_sha_pad(seg), (L, 64))], axis=1)
    nblocks = np.full(L, seg // 64 + 1, dtype=np.int32)
    sh = NamedSharding(jmesh, P("data"))
    want = np.asarray(ref_sharded.sha256_lanes_sharded(jmesh)(
        jax.device_put(buf, sh), jax.device_put(nblocks, sh)))
    out = sharded.sha256_lanes_sharded(pmesh)(
        sharded._put_global(buf, pmesh, ("data", None)),
        sharded._put_global(nblocks, pmesh, ("data",)))
    got = sharded._fetch_global(out, pmesh, ("data", None), (L, 32),
                                torch.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sharded._segment_sha_pad(seg),
                                  ref_sharded._segment_sha_pad(seg))


def test_reduction_step_equals_jax():
    jmesh, pmesh = _meshes(2, 4)
    seg, n_bytes = 512, 1024 * 4
    blocks = _data(4 * n_bytes, seed=13).reshape(4, n_bytes)
    mask = gear_mask(CdcConfig(mask_bits=8))
    want = ref_sharded.reduction_step(jmesh, seg=seg)(
        jax.device_put(blocks, NamedSharding(jmesh, P("data", "seq"))),
        jnp.uint32(mask))
    out = sharded.reduction_step(pmesh, seg=seg)(
        sharded._put_global(blocks, pmesh, ("data", "seq")), mask)
    spec = ("data", "seq")
    words = sharded._fetch_global(out["words"], pmesh, spec,
                                  (4, n_bytes // 32), torch.int32)
    digs = sharded._fetch_global(out["digests"], pmesh, spec,
                                 (4, n_bytes // seg, 32), torch.uint8)
    np.testing.assert_array_equal(words.view(np.uint32),
                                  np.asarray(want["words"]))
    np.testing.assert_array_equal(digs, np.asarray(want["digests"]))
    assert int(out["candidates"]) == int(want["candidates"])


# ---------------------------------------------------------- reduce_sharded

def _spy_routes(monkeypatch) -> list:
    routes = []
    for name, route in (("_sha_chunks_halo", "halo"),
                        ("_sha_chunks_sharded", "all-gather")):
        real = getattr(sharded, name)
        monkeypatch.setattr(
            sharded, name,
            lambda *a, _r=real, _route=route: routes.append(_route) or _r(*a))
    return routes


@pytest.mark.parametrize("n_data,n_seq,n,route", [
    (1, 8, 300_000, "halo"),          # data-local SHA, ring walk of 1 shard
    (2, 4, 400_000, "halo"),          # owners round-robin over 'data' too
    (1, 8, 5_000, "all-gather"),      # shards under one gather window
    (1, 2, 60_000, "all-gather"),     # halo == n_seq - 1
])
def test_reduce_sharded_equals_jax_and_native(monkeypatch, n_data, n_seq, n,
                                              route):
    routes = _spy_routes(monkeypatch)
    jmesh, pmesh = _meshes(n_data, n_seq)
    cdc = CdcConfig(**SMALL)
    rng = np.random.default_rng(n + n_seq)
    a = rng.integers(0, 256, size=n, dtype=np.uint8)
    a[: n // 4] = rng.integers(97, 123, size=n // 4, dtype=np.uint8)
    cuts, digs = sharded.reduce_sharded(a, cdc, pmesh)
    assert routes == [route]
    wc, wd = _oracle(a, cdc)
    np.testing.assert_array_equal(cuts, wc)
    np.testing.assert_array_equal(digs, wd)
    jc, jd = ref_sharded.reduce_sharded(a, RefCdc(**SMALL), jmesh)
    np.testing.assert_array_equal(cuts, np.asarray(jc))
    np.testing.assert_array_equal(digs, np.asarray(jd))


def test_reduce_sharded_empty_and_tiny_inputs():
    _, pmesh = _meshes(1, 8)
    cuts, digs = sharded.reduce_sharded(b"", CdcConfig(), pmesh)
    assert cuts.size == 0 and digs.shape == (0, 32)
    cdc = CdcConfig(**SMALL)
    tiny = np.arange(300, dtype=np.uint8)
    cuts, digs = sharded.reduce_sharded(tiny, cdc, pmesh)
    wc, wd = _oracle(tiny, cdc)
    np.testing.assert_array_equal(cuts, wc)
    np.testing.assert_array_equal(digs, wd)


def test_reduce_sharded_ledger_and_mesh_validation():
    """One put of every replica, one scan and one SHA dispatch, each closed
    by its readback; a mesh must be a full grid."""
    from hdrf_tpu_torch.utils import device_ledger

    _, pmesh = _meshes(2, 4)
    n0 = device_ledger.events_snapshot()[-1]["id"] \
        if device_ledger.events_snapshot() else 0
    sharded.reduce_sharded(_data(100_000), CdcConfig(**SMALL), pmesh)
    evs = [(e["op"], e["kind"]) for e in device_ledger.events_snapshot()
           if e["id"] > n0]
    assert ("sharded.scan", "dispatch") in evs
    assert ("sharded.sha", "dispatch") in evs
    puts = [e for e in device_ledger.events_snapshot()
            if e["id"] > n0 and e["op"] == "sharded.put"]
    assert puts[0]["bytes"] == 2 * 100_352   # the block on both data rows
    with pytest.raises(ValueError):
        sharded.make_mesh(3, 3, ["cpu"] * 8)
    with pytest.raises(ValueError):
        sharded.Mesh([["cpu", "cpu"], ["cpu"]])


def test_mesh_defaults_to_the_card():
    """make_mesh and MeshReducer without devices build a CUDA mesh: with no
    card they raise rather than use the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.MeshReducer(CdcConfig(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh(1, 2, ["cuda:0", "cuda:0"])


# ---------------------------------------------------------------- dispatch

def test_dispatch_routes_multichip(monkeypatch):
    """chunk_and_fingerprint('cuda') takes the sharded path when the mesh
    has more than one shard (here a CPU mesh stands in for the cards)."""
    called = {}
    real = sharded.reduce_sharded

    def spy(data, cdc, mesh):
        called["mesh"] = mesh
        return real(data, cdc, mesh)

    _, pmesh = _meshes(1, 4)
    monkeypatch.setattr(sharded, "reduce_sharded", spy)
    monkeypatch.setattr(dispatch, "_multichip_mesh", lambda: pmesh)
    cdc = CdcConfig(**SMALL)
    a = np.random.default_rng(62).integers(0, 256, size=300_000,
                                           dtype=np.uint8)
    cuts, digs = dispatch.chunk_and_fingerprint(a, cdc, backend="cuda")
    assert called.get("mesh") is pmesh, "multichip dispatch did not engage"
    wc, wd = dispatch.chunk_and_fingerprint(a, cdc, backend="cpu")
    np.testing.assert_array_equal(cuts, wc)
    np.testing.assert_array_equal(digs, wd)
    np.testing.assert_array_equal(cuts, _oracle(a, cdc)[0])


def test_dispatch_meshes_need_two_cards_and_reducers_are_kept(monkeypatch):
    monkeypatch.setattr(dispatch, "_mesh_cache", [])
    monkeypatch.setattr(dispatch, "_mesh_plane_mesh_cache", [])
    few = torch.cuda.device_count() < 2
    assert (dispatch._multichip_mesh() is None) == few
    assert (dispatch._mesh_plane_mesh() is None) == few
    assert (dispatch.mesh_reducer(CdcConfig(**SMALL)) is None) == few
    monkeypatch.setattr(dispatch, "_resident_cache", {})
    cdc = CdcConfig(**SMALL)
    a = np.arange(5000, dtype=np.uint8)
    dispatch.chunk_and_fingerprint(a, cdc, backend="cpu")
    dispatch.chunk_and_fingerprint(a, CdcConfig(**SMALL), backend="cpu")
    assert len(dispatch._resident_cache) == 1
    dispatch.chunk_and_fingerprint(a, CdcConfig(mask_bits=9), backend="cpu")
    assert len(dispatch._resident_cache) == 2


def test_mesh_plane_switch(monkeypatch):
    monkeypatch.setattr(dispatch, "_mesh_plane", [])
    monkeypatch.setenv("HDRF_MESH_PLANE", "1")
    assert dispatch.mesh_plane_enabled()
    dispatch.set_mesh_plane(False)
    assert not dispatch.mesh_plane_enabled()
    monkeypatch.setattr(dispatch, "_mesh_plane", [])
    monkeypatch.delenv("HDRF_MESH_PLANE")
    assert not dispatch.mesh_plane_enabled()
    assert ref_gear_mask(RefCdc(**SMALL)) == gear_mask(CdcConfig(**SMALL))

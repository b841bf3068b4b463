"""The port's in-process ``dedup_lz4`` scheme against the reference's.

The same seeded blocks go through the reference ``DedupScheme``
(``backend="native"``) and the port's (``backend="cpu"``: the card's
pipeline with each kernel's plain version), each over its own
``ContainerStore`` and ``ChunkIndex`` in its own temp directory, at a
small geometry (``CdcConfig(mask_bits=10, min_chunk=256,
max_chunk=4096)``) with 64 KiB containers, so containers roll and seal
mid-test.  With the host ``lz4`` codec on both sides the WAL, the
snapshot and every container file are byte-identical (no record holds a
wall-clock field), reads are bit-identical whole and ranged, and the
chunk plans and index tables are equal.  The cases mirror
tests/test_reduction.py:55-203.

    python -m pytest tests/test_torch_scheme.py tests/test_torch_reconstruct.py -q
"""

import dataclasses
import os
import random
import threading

import numpy as np
import pytest
import torch

from hdrf_tpu.config import ReductionConfig as RefConfig
from hdrf_tpu.index.chunk_index import ChunkIndex as RefIndex
from hdrf_tpu.ops.reconstruct import DeviceReconstructor as RefRecon
from hdrf_tpu.reduction import dedup as ref_dedup
from hdrf_tpu.reduction import scheme as ref_schemes
from hdrf_tpu.reduction.scheme import ReductionContext as RefCtx
from hdrf_tpu.server import read_plane as ref_read_plane
from hdrf_tpu.storage.container_store import ContainerStore as RefStore
from hdrf_tpu_torch.config import ReductionConfig
from hdrf_tpu_torch.index.chunk_index import ChunkIndex
from hdrf_tpu_torch.ops import dispatch
from hdrf_tpu_torch.ops.reconstruct import DeviceReconstructor
from hdrf_tpu_torch.reduction import dedup
from hdrf_tpu_torch.reduction import scheme as schemes
from hdrf_tpu_torch.reduction.scheme import ReductionContext
from hdrf_tpu_torch.server import read_plane
from hdrf_tpu_torch.storage.container_store import ContainerStore
from hdrf_tpu_torch.utils import qos

CONTAINER = 1 << 16
PORT = (ReductionConfig, ContainerStore, ChunkIndex, ReductionContext, "cpu")
REF = (RefConfig, RefStore, RefIndex, RefCtx, "native")


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain versions are per-op bound on small tensors; one intra-op
    thread keeps them off the cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ctx(kind, d, **kw):
    cfg_cls, store_cls, index_cls, ctx_cls, backend = kind
    cfg = cfg_cls()
    cfg.cdc.mask_bits, cfg.cdc.min_chunk, cfg.cdc.max_chunk = 10, 256, 4096
    return ctx_cls(config=cfg,
                   containers=store_cls(os.path.join(d, "containers"),
                                        container_size=CONTAINER, lanes=2),
                   index=index_cls(os.path.join(d, "index")),
                   backend=backend, **kw)


@pytest.fixture
def pair(tmp_path):
    """(reference ctx, port ctx), each in its own directory."""
    r = _ctx(REF, str(tmp_path / "ref"))
    p = _ctx(PORT, str(tmp_path / "port"))
    yield r, p
    for c in (r, p):
        c.index.close()


def _both(pair, op, *args):
    r, p = pair
    return (getattr(ref_schemes.get("dedup_lz4"), op)(*args, r),
            getattr(schemes.get("dedup_lz4"), op)(*args, p))


def _read(pair, bid, n, off=0, ln=-1):
    r, p = pair
    return (ref_schemes.get("dedup_lz4").reconstruct(bid, b"", n, r, off, ln),
            schemes.get("dedup_lz4").reconstruct(bid, b"", n, p, off, ln))


def _tables(idx) -> tuple:
    """Both index tables and the sealed set as plain values."""
    with idx._lock:
        return ({b: (e.logical_len, list(e.hashes))
                 for b, e in idx._blocks.items()},
                {h: (c.container_id, c.offset, c.length, c.refcount)
                 for h, c in idx._chunks.items()},
                sorted(idx._sealed), idx._seq)


def _files(d: str) -> dict:
    out = {}
    for sub in ("containers", "index"):
        for name in sorted(os.listdir(os.path.join(d, sub))):
            with open(os.path.join(d, sub, name), "rb") as f:
                out[f"{sub}/{name}"] = f.read()
    return out


def _blocks(seed: int) -> dict:
    rng = random.Random(seed)
    a = rng.randbytes(300_000)
    unit = rng.randbytes(30_000)
    return {1: a, 2: unit * 8, 3: a[12_345:250_000] + rng.randbytes(80_000),
            4: bytes(rng.randrange(97, 123) for _ in range(120_000))}


def test_registry_names_match_reference():
    assert schemes.names() == ref_schemes.names()
    with pytest.raises(KeyError):
        schemes.get("snappy-nope")


def test_backend_names_resolve_like_the_reference():
    assert dispatch.resolve_backend("tpu") == "cuda"
    assert dispatch.resolve_backend("auto") == "cuda"
    assert dispatch.resolve_backend("native") == "native"
    assert dispatch.resolve_backend("cpu") == "cpu"
    with pytest.raises(ValueError):
        dispatch.resolve_backend("xla")


def test_card_names_raise_without_a_card():
    """``auto`` / ``tpu`` name the card: without one the funnel and the
    reconstructor raise; nothing falls back to a host backend."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from hdrf_tpu_torch.config import CdcConfig

    for name in ("auto", "tpu", "cuda"):
        with pytest.raises(RuntimeError):
            dispatch.chunk_and_fingerprint(bytes(5000), CdcConfig(), name)
    with pytest.raises(RuntimeError):
        DeviceReconstructor()


def test_native_backend_equals_reference_native():
    """The port's ``native`` funnel (gear_candidates + cdc_select +
    sha256_batch) equals the reference's ``native`` (cdc_chunk +
    sha256_batch), cut for cut and digest for digest."""
    from hdrf_tpu.config import CdcConfig as RefCdc
    from hdrf_tpu.ops import dispatch as ref_dispatch
    from hdrf_tpu_torch.config import CdcConfig

    for seed, n in ((1, 300_000), (2, 70_000), (3, 100)):
        a = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
        for geo in ((10, 256, 4096), (13, 2048, 65536)):
            wc, wd = ref_dispatch.chunk_and_fingerprint(a, RefCdc(*geo),
                                                        "native")
            gc, gd = dispatch.chunk_and_fingerprint(a, CdcConfig(*geo),
                                                    "native")
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(gd, wd)


@pytest.mark.parametrize("name", ["direct", "lz4", "gzip"])
def test_compress_schemes_match_reference(name):
    data = (b"The quick brown fox. " * 400) + random.Random(8).randbytes(512)
    got = schemes.get(name).reduce(1, data,
                                   ReductionContext(ReductionConfig()))
    want = ref_schemes.get(name).reduce(1, data, RefCtx(RefConfig()))
    assert got == want
    s = schemes.get(name)
    ctx = ReductionContext(ReductionConfig())
    assert s.reconstruct(1, got, len(data), ctx) == data
    assert s.reconstruct(1, got, len(data), ctx, 100, 50) == data[100:150]


class TestDedup:
    def test_roundtrip(self, pair):
        data = random.Random(7).randbytes(256 * 1024)
        assert _both(pair, "reduce", 1, data) == (b"", b"")
        r, p = _read(pair, 1, len(data))
        assert r == p == data

    def test_range_reads_are_chunk_granular(self, pair):
        data = random.Random(1).randbytes(300_000)
        _both(pair, "reduce", 5, data)
        for off, ln in [(0, 10), (50_000, 1000), (299_990, 10), (0, 300_000),
                        (31_337, 31_337), (299_999, 5), (300_000, 4)]:
            r, p = _read(pair, 5, len(data), off, ln)
            assert r == p == data[off:off + ln]
        rp = read_plane.resolve_chunk_plan(pair[1].index, 5, 31_337, 31_337)
        want = ref_read_plane.resolve_chunk_plan(pair[0].index, 5, 31_337,
                                                 31_337)
        assert dataclasses.asdict(rp) == dataclasses.asdict(want)

    def test_cross_block_dedup(self, pair):
        data = random.Random(2).randbytes(200_000)
        _both(pair, "reduce", 1, data)
        before = pair[1].index.stats()
        _both(pair, "reduce", 2, data)
        after = pair[1].index.stats()
        assert after["unique_chunk_bytes"] == before["unique_chunk_bytes"]
        assert after == pair[0].index.stats()
        assert _read(pair, 2, len(data)) == (data, data)
        assert _tables(pair[1].index) == _tables(pair[0].index)

    def test_intra_block_dedup_fires(self, pair):
        unit = random.Random(3).randbytes(40_000)
        data = unit * 8
        _both(pair, "reduce", 1, data)
        assert pair[1].index.stats()["unique_chunk_bytes"] < 2 * len(unit)
        assert _tables(pair[1].index) == _tables(pair[0].index)
        assert _read(pair, 1, len(data)) == (data, data)

    def test_delete_releases_chunks(self, pair):
        data = random.Random(4).randbytes(60_000)
        _both(pair, "reduce", 1, data)
        _both(pair, "reduce", 2, data[:30_000])
        _both(pair, "delete", 1)
        assert _tables(pair[1].index) == _tables(pair[0].index)
        _both(pair, "delete", 2)
        assert pair[1].index.stats() == pair[0].index.stats() == {
            "blocks": 0, "chunks": 0, "sealed_containers": 0,
            "striped_containers": 0, "logical_bytes": 0,
            "unique_chunk_bytes": 0}

    def test_rollover_files_byte_identical(self, pair, tmp_path):
        """Containers roll and seal mid-test; the WAL, the snapshot and
        every container file (raw and sealed) equal the reference's."""
        blocks = _blocks(11)
        for bid, d in blocks.items():
            _both(pair, "reduce", bid, d)
        _both(pair, "reduce", 1, blocks[3])       # supersede a block
        _both(pair, "delete", 2)
        for bid, d in list(blocks.items())[2:]:
            assert _read(pair, bid, len(d)) == (d, d)
        assert pair[1].index.stats()["sealed_containers"] > 0
        for c in pair:
            c.index.checkpoint()
        _both(pair, "reduce", 9, blocks[4][:70_000])   # a WAL past it
        for c in pair:
            c.index.close()
        got, want = _files(str(tmp_path / "port")), \
            _files(str(tmp_path / "ref"))
        assert list(got) == list(want)
        assert any(k.endswith(".sealed") for k in got)
        assert "index/index.ckpt" in got
        for k in want:
            assert got[k] == want[k], k

    def test_index_survives_restart(self, pair, tmp_path):
        """Close, reopen from the directory (checkpoint + WAL replay),
        read again: the refcounts equal a plain model of the blocks."""
        blocks = _blocks(12)
        for bid, d in blocks.items():
            _both(pair, "reduce", bid, d)
        pair[1].index.checkpoint()
        _both(pair, "reduce", 7, blocks[1][:100_000])
        want_tables = _tables(pair[0].index)
        pair[1].index.close()
        p = dataclasses.replace(
            pair[1], index=ChunkIndex(str(tmp_path / "port" / "index")))
        assert _tables(p.index)[:3] == want_tables[:3]
        model: dict = {}
        for bid in p.index.block_ids():
            for h in p.index.get_block(bid).hashes:
                model[h] = model.get(h, 0) + 1
        assert {h: loc[3] for h, loc in _tables(p.index)[1].items()} == model
        s = schemes.get("dedup_lz4")
        blocks[7] = blocks[1][:100_000]
        for bid, d in blocks.items():
            assert s.reconstruct(bid, b"", len(d), p) == d
        p.index.close()

    def test_port_reopens_reference_index_and_back(self, pair, tmp_path):
        """An index directory the reference wrote reopens in the port
        with the same tables, and the other way round."""
        blocks = _blocks(13)
        for bid, d in blocks.items():
            _both(pair, "reduce", bid, d)
        pair[0].index.checkpoint()
        _both(pair, "delete", 3)
        want = _tables(pair[0].index)
        for c in pair:
            c.index.close()
        got = ChunkIndex(str(tmp_path / "ref" / "index"))
        back = RefIndex(str(tmp_path / "port" / "index"))
        assert _tables(got) == want
        assert _tables(back)[:3] == want[:3]
        got.close()
        back.close()

    def test_group_commit_window_matches_serial(self, pair, tmp_path):
        """Concurrent commits inside a group window leave the same tables
        as the reference's serial commits of the same blocks."""
        blocks = _blocks(14)
        for bid, d in blocks.items():
            ref_schemes.get("dedup_lz4").reduce(bid, d, pair[0])
        port = _ctx(PORT, str(tmp_path / "grouped"))
        port.index.close()
        port = dataclasses.replace(port, index=ChunkIndex(
            str(tmp_path / "grouped" / "index"), group_window_s=0.05))
        s = schemes.get("dedup_lz4")
        red = {bid: dispatch.chunk_and_fingerprint(d, port.config.cdc,
                                                   "native")
               for bid, d in blocks.items()}
        errs = []

        def write(bid):
            try:
                s.reduce_with(bid, blocks[bid], *red[bid], port)
            except Exception as e:  # noqa: BLE001
                errs.append(e)
        ts = [threading.Thread(target=write, args=(b,)) for b in blocks]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs
        got = _tables(port.index)
        want = _tables(pair[0].index)
        assert got[0] == want[0]
        assert {h: v[3] for h, v in got[1].items()} \
            == {h: v[3] for h, v in want[1].items()}
        for bid, d in blocks.items():
            assert s.reconstruct(bid, b"", len(d), port) == d
        port.index.close()

    def test_commit_pipeline_matches_serial(self, pair):
        """The batched committer (one sync + one group WAL commit for a
        batch) leaves the tables the serial commit leaves."""
        blocks = _blocks(15)
        cdc = pair[1].config.cdc
        for bid, d in blocks.items():
            ref_schemes.get("dedup_lz4").reduce(bid, d, pair[0])
        cp = dedup.CommitPipeline(pair[1].index, pair[1].containers, batch=3)
        futs = [cp.submit(bid, d, *dispatch.chunk_and_fingerprint(
            d, cdc, "native")) for bid, d in blocks.items()]
        for f in futs:
            f.result(timeout=60)
        cp.close()
        got, want = _tables(pair[1].index), _tables(pair[0].index)
        assert got[0] == want[0]
        assert {h: v[3] for h, v in got[1].items()} \
            == {h: v[3] for h, v in want[1].items()}
        for bid, d in blocks.items():
            assert schemes.get("dedup_lz4").reconstruct(
                bid, b"", len(d), pair[1]) == d


def test_reads_through_read_plane_and_device_recon(tmp_path):
    """Reads at or above DEVICE_RECON_MIN go through the reconstructor
    (plain versions on the CPU), smaller ones through the read plane's
    chunk cache; both equal the reference's reads of the same blocks."""
    assert dedup.DEVICE_RECON_MIN == ref_dedup.DEVICE_RECON_MIN
    rng = random.Random(9)
    data = (rng.randbytes(dedup.DEVICE_RECON_MIN) + b"Z" * 100_000
            + rng.randbytes(200_000))
    ref = _ctx(REF, str(tmp_path / "ref"))
    port = _ctx(PORT, str(tmp_path / "port"))
    ref_schemes.get("dedup_lz4").reduce(1, data, ref)
    schemes.get("dedup_lz4").reduce(1, data, port)
    recon = DeviceReconstructor(device="cpu")
    port.containers._on_delete = recon.invalidate
    rp = read_plane.ReadPlane(port.containers, backend="cpu",
                              qos_ctrl=qos.AdmissionController())
    rp.attach_store(port.containers)
    dctx = dataclasses.replace(port, recon=recon, read_plane=rp)
    rdctx = dataclasses.replace(ref, recon=RefRecon())
    s, rs = schemes.get("dedup_lz4"), ref_schemes.get("dedup_lz4")
    try:
        for off, ln in [(0, -1), (123_457, dedup.DEVICE_RECON_MIN + 10_000),
                        (99, 4097), (500_001, 65_536), (0, 1)]:
            want = data[off:] if ln < 0 else data[off:off + ln]
            assert s.reconstruct(1, b"", len(data), dctx, off, ln) == want
            assert rs.reconstruct(1, b"", len(data), rdctx, off, ln) == want
        assert recon._images
        assert rp.cache.bytes_used > 0
        # a second small read of the same range is served from the cache
        from hdrf_tpu_torch.utils import metrics

        hits = metrics.registry("read_plane").counter("chunk_cache_hit")
        assert s.reconstruct(1, b"", len(data), dctx, 99, 4097) \
            == data[99:4196]
        assert metrics.registry("read_plane").counter("chunk_cache_hit") \
            > hits
    finally:
        rp.close()
        ref.index.close()
        port.index.close()

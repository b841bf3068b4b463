"""Port ResidentReducer and dispatch (hdrf_tpu_torch.ops.resident /
dispatch) against the JAX reference's ``ResidentReducer(fused_mode=
"interpret")`` and the native oracle, on the CPU (plain versions).

Most cases use a small chunk geometry (the plain SHA-256 steps once per
64-byte block of the longest chunk, so 64 KiB chunks are slow on the
CPU); one case runs the default CdcConfig.  Cuts and digests are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hdrf_tpu.config import CdcConfig as RefCdc
from hdrf_tpu.ops import dispatch as ref_dispatch
from hdrf_tpu.ops.resident import ResidentReducer as RefReducer
from hdrf_tpu_torch.ops import dispatch
from hdrf_tpu_torch.ops.resident import ResidentReducer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are per-op bound on small tensors; one intra-op
    thread keeps them off the cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SMALL = RefCdc(mask_bits=10, min_chunk=256, max_chunk=4096)


def _pair(ref_cdc):
    cdc = dispatch.from_reference_cdc(dataclasses.asdict(ref_cdc))
    return (ResidentReducer(cdc, device="cpu"),
            RefReducer(ref_cdc, fused_mode="interpret"))


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gc, gd), (wc, wd) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gd, wd)
        assert gd.shape == (gc.size, 32)


def test_reduce_many_equal_size_group():
    rng = np.random.default_rng(1)
    datas = [rng.integers(0, 256, 1 << 17, dtype=np.uint8) for _ in range(3)]
    port, ref = _pair(SMALL)
    _assert_same(port.reduce_many(datas), ref.reduce_many(datas))


def test_reduce_many_mixed_empty_unaligned():
    """Mixed sizes, an empty block, a sub-grid block and a zero run — one
    port path for all of them."""
    rng = np.random.default_rng(2)
    dense = rng.integers(0, 256, 70_001, dtype=np.uint8)
    dense[10_000:50_000] = 0
    datas = [rng.integers(0, 256, 1 << 17, dtype=np.uint8),
             np.empty(0, np.uint8),
             rng.integers(97, 123, 100_001, dtype=np.uint8),
             rng.integers(0, 256, 777, dtype=np.uint8), dense]
    port, ref = _pair(SMALL)
    _assert_same(port.reduce_many(datas), ref.reduce_many(datas))


def test_reduce_default_geometry():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, 90_000, dtype=np.uint8)
    port, ref = _pair(RefCdc())
    _assert_same([port.reduce(a)], [ref.reduce(a)])


def test_device_resident_block_and_single_block_api():
    """submit/start_sha/finish on a block already on the device (a padded
    tensor with its true length) equals reduce of the host bytes."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, 60_000, dtype=np.uint8)
    port, _ = _pair(SMALL)
    padded = torch.zeros(60_416, dtype=torch.uint8)
    padded[:a.size] = torch.from_numpy(a)
    job = port.submit(padded, n=a.size)
    port.start_sha(job)
    _assert_same([port.finish(job)], [port.reduce(a.tobytes())])
    assert port.max_group(a.size) >= 1


def test_dispatch_equals_reference_native():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, 50_000, dtype=np.uint8)
    cdc = dispatch.from_reference_cdc(dataclasses.asdict(SMALL))
    wc, wd = ref_dispatch.chunk_and_fingerprint(a, SMALL, "native")
    gc, gd = dispatch.chunk_and_fingerprint(a, cdc, "cpu")
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gd, wd)
    cuts = dispatch.chunk_cuts(a, cdc, "cpu")
    np.testing.assert_array_equal(cuts, wc)
    np.testing.assert_array_equal(dispatch.fingerprints(a, cuts, "cpu"), wd)


def test_backend_and_device_resolution():
    assert dispatch.resolve_backend("auto") == "cuda"
    assert dispatch.resolve_backend("cpu") == "cpu"
    # the reference's name for its accelerator selects the card
    assert dispatch.resolve_backend("tpu") == "cuda"
    with pytest.raises(ValueError):
        dispatch.resolve_backend("xla")
    assert dispatch.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        # an entry point on the card raises without one: no CPU fallback
        with pytest.raises(RuntimeError):
            ResidentReducer(dispatch.from_reference_cdc(
                dataclasses.asdict(SMALL)))
        with pytest.raises(RuntimeError):
            dispatch.chunk_and_fingerprint(b"abc", dispatch.CdcConfig())

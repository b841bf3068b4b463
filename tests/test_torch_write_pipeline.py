"""The port's multi-block write pipeline (hdrf_tpu_torch/server/
write_pipeline.py) held against the reference's on the CPU: the lane-size
buckets, grouping, the ``pipeline_max_inflight`` bound, the weighted-fair
drain across tenants, and the coalescer's results against
``chunk_and_fingerprint`` — the port's ``cpu`` backend (the kernels'
plain versions) beside the reference's ``tpu`` backend on the JAX CPU
device, ``native`` on both.  Byte identity is the tolerance.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from _dn_standin import SMALL_CDC


def _port_cdc():
    from hdrf_tpu_torch.config import CdcConfig
    return CdcConfig(**SMALL_CDC)


def _ref_cdc():
    from hdrf_tpu.config import CdcConfig
    return CdcConfig(**SMALL_CDC)


def _arrays(seed: int, sizes) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, max(sizes), dtype=np.uint8)
    out = []
    for i, n in enumerate(sizes):
        a = base[:n].copy()
        a[: n // 3] = rng.integers(0, 256, n // 3, dtype=np.uint8)
        out.append(a)
    return out


def test_pad_bucket_matches_reference():
    from hdrf_tpu.server.write_pipeline import WritePipeline as Ref
    from hdrf_tpu_torch.server.write_pipeline import WritePipeline

    rng = np.random.default_rng(0)
    ns = [1, 4095, 4096, 4097, 65_535, 65_536, 65_537, (128 << 20) - 1,
          128 << 20, (128 << 20) + 1] + [int(v) for v in
                                         rng.integers(1, 1 << 28, 200)]
    for n in ns:
        assert WritePipeline._pad_bucket(n) == Ref._pad_bucket(n), n


class _FakeReducer:
    """Stands in for the device reducer: records groups, answers with the
    block's length as its one cut."""

    def __init__(self, gate: threading.Event | None = None, cap: int = 16):
        self.groups: list[list[int]] = []
        self.gate = gate
        self.cap = cap
        self.entered = threading.Event()   # a group is held at the gate

    def max_group(self, n: int = 0) -> int:
        return self.cap

    def submit_many(self, arrs):
        if self.gate is not None:
            self.entered.set()
            assert self.gate.wait(60)
        self.groups.append([a.size for a in arrs])
        return list(arrs)

    def start_sha_many(self, bj) -> None:
        pass

    def finish_many(self, bj):
        return [(np.array([a.size], np.uint64),
                 np.zeros((1, 32), np.uint8)) for a in bj]


def _install(wp, fake) -> None:
    """Make ``fake`` the coalescer's reducer: the loop resolves its
    reducer at the top of each round, so one warm-up block lets the
    round already waiting pass with the real one."""
    wp._reducer = lambda: fake
    gate, fake.gate = fake.gate, None
    wp.submit(-1, np.zeros(1, np.uint8)).result(timeout=60)
    fake.groups.clear()
    fake.gate = gate


def _pipelines(depth=4, max_inflight=8):
    """(port on cpu, reference on tpu) pipelines over the small geometry."""
    from hdrf_tpu.server.write_pipeline import WritePipeline as Ref
    from hdrf_tpu_torch.server.write_pipeline import WritePipeline

    return (WritePipeline(_port_cdc(), "cpu", depth=depth,
                          max_inflight=max_inflight),
            Ref(_ref_cdc(), "tpu", depth=depth, max_inflight=max_inflight))


def test_grouping_by_lane_bucket_matches_reference():
    """The coalescer groups one round's blocks by lane-size bucket, at
    most ``depth`` a group and the reducer's ``max_group`` — the same
    groups as the reference's, in the same order."""
    sizes = [5000, 5100, 70_000, 5050, 70_100, 200_000, 5001, 5002, 5003]
    groups = []
    for wp in _pipelines(depth=4, max_inflight=16):
        gate = threading.Event()
        fake = _FakeReducer(gate, cap=3)
        _install(wp, fake)
        futs = [wp.submit(i, np.zeros(n, np.uint8))
                for i, n in enumerate(sizes[:1])]
        assert fake.entered.wait(30)   # the coalescer holds the first group
        futs += [wp.submit(i, np.zeros(n, np.uint8))
                 for i, n in enumerate(sizes[1:], 1)]
        gate.set()
        res = [f.result(timeout=60) for f in futs]
        assert [int(r[0][0]) for r in res] == sizes
        wp.close()
        groups.append(fake.groups)
    assert groups[0] == groups[1]
    assert all(len(g) <= 3 for g in groups[0])
    assert len(groups[0]) < len(sizes)


def test_max_inflight_bounds_admission_like_reference():
    """With ``max_inflight`` 2 and the device held, a third submit waits
    for a permit in both packages; it is admitted once a block finishes."""
    for wp in _pipelines(depth=2, max_inflight=2):
        gate = threading.Event()
        fake = _FakeReducer(gate)
        _install(wp, fake)
        f1 = wp.submit(1, np.zeros(10, np.uint8))
        f2 = wp.submit(2, np.zeros(20, np.uint8))
        third: list = []
        t = threading.Thread(target=lambda: third.append(
            wp.submit(3, np.zeros(30, np.uint8))), daemon=True)
        t.start()
        time.sleep(0.3)
        assert not third, "the third submit passed the admission bound"
        gate.set()
        t.join(timeout=30)
        assert third and int(third[0].result(timeout=30)[0][0]) == 30
        assert [int(f.result(timeout=30)[0][0]) for f in (f1, f2)] == [10, 20]
        wp.close()


def test_weighted_fair_drain_matches_reference():
    """Queued blocks drain round-robin across tenants (a flooding
    tenant cannot starve a light one), in the reference's order."""
    from hdrf_tpu.server import write_pipeline as rwp
    from hdrf_tpu_torch.server import write_pipeline as pwp

    plan = [("flood", i) for i in range(6)] + [("light", 10), ("other", 20),
                                               ("light", 11)]
    orders = []
    for mod, wp in ((pwp, pwp.WritePipeline(_port_cdc(), "native", depth=3)),
                    (rwp, rwp.WritePipeline(_ref_cdc(), "native", depth=3))):
        for tenant, bid in plan:
            wp._q.put(mod._Item(bid, np.zeros(1, np.uint8), None, Future(),
                                tenant))
        wp._q.put(None)
        got, stop = [], False
        while not stop:
            items, stop = wp._drain(block=False)
            got.append([it.block_id for it in items])
        orders.append(got)
    assert orders[0] == orders[1]
    assert orders[0][0] == [0, 10, 20]


@pytest.mark.parametrize("backend,ref_backend", [("cpu", "tpu"),
                                                 ("native", "native")])
def test_results_equal_chunk_and_fingerprint(backend, ref_backend):
    """Blocks of mixed sizes through the pipeline (groups on the device
    backends, inline on ``native``) resolve to the cuts and digests of
    ``chunk_and_fingerprint``, and to the reference pipeline's."""
    from hdrf_tpu.ops import dispatch as rdispatch
    from hdrf_tpu.server.write_pipeline import WritePipeline as Ref
    from hdrf_tpu_torch.ops import dispatch
    from hdrf_tpu_torch.server.write_pipeline import WritePipeline
    from hdrf_tpu_torch.utils import metrics

    arrs = _arrays(5, [200_000, 200_000, 131_071, 4096, 1, 65_537])
    reg = metrics.registry("write_pipeline")
    b0 = reg.counter("device_batches")
    wp = WritePipeline(_port_cdc(), backend, depth=4)
    rp = Ref(_ref_cdc(), ref_backend, depth=4)
    try:
        futs = [wp.submit(i, a) for i, a in enumerate(arrs)]
        rfuts = [rp.submit(i, a) for i, a in enumerate(arrs)]
        for a, f, rf in zip(arrs, futs, rfuts):
            cuts, digs = f.result(timeout=300)
            want = dispatch.chunk_and_fingerprint(a, _port_cdc(), "native")
            ref = rf.result(timeout=300)
            ref_nat = rdispatch.chunk_and_fingerprint(a, _ref_cdc(), "native")
            for got in (want, ref, ref_nat):
                assert np.array_equal(np.asarray(cuts, np.int64),
                                      np.asarray(got[0], np.int64))
                assert np.array_equal(np.asarray(digs), np.asarray(got[1]))
    finally:
        wp.close()
        rp.close()
    if backend == "cpu":
        assert wp.mesh_reducer is None        # one device: no mesh plane
        assert reg.counter("device_batches") > b0
    else:
        assert wp._thread is None


def test_reducer_is_the_dispatch_cache_entry():
    """The coalescer's reducer is ops/dispatch's cached ResidentReducer
    for (geometry, device): one per configuration process-wide."""
    from hdrf_tpu_torch.ops import dispatch
    from hdrf_tpu_torch.server.write_pipeline import WritePipeline

    wp = WritePipeline(_port_cdc(), "cpu", depth=2)
    try:
        r = wp._reducer()
        assert r is wp._reducer()
        key = (SMALL_CDC["mask_bits"], SMALL_CDC["min_chunk"],
               SMALL_CDC["max_chunk"], r.device)
        assert dispatch._resident_cache[key] is r
        assert r.device.type == "cpu"
    finally:
        wp.close()


def test_qos_sheds_before_a_permit_is_held():
    """An installed AdmissionController sheds an over-rate tenant in
    ``submit`` before any permit is taken; unattributed submits pass."""
    from hdrf_tpu_torch.server.write_pipeline import WritePipeline
    from hdrf_tpu_torch.utils import qos

    ctl = qos.AdmissionController(rate_mb_s=0.001, burst_mb=0.001)
    wp = WritePipeline(_port_cdc(), "native", depth=2, max_inflight=1,
                       qos_ctrl=ctl)
    a = np.zeros(4096, np.uint8)
    wp.submit(1, a, tenant="t").result(timeout=30)
    ctl.charge("t", "write", 1 << 20)
    with pytest.raises(qos.ShedError):
        wp.submit(2, a, tenant="t")
    # the shed held no permit: max_inflight 1 still admits
    assert wp.submit(3, a).result(timeout=30)[0][-1] == 4096

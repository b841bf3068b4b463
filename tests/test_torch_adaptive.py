"""Adaptive chunk sizing on the port, held against the reference on the
CPU: ``AdaptiveChunkController`` (reduction/accounting.py) decision for
decision over seeded hit/miss streams, the CDC select's telemetry lanes
``H_SURV`` / ``H_CANDS`` (ops/cdc_cuda.py's plain version) against the
reference's fused Pallas kernel run in interpret mode, the DataNode's
live reconfiguration replies, and the retune loop end to end on the
port's MiniCluster (the regression guard's rollback included, as
tests/test_adaptive_cdc.py drives the reference).  Exact equality
throughout; clocks are the flight ring's injected samples, never
timings.
"""

import time

import numpy as np
import pytest

from _dn_standin import StandInNN, op_reply, port_dn, ref_dn


def _controllers(**kw):
    from hdrf_tpu.reduction.accounting import AdaptiveChunkController as R
    from hdrf_tpu_torch.reduction.accounting import \
        AdaptiveChunkController as P
    return P(**kw), R(**kw)


# ------------------------------------------------------- controller decisions

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_controller_decisions_equal_reference(seed):
    """The same cumulative (hit, miss) stream — rich, poor and mid-band
    windows, partial windows, counter resets and guard holds — yields
    the same steps, in the same order, from both controllers."""
    rng = np.random.default_rng(seed)
    target = int(rng.integers(8, 17))
    port, ref = _controllers(target_mask_bits=target, min_size=512,
                             window_chunks=int(rng.integers(16, 200)))
    hit = miss = 0
    mb = target
    for step in range(400):
        r = rng.random()
        if r < 0.03:
            hit, miss = 0, 0                       # a restart
        else:
            n = int(rng.integers(0, 120))
            p_hit = rng.choice([0.0, 0.02, 0.2, 0.6, 0.9])
            h = int(rng.binomial(n, p_hit))
            hit, miss = hit + h, miss + n - h
        if rng.random() < 0.02:
            hold = int(rng.integers(1, 4))
            port.note_rollback(hold)
            ref.note_rollback(hold)
        got, want = port.observe(hit, miss, mb), ref.observe(hit, miss, mb)
        assert got == want, step
        if got:
            mb = got[-1][1]
    assert port.emit_range() == ref.emit_range()
    for old in range(port.MASK_BITS_MIN, port.MASK_BITS_MAX + 1):
        for new in range(port.MASK_BITS_MIN, port.MASK_BITS_MAX + 1):
            assert port.steps(old, new) == ref.steps(old, new)


def test_controller_constants_equal_reference():
    port, ref = _controllers()
    for name in ("MASK_BITS_MIN", "MASK_BITS_MAX", "LOW_HIT", "HIGH_HIT"):
        assert getattr(port, name) == getattr(ref, name)
    assert (port.target, port.min_size, port.window_chunks) == \
        (ref.target, ref.min_size, ref.window_chunks)


# -------------------------------------------------- the select's header lanes

GEOMETRIES = [(8, 512, 2048, 65_536 + 300), (11, 512, 16_384, 131_072),
              (13, 2048, 65_536, 200_000), (16, 16_384, 524_288, 262_144)]


@pytest.mark.parametrize("mb,mn,mx,size", GEOMETRIES,
                         ids=[f"mb{g[0]}" for g in GEOMETRIES])
def test_header_lanes_equal_reference_fused_kernel(mb, mn, mx, size):
    """``H_SURV`` and ``H_CANDS`` of the port's plain select equal the
    reference fused kernel's (interpret mode, skip-ahead: the variant
    the port has), on a random block and a low-entropy one, with the
    cuts and the other header lanes."""
    import jax

    from hdrf_tpu import native
    from hdrf_tpu.config import CdcConfig as RefCdc
    from hdrf_tpu.ops import cdc_pallas
    from hdrf_tpu.ops.dispatch import gear_mask as ref_mask
    from hdrf_tpu_torch.config import CdcConfig
    from hdrf_tpu_torch.ops import cdc_cuda
    from hdrf_tpu_torch.ops.dispatch import gear_mask

    mask = gear_mask(CdcConfig(mask_bits=mb, min_chunk=mn, max_chunk=mx))
    assert mask == ref_mask(RefCdc(mask_bits=mb, min_chunk=mn,
                                   max_chunk=mx))
    rng = np.random.default_rng(mb)
    text = rng.integers(97, 101, size, dtype=np.uint8)
    for a in (rng.integers(0, 256, size, dtype=np.uint8), text):
        p = cdc_pallas.plan_for(a.size, mask, mb, mn, mx, b_small=1 << 30,
                                b_big=1 << 30, skip_ahead=True)
        buf = np.zeros(p.n_pad, dtype=np.uint8)
        buf[:a.size] = a
        _, table, _, _ = cdc_pallas.fused_block(
            jax.device_put(buf.view(np.uint32).reshape(-1, 128)), p, True)
        want = np.asarray(table)[0]
        block, n = cdc_cuda.padded_block(a, "cpu")
        _, got, _, _ = cdc_cuda.cdc_block(block, n, mask, mn, mx, 1 << 30)
        got = got.numpy()
        assert got[cdc_cuda.H_SURV] == want[cdc_pallas.H_SURV]
        assert got[cdc_cuda.H_CANDS] == want[cdc_pallas.H_CANDS]
        assert not want[cdc_pallas.H_OVERFLOW]
        nc = int(want[cdc_pallas.H_COUNT])
        assert got[:4].tolist() == want[:4].tolist()
        np.testing.assert_array_equal(got[8:8 + nc], want[8:8 + nc])
        np.testing.assert_array_equal(
            got[8:8 + nc].astype(np.uint64),
            np.asarray(native.cdc_chunk(a.tobytes(), mask, mn, mx),
                       dtype=np.uint64))


def test_reducer_records_scan_summary():
    """``ResidentReducer`` feeds the header lanes to
    ``accounting.record_scan_summary`` once a header lands, as the
    reference's ``_start_sha_fused`` does: the counters grow by the
    plain select's lanes of every block."""
    from hdrf_tpu_torch.config import CdcConfig
    from hdrf_tpu_torch.ops import cdc_cuda
    from hdrf_tpu_torch.ops.dispatch import gear_mask
    from hdrf_tpu_torch.ops.resident import ResidentReducer
    from hdrf_tpu_torch.reduction import accounting

    cdc = CdcConfig(mask_bits=10, min_chunk=256, max_chunk=4096)
    rng = np.random.default_rng(9)
    blocks = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
              for s in (40_000, 70_001)]
    want_s = want_c = 0
    for b in blocks:
        block, n = cdc_cuda.padded_block(b, "cpu")
        _, bm = cdc_cuda.cdc_scan(block, n, gear_mask(cdc), cdc.min_chunk)
        s, c = cdc_cuda.scan_telemetry_plain(bm)
        want_s, want_c = want_s + s, want_c + c
    c0 = accounting.snapshot()["counters"]
    ResidentReducer(cdc, device="cpu").reduce_many(blocks)
    c1 = accounting.snapshot()["counters"]
    assert want_c > 0
    assert c1["cdc_scan_slab_survivors"] - \
        c0.get("cdc_scan_slab_survivors", 0) == want_s
    assert c1["cdc_scan_candidates"] - c0.get("cdc_scan_candidates", 0) \
        == want_c


# ------------------------------------------------- live-reconfig validation

RECONFIGURE_CALLS = [
    [("cdc_mask_bits", 25), ("cdc_mask_bits", 5), ("cdc_mask_bits", 20),
     ("cdc_mask_bits", "junk"), ("cdc_mask_bits", None)],
    [("cdc_min_chunk", 1 << 20), ("cdc_min_chunk", 31),
     ("cdc_max_chunk", 63), ("cdc_max_chunk", 1 << 25),
     ("cdc_max_chunk", 1 << 17), ("cdc_min_chunk", 1 << 17),
     ("cdc_max_chunk", 4096)],
    [("scan_interval_s", 0), ("scan_interval_s", 2.5),
     ("volume_check_interval_s", -1), ("scrub_interval_s", 1.0),
     ("block_report_interval_s", 30), ("cache_capacity", "12"),
     ("balancer_bandwidth", 1 << 20), ("heartbeat_interval_s", 1),
     ("", None)],
]


@pytest.mark.parametrize("calls", RECONFIGURE_CALLS,
                         ids=["mask_bits", "min_max", "intervals"])
def test_reconfigure_replies_equal_reference(tmp_path, calls):
    """Bounds, casts, the min <= max ordering rule, the loop guards and
    the whitelist answer alike, over the wire; the shared CdcConfig ends
    in the same geometry."""
    nn = StandInNN()
    got = {}
    try:
        for pkg, make in (("port", port_dn), ("ref", ref_dn)):
            dn = make(str(tmp_path / pkg), nn.addr, f"dn-{pkg}",
                      red={"cdc_adaptive": True},
                      dn={"scan_interval_s": 60.0})
            try:
                out = [op_reply(dn.addr, "get_reconfigurable")]
                out += [op_reply(dn.addr, "reconfigure", key=k, value=v)
                        for k, v in calls]
                cdc = dn.reduction_ctx.config.cdc
                out.append((cdc.mask_bits, cdc.min_chunk, cdc.max_chunk,
                            dn.config.scan_interval_s,
                            dn.config.cache_capacity))
                got[pkg] = out
            finally:
                dn.stop()
    finally:
        nn.stop()
    assert got["port"] == got["ref"]


# --------------------------------------------------------- end-to-end loop

def _flight(dn, values: list[float], t0: int) -> None:
    dn.flight._ring.extend({"t": float(t0 + i), "mono": float(t0 + i),
                            "write_p95_ms": v} for i, v in enumerate(values))


@pytest.mark.parametrize("post", [30.0, 10.0], ids=["regress", "healthy"])
def test_retune_guard_equal_reference(post):
    """The guard end to end on both packages' MiniClusters: a retune
    lands through ``reconfigure``, the flight ring gets a healthy
    baseline and an injected post-retune window; a regressing window
    rolls the geometry back (``retune_rollbacks`` + 1, the controller
    held), a healthy one keeps it.  Both packages reach the same
    geometry, counters delta and hold."""
    from hdrf_tpu.reduction import accounting as ref_acc
    from hdrf_tpu.testing.minicluster import MiniCluster as RefMC
    from hdrf_tpu_torch.reduction import accounting as port_acc
    from hdrf_tpu_torch.testing.minicluster import MiniCluster as PortMC

    overrides = {"cdc_adaptive": True, "cdc_target_mask_bits": 13}
    out = {}
    for pkg, mc_cls, acc in (("port", PortMC, port_acc),
                             ("ref", RefMC, ref_acc)):
        with mc_cls(n_datanodes=1, replication=1,
                    reduction_overrides=overrides) as mc:
            dn = mc.datanodes[0]
            ctl = dn._cdc_controller
            dn._cdc_controller = None        # park the heartbeat tick
            cdc = dn.reduction_ctx.config.cdc
            mb0 = cdc.mask_bits
            applied = [dn.reconfigure(k, v)
                       for k, v in ctl.steps(mb0, mb0 + 1)]
            dn.flight._ring.clear()
            _flight(dn, [10.0] * 4, 0)
            dn._arm_cdc_guard(mb0, mb0 + 1)
            _flight(dn, [post] * dn.GUARD_MIN_SAMPLES, 10)
            before = int(acc.snapshot()["counters"]
                         .get("retune_rollbacks", 0))
            dn._cdc_guard_tick(ctl)
            out[pkg] = (applied, dn._cdc_guard,
                        (cdc.mask_bits, cdc.min_chunk, cdc.max_chunk),
                        int(acc.snapshot()["counters"]
                            .get("retune_rollbacks", 0)) - before,
                        ctl._hold_windows)
    assert out["port"] == out["ref"]
    assert out["port"][3] == (1 if post > 10 else 0)


def test_adaptive_retune_end_to_end_and_old_reads_survive():
    """A dedup-poor corpus drives the port DataNode's controller one bit
    coarser through ``reconfigure`` (three steps, ``cdc_retunes`` + 3);
    blocks written before and after the retune read back equal."""
    from hdrf_tpu_torch.reduction import accounting
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    overrides = {"cdc_adaptive": True, "cdc_target_mask_bits": 13}
    with MiniCluster(n_datanodes=1, replication=1,
                     reduction_overrides=overrides) as mc:
        dn = mc.datanodes[0]
        ctl = dn._cdc_controller
        dn._cdc_controller = None
        ctl.observe(*accounting.dedup_counters(), 13)   # absorb baseline
        ctl._win_hit = ctl._win_miss = 0
        ctl.window_chunks = 64
        cdc = dn.reduction_ctx.config.cdc
        mb0 = cdc.mask_bits
        rng = np.random.default_rng(42)
        old = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
        _, miss0 = accounting.dedup_counters()
        r0 = int(accounting.snapshot()["counters"].get("cdc_retunes", 0))
        with mc.client("adaptive", device="cpu") as c:
            c.write("/adaptive/old", old, scheme="dedup_lz4")
            deadline = time.monotonic() + 10
            while (accounting.dedup_counters()[1] - miss0 < 64
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            dn._cdc_controller = ctl
            dn._cdc_tick()
            dn._cdc_controller = None
            assert cdc.mask_bits == mb0 + 1
            assert (cdc.min_chunk, cdc.max_chunk) == ctl.geometry(mb0 + 1)
            assert int(accounting.snapshot()["counters"]["cdc_retunes"]) \
                == r0 + 3
            new = rng.integers(0, 256, 1 << 19, dtype=np.uint8).tobytes()
            c.write("/adaptive/new", new, scheme="dedup_lz4")
            assert c.read("/adaptive/old") == old
            assert c.read("/adaptive/new") == new


def test_retune_reaches_the_worker():
    """With a co-located worker, the next ``reduce`` after a retune cuts
    at the new geometry (the request carries it): chunks of the block
    written after a coarsening pass the old ``max_chunk``, and every
    block reads back equal."""
    from hdrf_tpu_torch.config import CdcConfig
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    small = CdcConfig(mask_bits=10, min_chunk=256, max_chunk=4096)
    overrides = {"cdc": small, "cdc_adaptive": True,
                 "cdc_target_mask_bits": 10, "cdc_min_size": 256}
    with MiniCluster(n_datanodes=1, replication=1, tpu_worker=True,
                     worker_backend="cpu",
                     reduction_overrides=overrides) as mc:
        dn = mc.datanodes[0]
        dn._cdc_controller = None
        rng = np.random.default_rng(3)
        blocks = [rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
                  for _ in range(2)]

        def longest(path_block):
            e = dn.index.get_block(path_block)
            return max(dn.index.chunk_location(h).length for h in e.hashes)

        with mc.client("w", device="cpu") as c:
            c.write("/w/a", blocks[0], scheme="dedup_lz4")
            bid_a = c._call("get_block_locations",
                            path="/w/a")["blocks"][0]["block_id"]
            assert longest(bid_a) <= 4096
            for k, v in (("cdc_max_chunk", 65536), ("cdc_min_chunk", 2048),
                         ("cdc_mask_bits", 13)):
                assert dn.reconfigure(k, v)["ok"]
            c.write("/w/b", blocks[1], scheme="dedup_lz4")
            bid_b = c._call("get_block_locations",
                            path="/w/b")["blocks"][0]["block_id"]
            assert longest(bid_b) > 4096
            assert c.read("/w/a") == blocks[0]
            assert c.read("/w/b") == blocks[1]

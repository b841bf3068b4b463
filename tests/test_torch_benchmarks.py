"""The port's device harnesses (hdrf_tpu_torch/benchmarks.py: reduction,
cdc, sort, ec, ec --repair-ab, recon, multichip) against the reference's
(hdrf_tpu/benchmarks.py) on the CPU.

Each case runs the argv of the reference's own test
(tests/test_benchmarks.py, tests/test_observability.py) through both
packages' ``main``, the port's on ``--device cpu`` (``--backend cpu``):
the same number of lines, the same keys recursively, equal deterministic
fields, and the reference test's assertions on the port's line.  The
reference's ``multichip`` does not run here, so the port's runs alone on
an 8-shard ``["cpu"]`` mesh and meets every assertion of the reference's
test.  The cluster harnesses are in tests/test_torch_benchmarks_cluster.py.
"""

import pytest

from _bench_twin import port_only, twin

CPU = ["--device", "cpu"]


def test_reduction_chunks_equal():
    ref, port = twin(["reduction", "--mb", "4", "--backend", "native"])
    (r,), (p,) = ref, port
    # the plain versions on the CPU give the native library's chunks
    (c,) = port_only(["reduction", "--mb", "4", "--backend", "cpu"])
    assert c["op"] == "reduction pipeline [cpu]"
    assert c["chunks"] == p["chunks"] == r["chunks"] > 0
    assert c["ledger"]["dispatch_total"] > 0
    assert set(c["ledger"]) == set(r["ledger"])


def test_cdc_cuts_and_lanes_equal():
    (r,), (p,) = twin(["cdc", "--mb", "1", "--inner", "2", "--repeats", "1"],
                      CPU)
    assert p["op"].startswith("cdc_prep")
    for key in ("cuts_verified", "scan_slab_survivors", "scan_candidates",
                "mb", "mask_bits", "min_size", "skip_ahead", "overflowed"):
        assert p[key] == r[key], key
    assert p["cuts_verified"] is True and p["scan_candidates"] > 0
    assert p["interpret"] is True and p["backend"] == "cpu"
    assert p["fused_ms_per_block"] > 0 and p["xla_ms_per_block"] > 0
    # the reference's second variant has no counterpart in the port
    assert p["fused_noskip_ms_per_block"] is None
    assert p["skip_ahead_speedup"] is None
    assert set(p["micro_profile_ms"]) == {"gear", "scan", "image", "pad"}
    assert p["serial_awaited_boundaries"] == {"xla": 2, "fused": 2}


def test_cdc_no_skip_ahead_reads_no_lanes():
    (r,), (p,) = twin(["cdc", "--mb", "1", "--inner", "2", "--repeats", "1",
                       "--no-skip-ahead"], CPU)
    assert p["scan_slab_survivors"] == r["scan_slab_survivors"] == 0
    assert p["scan_candidates"] == r["scan_candidates"] == 0
    assert p["cuts_verified"] is r["cuts_verified"] is True


def test_sort_record_readback_equal():
    ref, port = twin(["sort", "--tiles", "1", "--entries", "2048",
                      "--inner", "2", "--repeats", "1"], CPU)
    ops = {o["op"] for o in port}
    # the CPU runs only the plain leg; the readback ledger always prints
    assert "match_deltas [plain]" in ops and "sort_rows [plain]" in ops
    (lr,) = [o for o in ref if o["op"] == "record readback"]
    (lp,) = [o for o in port if o["op"] == "record readback"]
    assert lp == lr
    assert lp["reduction_pct"] >= 25.0


def test_sort_interpret_runs_the_cuda_leg_plain():
    port = port_only(["sort", "--tiles", "1", "--entries", "2048",
                      "--inner", "2", "--repeats", "1", "--interpret",
                      *CPU])
    assert [o["op"] for o in port] == [
        "match_deltas [plain]", "match_deltas [cuda/interp]",
        "sort_rows [plain]", "sort_rows [cuda/interp]", "record readback"]


@pytest.mark.parametrize("argv,k,m", [
    (["ec", "--mb", "3", "--policy", "rs-3-2-4k", "--inner", "2"], 3, 2),
    (["ec", "--mb", "2", "--inner", "2"], 6, 3),
], ids=["rs-3-2", "rs-6-3"])
def test_ec_parity_pinned_equal(argv, k, m):
    (r,), (p,) = twin(argv, CPU)
    for key in ("k", "m", "parity_oracle_ok", "storage_ratio", "mb",
                "inner"):
        assert p[key] == r[key], key
    assert p["parity_oracle_ok"] is True
    assert (p["k"], p["m"]) == (k, m) and p["backend"] == "cpu"
    assert p["encode_MBps"] > 0 and p["degraded_read_MBps"] > 0
    assert p["intact_read_MBps"] > 0


def test_ec_repair_ab_wire_ratios_equal():
    (r,), (p,) = twin(["ec", "--repair-ab", "--mb", "2", "--policy",
                       "rs-3-2-4k", "--inner", "2", "--dns", "4"], CPU)
    for key in ("patterns_pinned", "repair_wire_ratio_full",
                "repair_wire_ratio_coded", "repair_wire_ratio_coded_lz4",
                "wire_saved_frac", "parity_oracle_ok", "erasures"):
        assert p[key] == r[key], key
    assert p["op"].startswith("ec repair A/B")
    assert p["parity_oracle_ok"] is True and p["patterns_pinned"] == 15
    assert p["repair_wire_ratio_coded"] < p["repair_wire_ratio_full"]
    assert abs(p["repair_wire_ratio_full"] - p["k"]) < 1e-6


def test_recon_host_and_device_legs():
    ref, port = twin(["recon", "--mb", "8", "--repeats", "1"], CPU)
    # no card: the gather kernel's line prints on the card only, as the
    # reference's prints on an accelerator only
    assert [o["op"] for o in port] == [
        "reconstruction [host]", "reconstruction [device]"]
    assert all(o["MBps"] > 0 for o in port)


def test_multichip_on_an_eight_shard_cpu_mesh():
    """The reference test's assertions (tests/test_benchmarks.py:107-123)
    on the port's line: an 8-shard mesh of the CPU repeated."""
    out = port_only(["multichip", "--blocks", "16", "--repeats", "1", *CPU])
    assert len(out) == 1
    (o,) = out
    assert o["op"].startswith("multichip")
    assert o["oracle_ok"] is True
    assert o["one_dispatch_per_step"] is True
    assert set(o["MBps"]) == {"1", "2", "4", "8"}
    assert all(v > 0 for v in o["MBps"].values())
    assert o["ratio_8v1"] > 0
    assert o["steps"] == o["step_dispatches"]
    assert o["backend"] == "cpu" and o["devices"] == 8

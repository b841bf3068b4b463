"""The port's cluster harnesses (hdrf_tpu_torch/benchmarks.py: nn and its
``--observer-ab`` / ``--kill-active`` modes, dfs and ``--pipeline-ab``,
churn) against the reference's on the CPU: the argv of the reference's
tests (tests/test_benchmarks.py, tests/test_tools.py) through both
packages' ``main`` — the same number of lines, the same keys recursively,
equal deterministic fields, and the reference test's assertions on the
port's line.  The port's MiniCluster runs its DataNodes' schemes on
``--device cpu``; ``dfs --pipeline-ab`` keeps the reference's default
DataNode backend (``native``) on both sides: the plain SHA-256 at the
default geometry takes ~100 s for its six 1 MiB blocks here.
"""

from _bench_twin import twin

CPU = ["--device", "cpu"]


def test_nn_metadata_storm():
    (r,), (p,) = twin(["nn", "--ops", "60", "--clients", "3",
                       "--meta-per-op", "2"])
    assert p["bench"] == r["bench"] == "nn_metadata_storm"
    for key in ("clients", "data_ops", "meta_per_op", "errors"):
        assert p[key] == r[key], key
    assert p["clients"] == 3 and p["errors"] == 0
    assert p["ops_per_s"] > 0 and p["rpc_calls"] > 0
    assert p["rpc_p99_ms"] > 0
    assert 0.0 <= p["lock_saturation"] <= 1.0
    assert p["lock_wait_p99_us"] >= 0.0
    assert p["top_method"] in p["lock_share"]
    assert all(0.0 <= v <= 1.0 for v in p["lock_share"].values())
    assert p["attributed_frac"] >= 0.95


def test_nn_observer_ab():
    (r,), (p,) = twin(["nn", "--observer-ab", "--ops", "40", "--clients",
                       "2", "--meta-per-op", "2", "--rounds", "1"])
    assert p["bench"] == "nn_observer_ab"
    for key in ("rounds", "clients", "data_ops", "observers", "errors"):
        assert p[key] == r[key], key
    assert p["errors"] == 0 and p["observer_reads"] > 0
    assert p["b"]["active_read_lock_share"] \
        <= p["a"]["active_read_lock_share"]


def test_nn_kill_active():
    (r,), (p,) = twin(["nn", "--kill-active", "--duration", "3",
                       "--clients", "2"], CPU)
    assert p["bench"] == "nn_kill_active"
    assert p["stale_beyond_bound"] == r["stale_beyond_bound"] == 0
    assert p["reads"] > 0 and p["failover_s"] is not None


def test_dfs_throughput():
    ref, port = twin(["dfs", "--mb", "2", "--datanodes", "2",
                      "--replication", "1", "--schemes", "direct,dedup_lz4"],
                     CPU)
    assert [o["scheme"] for o in port] == [o["scheme"] for o in ref]
    assert all(o["write_MBps"] > 0 for o in port)
    direct, dedup = port
    # the dedup write ran the DataNode's scheme through the port's
    # device funnel (plain versions on the CPU); the direct one did not
    assert direct["ledger"]["dispatch_total"] == 0
    assert dedup["ledger"]["dispatch_total"] > 0


def test_dfs_pipeline_ab():
    (r,), (p,) = twin(["dfs", "--pipeline-ab", "--mb", "1", "--streams",
                       "2", "--rounds", "1", "--depth", "4"])
    assert p["op"].startswith("dfs write pipeline A/B")
    for key in ("backend", "streams", "depth", "rounds", "mb_per_stream"):
        assert p[key] == r[key], key
    assert p["depth1_MBps"] > 0 and p["depthN_MBps"] > 0
    assert p["speedup"] > 0


def test_churn_curves_and_verdict_equal():
    (r,), (p,) = twin(["churn", "--rounds", "3", "--files", "3", "--kb",
                       "8", "--delete-frac", "0.5"], CPU)
    for key in ("rounds", "samples", "verdict"):
        assert p[key] == r[key], key
    assert p["rounds"] == 3 and p["samples"] == 3
    for name in ("storage_ratio", "garbage_bytes",
                 "chunk_cache_hit_ratio", "read_p95_ms"):
        assert len(p["curves"][name]["series"]) == 3
    sr = p["curves"]["storage_ratio"]
    assert sr["last"] > sr["first"]  # deletes inflate the ratio
    assert "storage_ratio" in p["regressions"]
    assert p["verdict"] == "REGRESSED"

"""In-tree performance harnesses of the port (port of
hdrf_tpu/benchmarks.py: ``bench_nn`` benchmarks.py:289, its modes
``_nn_observer_ab`` :41 and ``_nn_kill_active`` :202, ``bench_dfs`` :456
and ``_dfs_pipeline_ab`` :388, ``bench_ec`` :620 and
``bench_ec_repair_ab`` :489, ``bench_reduction`` :688, ``bench_recon``
:711, ``bench_sort`` :844, ``bench_cdc`` :936, ``bench_multichip``
:1123, ``bench_churn`` :1240, ``main`` :1324).

The same nine harnesses with the reference's argparse surface, so the
same argv runs both packages; each prints the reference's lines (one JSON
object per metric, exactly one line where the reference's docstring says
so) with the reference's keys:

- ``nn``   — metadata storm against a started NameNode over wire clients
             (NNThroughputBenchmark.java:97); ``--observer-ab``,
             ``--kill-active``.
- ``dfs``  — DFS write/read MB/s through a MiniCluster per reduction
             scheme (BenchmarkThroughput.java); ``--pipeline-ab``.
- ``ec``   — RS encode / intact / degraded rates over the stripe store
             (ErasureCodeBenchmarkThroughput.java); ``--repair-ab``.
- ``reduction`` — the block-reduction funnel, selectable backend.
- ``cdc``, ``sort``, ``recon``, ``multichip`` — the device front end's
             kernels against their plain versions.
- ``churn`` — the delete/rewrite lifecycle's flight-sampled curves.

Run: ``python -m hdrf_tpu_torch.benchmarks <which> [options]``.

**Devices.**  A line's ``backend`` names the device that ran: ``cuda`` or
``cpu``.  ``reduction`` and ``dfs --pipeline-ab`` take the reference's
``--backend`` (``auto`` and ``tpu`` are the card, ops/dispatch.py:59-66;
``native`` the host library); every other harness that touches a device
takes ``--device`` (default ``cuda``), and ``--device cpu`` sends all it
touches to the plain versions, the MiniCluster's DataNodes
(``backend="cpu"``) and clients included.  Nothing falls back: on
``cuda`` a kernel that fails to build or launch raises.  ``--interpret``
(``cdc``, ``sort``) runs the plain versions in place of the kernels on
either device; a line's ``interpret`` (or ``/interp`` tag) is true
exactly when they ran.

**Timing.**  One method for every timed leg (``_per_call``): after one
warm call, ``--repeats`` passes of ``--inner`` back-to-back calls, each
pass ending in ``torch.cuda.synchronize()`` (the reference's dependent
readback); the time a call is the fastest pass over ``--inner``.  It
keeps ``1/k`` of a pass's fixed cost (one synchronisation), which the
reference's slope method, ``(T(k) - T(1)) / (k - 1)``, divides out;
but a difference of two timings goes to zero or below when the host
stalls the short pass (other processes on its cores), and a printed
time is never that: the fastest pass is positive for any leg that ran.  The
reference salts each iteration's input so XLA cannot merge them; eager
launches are never merged, so the port calls each kernel on the same
input.

**Keys the port reports as ``null``**, and why:

- ``cdc`` ``fused_noskip_ms_per_block`` and ``skip_ahead_speedup``: the
  reference times two Pallas variants (the skip-ahead select and the
  plain frontier walk); the port has one select for both (ops/cdc_cuda.py:60-61), so
  there is no second leg and no ratio.

What other keys mean on the port:

- ``cdc``: "fused" is ``cdc_cuda.cdc_block`` (the scan and the select),
  "gear" ``cdc_scan`` alone (so "scan" in ``micro_profile_ms`` is the
  select), "image" ``be_image``, "pad" ``gather_cuda.gather_pad_messages``
  over 1,024 lanes, "xla" the plain PyTorch scan on the same device (the
  reference's XLA prep: words and candidates).  ``scan_slab_survivors`` /
  ``scan_candidates`` are the select's ``H_SURV`` / ``H_CANDS`` lanes
  (the reference reads them from its skip-ahead variant only, so
  ``--no-skip-ahead`` reports 0 on both, as there).
  ``cut_table_d2h_bytes_per_block_fused`` is the port's table
  (``TABLE_HDR + cap_for``, ops/cdc_cuda.py:120) in int32 words;
  ``cand_d2h_bytes_per_block_xla`` the plain pipeline's readback of the
  candidate positions (int64 each) for the host select.
  ``serial_awaited_boundaries`` counts what each shape waits for before
  the digests are on the host: the plain pipeline its candidates and its
  results, the port's fused path its 32-byte table header (the lane
  counts size the gather and SHA launches, ops/resident.py) and its
  results — 2 each, where the reference's fused kernel enqueued SHA
  against fixed-capacity lanes and waited once.
- ``sort``: the legs are ``plain`` and ``cuda``, ``sort_cuda.match_deltas
  [_plain]`` and ``sort_rows[_plain]`` (the reference's ``xla`` and
  ``pallas``); the ``cuda`` leg runs on the card, or with
  ``--interpret`` as ``cuda/interp`` through the plain versions.  The
  record-readback line is ``lz4_device._packed_len``, deterministic.
- ``recon``: the host and device legs through the port's ``DedupScheme``
  and ``DeviceReconstructor``; on the card a third line times
  ``gather_pad_messages`` over the reconstructor's resident images in
  the read's (container, bucket) groups, ``INNER`` passes a timed pass.
  The images are the int32 big-endian words the kernel takes: no adapter.
- ``multichip``: the widths 1/2/4/8 are meshes ``('data'=d, 'seq'=1)``
  over one device repeated (sharded.make_mesh with ``[dev] * d``), the
  counterpart of the reference's virtual CPU devices.  On one card the
  shards' steps share the card, so the curve measures how a step's fixed
  cost amortizes over more blocks, not scaling over chips.
  ``one_dispatch_per_step`` reads the port's device ledger.
- ``dfs``, ``churn``, ``nn --kill-active``: the port's MiniCluster, whose
  DataNodes run their schemes on ``--device``, and the port's client.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _device(args):
    """The harness's ``torch.device`` (the card must exist for cuda)."""
    from hdrf_tpu_torch.ops.dispatch import resolve_device

    return resolve_device(args.device)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _per_call(fn, dev, inner: int, repeats: int) -> float:
    """Seconds per call of ``fn`` (module docstring, "Timing"): after one
    warm call, the fastest of ``repeats`` passes of ``inner`` calls, each
    pass ending in a device synchronisation, over ``inner``.  The fastest
    pass is the one the host stalled least."""
    inner, repeats = max(inner, 1), max(repeats, 1)
    fn()                                       # warm: build + page in
    _sync(dev)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best / inner


def _nn_observer_ab(args) -> None:
    """Paired observer A/B: the same metadata storm run twice a round —
    leg A against a lone active, leg B with ``--observers`` observer NNs
    tailing it and the HA proxy routing reads observer-first (one msync a
    data op buys read-your-writes).  Medians over ``--rounds`` rounds.
    Prints ONE JSON line: per-leg read p99 + the ACTIVE's lock share of
    the read methods, plus observer_reads / observer_share / msync_p99_ms
    / observer_lag_txids."""
    import dataclasses
    import tempfile
    import threading

    from hdrf_tpu_torch.config import NameNodeConfig
    from hdrf_tpu_torch.proto.rpc import HaRpcClient
    from hdrf_tpu_torch.server.namenode import NameNode
    from hdrf_tpu_torch.utils import metrics, retry

    read_methods = ("stat", "get_block_locations", "listing")

    def _counter(reg: str, key: str) -> int:
        return metrics.registry(reg).snapshot()["counters"].get(key, 0)

    def leg(observer: bool) -> dict:
        clients = max(1, args.clients)
        per = max(1, args.ops // clients)
        meta = max(0, args.meta_per_op)
        obs_reads0 = _counter("client.ha", "observer_reads")
        bounces0 = _counter("client.ha", "observer_bounces")
        with tempfile.TemporaryDirectory() as d:
            cfg = NameNodeConfig(
                meta_dir=d, replication=1, heartbeat_interval_s=30.0,
                dead_node_interval_s=600.0, tail_interval_s=0.02)
            nn = NameNode(cfg).start()
            obs = []
            try:
                nn.rpc_register_datanode("dn-bench", ["127.0.0.1", 1])
                if observer:
                    for _k in range(max(1, args.observers)):
                        ob = NameNode(dataclasses.replace(
                            cfg, role="observer", port=0)).start()
                        ob.rpc_register_datanode("dn-bench",
                                                 ["127.0.0.1", 1])
                        obs.append(ob)
                addrs = [nn.addr] + [o.addr for o in obs]
                read_ms = [[] for _ in range(clients)]
                msync_ms = [[] for _ in range(clients)]
                errors = [0] * clients
                calls = [0] * clients

                def storm(w: int) -> None:
                    ha = HaRpcClient(addrs, observer_reads=observer)
                    try:
                        for i in range(per):
                            p = f"/storm/c{w}/{i // args.files}/f{i}"
                            try:
                                ha.call("create", path=p, client=f"s{w}")
                                alloc = ha.call("add_block", path=p,
                                                client=f"s{w}")
                                ha.call("complete", path=p, client=f"s{w}",
                                        block_lengths={
                                            alloc["block_id"]: 1024})
                                calls[w] += 3
                                if observer:
                                    t = time.perf_counter()
                                    ha.msync(wait_s=1.0)
                                    msync_ms[w].append(
                                        (time.perf_counter() - t) * 1e3)
                                for j in range(meta):
                                    which = (i * meta + j) % 3
                                    t = time.perf_counter()
                                    if which == 0:
                                        ha.call("stat", path=p)
                                    elif which == 1:
                                        ha.call("get_block_locations",
                                                path=p)
                                    else:
                                        ha.call("listing",
                                                path=f"/storm/c{w}/"
                                                     f"{i // args.files}")
                                    read_ms[w].append(
                                        (time.perf_counter() - t) * 1e3)
                                    calls[w] += 1
                            except Exception:  # noqa: BLE001 — count on
                                errors[w] += 1
                    finally:
                        ha.close()

                t0 = time.perf_counter()
                ts = [threading.Thread(target=storm, args=(w,))
                      for w in range(clients)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
                dt = time.perf_counter() - t0
                lock = nn.rpc_contention()["lock"]
                flat = [x for lat in read_ms for x in lat]
                msy = [x for lat in msync_ms for x in lat]
                lag_txids = max((nn._editlog.seq - o._editlog.seq
                                 for o in obs), default=0)
                obs_reads = _counter("client.ha",
                                     "observer_reads") - obs_reads0
                return {
                    "ops_per_s": round(sum(calls) / dt) if dt > 0 else 0,
                    "errors": sum(errors),
                    "read_p99_ms": round(float(
                        np.percentile(flat, 99)) if flat else 0.0, 3),
                    "active_read_lock_share": round(sum(
                        lock["by_method"].get(m, {}).get("hold_share", 0.0)
                        for m in read_methods), 4),
                    "observer_reads": obs_reads,
                    "observer_share": round(obs_reads / len(flat), 4)
                    if flat else 0.0,
                    "observer_bounces": _counter(
                        "client.ha", "observer_bounces") - bounces0,
                    "msync_p99_ms": round(float(
                        np.percentile(msy, 99)) if msy else 0.0, 3),
                    "observer_lag_txids": lag_txids,
                }
            finally:
                for o in obs:
                    o.stop()
                nn.stop()
                retry.reset_breakers()

    rounds = max(1, args.rounds)
    a_rounds = [leg(False) for _ in range(rounds)]
    b_rounds = [leg(True) for _ in range(rounds)]

    def med(rs: list[dict], key: str) -> float:
        return float(np.median([r[key] for r in rs]))

    a_p99, b_p99 = med(a_rounds, "read_p99_ms"), med(b_rounds, "read_p99_ms")
    print(json.dumps({
        "bench": "nn_observer_ab",
        "rounds": rounds,
        "clients": max(1, args.clients),
        "data_ops": max(1, args.ops // max(1, args.clients))
        * max(1, args.clients),
        "observers": max(1, args.observers),
        "a": {"read_p99_ms": round(a_p99, 3),
              "active_read_lock_share": round(
                  med(a_rounds, "active_read_lock_share"), 4),
              "ops_per_s": round(med(a_rounds, "ops_per_s"))},
        "b": {"read_p99_ms": round(b_p99, 3),
              "active_read_lock_share": round(
                  med(b_rounds, "active_read_lock_share"), 4),
              "ops_per_s": round(med(b_rounds, "ops_per_s"))},
        "read_p99_ratio": round(b_p99 / a_p99, 3) if a_p99 > 0 else 0.0,
        "observer_reads": round(med(b_rounds, "observer_reads")),
        "observer_share": round(med(b_rounds, "observer_share"), 4),
        "observer_bounces": round(med(b_rounds, "observer_bounces")),
        "msync_p99_ms": round(med(b_rounds, "msync_p99_ms"), 3),
        "observer_lag_txids": round(med(b_rounds, "observer_lag_txids")),
        "errors": sum(r["errors"] for r in a_rounds + b_rounds),
    }))


def _nn_kill_active(args) -> None:
    """Kill-active-mid-storm: readers hammer a file through the HA proxy
    while the active NN dies a third of the way in; a FailoverController
    promotes the standby while observers keep serving.  Prints ONE JSON
    line: reads served, read errors, responses staler than the bound
    (must be 0), and the write-unavailability window (kill -> first
    post-promotion write)."""
    import threading

    from hdrf_tpu_torch.server.failover import FailoverController
    from hdrf_tpu_torch.testing.minicluster import MiniCluster
    from hdrf_tpu_torch.utils import metrics

    def _counter(reg: str, key: str) -> int:
        return metrics.registry(reg).snapshot()["counters"].get(key, 0)

    payload = b"observer-kill-active" * 200
    dur = max(2.0, args.duration)
    readers = max(1, args.clients)
    dev = _device(args).type
    obs_reads0 = _counter("client.ha", "observer_reads")
    bounces0 = _counter("client.ha", "observer_bounces")
    with MiniCluster(n_datanodes=1, replication=1, ha=True,
                     observers=max(1, args.observers), backend=dev) as mc:
        with mc.client("seed", device=dev) as c:
            c.write("/kill/f0", payload)
            c.msync(wait_s=2.0)
        fc = FailoverController(mc.nn_addrs(), probe_interval_s=0.2,
                                grace=2).start()
        stop = threading.Event()
        reads = [0] * readers
        read_errors = [0] * readers
        stale = [0] * readers

        def reader(w: int) -> None:
            with mc.client(f"reader-{w}", device=dev) as c:
                while not stop.is_set():
                    try:
                        data = c.read("/kill/f0")
                    except Exception:  # noqa: BLE001 — the verdict counts
                        read_errors[w] += 1
                        time.sleep(0.05)
                        continue
                    reads[w] += 1
                    if data != payload:
                        stale[w] += 1

        ts = [threading.Thread(target=reader, args=(w,))
              for w in range(readers)]
        for t in ts:
            t.start()
        time.sleep(dur / 3)
        t_kill = time.perf_counter()
        mc.kill_namenode()
        # write probe: the moment a mutation lands again, promotion is done
        failover_s = None
        deadline = time.monotonic() + dur
        with mc.client("write-probe", device=dev) as c:
            k = 0
            while time.monotonic() < deadline:
                try:
                    c.write(f"/kill/probe{k}", b"x")
                    failover_s = time.perf_counter() - t_kill
                    break
                except Exception:  # noqa: BLE001 — still failing over
                    k += 1
                    time.sleep(0.1)
        time.sleep(max(0.0, dur / 3))
        stop.set()
        for t in ts:
            t.join()
        fc.stop()
    print(json.dumps({
        "bench": "nn_kill_active",
        "duration_s": dur,
        "readers": readers,
        "reads": sum(reads),
        "read_errors": sum(read_errors),
        "stale_beyond_bound": sum(stale),
        "failover_s": round(failover_s, 3) if failover_s else None,
        "observer_reads": _counter("client.ha",
                                   "observer_reads") - obs_reads0,
        "observer_bounces": _counter("client.ha",
                                     "observer_bounces") - bounces0,
    }))


def bench_nn(args) -> None:
    """Metadata-storm harness: ``--clients`` concurrent WIRE clients each
    run a data op (create + addBlock + complete) followed by
    ``--meta-per-op`` read-plane calls (stat / getBlockLocations /
    listing, round-robin) against a started NameNode.  Prints exactly ONE
    JSON line: throughput, rolling ``rpc_p99_ms``, ``lock_saturation``,
    the rolling lock-wait p99, the top lock-holding method and the
    per-method lock-share curve.  ``--observer-ab`` runs the paired
    observer A/B legs, ``--kill-active`` the failover scenario."""
    if getattr(args, "observer_ab", False):
        return _nn_observer_ab(args)
    if getattr(args, "kill_active", False):
        return _nn_kill_active(args)
    import tempfile
    import threading

    from hdrf_tpu_torch.config import NameNodeConfig
    from hdrf_tpu_torch.proto.rpc import RpcClient
    from hdrf_tpu_torch.server.namenode import NameNode

    with tempfile.TemporaryDirectory() as d:
        nn = NameNode(NameNodeConfig(
            meta_dir=d, replication=1,
            heartbeat_interval_s=30.0, dead_node_interval_s=600.0)).start()
        try:
            nn.rpc_register_datanode("dn-bench", ["127.0.0.1", 1])
            clients = max(1, args.clients)
            per = max(1, args.ops // clients)
            meta = max(0, args.meta_per_op)
            errors = [0] * clients
            calls = [0] * clients

            def storm(w: int) -> None:
                with RpcClient(nn.addr) as c:
                    for i in range(per):
                        # rotate subdirs so listings stay <= --files wide
                        p = f"/storm/c{w}/{i // args.files}/f{i}"
                        try:
                            c.call("create", path=p, client=f"s{w}")
                            alloc = c.call("add_block", path=p,
                                           client=f"s{w}")
                            c.call("complete", path=p, client=f"s{w}",
                                   block_lengths={alloc["block_id"]: 1024})
                            calls[w] += 3
                            for j in range(meta):
                                which = (i * meta + j) % 3
                                if which == 0:
                                    c.call("stat", path=p)
                                elif which == 1:
                                    c.call("get_block_locations", path=p)
                                else:
                                    c.call("listing",
                                           path=f"/storm/c{w}/"
                                                f"{i // args.files}")
                                calls[w] += 1
                            if w == 0 and i % 50 == 0:
                                c.call("heartbeat", dn_id="dn-bench")
                                calls[w] += 1
                        except Exception:  # noqa: BLE001 — count, keep going
                            errors[w] += 1

            t0 = time.perf_counter()
            ts = [threading.Thread(target=storm, args=(w,))
                  for w in range(clients)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            dt = time.perf_counter() - t0
            cont = nn.rpc_contention()
            lock = cont["lock"]
            shares = sorted(((m, r["hold_share"])
                             for m, r in lock["by_method"].items()),
                            key=lambda kv: kv[1], reverse=True)
            print(json.dumps({
                "bench": "nn_metadata_storm",
                "clients": clients,
                "data_ops": per * clients,
                "meta_per_op": meta,
                "rpc_calls": sum(calls),
                "errors": sum(errors),
                "ops_per_s": round(sum(calls) / dt) if dt > 0 else 0,
                "rpc_p99_ms": round(cont["rpc_p99_ms"], 3),
                "lock_saturation": round(lock["saturation"], 4),
                "lock_wait_p99_us": round(
                    lock["wait_us"].get("p99", 0.0), 1),
                "top_method": shares[0][0] if shares else None,
                "lock_share": {m: round(s, 4) for m, s in shares[:8]},
                "attributed_frac": round(cont["attributed_frac"], 4),
            }))
        finally:
            nn.stop()


def _dfs_pipeline_ab(args) -> None:
    """Paired write-pipeline A/B: ``--streams`` concurrent client streams
    through one DN at pipeline_depth=1 vs ``--depth``, alternating the two
    each round and taking the MEDIAN of the per-round ratios.  The DN's
    in-process backend is ``--backend``.  Prints exactly ONE JSON line."""
    import statistics
    import threading

    from hdrf_tpu_torch.ops.dispatch import resolve_backend
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    backend = resolve_backend(args.backend)
    client_dev = "cuda" if backend == "cuda" else "cpu"
    rng = np.random.default_rng(42)
    n = args.mb << 20
    payloads = []
    for _ in range(args.streams):
        a = rng.integers(0, 256, size=n, dtype=np.uint8)
        a[: n // 2] = rng.integers(97, 123, size=n // 2, dtype=np.uint8)
        payloads.append(a.tobytes())

    def one_pass(depth: int) -> float:
        overrides = {"pipeline_depth": depth,
                     "pipeline_max_inflight": max(args.streams, 4),
                     "max_concurrent_writes": max(args.streams, 4)}
        with MiniCluster(n_datanodes=1, replication=1,
                         block_size=1 << 20, backend=backend,
                         reduction_overrides=overrides) as mc:
            with mc.client("ab-warm", device=client_dev) as c:  # warmup
                c.write("/ab/warm", payloads[0][: 1 << 20], scheme="dedup")
            errs: list[BaseException] = []

            def wr(s: int) -> None:
                try:
                    with mc.client(f"ab{s}", device=client_dev) as c:
                        c.write(f"/ab/{s}", payloads[s], scheme="dedup")
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)

            ts = [threading.Thread(target=wr, args=(s,))
                  for s in range(args.streams)]
            t0 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            dt = time.perf_counter() - t0
            if errs:
                raise errs[0]
            return args.streams * n / dt / 2**20

    r1, rn, ratios = [], [], []
    for _ in range(args.rounds):
        a = one_pass(1)
        b = one_pass(args.depth)
        r1.append(a)
        rn.append(b)
        ratios.append(b / a)
    print(json.dumps({
        "op": "dfs write pipeline A/B (concurrent streams, paired)",
        "backend": backend, "streams": args.streams,
        "mb_per_stream": args.mb, "rounds": args.rounds,
        "depth": args.depth,
        "depth1_MBps": round(statistics.median(r1), 1),
        "depthN_MBps": round(statistics.median(rn), 1),
        "speedup": round(statistics.median(ratios), 3),
    }))


def bench_dfs(args) -> None:
    """DFS write/read MB/s a scheme through a MiniCluster whose DataNodes
    run their schemes on ``--device``; each line carries the device
    ledger's movement over its write and read."""
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    if args.pipeline_ab:
        return _dfs_pipeline_ab(args)

    rng = np.random.default_rng(42)
    n = args.mb << 20
    payload = rng.integers(0, 256, size=n, dtype=np.uint8)
    payload[: n // 2] = rng.integers(97, 123, size=n // 2, dtype=np.uint8)
    payload = payload.tobytes()
    dev = _device(args).type
    with MiniCluster(n_datanodes=args.datanodes, replication=args.replication,
                     block_size=8 << 20, backend=dev) as mc:
        from hdrf_tpu_torch.utils import device_ledger

        with mc.client("bench", device=dev) as c:
            for scheme in args.schemes.split(","):
                led0 = device_ledger.stamp()
                t0 = time.perf_counter()
                c.write(f"/bench/{scheme}", payload, scheme=scheme)
                w = n / (time.perf_counter() - t0) / 2**20
                t0 = time.perf_counter()
                got = c.read(f"/bench/{scheme}")
                r = n / (time.perf_counter() - t0) / 2**20
                assert got == payload
                led = device_ledger.delta(led0)
                print(json.dumps({"scheme": scheme,
                                  "write_MBps": round(w, 1),
                                  "read_MBps": round(r, 1),
                                  "ledger": led,
                                  "stalls": led.get("stall_total", 0)}))


def bench_ec_repair_ab(args) -> None:
    """Paired repair A/B: classic full-gather decode vs the coded
    partial-sum exchange, over the same container, erasure pattern and
    holder layout.  BEFORE timing, the coded fold is pinned bit-identical
    to the full-gather oracle (storage/stripe_store.py
    ``reconstruct_container``) on EVERY erasure pattern up to ``m``
    losses.  The wire ledger mirrors the live path's accounting
    (server/coded_exchange.py ``book_repair_wire``): full gather ships k
    whole stripes to the repairing owner, the coded chain one
    (|missing|, stripe_len) fold, holder-local contributions are free,
    and the contributions also ride the smaller-of LZ4 negotiation.
    Every RS product runs on ``--device``.  Slope method for the timings;
    prints exactly ONE JSON line."""
    import itertools

    from hdrf_tpu_torch.ops import rs
    from hdrf_tpu_torch.server import coded_exchange
    from hdrf_tpu_torch.storage import stripe_store

    dev = _device(args)
    k, m, _cell = rs.parse_policy(args.policy)
    rng = np.random.default_rng(7)
    n = args.mb << 20
    # half-compressible corpus: random tiles interleaved with repeated
    # text, the shape raw-codec container stripes actually have
    tile = rng.integers(0, 256, size=max(n // 2, 1), dtype=np.uint8)
    text = np.frombuffer(
        (b"the quick brown fox jumps over the lazy dog. " * 8192)
        [: max(n - tile.size, 1)], dtype=np.uint8)
    payload = np.concatenate([tile, text])[:n].tobytes()
    stripes, manifest = stripe_store.encode_container(payload, k, m,
                                                      device=dev)
    stripe_len = int(manifest["stripe_len"])
    arrs = {i: np.frombuffer(s, dtype=np.uint8)
            for i, s in enumerate(stripes)}
    dns = max(int(args.dns), 2)
    holder_of = {i: i % dns for i in range(k + m)}  # round-robin layout

    def coded_fold(missing: list[int], shards: dict[int, np.ndarray]):
        """The owner's view of one coded repair: per-holder partial sums
        (one launch each), XOR fold, plus the remote wire bytes."""
        have = sorted(shards)[:k]
        rows = rs.repair_rows(k, m, tuple(have), tuple(missing))
        col = {s: j for j, s in enumerate(have)}
        parts, remote = [], 0
        for h in range(dns):
            mine = [s for s in have if holder_of[s] == h]
            if not mine:
                continue
            st = np.stack([shards[s] for s in mine])
            parts.append(rs.partial_sums(
                st, rows[:, [col[s] for s in mine]], device=dev))
            if h != 0:  # holder 0 is the repairing owner: local = free
                remote = len(missing) * stripe_len  # ONE chained fold
        return rs.xor_fold(parts), remote

    # ---- oracle pin: every erasure pattern up to m losses, small corpus
    small, sman = stripe_store.encode_container(payload[: k * 256], k, m,
                                                device=dev)
    sarrs = {i: np.frombuffer(s, dtype=np.uint8)
             for i, s in enumerate(small)}
    patterns = [list(c) for e in range(1, m + 1)
                for c in itertools.combinations(range(k + m), e)]
    oracle_ok = True
    for missing in patterns:
        shards = {i: a for i, a in sarrs.items() if i not in missing}
        want = stripe_store.reconstruct_container(
            dict(shards), sman, want=missing, device=dev)
        fold, _ = coded_fold(missing, shards)
        for i, w in enumerate(missing):
            if fold[i].tobytes() != want[w]:
                oracle_ok = False

    # ---- paired timing on the full corpus; default is the common
    # single-loss repair
    e = max(1, min(int(args.erasures), m))
    missing = list(range(e))  # data stripes lost: decode-heavy for A
    survivors = {i: arrs[i] for i in range(k + m) if i not in missing}
    rebuilt = len(missing) * stripe_len

    def run_full():
        return stripe_store.reconstruct_container(
            dict(survivors), manifest, want=missing, device=dev)

    def run_coded():
        return coded_fold(missing, survivors)

    full_mbps = rebuilt / _per_call(run_full, dev, args.inner, 1) / 2**20
    coded_mbps = rebuilt / _per_call(run_coded, dev, args.inner, 1) / 2**20

    # ---- wire ledger (the live path's accounting, stamped in-registry)
    fold, remote_wire = run_coded()
    packed = coded_exchange.pack_many(
        [fold[i].tobytes() for i in range(len(missing))])
    coded_wire_packed = sum(len(p) for p, _ in packed)
    full_wire = sum(len(survivors[i]) for i in sorted(survivors)[:k])
    coded_exchange.book_repair_wire(remote_wire, rebuilt)
    print(json.dumps({
        "op": f"ec repair A/B [{args.policy}, fastest pass]",
        "mb": args.mb, "backend": dev.type,
        "k": k, "m": m, "dns": dns, "inner": args.inner,
        "erasures": len(missing),
        "patterns_pinned": len(patterns),
        "parity_oracle_ok": bool(oracle_ok),
        "full_gather_MBps": round(full_mbps, 1),
        "coded_repair_MBps": round(coded_mbps, 1),
        "speedup": (round(coded_mbps / full_mbps, 3)
                    if full_mbps > 0 else None),
        "repair_wire_ratio_full": round(full_wire / rebuilt, 3),
        "repair_wire_ratio_coded": round(remote_wire / rebuilt, 3),
        "repair_wire_ratio_coded_lz4": round(
            coded_wire_packed / rebuilt, 3),
        "wire_saved_frac": round(1 - remote_wire / full_wire, 4),
    }))


def bench_ec(args) -> None:
    """EC cold-tier harness: paired encode / intact-reassembly /
    degraded-decode rates over the container striping path
    (storage/stripe_store.py on ops/rs.py, every RS product one launch on
    ``--device``).  Intact reassembly is CRC + concat (all k data stripes
    present); degraded drops the first m stripes (all-data erasures, the
    worst case) and decodes through parity — their ratio is the cold
    tier's read penalty.  Parity is pinned against the GF log/antilog
    oracle (rs.encode_ref) before timing.  Prints exactly ONE JSON
    line."""
    if getattr(args, "repair_ab", False):
        return bench_ec_repair_ab(args)
    from hdrf_tpu_torch.ops import rs
    from hdrf_tpu_torch.storage import stripe_store

    dev = _device(args)
    k, m, _cell = rs.parse_policy(args.policy)
    rng = np.random.default_rng(7)
    n = args.mb << 20
    payload = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    stripes, manifest = stripe_store.encode_container(payload, k, m,
                                                      device=dev)

    # pin vs the numpy GF oracle before trusting any timing
    padded = np.zeros(k * manifest["stripe_len"], dtype=np.uint8)
    padded[:n] = np.frombuffer(payload, dtype=np.uint8)
    ref = rs.encode_ref(padded.reshape(k, -1), m)
    oracle_ok = all(bytes(ref[i]) == stripes[k + i] for i in range(m))

    intact = {i: stripes[i] for i in range(k)}
    degraded = {i: stripes[i] for i in range(m, k + m)}

    def mbps(fn) -> float:
        return n / _per_call(fn, dev, args.inner, 1) / 2**20

    enc = mbps(
        lambda: stripe_store.encode_container(payload, k, m, device=dev))
    rd_ok = mbps(lambda: stripe_store.reconstruct_container(
        intact, manifest, device=dev))
    rd_deg = mbps(lambda: stripe_store.reconstruct_container(
        degraded, manifest, device=dev))
    print(json.dumps({
        "op": f"ec cold tier [{args.policy}, fastest pass]",
        "mb": args.mb, "backend": dev.type,
        "k": k, "m": m, "inner": args.inner,
        "parity_oracle_ok": bool(oracle_ok),
        "encode_MBps": round(enc, 1),
        "intact_read_MBps": round(rd_ok, 1),
        "degraded_read_MBps": round(rd_deg, 1),
        "degraded_penalty": (round(rd_ok / rd_deg, 3)
                             if rd_deg > 0 else None),
        # the tier's expansion: (k+m)*stripe_len over true length
        "storage_ratio": round(
            (k + m) * manifest["stripe_len"] / manifest["length"], 4),
    }))


def bench_reduction(args) -> None:
    """The block-reduction funnel (ops/dispatch.chunk_and_fingerprint) on
    ``--backend``: one timed block after a 1 MiB warm-up, with the device
    ledger's movement."""
    from hdrf_tpu_torch.config import CdcConfig
    from hdrf_tpu_torch.ops import dispatch
    from hdrf_tpu_torch.utils import device_ledger

    rng = np.random.default_rng(3)
    n = args.mb << 20
    data = rng.integers(0, 256, size=n, dtype=np.uint8)
    cdc = CdcConfig()
    backend = dispatch.resolve_backend(args.backend)
    dispatch.chunk_and_fingerprint(data[: 1 << 20], cdc, backend)  # warm
    led0 = device_ledger.stamp()
    t0 = time.perf_counter()
    cuts, digs = dispatch.chunk_and_fingerprint(data, cdc, backend)
    mbps = n / (time.perf_counter() - t0) / 2**20
    led = device_ledger.delta(led0)
    print(json.dumps({"op": f"reduction pipeline [{backend}]",
                      "MBps": round(mbps, 1), "chunks": int(cuts.size),
                      "ledger": led,
                      "stalls": led.get("stall_total", 0)}))


def bench_recon(args) -> None:
    """Read-side reconstruction MB/s: host path vs device gather path
    (DataConstructor.java:360-567 vs ops/reconstruct.py).  Builds a dedup
    store once (host ``native`` writes), then reconstructs blocks
    repeatedly — the device path's resident container images make repeat
    reads gather-only.  On the card a third line times the padded gather
    kernel over those images (module docstring)."""
    import dataclasses
    import tempfile

    import torch

    from hdrf_tpu_torch.config import ReductionConfig
    from hdrf_tpu_torch.index.chunk_index import ChunkIndex
    from hdrf_tpu_torch.ops.reconstruct import DeviceReconstructor
    from hdrf_tpu_torch.reduction import scheme as schemes
    from hdrf_tpu_torch.reduction.scheme import ReductionContext
    from hdrf_tpu_torch.storage.container_store import ContainerStore

    dev = _device(args)
    rng = np.random.default_rng(5)
    n = args.mb << 20
    blocks = {}
    with tempfile.TemporaryDirectory() as d:
        cfg = ReductionConfig()
        if args.chunk_kb:
            # bigger lanes: per-lane overhead amortizes with lane size
            import math

            from hdrf_tpu_torch.config import CdcConfig

            kb = args.chunk_kb
            cfg = dataclasses.replace(cfg, cdc=CdcConfig(
                mask_bits=int(math.log2(kb)) + 10,
                min_chunk=(kb << 10) // 4, max_chunk=(kb << 10) * 4))
        ctx = ReductionContext(
            config=cfg,
            containers=ContainerStore(d + "/containers", codec="lz4"),
            index=ChunkIndex(d + "/index"), backend="native")
        s = schemes.get("dedup_lz4")
        per = 8 << 20
        for bid in range(n // per):
            data = rng.integers(0, 256, size=per, dtype=np.uint8)
            data[: per // 3] = rng.integers(97, 123, size=per // 3,
                                            dtype=np.uint8)
            blocks[bid] = data.tobytes()
            s.reduce(bid, blocks[bid], ctx)
        for label, rctx in (
                ("host", ctx),
                ("device", dataclasses.replace(
                    ctx, recon=DeviceReconstructor(device=dev)))):
            for bid, data in blocks.items():  # warm (stage images)
                assert s.reconstruct(bid, b"", len(data), rctx) == data
            t0 = time.perf_counter()
            total = 0
            for _ in range(args.repeats):
                for bid, data in blocks.items():
                    out = s.reconstruct(bid, b"", len(data), rctx)
                    total += len(out)
            mbps = total / (time.perf_counter() - t0) / 2**20
            print(json.dumps({"op": f"reconstruction [{label}]",
                              "MBps": round(mbps, 1)}))

        # The gather kernel's own service rate once images are resident:
        # reconstructed bytes need not cross to the host for this rate.
        if dev.type == "cuda":
            from hdrf_tpu_torch.ops.gather_cuda import gather_pad_messages
            from hdrf_tpu_torch.ops.reconstruct import _bucket_of

            recon = DeviceReconstructor(device=dev)
            s2 = dataclasses.replace(ctx, recon=recon)
            for bid, data in blocks.items():   # stage images
                assert s.reconstruct(bid, b"", len(data), s2) == data
            # group every block's chunks like DeviceReconstructor.gather
            jobs = []
            for bid in blocks:
                entry = ctx.index.get_block(bid)
                locmap = ctx.index.lookup_chunks(list(set(entry.hashes)))
                groups: dict = {}
                for h in entry.hashes:
                    loc = locmap[h]
                    b = _bucket_of(-(-loc.length // 64) + 1)
                    groups.setdefault((loc.container_id, b),
                                      []).append(loc)
                for (cid, b), locs in groups.items():
                    L = -(-len(locs) // 128) * 128
                    ol = np.zeros((2, L), np.int32)
                    for j, loc in enumerate(locs):
                        ol[0, j], ol[1, j] = loc.offset, loc.length
                    img = recon._image(
                        cid, lambda c=cid: ctx.containers.read_container(c))
                    jobs.append((img, torch.from_numpy(ol).to(dev), b,
                                 sum(loc.length for loc in locs)))

            INNER = 8

            def one_pass():
                for _ in range(INNER):
                    for img, ol, b, _n in jobs:
                        gather_pad_messages(img, ol, b)
                _sync(dev)

            one_pass()  # warm
            t0 = time.perf_counter()
            for _ in range(args.repeats):
                one_pass()
            dt = time.perf_counter() - t0
            gathered = args.repeats * INNER * sum(j[3] for j in jobs)
            print(json.dumps({"op": "reconstruction [device gather kernel]",
                              "MBps": round(gathered / dt / 2**20, 1)}))
        ctx.index.close()


def bench_sort(args) -> None:
    """Match-scan sort engine A/B: the card's ``match_deltas`` and
    ``sort_rows`` kernels (ops/sort_cuda.py) vs their plain PyTorch
    versions, fastest pass (module docstring).  On the CPU only the plain leg runs;
    ``--interpret`` runs the ``cuda`` leg through the plain versions (a
    correctness spot-check, not a timing)."""
    import torch

    from hdrf_tpu_torch.ops import sort_cuda
    from hdrf_tpu_torch.ops.lz4_device import _packed_len

    dev = _device(args)
    rng = np.random.default_rng(13)
    t, e = args.tiles, args.entries
    stride, pos_bits = 2, int(e - 1).bit_length()
    vals = torch.from_numpy(rng.integers(0, 2**32, size=(t, e),
                                         dtype=np.uint32).view(np.int32)
                            ).to(dev)

    impls = ["plain"]
    if dev.type == "cuda" or args.interpret:
        impls.append("cuda")

    def legs(impl: str) -> tuple[bool, str]:
        interp = args.interpret and impl == "cuda"
        return interp, f"{impl}{'/interp' if interp else ''}"

    for impl in impls:
        interp, tag = legs(impl)
        fn = (sort_cuda.match_deltas_plain if impl == "plain" or interp
              else sort_cuda.match_deltas)
        per = _per_call(lambda: fn(vals, stride, pos_bits), dev,
                        args.inner, args.repeats)
        print(json.dumps({
            "op": f"match_deltas [{tag}]",
            "entries": t * e, "ms_per_scan": round(per * 1e3, 3),
            "MBps": round(t * e * stride / per / 2**20, 1)}))

    for impl in impls:
        interp, tag = legs(impl)
        fn = (sort_cuda.sort_rows_plain if impl == "plain" or interp
              else sort_cuda.sort_rows)
        per = _per_call(lambda: fn(vals, vals, key_unsigned=True), dev,
                        args.inner, args.repeats)
        print(json.dumps({
            "op": f"sort_rows [{tag}]",
            "entries": t * e, "ms_per_sort": round(per * 1e3, 3),
            "Mkeys_per_s": round(t * e / per / 1e6, 1)}))

    # Readback-size ledger: the packed record layout vs the full one at the
    # production L3 width (deterministic; no device needed).
    p3 = 1 << 17
    full, packed = 1 + 2 * p3, _packed_len(p3)
    print(json.dumps({"op": "record readback", "p3": p3,
                      "full_words": full, "packed_words": packed,
                      "reduction_pct": round(100 * (1 - packed / full), 1)}))


def _native_cuts(a: np.ndarray, mask: int, mn: int, mx: int) -> np.ndarray:
    """``native.cdc_chunk`` of the reference: the host select over the
    host candidate scan."""
    from hdrf_tpu_torch import native

    return native.cdc_select(native.gear_candidates(a, mask), a.size, mn, mx)


def bench_cdc(args) -> None:
    """CDC front end A/B, geometry-sweepable: the card's scan + select pair
    (``cdc_cuda.cdc_block``) vs the plain PyTorch scan on the same device,
    fastest pass, with the per-leg micro-profile (gear = the scan alone,
    scan = the pair minus gear, image = ``be_image``, pad =
    ``gather_pad_messages``), the select's H_SURV / H_CANDS lanes and the
    per-block readback byte ledger.  Cuts are pinned bit-identical to
    native.cdc_chunk BEFORE any timing.  ``--interpret`` (or a CPU device)
    runs the plain versions: a correctness-grade timing, flagged in the
    line.  Prints exactly ONE JSON line (null keys: module docstring)."""
    import torch

    from hdrf_tpu_torch.config import CdcConfig
    from hdrf_tpu_torch.ops import cdc_cuda, gather_cuda, gear
    from hdrf_tpu_torch.ops.resident import ResidentReducer

    dev = _device(args)
    cdc = CdcConfig(mask_bits=args.mask_bits, min_chunk=args.min_size)
    r = ResidentReducer(cdc, device=dev)
    n = args.mb << 20
    rng = np.random.default_rng(17)
    a = rng.integers(0, 256, n, dtype=np.uint8)
    a[: n // 4] = rng.integers(97, 123, size=n // 4, dtype=np.uint8)

    interpret = args.interpret or dev.type != "cuda"
    if interpret:
        block_fn, scan_fn = cdc_cuda.cdc_block_plain, cdc_cuda.cdc_scan_plain
        image_fn = gear.be_words
        pad_fn = gather_cuda.gather_pad_messages_plain
    else:
        block_fn, scan_fn = cdc_cuda.cdc_block, cdc_cuda.cdc_scan
        image_fn = cdc_cuda.be_image
        pad_fn = gather_cuda.gather_pad_messages
    mn, mx = cdc.min_chunk, cdc.max_chunk
    blk, _ = cdc_cuda.padded_block(a, dev)

    # -- correctness pin BEFORE timing: the cuts must equal the native
    # oracle (the tables hold the hard cut bound: no overflow)
    want = _native_cuts(a, r.mask, mn, mx)
    _, table, _, _ = block_fn(blk, n, r.mask, mn, mx, r._b_small)
    tb = table.cpu().numpy()
    overflowed = bool(tb[cdc_cuda.H_OVERFLOW])
    assert np.array_equal(cdc_cuda.table_cuts(tb),
                          np.asarray(want, np.uint64)), \
        "kernel cuts diverge from native.cdc_chunk"
    surv = int(tb[cdc_cuda.H_SURV]) if args.skip_ahead else 0
    cands = int(tb[cdc_cuda.H_CANDS]) if args.skip_ahead else 0
    words = image_fn(blk)

    L_pad = 1024
    ol_np = np.zeros((2, L_pad), dtype=np.int32)
    ol_np[0] = (np.arange(L_pad) * mn) % max(n // 2, 1)
    ol_np[1] = min(mn, r._b_small * 64 - 9)
    ol_dev = torch.from_numpy(ol_np).to(dev)

    def ms(fn) -> float:
        return _per_call(fn, dev, args.inner, args.repeats) * 1e3

    fused_ms = ms(lambda: block_fn(blk, n, r.mask, mn, mx, r._b_small))
    gear_ms = ms(lambda: scan_fn(blk, n, r.mask, mn))
    image_ms = ms(lambda: image_fn(blk))
    pad_ms = ms(lambda: pad_fn(words, ol_dev, r._b_small))
    xla_ms = ms(lambda: cdc_cuda.cdc_scan_plain(blk, n, r.mask, mn))
    cap = cdc_cuda.cap_for(n, mn)
    n_cands = int(tb[cdc_cuda.H_CANDS])
    print(json.dumps({
        "op": "cdc_prep [fused scan + select vs plain prep, fastest pass "
              "A/B]",
        "mb": args.mb, "backend": dev.type,
        "interpret": interpret,
        "mask_bits": cdc.mask_bits, "min_size": cdc.min_chunk,
        "skip_ahead": bool(args.skip_ahead),
        "cuts_verified": not overflowed, "overflowed": overflowed,
        "fused_ms_per_block": round(fused_ms, 3),
        "fused_noskip_ms_per_block": None,
        "skip_ahead_speedup": None,
        "xla_ms_per_block": round(xla_ms, 3),
        "speedup": round(xla_ms / fused_ms, 3) if fused_ms > 0 else None,
        "micro_profile_ms": {"gear": round(max(gear_ms, 0.0), 3),
                             "scan": round(max(fused_ms - gear_ms, 0.0), 3),
                             "image": round(max(image_ms, 0.0), 3),
                             "pad": round(max(pad_ms, 0.0), 3)},
        "scan_slab_survivors": surv, "scan_candidates": cands,
        "cand_d2h_bytes_per_block_xla": 8 * n_cands,
        "cut_table_d2h_bytes_per_block_fused":
            (cdc_cuda.TABLE_HDR + cap) * 4,
        "serial_awaited_boundaries": {"xla": 2, "fused": 2},
    }))


def bench_multichip(args) -> None:
    """Mesh-plane service-rate curve: the same small-block corpus through
    parallel/sharded.MeshReducer on meshes of 1/2/4/8 shards of
    ``--device`` (module docstring: on one card this is per-step
    amortization, not chip scaling).  Each coalesced group runs CDC,
    SHA-256 and the sharded dedup-bucket probe as ONE ledger-visible
    dispatch ("sharded.step").  Cuts + digests are pinned against the
    native oracle before any timing, and the timed full-width pass
    carries device-ledger evidence that one mesh step == one dispatch.
    Prints exactly ONE JSON line."""
    from hdrf_tpu_torch import native
    from hdrf_tpu_torch.config import CdcConfig
    from hdrf_tpu_torch.ops.dispatch import gear_mask
    from hdrf_tpu_torch.parallel.sharded import MeshReducer, make_mesh
    from hdrf_tpu_torch.utils import device_ledger

    dev = _device(args)
    cdc = CdcConfig(mask_bits=args.mask_bits, min_chunk=args.min_chunk,
                    max_chunk=args.max_chunk)
    mask = gear_mask(cdc)
    widths = [1, 2, 4, 8]
    bs = args.block_kb << 10
    rng = np.random.default_rng(23)
    blocks = []
    for _ in range(args.blocks):
        a = rng.integers(0, 256, size=bs, dtype=np.uint8)
        a[: bs // 2] = rng.integers(97, 123, size=bs // 2, dtype=np.uint8)
        blocks.append(a)

    def reducer(d: int) -> MeshReducer:
        mesh = make_mesh(n_data=d, n_seq=1, devices=[dev] * d)
        return MeshReducer(cdc, mesh=mesh, lanes_per_device=args.lanes)

    # pin vs the native oracle on the full-width mesh before any timing
    r_full = reducer(widths[-1])
    got = r_full.reduce_many(blocks[: r_full.max_group()])
    oracle_ok = True
    for a, (cuts, digs, _probe) in zip(blocks, got):
        ref_cuts = _native_cuts(a, mask, cdc.min_chunk, cdc.max_chunk)
        starts = np.concatenate([[0], ref_cuts[:-1]]).astype(np.uint64)
        ref_digs = native.sha256_batch(
            a, starts, (ref_cuts - starts).astype(np.uint64))
        oracle_ok &= bool(np.array_equal(cuts, ref_cuts)
                          and np.array_equal(digs, ref_digs))

    def timed(r: MeshReducer):
        g = r.max_group()
        groups = [blocks[at:at + g] for at in range(0, len(blocks), g)]
        for grp in groups:        # warm: first launch of each shape
            r.finish_many(r.submit_many(grp))
        evs = device_ledger.events_snapshot()
        id0 = evs[-1]["id"] if evs else 0
        steps = 0
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            inflight = None
            for grp in groups:    # depth-2 pipelining, write-path style
                nxt = r.submit_many(grp)
                steps += 1
                if inflight is not None:
                    r.finish_many(inflight)
                inflight = nxt
            r.finish_many(inflight)
        dt = time.perf_counter() - t0
        enq = [e for e in device_ledger.events_snapshot()
               if e["id"] > id0 and e["kind"] == "enqueue"]
        disp = sum(1 for e in enq if e["op"] == "sharded.step")
        foreign = sum(1 for e in enq
                      if e["op"] not in ("sharded.step",
                                         "sharded.bucket_refresh"))
        rate = args.repeats * len(blocks) * bs / dt / 2**20
        return rate, dt / steps * 1e3, steps, disp, foreign

    rates: dict[int, float] = {}
    step_ms: dict[int, float] = {}
    steps_full = disp_full = foreign_full = 0
    for d in widths:
        r = r_full if d == widths[-1] else reducer(d)
        rate, per_step, steps, disp, foreign = timed(r)
        rates[d] = rate
        step_ms[d] = per_step
        if d == widths[-1]:
            steps_full, disp_full, foreign_full = steps, disp, foreign
    # Two-point fit of step_time(d) = fixed + d * per_device: the shards
    # of one device run one after another, so a step's cost grows with d
    dmax = widths[-1]
    c_fit = (step_ms[dmax] - step_ms[1]) / (dmax - 1)
    print(json.dumps({
        "op": "multichip mesh reduction plane [service-rate curve]",
        "backend": dev.type,
        "devices": dmax, "blocks": args.blocks,
        "block_kb": args.block_kb, "lanes_per_device": args.lanes,
        "oracle_ok": oracle_ok,
        "MBps": {str(d): round(v, 2) for d, v in rates.items()},
        "ratio_8v1": round(rates[dmax] / rates[1], 2),
        "step_ms": {str(d): round(v, 3) for d, v in step_ms.items()},
        "step_fixed_ms": round(step_ms[1] - c_fit, 3),
        "step_per_device_ms": round(c_fit, 3),
        "steps": steps_full, "step_dispatches": disp_full,
        "one_dispatch_per_step": bool(steps_full == disp_full
                                      and foreign_full == 0),
    }))


def bench_churn(args) -> None:
    """Long-horizon churn scenario: a delete-heavy / rewrite lifecycle
    over a 1-DN MiniCluster (its scheme on ``--device``): every round
    writes a generation of dedup-friendly files (a shared tile plus a
    unique tail), deletes a fraction of the oldest generation, rewrites a
    fraction of the survivors, reads everything still live, runs one
    scrub census cycle and takes one deterministic flight-recorder sample
    (utils/flight_recorder.py sample_once).  Deletes shrink the LOGICAL
    footprint while sealed containers keep their PHYSICAL bytes, so the
    storage_ratio curve rises round over round and the trend report
    (tools/slo_report.py trend) flags it.  Prints exactly ONE JSON line:
    the per-metric first/last/slope curve summary plus the verdict."""
    import random

    from hdrf_tpu_torch.testing.minicluster import MiniCluster
    from hdrf_tpu_torch.tools import slo_report

    rng = random.Random(0x17)
    kb = args.kb
    shared = bytes(rng.getrandbits(8) for _ in range(kb << 10))

    def payload() -> bytes:
        return shared + bytes(rng.getrandbits(8) for _ in range(kb << 10))

    samples: list[dict] = []
    live: list[str] = []
    gen = 0
    dev = _device(args).type
    with MiniCluster(n_datanodes=1, replication=1, backend=dev) as mc:
        dn = mc.datanodes[0]
        with mc.client("churn", device=dev) as c:
            for _ in range(args.rounds):
                for i in range(args.files):
                    path = f"/churn/g{gen}/f{i}"
                    c.write(path, payload(), scheme="dedup_lz4")
                    live.append(path)
                gen += 1
                ndel = int(len(live) * args.delete_frac)
                for path in live[:ndel]:
                    c.delete(path)
                live = live[ndel:]
                nrw = int(len(live) * args.rewrite_frac)
                for path in live[:nrw]:
                    c.delete(path)
                    c.write(path, payload(), scheme="dedup_lz4")
                # deletes reach the DN as invalidate commands riding
                # heartbeats: wait for the replica count to settle so the
                # logical census is honest
                deadline = time.monotonic() + 5.0
                while (len(dn.replicas.block_ids()) > len(live)
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                for path in live:
                    c.read(path)
                dn.scrubber.run_cycle()
                samples.append(dn.flight.sample_once())
    curves = {}
    for metric in ("storage_ratio", "garbage_bytes",
                   "chunk_cache_hit_ratio", "read_p95_ms"):
        vals = [float(s.get(metric, 0.0)) for s in samples]
        curves[metric] = {"first": vals[0], "last": vals[-1],
                          "slope": slo_report.slope(vals),
                          "series": vals}
    tr = slo_report.trend(samples)
    print(json.dumps({
        "op": "churn [delete/rewrite lifecycle, flight-sampled]",
        "rounds": args.rounds,
        "files_per_round": args.files,
        "kb": kb,
        "delete_frac": args.delete_frac,
        "rewrite_frac": args.rewrite_frac,
        "samples": len(samples),
        "curves": curves,
        "regressions": tr["regressions"],
        "verdict": tr["verdict"],
    }))


def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="where the harness's device work runs: cuda (the "
                        "card; raises without one) or cpu (the plain "
                        "versions)")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="hdrf-bench")
    sub = p.add_subparsers(dest="which", required=True)
    d = sub.add_parser("nn")
    d.add_argument("--ops", type=int, default=2000,
                   help="total data ops (create+addBlock+complete chains)")
    d.add_argument("--clients", type=int, default=8,
                   help="concurrent wire clients")
    d.add_argument("--meta-per-op", type=int, default=3,
                   help="stat/getBlockLocations/listing calls per data op")
    d.add_argument("--files", type=int, default=100,
                   help="files per listing directory (rotation width)")
    d.add_argument("--observer-ab", action="store_true",
                   help="paired A/B: storm with vs without observer reads")
    d.add_argument("--kill-active", action="store_true",
                   help="kill the active mid-storm; observers keep serving")
    d.add_argument("--observers", type=int, default=1,
                   help="observer NNs in --observer-ab/--kill-active modes")
    d.add_argument("--rounds", type=int, default=5,
                   help="paired rounds to median over (--observer-ab)")
    d.add_argument("--duration", type=float, default=6.0,
                   help="storm duration in seconds (--kill-active)")
    _device_arg(d)
    d.set_defaults(fn=bench_nn)
    d = sub.add_parser("dfs")
    d.add_argument("--mb", type=int, default=64)
    d.add_argument("--datanodes", type=int, default=3)
    d.add_argument("--replication", type=int, default=2)
    d.add_argument("--schemes", default="direct,lz4,dedup_lz4")
    d.add_argument("--pipeline-ab", action="store_true",
                   help="paired multi-stream A/B: pipeline_depth=1 vs "
                        "--depth; one JSON line with the median speedup")
    d.add_argument("--streams", type=int, default=4)
    d.add_argument("--rounds", type=int, default=5)
    d.add_argument("--depth", type=int, default=4)
    d.add_argument("--backend", default="native",
                   help="DN in-process backend for --pipeline-ab")
    _device_arg(d)
    d.set_defaults(fn=bench_dfs)
    d = sub.add_parser("ec")
    d.add_argument("--mb", type=int, default=48)
    d.add_argument("--policy", default="rs-6-3-64k")
    d.add_argument("--inner", type=int, default=4,
                   help="calls in a timed pass")
    d.add_argument("--repair-ab", action="store_true",
                   help="paired repair A/B: full-gather decode vs coded "
                        "partial-sum exchange, oracle-pinned on every "
                        "erasure pattern; one JSON line")
    d.add_argument("--dns", type=int, default=5,
                   help="simulated holder count for --repair-ab")
    d.add_argument("--erasures", type=int, default=1,
                   help="stripes lost in the --repair-ab timed pattern")
    _device_arg(d)
    d.set_defaults(fn=bench_ec)
    d = sub.add_parser("reduction")
    d.add_argument("--mb", type=int, default=64)
    d.add_argument("--backend", default="auto")
    d.set_defaults(fn=bench_reduction)
    d = sub.add_parser("sort")
    d.add_argument("--tiles", type=int, default=8)
    d.add_argument("--entries", type=int, default=1 << 15)
    d.add_argument("--inner", type=int, default=8,
                   help="calls in a timed pass")
    d.add_argument("--repeats", type=int, default=5)
    d.add_argument("--interpret", action="store_true",
                   help="run the cuda leg through the plain versions "
                        "(a correctness spot-check)")
    _device_arg(d)
    d.set_defaults(fn=bench_sort)
    d = sub.add_parser("cdc")
    d.add_argument("--mb", type=int, default=16)
    d.add_argument("--inner", type=int, default=4,
                   help="calls in a timed pass")
    d.add_argument("--repeats", type=int, default=3)
    d.add_argument("--interpret", action="store_true",
                   help="run the plain versions in place of the kernels "
                        "(correctness-grade timing)")
    d.add_argument("--mask-bits", type=int, default=13,
                   help="geometry sweep: expected chunk size 2^mask_bits")
    d.add_argument("--min-size", type=int, default=2048,
                   help="geometry sweep: CDC min chunk size (bytes)")
    d.add_argument("--no-skip-ahead", dest="skip_ahead",
                   action="store_false",
                   help="the reference's walk variant alone: the "
                        "telemetry lanes read 0, as there")
    _device_arg(d)
    d.set_defaults(fn=bench_cdc)
    d = sub.add_parser("multichip")
    d.add_argument("--blocks", type=int, default=64)
    # Defaults are the dispatch-bound geometry (2 KiB blocks, single-SHA
    # -leg chunks): per-shard compute is as thin as the kernels allow, so
    # the curve isolates what widening the mesh buys per step.
    d.add_argument("--block-kb", type=int, default=2)
    d.add_argument("--lanes", type=int, default=1,
                   help="per-device lane capacity (blocks per device "
                        "per mesh step)")
    d.add_argument("--repeats", type=int, default=3)
    d.add_argument("--mask-bits", type=int, default=6)
    d.add_argument("--min-chunk", type=int, default=32)
    d.add_argument("--max-chunk", type=int, default=112)
    _device_arg(d)
    d.set_defaults(fn=bench_multichip)
    d = sub.add_parser("recon")
    d.add_argument("--mb", type=int, default=64)
    d.add_argument("--repeats", type=int, default=3)
    d.add_argument("--chunk-kb", type=int, default=0,
                   help="target avg chunk KiB (0 = config default ~8)")
    _device_arg(d)
    d.set_defaults(fn=bench_recon)
    d = sub.add_parser("churn")
    d.add_argument("--rounds", type=int, default=6,
                   help="churn generations (one flight sample each)")
    d.add_argument("--files", type=int, default=6,
                   help="files written per generation")
    d.add_argument("--kb", type=int, default=64,
                   help="shared-tile and unique-tail size per file (KiB)")
    d.add_argument("--delete-frac", type=float, default=0.4,
                   help="fraction of the oldest live files deleted per "
                        "round")
    d.add_argument("--rewrite-frac", type=float, default=0.2,
                   help="fraction of survivors rewritten per round")
    _device_arg(d)
    d.set_defaults(fn=bench_churn)
    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

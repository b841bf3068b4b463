"""Per-tenant SLO / read-plane report over flight-recorder time series
(port of hdrf_tpu/tools/slo_report.py: the window report, ``--trend``, the
``--input FILE|DIR`` sources and ``guard()``; the default smoke runs on the
port's MiniCluster).

The read-side sibling of tools/gap_report.py (gap_report.py:1-24): where
that tool decomposes ONE run's write wall-clock, this one reads the
over-time story — the bounded gauge ring each daemon's flight recorder
keeps (utils/flight_recorder.py:1-40, served as ``/timeseries`` by
server/status_http.py:84-87 and the gateway) — and answers the operator
questions the reference leaves to external TSDBs: is read p95 regressing,
is the decoded-container cache decaying, is one tenant's load moving the
cluster (DataNodeMetrics.java:553-560 keeps windowed means; nothing in the
reference keeps the curve or flags the drift).

For every numeric gauge in the series it compares a BASELINE window (the
first ``baseline_frac`` of samples) against the CURRENT window (the last
``baseline_frac``) and flags regressions direction-aware: latency/backlog
gauges regress UP, ratio/hit-rate gauges regress DOWN, unflagged gauges
are reported but never flagged.

Sources, in order of preference:

- ``--input FILE``: a ``/timeseries`` capture (``{"samples": [...]}``),
  bench.py's single JSON output line (its ``read`` block becomes a
  one-sample series), or a bare JSON list of samples;
- ``--input DIR``: a flight-archive directory of JSONL segments
  (utils/flight_archive.py:1-40), replayed oldest-first with torn tails
  dropped — the restart-surviving long-horizon source;
- default: an in-process read-mostly MiniCluster smoke — write a tiny
  corpus once, read it repeatedly under two tenant identities, sampling
  the DN flight recorder between rounds
  (``python -m hdrf_tpu_torch.tools.slo_report``).

``--trend`` switches from window comparison to the long-horizon fit:
per-metric least-squares slope + single-changepoint detection over the
whole series, same direction tables and jitter floor.  ``guard()`` is
the programmatic hook the DataNode's adaptive-chunking tick calls after
each retune window (server/datanode.py _cdc_tick) to decide whether the
retune regressed its blast-radius gauges and must roll back.
"""

from __future__ import annotations

import argparse
import json
import sys

SMOKE_BLOCKS = 3
SMOKE_BLOCK_KB = 256
SMOKE_ROUNDS = 4

# Direction a drift must move to count as a regression.  Everything else
# is informational: flagging unknown gauges both ways would page on any
# load change.
REGRESS_UP = ("read_p95_ms", "write_p95_ms", "stalls", "breakers_open",
              "breakers_half_open", "storage_ratio", "under_replicated",
              "pending_replication", "pending_recovery", "safemode",
              "read_amplification",
              # integrity drift: garbage growth and scrub/fsck
              # corruption counts only ever regress upward
              "garbage_bytes", "scrub_corrupt_total", "fsck_violations",
              # overload plane: a shed-rate climb is the QoS
              # plane absorbing pressure — flag it before clients notice
              "sheds_total",
              # metadata plane: rolling NN RPC tail latency
              "nn_rpc_p99_ms",
              # contention observatory: namesystem-lock
              # saturation and rolling acquire-wait tail — the leading
              # indicators of a lock convoy, both one-directional
              "nn_lock_saturation", "nn_lock_wait_p99_us",
              "observer_lag_s")
REGRESS_DOWN = ("container_cache_hit_ratio", "cache_hit_ratio",
                "dedup_ratio", "datanodes_live")
# Relative drift below this never flags (jitter floor), and a baseline of
# exactly 0 only flags on a nonzero current value.
DRIFT_FRAC = 0.25


def run_smoke(rounds: int = SMOKE_ROUNDS) -> list[dict]:
    """Read-mostly MiniCluster smoke: one write pass, ``rounds`` read
    passes under two tenant identities, one deterministic flight-recorder
    sample per round (sample_once, not the wall-clock sampler thread)."""
    import random

    from hdrf_tpu_torch.testing.minicluster import MiniCluster
    from hdrf_tpu_torch.utils import profiler, tenants

    profiler.reset()
    tenants.TRACKER.reset()
    rng = random.Random(0x510)
    payloads = [bytes(rng.getrandbits(8) for _ in range(SMOKE_BLOCK_KB << 10))
                for _ in range(SMOKE_BLOCKS)]
    samples: list[dict] = []
    with MiniCluster(n_datanodes=1, replication=1) as mc:
        with mc.client("slo-writer") as c:
            for i, p in enumerate(payloads):
                c.write(f"/slo/blk{i}", p, scheme="dedup")
        dn = mc.datanodes[0]
        for r in range(rounds):
            # tenant-a reads everything each round; tenant-b only half —
            # the per-tenant counters must keep them apart
            with mc.client("tenant-a") as a, mc.client("tenant-b") as b:
                for i in range(SMOKE_BLOCKS):
                    assert a.read(f"/slo/blk{i}") == payloads[i]
                    if i % 2 == 0:
                        b.read(f"/slo/blk{i}")
            dn.flight.sample_once()
            samples.append(dn.flight.snapshot()["samples"][-1])
    return samples


def _windows(vals: list[float],
             baseline_frac: float) -> tuple[list[float], list[float]]:
    n = len(vals)
    w = max(1, int(n * baseline_frac))
    return vals[:w], vals[-w:]


def aggregate(samples: list[dict],
              baseline_frac: float = 0.25) -> dict:
    """Fold a gauge series into per-gauge baseline/current rows with
    direction-aware regression flags.  Deterministic: rows sort by gauge
    name, windows are positional."""
    series: dict[str, list[float]] = {}
    for s in samples:
        for k, v in s.items():
            if k in ("t", "mono") or not isinstance(v, (int, float)):
                continue
            series.setdefault(k, []).append(float(v))
    rows = []
    regressions = []
    for name in sorted(series):
        vals = series[name]
        base_w, cur_w = _windows(vals, baseline_frac)
        base = sum(base_w) / len(base_w)
        cur = sum(cur_w) / len(cur_w)
        delta = cur - base
        rel = (delta / abs(base)) if base else (1.0 if delta else 0.0)
        direction = ("up" if name in REGRESS_UP
                     else "down" if name in REGRESS_DOWN else "none")
        regressed = bool(
            (direction == "up" and delta > 0 and rel > DRIFT_FRAC)
            or (direction == "down" and delta < 0 and -rel > DRIFT_FRAC))
        row = {"gauge": name, "baseline": base, "current": cur,
               "min": min(vals), "max": max(vals), "last": vals[-1],
               "rel_change": rel, "direction": direction,
               "regressed": regressed}
        rows.append(row)
        if regressed:
            regressions.append(name)
    return {"samples": len(samples), "baseline_frac": baseline_frac,
            "gauges": rows, "regressions": regressions,
            "verdict": "REGRESSED" if regressions else "OK"}


def format_table(agg: dict) -> str:
    """Deterministic text rendering (golden-tested)."""
    out = [f"slo report: {agg['samples']} samples, baseline window = "
           f"first/last {agg['baseline_frac'] * 100.0:.0f}%",
           f"verdict: {agg['verdict']}"
           + (f" ({', '.join(agg['regressions'])})"
              if agg["regressions"] else ""),
           "",
           f"{'gauge':<28} {'baseline':>10} {'current':>10} "
           f"{'drift':>8} {'flag':>5}"]
    for r in agg["gauges"]:
        flag = "REGR" if r["regressed"] else "-"
        out.append(f"{r['gauge']:<28} {r['baseline']:>10.3f} "
                   f"{r['current']:>10.3f} {r['rel_change'] * 100.0:>7.1f}% "
                   f"{flag:>5}")
    return "\n".join(out)


def slope(vals: list[float]) -> float:
    """Least-squares slope of a series over its sample index (per-sample
    units) — the long-horizon fit bench_churn and trend mode report."""
    n = len(vals)
    if n < 2:
        return 0.0
    xm = (n - 1) / 2.0
    ym = sum(vals) / n
    num = sum((i - xm) * (v - ym) for i, v in enumerate(vals))
    den = sum((i - xm) ** 2 for i in range(n))
    return num / den if den else 0.0


def _sse(vals: list[float]) -> float:
    if not vals:
        return 0.0
    m = sum(vals) / len(vals)
    return sum((v - m) ** 2 for v in vals)


def changepoint(vals: list[float]) -> dict | None:
    """Single-changepoint detection: the split index minimizing the summed
    squared error of a two-segment piecewise-constant fit (the simplest
    offline CUSUM-family estimator — deterministic, O(n^2), fine for
    flight-ring-sized series).  Returns ``{"index", "before", "after",
    "gain"}`` or None when the series is too short (< 4 samples)."""
    n = len(vals)
    if n < 4:
        return None
    total = _sse(vals)
    best_k, best_sse = None, total
    for k in range(1, n):
        s = _sse(vals[:k]) + _sse(vals[k:])
        if s < best_sse:
            best_k, best_sse = k, s
    if best_k is None:
        return None
    before = sum(vals[:best_k]) / best_k
    after = sum(vals[best_k:]) / (n - best_k)
    return {"index": best_k, "before": before, "after": after,
            "gain": total - best_sse}


def trend(samples: list[dict], jitter_frac: float = DRIFT_FRAC) -> dict:
    """Long-horizon trend report over an archived series: per-metric
    least-squares slope plus changepoint detection, regressions flagged
    direction-aware (the REGRESS_UP/REGRESS_DOWN tables) once the fitted
    total drift — or the changepoint's mean shift — clears the same 25%
    jitter floor ``aggregate`` uses.  A flat series never flags; an
    injected step or ramp deterministically does."""
    series: dict[str, list[float]] = {}
    for s in samples:
        for k, v in s.items():
            if k in ("t", "mono") or not isinstance(v, (int, float)):
                continue
            series.setdefault(k, []).append(float(v))
    rows = []
    regressions = []
    for name in sorted(series):
        vals = series[name]
        sl = slope(vals)
        total_drift = sl * (len(vals) - 1)
        base_w, _ = _windows(vals, DRIFT_FRAC)
        base = sum(base_w) / len(base_w)
        rel = ((total_drift / abs(base)) if base
               else (1.0 if total_drift else 0.0))
        cp = changepoint(vals)
        cp_rel = 0.0
        if cp is not None:
            shift = cp["after"] - cp["before"]
            cp_rel = ((shift / abs(cp["before"])) if cp["before"]
                      else (1.0 if shift else 0.0))
        direction = ("up" if name in REGRESS_UP
                     else "down" if name in REGRESS_DOWN else "none")
        regressed = bool(
            (direction == "up"
             and max(rel, cp_rel) > jitter_frac)
            or (direction == "down"
                and min(rel, cp_rel) < -jitter_frac))
        row = {"metric": name, "first": vals[0], "last": vals[-1],
               "slope": sl, "total_drift": total_drift,
               "rel_drift": rel, "changepoint": cp,
               "changepoint_rel": cp_rel, "direction": direction,
               "regressed": regressed}
        rows.append(row)
        if regressed:
            regressions.append(name)
    return {"samples": len(samples), "jitter_frac": jitter_frac,
            "metrics": rows, "regressions": regressions,
            "verdict": "REGRESSED" if regressions else "OK"}


def format_trend_table(tr: dict) -> str:
    """Deterministic text rendering of a trend report (golden-tested)."""
    out = [f"slo trend: {tr['samples']} samples, jitter floor = "
           f"{tr['jitter_frac'] * 100.0:.0f}%",
           f"verdict: {tr['verdict']}"
           + (f" ({', '.join(tr['regressions'])})"
              if tr["regressions"] else ""),
           "",
           f"{'metric':<28} {'first':>10} {'last':>10} "
           f"{'slope':>10} {'cp':>4} {'flag':>5}"]
    for r in tr["metrics"]:
        flag = "REGR" if r["regressed"] else "-"
        cp = str(r["changepoint"]["index"]) if r["changepoint"] else "-"
        out.append(f"{r['metric']:<28} {r['first']:>10.3f} "
                   f"{r['last']:>10.3f} {r['slope']:>10.4f} {cp:>4} "
                   f"{flag:>5}")
    return "\n".join(out)


def guard(baseline_samples: list[dict], current_samples: list[dict],
          gauges: tuple | None = None,
          jitter_frac: float = DRIFT_FRAC) -> dict:
    """Retune regression guard (ROADMAP item 5; called from the DN's
    _cdc_tick after each retune window): compare the pre-change window's
    gauge means against the post-change window's, direction-aware with
    the same jitter floor — ``regressed`` means the change made a flagged
    gauge measurably worse and should be rolled back.  ``gauges`` narrows
    the comparison to the metrics the change can plausibly move (the
    caller's blast radius), so unrelated cluster noise cannot veto it."""
    def _means(samples):
        acc: dict[str, list[float]] = {}
        for s in samples:
            for k, v in s.items():
                if k in ("t", "mono") or not isinstance(v, (int, float)):
                    continue
                if gauges is not None and k not in gauges:
                    continue
                acc.setdefault(k, []).append(float(v))
        return {k: sum(v) / len(v) for k, v in acc.items()}

    base = _means(baseline_samples)
    cur = _means(current_samples)
    rows = []
    regressed_any = False
    for name in sorted(set(base) & set(cur)):
        b, c = base[name], cur[name]
        delta = c - b
        rel = (delta / abs(b)) if b else (1.0 if delta else 0.0)
        direction = ("up" if name in REGRESS_UP
                     else "down" if name in REGRESS_DOWN else "none")
        regressed = bool(
            (direction == "up" and delta > 0 and rel > jitter_frac)
            or (direction == "down" and delta < 0 and -rel > jitter_frac))
        rows.append({"metric": name, "baseline": b, "current": c,
                     "rel_change": rel, "direction": direction,
                     "regressed": regressed})
        regressed_any = regressed_any or regressed
    return {"regressed": regressed_any, "rows": rows}


def _load_samples(doc) -> list[dict]:
    """Accept the three documented input shapes (mirrors gap_report.py's
    --input leniency, gap_report.py:138-147): a /timeseries capture, the
    bench.py JSON line (its ``read`` block as a one-sample series), or a
    bare sample list."""
    if isinstance(doc, list):
        return doc
    if isinstance(doc, dict):
        if isinstance(doc.get("samples"), list):
            return doc["samples"]
        if isinstance(doc.get("read"), dict):
            return [doc["read"]]
        return [doc]
    raise ValueError("unrecognized slo_report input shape")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="hdrf_tpu_torch.tools.slo_report",
        description="Read-plane / per-tenant SLO drift report over "
                    "flight-recorder time series")
    p.add_argument("--input", help="JSON file (a /timeseries capture, "
                   "bench JSON line, or bare sample list) OR a flight-"
                   "archive directory of JSONL segments, replayed torn-"
                   "tail-tolerantly (default: run a read-mostly "
                   "MiniCluster smoke)")
    p.add_argument("--rounds", type=int, default=SMOKE_ROUNDS,
                   help="smoke-mode read rounds")
    p.add_argument("--baseline-frac", type=float, default=0.25,
                   help="fraction of samples in each comparison window")
    p.add_argument("--trend", action="store_true",
                   help="long-horizon mode: per-metric slope fit + "
                        "changepoint detection instead of the window "
                        "comparison")
    p.add_argument("--json", action="store_true",
                   help="emit the aggregate as JSON instead of the table")
    args = p.parse_args(argv)
    if args.input:
        import os

        if os.path.isdir(args.input):
            from hdrf_tpu_torch.utils import flight_archive

            samples = flight_archive.replay_dir(args.input)
        else:
            with open(args.input) as f:
                samples = _load_samples(json.load(f))
    else:
        samples = run_smoke(rounds=args.rounds)
    if args.trend:
        tr = trend(samples)
        print(json.dumps(tr) if args.json else format_trend_table(tr))
        return 0
    agg = aggregate(samples, baseline_frac=args.baseline_frac)
    if args.json:
        print(json.dumps(agg))
    else:
        print(format_table(agg))
    return 0


if __name__ == "__main__":
    sys.exit(main())

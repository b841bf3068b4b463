"""Decayed rolling windows for health telemetry (port of
hdrf_tpu/utils/rollwin.py: ``RollingWindow``, ``P2Quantile``, ``WindowMap``;
the admission controller's service estimator reads them).

Re-expresses the windowing half of the reference daemons' health trackers:
HDFS's SlowPeerTracker.java:56 keeps per-peer latency reports in rolling
report windows that age out stale observations, and SlowDiskTracker rides
the same shape over per-volume IO latencies (DataNodeVolumeMetrics).  Here
one structure serves both: a bounded sample window whose entries expire
after ``window_s`` seconds, summarized as median/mean/max/count, with a
nearest-rank ``quantiles()`` surface (p50/p95/p99 for the per-tenant SLO
gauges).  (The reference's ``P2Quantile`` streaming estimator has no
caller in the port yet.)

Deterministic by construction — the clock is injectable (tests drive
``now=``), expiry happens on access (no background thread), and the
summary is a pure function of the surviving samples.  The DataNode keeps
one ``WindowMap`` per telemetry family (peers, volumes) and ships the
summaries in its heartbeat payload (server/datanode.py) — the compact
SlowPeerReports analog the NameNode's outlier detector consumes
(utils/outlier.py).
"""

from __future__ import annotations

import statistics
import threading
import time
from collections import deque


class RollingWindow:
    """Bounded, time-decayed sample window.

    Samples older than ``window_s`` are pruned on access; at most
    ``maxlen`` samples are retained (oldest dropped first) so a hot
    observation point cannot grow the window without bound between
    heartbeats."""

    __slots__ = ("window_s", "maxlen", "_clock", "_samples")

    def __init__(self, window_s: float = 300.0, maxlen: int = 64,
                 clock=time.monotonic):
        self.window_s = window_s
        self.maxlen = maxlen
        self._clock = clock
        self._samples: deque[tuple[float, float]] = deque(maxlen=maxlen)

    def add(self, value: float, now: float | None = None) -> None:
        t = self._clock() if now is None else now
        self._samples.append((t, float(value)))

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    def values(self, now: float | None = None) -> list[float]:
        t = self._clock() if now is None else now
        self._prune(t)
        return [v for _, v in self._samples]

    def summary(self, now: float | None = None) -> dict | None:
        """{"median","mean","max","p95","count"} over live samples, or None
        when every sample has decayed out.  p95 is the nearest-rank upper
        quantile — the hedged mirror legs' trigger statistic (a pure
        function of the surviving samples, so deterministic under an
        injected clock like the rest of the summary)."""
        vs = self.values(now)
        if not vs:
            return None
        ranked = sorted(vs)
        # nearest-rank: ceil(0.95 * n) - 1, clamped to the last sample
        p95 = ranked[min(len(ranked) - 1, max(0, -(-len(ranked) * 95 // 100) - 1))]
        return {"median": statistics.median(vs),
                "mean": sum(vs) / len(vs),
                "max": max(vs),
                "p95": p95,
                "count": len(vs)}

    def quantiles(self, pcts: tuple[int, ...] = (50, 95, 99),
                  now: float | None = None) -> dict | None:
        """{"p50","p95","p99",...} over live samples by the same
        nearest-rank rule ``summary()`` uses for p95 (so ``quantiles((95,))
        == {"p95": summary()["p95"]}`` by construction), or None when the
        window is empty.  Memory stays bounded by ``maxlen`` — this is the
        rolling per-tenant p50/p95/p99 surface; for unbounded cumulative
        streams use :class:`P2Quantile` instead."""
        vs = self.values(now)
        if not vs:
            return None
        ranked = sorted(vs)
        n = len(ranked)
        return {f"p{p}": ranked[min(n - 1, max(0, -(-n * p // 100) - 1))]
                for p in pcts}


class WindowMap:
    """Keyed RollingWindows sharing one parameter set — the per-peer /
    per-volume maps the DataNode aggregates heartbeat summaries from.
    Thread-safe: observation points (xceiver threads, the volume checker)
    and the heartbeat loop touch it concurrently."""

    def __init__(self, window_s: float = 300.0, maxlen: int = 64,
                 clock=time.monotonic):
        self.window_s = window_s
        self.maxlen = maxlen
        self._clock = clock
        self._lock = threading.Lock()
        self._wins: dict = {}

    def note(self, key, value: float, now: float | None = None) -> None:
        with self._lock:
            w = self._wins.get(key)
            if w is None:
                w = self._wins[key] = RollingWindow(
                    self.window_s, self.maxlen, self._clock)
            w.add(value, now=now)

    def summaries(self, now: float | None = None) -> dict:
        """key -> summary dict for every key with live samples; fully
        decayed keys are dropped from the map (a peer that stopped being
        written to ages out of the reports, SlowPeerTracker semantics)."""
        out = {}
        with self._lock:
            for key in list(self._wins):
                s = self._wins[key].summary(now)
                if s is None:
                    del self._wins[key]
                else:
                    out[key] = s
        return out

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
gauges) and a five-marker P² streaming estimator (:class:`P2Quantile`)
for cumulative series where even ``maxlen`` samples is too much state.

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


class P2Quantile:
    """Bounded-memory streaming quantile estimator (the P² algorithm,
    Jain & Chlamtac 1985): five markers tracked in O(1) memory regardless
    of stream length — the cumulative-series complement to the decayed
    window's exact nearest-rank.  Exact (nearest-rank) below five samples;
    marker-interpolated above.  Deterministic: a pure function of the
    observation sequence, no clock involved."""

    __slots__ = ("q", "_h", "_n", "_ns", "_dns", "count")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1): {q}")
        self.q = q
        self.count = 0
        self._h: list[float] = []       # marker heights (first 5: raw samples)
        self._n = [0.0, 1.0, 2.0, 3.0, 4.0]            # actual positions
        self._ns = [0.0, 2 * q, 4 * q, 2 + 2 * q, 4.0]  # desired positions
        self._dns = [0.0, q / 2, q, (1 + q) / 2, 1.0]   # desired increments

    def add(self, x: float) -> None:
        self.count += 1
        h = self._h
        if len(h) < 5:
            h.append(float(x))
            h.sort()
            return
        n, ns, dns = self._n, self._ns, self._dns
        if x < h[0]:
            h[0] = float(x)
            k = 0
        elif x >= h[4]:
            h[4] = float(x)
            k = 3
        else:
            k = 3
            for i in range(1, 5):
                if x < h[i]:
                    k = i - 1
                    break
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            ns[i] += dns[i]
        for i in range(1, 4):
            d = ns[i] - n[i]
            if ((d >= 1.0 and n[i + 1] - n[i] > 1.0)
                    or (d <= -1.0 and n[i - 1] - n[i] < -1.0)):
                s = 1.0 if d > 0 else -1.0
                hp = self._parabolic(i, s)
                if not h[i - 1] < hp < h[i + 1]:
                    # parabolic prediction left the bracket: linear fallback
                    j = i + int(s)
                    hp = h[i] + s * (h[j] - h[i]) / (n[j] - n[i])
                h[i] = hp
                n[i] += s

    def _parabolic(self, i: int, s: float) -> float:
        h, n = self._h, self._n
        return h[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (h[i] - h[i - 1]) / (n[i] - n[i - 1]))

    def value(self) -> float:
        """Current estimate; nearest-rank over the raw samples while fewer
        than five have arrived, 0.0 for an empty stream."""
        h = self._h
        if not h:
            return 0.0
        if len(h) < 5:
            k = len(h)
            return h[min(k - 1, max(0, -(-k * int(self.q * 100) // 100) - 1))]
        return self._h[2]


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

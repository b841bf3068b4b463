"""Metrics registry (port of hdrf_tpu/utils/metrics.py: ``Histogram``
metrics.py:17, ``MetricsRegistry`` :73, ``registry`` :129).

Named counters, gauges and histograms on a process-wide registry,
snapshot-able as a dict — what the worker, the device ledger and the
scheme layer (index, containers, read plane, reconstructor) stamp into.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Any


class Histogram:
    """Fixed-bucket latency/size histogram with mean/max tracking."""

    __slots__ = ("count", "total", "max", "_buckets")

    # Power-of-2 bucket upper bounds (microseconds or bytes, caller's choice).
    BOUNDS = tuple(2 ** i for i in range(32))

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._buckets = [0] * (len(self.BOUNDS) + 1)

    def update(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value > self.max:
            self.max = value
        for i, b in enumerate(self.BOUNDS):
            if value <= b:
                self._buckets[i] += 1
                return
        self._buckets[-1] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate quantile from the power-of-2 buckets (upper bound)."""
        target = q * self.count
        seen = 0
        for i, c in enumerate(self._buckets):
            seen += c
            if seen >= target:
                return float(self.BOUNDS[i]) if i < len(self.BOUNDS) else self.max
        return self.max

    def snapshot(self) -> dict[str, Any]:
        """Snapshot with CUMULATIVE bucket counts (the Prometheus histogram
        contract: each ``le`` bucket counts all observations <= the bound, and
        the implicit ``+Inf`` bucket equals ``count``).  Only bounds where the
        cumulative count increases are emitted, so 32 power-of-2 bounds don't
        bloat every snapshot; p50/p99 stay for existing JSON consumers."""
        buckets: list[list[float]] = []
        cum = 0
        for i, c in enumerate(self._buckets[:-1]):
            if c:
                cum += c
                buckets.append([float(self.BOUNDS[i]), cum])
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "max": self.max, "p50": self.quantile(0.50),
                "p99": self.quantile(0.99), "buckets": buckets}


class MetricsRegistry:
    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        self._counters: dict[str, int] = defaultdict(int)
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, Histogram] = {}

    def incr(self, key: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[key] += delta

    def gauge(self, key: str, value: float) -> None:
        with self._lock:
            self._gauges[key] = value

    def observe(self, key: str, value: float) -> None:
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram()
            h.update(value)

    def time(self, key: str) -> "_Timer":
        return _Timer(self, key)

    def counter(self, key: str) -> int:
        with self._lock:
            return self._counters[key]

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "name": self.name,
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.snapshot() for k, h in self._histograms.items()},
            }


class _Timer:
    def __init__(self, reg: MetricsRegistry, key: str) -> None:
        self._reg, self._key = reg, key

    def __enter__(self) -> "_Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._reg.observe(self._key, (time.perf_counter() - self._t0) * 1e6)


_registries: dict[str, MetricsRegistry] = {}
_registries_lock = threading.Lock()


def registry(name: str) -> MetricsRegistry:
    with _registries_lock:
        reg = _registries.get(name)
        if reg is None:
            reg = _registries[name] = MetricsRegistry(name)
        return reg


def all_snapshots() -> dict[str, Any]:
    with _registries_lock:
        regs = list(_registries.values())
    return {r.name: r.snapshot() for r in regs}

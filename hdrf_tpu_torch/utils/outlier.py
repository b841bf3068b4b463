"""Median + MAD outlier detection for slow-peer / slow-volume flagging
(port of hdrf_tpu/utils/outlier.py, whole).

Re-expresses HDFS's OutlierDetector.java:61-103 (used by SlowPeerTracker
and SlowDiskTracker): given one latency statistic per resource, compute the
population median and the median absolute deviation, and flag resources
whose value exceeds ``max(median * min_ratio, median + k * MAD)`` — the
reference's ``upperLimit = max(median * DEVIATION_MULTIPLIER, median +
mad * DEVIATION_MULTIPLIER)`` with its ``minOutlierDetectionNodes``
population guard and ``lowThresholdMs`` absolute guard.  Straggler
flagging over reported latencies is the outlier-mitigation primitive the
coded-computing literature builds on (arXiv:1805.01993 §I).

Deterministic: pure functions of the input mapping, no wall clock.  The
stateful ``OutlierTracker`` adds flag timestamps with an injectable clock
so callers (server/namenode.py) can expose "currently flagged" gauges
without hidden time dependencies.

Degenerate windows are first-class: with MAD == 0 (all values equal, the
common all-healthy case) the threshold collapses to ``median * min_ratio``,
so a planted straggler still flags and a uniform population never does.
"""

from __future__ import annotations

import statistics
import time

# Consistency constant: scaled MAD estimates the standard deviation for
# normally distributed data (the reference's MAD_MULTIPLIER = 1.4826).
MAD_SCALE = 1.4826


def mad(values: list[float], med: float | None = None) -> float:
    """Scaled median absolute deviation; 0.0 for empty input."""
    if not values:
        return 0.0
    m = statistics.median(values) if med is None else med
    return MAD_SCALE * statistics.median([abs(v - m) for v in values])


def detect(values: dict, *, k: float = 3.0, min_ratio: float = 3.0,
           min_points: int = 3, floor: float = 0.0,
           abs_floor: float | None = None) -> dict:
    """Flag outliers in ``values`` (resource -> latency statistic).

    Two rules, mirroring the reference pair:

    - **MAD rule** (needs >= ``min_points`` resources): flag values above
      ``max(median * min_ratio, median + k * MAD)``; values must also
      exceed ``floor`` (the lowThreshold guard — a 'slow' peer in a
      uniformly sub-millisecond population is not actionable).
    - **absolute rule** (any population size): when ``abs_floor`` is set,
      a value above it is pathological regardless of the population —
      the no-baseline case (tiny cluster, skewed placement) where the
      MAD rule has nothing to compare against.

    Returns {resource: {"value", "median", "mad", "upper", "rule"}}, empty
    when nothing flags.  Deterministic: no clock, no randomness.
    """
    out: dict = {}
    vs = [float(v) for v in values.values()]
    med = statistics.median(vs) if vs else 0.0
    spread = mad(vs, med)
    upper = max(med * min_ratio, med + k * spread)
    for key, v in values.items():
        v = float(v)
        rule = None
        if len(vs) >= min_points and v > upper and v > floor:
            rule = "mad"
        elif abs_floor is not None and v > abs_floor:
            rule = "absolute"
        if rule:
            out[key] = {"value": v, "median": med, "mad": spread,
                        "upper": upper, "rule": rule}
    return out


class OutlierTracker:
    """detect() plus flag bookkeeping: remembers when each resource was
    last flagged and expires stale flags after ``expiry_s`` without a
    re-flag — so a gauge built on ``report()`` recovers once the slow
    resource heals instead of latching forever.  Clock injectable for
    deterministic tests."""

    def __init__(self, expiry_s: float = 300.0, clock=time.monotonic,
                 **detect_kw):
        self.expiry_s = expiry_s
        self._clock = clock
        self._detect_kw = detect_kw
        self._flags: dict = {}   # resource -> {"since", "last", **detail}

    def observe(self, values: dict, now: float | None = None) -> dict:
        """Run detection over a fresh snapshot and fold into the flag set.
        Returns the currently flagged resources (same shape as report())."""
        t = self._clock() if now is None else now
        for key, detail in detect(values, **self._detect_kw).items():
            prev = self._flags.get(key)
            self._flags[key] = {**detail,
                                "since": prev["since"] if prev else t,
                                "last": t}
        return self.report(now=t)

    def report(self, now: float | None = None) -> dict:
        t = self._clock() if now is None else now
        for key in [k for k, f in self._flags.items()
                    if t - f["last"] > self.expiry_s]:
            del self._flags[key]
        return {k: dict(f) for k, f in self._flags.items()}

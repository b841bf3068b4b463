"""Bandwidth throttling for background transfers (port of
hdrf_tpu/utils/throttler.py; util/DataTransferThrottler.java:28 analog,
used by BlockSender's balancer and re-replication legs in the reference).

Token bucket: ``throttle(n)`` blocks until ``n`` bytes of budget exist.
Budget accrues at ``bytes_per_s`` and is capped at one period's worth
(burst = period * rate, period 500 ms like the reference), so an idle
throttler doesn't bank unlimited credit.  Rate 0 disables (no locking on
the fast path).  ``set_rate`` applies live — the
``dfsadmin -setBalancerBandwidth`` path."""

from __future__ import annotations

import threading
import time

PERIOD_S = 0.5


class Throttler:
    def __init__(self, bytes_per_s: float = 0):
        self._rate = float(bytes_per_s)
        self._lock = threading.Lock()
        self._budget = 0.0
        self._last = time.monotonic()
        self.throttled_bytes = 0   # observability: bytes gated so far

    @property
    def rate(self) -> float:
        return self._rate

    def set_rate(self, bytes_per_s: float) -> None:
        self._rate = float(bytes_per_s)

    def throttle(self, nbytes: int) -> None:
        rate = self._rate
        if rate <= 0 or nbytes <= 0:
            return
        with self._lock:
            self.throttled_bytes += nbytes
            while True:
                now = time.monotonic()
                self._budget = min(self._budget + (now - self._last) * rate,
                                   rate * PERIOD_S)
                self._last = now
                if self._budget >= nbytes or self._budget >= rate * PERIOD_S:
                    # a request larger than the whole burst window passes
                    # once the bucket is full (it still paid the wait) —
                    # the reference caps the same way
                    self._budget -= nbytes
                    return
                need = (nbytes - self._budget) / rate
                time.sleep(min(need, PERIOD_S))

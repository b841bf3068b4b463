"""Instrumented namesystem lock: per-method wait/hold attribution (port of
hdrf_tpu/utils/lockprof.py, whole: ``InstrumentedRLock``, ``bind_request``
and the request context in a ``contextvars`` variable).

The reference wraps its global FSNamesystem lock in a dedicated
instrumented type (FSNamesystemLock.java:60) that stamps every
acquire/release pair with hold time, logs a stack trace when a writer
holds past ``dfs.namenode.write-lock-reporting-threshold-ms``
(FSNamesystemLock.java:252-267) and feeds per-operation read/write hold
metrics keyed by the RPC op name (FSNamesystemLock.java:160 ``
addMetric``).  This module re-expresses that plane for the single
``RLock`` our NameNode uses (server/namenode.py:269 — "the FSNamesystem
lock analog"):

- :class:`InstrumentedRLock` is a drop-in ``with``-compatible RLock.
  Every OUTERMOST acquire records wait (entry -> lock granted) and hold
  (granted -> final release) seconds, attributed to the ambient RPC
  method (:func:`bind_request`, a contextvar the RPC server stamps in
  dispatch — the same side-channel ride as ``_trace``,
  proto/rpc.py:138).  Reentrant acquires ride the owner fast path: one
  attribute compare, no clock reads, no books (counted once, like the
  reference's read-lock reentrancy counting, FSNamesystemLock.java:125).
- Cumulative books and the rolling p50/p95/p99 windows
  (utils/rollwin.py) are mutated while the caller still HOLDS the inner
  lock, so the lock itself serializes them — no secondary mutex can ever
  block an acquirer (the "no extra blocking" contract the overhead
  guard test pins).  Registry emission (``nn_lock_wait_us|method=`` /
  ``nn_lock_hold_us|method=`` histograms) happens AFTER release.
- ``saturation()`` = fraction of the trailing window the lock was held,
  from a bounded ring of ``(t0, t1)`` hold intervals — the
  ``nn_lock_saturation`` gauge, exact under an injected clock.
- A hold past ``long_hold_s`` captures the holder's stack into a bounded
  ring and fires the ``lockprof.long_hold`` fault point (the
  writeLockReport analog); ``holder()`` exposes the live owner
  (thread id, method, held-for) for the watchdog's convoy capture.

Readers (flight sampler, ``/contention``) take NO lock: they snapshot
the deques/dicts with a retry-on-RuntimeError loop and tolerate the
bounded raciness — observability must never queue behind the very lock
it measures.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import traceback
from collections import deque
from typing import Any, Iterator

from . import fault_injection, rollwin


class RequestContext:
    """Ambient request identity + span sink for one RPC dispatch."""

    __slots__ = ("method", "spans")

    def __init__(self, method: str, spans: list | None = None) -> None:
        self.method = method
        self.spans = spans if spans is not None else []


_request: contextvars.ContextVar[RequestContext | None] = \
    contextvars.ContextVar("hdrf_rpc_request", default=None)


def current_request() -> RequestContext | None:
    return _request.get()


def current_method() -> str | None:
    ctx = _request.get()
    return None if ctx is None else ctx.method


@contextlib.contextmanager
def bind_request(method: str,
                 spans: list | None = None) -> Iterator[RequestContext]:
    """Stamp the ambient RPC method for the dispatch window.  The lock's
    wait/hold books attribute to it, and ``lock_wait`` / ``locked`` spans
    land in ``spans`` for the server's service-time decomposition."""
    ctx = RequestContext(method, spans)
    tok = _request.set(ctx)
    try:
        yield ctx
    finally:
        _request.reset(tok)


def _snapshot(seq):
    """Copy a deque/dict being mutated by the holder thread; retry the
    rare mid-resize RuntimeError instead of taking any lock."""
    while True:
        try:
            return list(seq)
        except RuntimeError:
            continue


class InstrumentedRLock:
    """Drop-in ``threading.RLock`` with wait/hold/saturation books."""

    _LONG_RING = 32
    _HOLD_RING = 4096

    def __init__(self, name: str = "lock", registry=None,
                 clock=time.perf_counter, long_hold_s: float = 0.5,
                 window_s: float = 300.0, maxlen: int = 512,
                 sat_window_s: float = 60.0) -> None:
        self.name = name
        self.long_hold_s = long_hold_s
        self.sat_window_s = sat_window_s
        self._inner = threading.RLock()
        self._clock = clock
        self._reg = registry
        self._epoch = clock()
        # Owner state: written only by the holder (serialized by the lock).
        self._owner = 0
        self._depth = 0
        self._hold_t0 = 0.0
        self._owner_method: str | None = None
        self._pending_wait = 0.0
        # Cumulative books + rolling windows, mutated under the lock.
        self._acquires = 0
        self._wait_total_s = 0.0
        self._hold_total_s = 0.0
        self._by_method: dict[str | None, list] = {}  # m -> [acq, wait, hold]
        self._wait_win = rollwin.RollingWindow(window_s, maxlen, clock=clock)
        self._hold_win = rollwin.RollingWindow(window_s, maxlen, clock=clock)
        self._hold_win_by_method: dict[str | None, rollwin.RollingWindow] = {}
        self._holds: deque[tuple[float, float]] = deque(maxlen=self._HOLD_RING)
        self._long_holds: deque[dict[str, Any]] = deque(maxlen=self._LONG_RING)

    # ------------------------------------------------------------- lock API

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:  # reentrant: cannot block, skip the books
            self._inner.acquire()
            self._depth += 1
            return True
        t0 = self._clock()
        if not self._inner.acquire(blocking, timeout):
            return False
        t1 = self._clock()
        wait = t1 - t0
        self._owner = me
        self._depth = 1
        self._hold_t0 = t1
        self._pending_wait = wait
        ctx = _request.get()
        m = self._owner_method = None if ctx is None else ctx.method
        # Books under the lock we just took — serialized by construction.
        self._acquires += 1
        self._wait_total_s += wait
        rec = self._by_method.get(m)
        if rec is None:
            rec = self._by_method[m] = [0, 0.0, 0.0]
        rec[0] += 1
        rec[1] += wait
        self._wait_win.add(wait * 1e6, now=t1)
        if ctx is not None and ctx.spans is not None:
            ctx.spans.append(("lock_wait", t0, t1))
        return True

    def release(self) -> None:
        me = threading.get_ident()
        if self._owner != me or self._depth > 1:
            if self._owner == me:
                self._depth -= 1
            self._inner.release()  # raises for non-owners, like RLock
            return
        t1 = self._clock()
        hold_t0, m = self._hold_t0, self._owner_method
        hold = t1 - hold_t0
        wait = self._pending_wait
        # Final-release books, still under the lock.
        self._hold_total_s += hold
        rec = self._by_method.get(m)
        if rec is not None:
            rec[2] += hold
        win = self._hold_win_by_method.get(m)
        if win is None:
            win = self._hold_win_by_method[m] = rollwin.RollingWindow(
                self._wait_win.window_s, self._wait_win.maxlen,
                clock=self._clock)
        win.add(hold * 1e6, now=t1)
        self._hold_win.add(hold * 1e6, now=t1)
        self._holds.append((hold_t0, t1))
        cutoff = t1 - self.sat_window_s
        while self._holds and self._holds[0][1] < cutoff:
            self._holds.popleft()
        long_hold = hold >= self.long_hold_s
        if long_hold:  # slow path by definition — allocation is fine here
            self._long_holds.append({
                "ts": time.time(), "method": m, "hold_s": round(hold, 6),
                "stack": traceback.format_stack()})
        ctx = _request.get()
        if ctx is not None and ctx.spans is not None:
            ctx.spans.append(("locked", hold_t0, t1))
        self._owner = 0
        self._depth = 0
        self._owner_method = None
        self._inner.release()
        # Emission AFTER release: the registry mutex never extends a hold.
        if self._reg is not None:
            lbl = m or "other"
            self._reg.observe(f"nn_lock_wait_us|method={lbl}", wait * 1e6)
            self._reg.observe(f"nn_lock_hold_us|method={lbl}", hold * 1e6)
            if long_hold:
                self._reg.incr("nn_lock_long_holds")
        if long_hold:
            fault_injection.point("lockprof.long_hold", lock=self.name,
                                  method=m, hold_s=hold)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    # ---------------------------------------------------------- introspection

    def holder(self) -> dict[str, Any] | None:
        """Live owner (thread id, ambient method, held-for seconds), or
        None.  Racy by design — the watchdog's convoy probe must never
        queue behind the lock it is diagnosing."""
        owner = self._owner
        if not owner:
            return None
        return {"thread": owner, "method": self._owner_method,
                "held_for_s": max(0.0, self._clock() - self._hold_t0)}

    def saturation(self, now: float | None = None) -> float:
        """Fraction of the trailing ``sat_window_s`` the lock was held
        (hold-interval overlap + any in-progress hold, clamped to [0, 1];
        the window shrinks to the lock's age early in life so the
        fraction is exact from the first sample)."""
        t = self._clock() if now is None else now
        wall = min(self.sat_window_s, t - self._epoch)
        if wall <= 0:
            return 0.0
        w0 = t - self.sat_window_s
        held = 0.0
        in_progress = self._hold_t0 if self._owner else None
        for a, b in _snapshot(self._holds):
            if in_progress is not None and a == in_progress:
                in_progress = None  # raced with release: interval now rung
            held += max(0.0, min(b, t) - max(a, w0))
        if in_progress is not None:
            held += max(0.0, t - max(in_progress, w0))
        v = min(1.0, held / wall)
        if self._reg is not None:
            self._reg.gauge("nn_lock_saturation", v)
        return v

    def wait_p99_us(self, now: float | None = None) -> float:
        q = self._wait_win.quantiles((99,), now=now)
        return (q or {}).get("p99", 0.0)

    def top_methods(self, n: int = 3) -> list[tuple[str, float]]:
        """Top-``n`` methods by cumulative hold seconds with their rolling
        hold p99 (µs) — the flight sample's per-method lock axis."""
        items = sorted(((m, rec[2]) for m, rec in
                        _snapshot(self._by_method.items())),
                       key=lambda kv: kv[1], reverse=True)[:n]
        out = []
        for m, _hold in items:
            win = self._hold_win_by_method.get(m)
            q = win.quantiles((99,)) if win is not None else None
            out.append((m or "other", (q or {}).get("p99", 0.0)))
        return out

    def contention_summary(self, now: float | None = None) -> dict[str, Any]:
        """JSON-safe contention books: cumulative + rolling + per-method
        table with hold shares — the ``/contention`` lock block."""
        total_hold = self._hold_total_s
        by: dict[str, Any] = {}
        for m, rec in _snapshot(self._by_method.items()):
            acq, wait_s, hold_s = rec[0], rec[1], rec[2]
            win = self._hold_win_by_method.get(m)
            q = win.quantiles((99,), now=now) if win is not None else None
            by[m or "other"] = {
                "acquires": acq,
                "wait_s": round(wait_s, 6),
                "hold_s": round(hold_s, 6),
                "hold_share": hold_s / total_hold if total_hold > 0 else 0.0,
                "hold_p99_us": (q or {}).get("p99", 0.0),
            }
        return {
            "name": self.name,
            "acquires": self._acquires,
            "wait_s": round(self._wait_total_s, 6),
            "hold_s": round(total_hold, 6),
            "saturation": self.saturation(now=now),
            "wait_us": self._wait_win.quantiles((50, 95, 99), now=now) or {},
            "hold_us": self._hold_win.quantiles((50, 95, 99), now=now) or {},
            "by_method": by,
            "long_holds": list(self._long_holds),
        }

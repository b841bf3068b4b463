"""Stall watchdog: flags in-flight operations that exceed their budget (port of
hdrf_tpu/utils/watchdog.py, whole).

Equivalent of the reference's slow-node/slow-disk detection
(DataNodeMetrics.java:557's SlowPeer reports and the ``/stacks`` servlet Hadoop's
HttpServer2 exposes for hung-daemon triage): a per-daemon background thread
scans the in-flight table every ``tick_s`` and, when an op has been running
past its budget, bumps ``stall_total`` on the daemon's registry, captures a
full thread-stack snapshot into a bounded ring (served by the ``/stacks``
endpoint), emits a structured log line, and fires the
``watchdog.stall`` fault-injection point so tests can observe the flag.

Budgets target stalled transports and device dispatches far over their
norm.  Each stalled op is flagged ONCE (re-flagged only if still running after
another full budget), so a 35 s stall counts as one stall, not 35/tick.

Stall records carry the tracked op's active trace id (captured at track()
entry) and the phase the op's thread is in at flag time (utils/profiler.py
per-thread phase stacks), and a synthetic ``stall`` span lands in the
``watchdog`` tracer — so a stall is attributable to a specific
block/phase in /stacks AND visible on the chrome export timeline.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Iterator

from . import fault_injection, log, metrics, profiler, tracing

DEFAULT_BUDGET_S = float(os.environ.get("HDRF_STALL_BUDGET_S", "30.0"))


def thread_stacks() -> dict[str, list[str]]:
    """Formatted stacks of every live thread (the /stacks servlet body)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: dict[str, list[str]] = {}
    for ident, frame in sys._current_frames().items():
        key = f"{names.get(ident, '?')}:{ident}"
        out[key] = traceback.format_stack(frame)
    return out


class StallWatchdog:
    """Tracks in-flight ops and flags the ones that exceed their budget."""

    def __init__(self, name: str, budget_s: float = DEFAULT_BUDGET_S,
                 tick_s: float | None = None,
                 registry: metrics.MetricsRegistry | None = None,
                 lock: Any | None = None) -> None:
        """``lock``: optional utils.lockprof.InstrumentedRLock — when set,
        each stall record also captures the CURRENT lock holder's identity,
        held-for duration and stack, so a lock convoy (N threads parked
        behind one slow holder) is diagnosable from /stacks instead of
        showing N identical waiter stacks and no culprit."""
        self.name = name
        self._profiled_lock = lock
        self.budget_s = budget_s
        self.tick_s = tick_s if tick_s is not None else min(
            max(budget_s / 4.0, 0.01), 2.0)
        self._reg = registry if registry is not None else metrics.registry(
            name)
        self._log = log.get_logger(f"watchdog.{name}")
        self._lock = threading.Lock()
        self._inflight: dict[int, dict[str, Any]] = {}
        self._next = 0
        self._stalls: deque[dict[str, Any]] = deque(maxlen=64)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "StallWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=f"watchdog-{self.name}", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # ------------------------------------------------------------- tracking

    @contextlib.contextmanager
    def track(self, op: str, budget_s: float | None = None) -> Iterator[None]:
        """Wrap an operation; the scan thread flags it if it outlives its
        budget.  Zero-cost beyond one dict insert/remove."""
        ctx = tracing.current_context()
        ent = {"op": op, "t0": time.monotonic(),
               "budget": budget_s if budget_s is not None else self.budget_s,
               "flagged": 0.0, "thread": threading.get_ident(),
               "trace_id": None if ctx is None else f"{ctx[0]:016x}"}
        with self._lock:
            self._next += 1
            key = self._next
            self._inflight[key] = ent
        try:
            yield
        finally:
            with self._lock:
                self._inflight.pop(key, None)

    def _run(self) -> None:
        while not self._stop.wait(self.tick_s):
            self.scan()

    def scan(self, now: float | None = None) -> int:
        """One watchdog pass; returns how many ops were newly flagged.
        Public so tests can drive the check deterministically."""
        if now is None:
            now = time.monotonic()
        stalled: list[dict[str, Any]] = []
        with self._lock:
            for ent in self._inflight.values():
                ref = ent["flagged"] or ent["t0"]
                if now - ref > ent["budget"]:
                    ent["flagged"] = now
                    stalled.append(dict(ent))
        holder = self._lock_holder() if stalled else None
        for ent in stalled:
            elapsed = now - ent["t0"]
            # phase the stalled op's thread is in RIGHT NOW (cross-thread
            # probe — the scan thread is not the stalled thread)
            phase = profiler.thread_phase(ent.get("thread"))
            self._reg.incr("stall_total")
            rec = {"ts": time.time(), "daemon": self.name, "op": ent["op"],
                   "elapsed_s": round(elapsed, 3),
                   "budget_s": ent["budget"],
                   "trace_id": ent.get("trace_id"), "phase": phase,
                   "stacks": thread_stacks()}
            if holder is not None:
                rec["lock_holder"] = holder
            with self._lock:
                self._stalls.append(rec)
            self._log.warning("stall", op=ent["op"],
                              elapsed_s=round(elapsed, 3),
                              budget_s=ent["budget"],
                              trace_id=ent.get("trace_id"), phase=phase)
            fault_injection.point("watchdog.stall", daemon=self.name,
                                  op=ent["op"], elapsed_s=elapsed,
                                  trace_id=ent.get("trace_id"), phase=phase)
            self._stall_span(ent, elapsed, phase)
        return len(stalled)

    def _lock_holder(self) -> dict[str, Any] | None:
        """The profiled lock's current holder with its live stack — the
        convoy culprit a stall record would otherwise omit (the waiters'
        stacks all show the same acquire site)."""
        if self._profiled_lock is None:
            return None
        try:
            h = self._profiled_lock.holder()
        except Exception:  # noqa: BLE001 — diagnostics must never raise
            return None
        if h is None:
            return None
        h = dict(h)
        h["held_for_s"] = round(h.get("held_for_s", 0.0), 3)
        frame = sys._current_frames().get(h.get("thread"))
        if frame is not None:
            h["stack"] = traceback.format_stack(frame)
        return h

    def _stall_span(self, ent: dict[str, Any], elapsed: float,
                    phase: str | None) -> None:
        """Synthetic span covering the stalled window so the stall shows up
        on the chrome-export timeline next to the block's other spans
        (same trace id when the op carried one)."""
        try:
            tid = (int(ent["trace_id"], 16) if ent.get("trace_id")
                   else tracing._rand_id())
            sp = tracing.Span(tid, tracing._rand_id(), 0,
                              f"stall:{ent['op']}",
                              tracer=tracing.tracer("watchdog"),
                              t0=time.time() - elapsed)
            sp.annotate("daemon", self.name)
            sp.annotate("elapsed_s", round(elapsed, 3))
            if phase is not None:
                sp.annotate("phase", phase)
            sp.finish()
        except (ValueError, TypeError):
            pass  # malformed trace id: the rec/log/fault still carry it

    # ------------------------------------------------------------ introspect

    def inflight(self) -> list[dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            return [{"op": e["op"], "elapsed_s": round(now - e["t0"], 3),
                     "budget_s": e["budget"], "flagged": bool(e["flagged"])}
                    for e in self._inflight.values()]

    def stalls(self) -> list[dict[str, Any]]:
        """Recent stall records, stacks included (newest last)."""
        with self._lock:
            return list(self._stalls)

    def stall_count(self) -> int:
        return self._reg.counter("stall_total")

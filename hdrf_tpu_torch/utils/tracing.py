"""Lightweight distributed tracing (port of hdrf_tpu/utils/tracing.py:
``Span`` tracing.py:34, ``Tracer`` :61, ``chrome_trace`` :137).

A span is ``(trace_id, span_id, parent_id, name, t0, t1)``; the wire carries
``(trace_id, span_id)`` as the ``_trace`` request key, and finished spans
accumulate in a bounded per-tracer sink that the worker's ``traces`` op
returns; ``chrome_trace`` renders spans, device-ledger events and profiler
counter samples as Chrome ``trace_event`` JSON for the status servers.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import struct
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterator


def _rand_id() -> int:
    return struct.unpack("<Q", os.urandom(8))[0] | 1


@dataclass
class Span:
    trace_id: int
    span_id: int
    parent_id: int
    name: str
    tracer: "Tracer | None" = None
    t0: float = field(default_factory=time.time)
    t1: float | None = None
    annotations: dict[str, Any] = field(default_factory=dict)

    def context(self) -> tuple[int, int]:
        """The bits that ride the wire (request frame)."""
        return (self.trace_id, self.span_id)

    def annotate(self, key: str, value: Any) -> None:
        self.annotations[key] = value

    def finish(self) -> None:
        self.t1 = time.time()
        if self.tracer is not None:
            self.tracer._record(self)


_current_span: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "hdrf_torch_current_span", default=None)


class Tracer:
    def __init__(self, name: str, max_spans: int = 4096) -> None:
        self.name = name
        self._sink: deque[Span] = deque(maxlen=max_spans)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str,
             parent: tuple[int, int] | None = None) -> Iterator[Span]:
        """Open a span; ``parent`` is a wire context from a request, if any."""
        cur = _current_span.get()
        if parent is not None:
            trace_id, parent_id = parent
        elif cur is not None:
            trace_id, parent_id = cur.trace_id, cur.span_id
        else:
            trace_id, parent_id = _rand_id(), 0
        sp = Span(trace_id, _rand_id(), parent_id, name, tracer=self)
        token = _current_span.set(sp)
        try:
            yield sp
        finally:
            _current_span.reset(token)
            sp.finish()

    def _record(self, span: Span) -> None:
        with self._lock:
            self._sink.append(span)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._sink)

    def snapshot(self) -> list[dict[str, Any]]:
        return [
            {
                "trace_id": f"{s.trace_id:016x}", "span_id": f"{s.span_id:016x}",
                "parent_id": f"{s.parent_id:016x}", "name": s.name,
                "tracer": self.name, "start": s.t0,
                "duration_ms": None if s.t1 is None else (s.t1 - s.t0) * 1e3,
                "annotations": s.annotations,
            }
            for s in self.spans()
        ]


def current_context() -> tuple[int, int] | None:
    """Wire context of the active span, to stamp into outgoing requests."""
    sp = _current_span.get()
    return None if sp is None else sp.context()


_tracers: dict[str, Tracer] = {}
_tracers_lock = threading.Lock()


def tracer(name: str) -> Tracer:
    """Process-wide named tracer (one per daemon/subsystem)."""
    with _tracers_lock:
        t = _tracers.get(name)
        if t is None:
            t = _tracers[name] = Tracer(name)
        return t


def all_span_snapshots() -> list[dict[str, Any]]:
    """Finished spans from every tracer in this process."""
    with _tracers_lock:
        ts = list(_tracers.values())
    out: list[dict[str, Any]] = []
    for t in ts:
        out.extend(t.snapshot())
    return out


def chrome_trace(spans: list[dict[str, Any]],
                 ledger: list[dict[str, Any]] = (),
                 trace_id: str | None = None,
                 counters: list[dict[str, Any]] = ()) -> dict[str, Any]:
    """Assemble span snapshots + device-ledger events + profiler counter
    samples into Chrome ``trace_event`` format (the ``chrome://tracing`` /
    Perfetto JSON schema: ``M`` process-name metadata rows plus ``X``
    complete events with microsecond ``ts``/``dur``, plus ``C`` counter
    events rendered as Perfetto counter tracks — in-flight blocks,
    outstanding dispatches, WAL queue depth from utils/profiler.py).
    ``pid`` groups rows by tracer (spans) or originating process (ledger
    events / counter tracks); ``tid`` groups by trace so one write's causal
    chain reads as one row block.  ``args`` keeps the raw trace/span/parent
    ids, so parent-chain assembly survives the export.  Counter samples have
    no trace affinity, so a ``trace_id`` filter drops them."""
    if trace_id is not None:
        spans = [s for s in spans if s["trace_id"] == trace_id]
        ledger = [e for e in ledger if e.get("trace_id") == trace_id]
        counters = []
    events: list[dict[str, Any]] = []
    pids: dict[str, int] = {}

    def pid_of(group: str) -> int:
        if group not in pids:
            pids[group] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[group], "tid": 0,
                           "args": {"name": group}})
        return pids[group]

    for s in spans:
        if s.get("duration_ms") is None:
            continue
        events.append({
            "ph": "X", "name": s["name"], "cat": "span",
            "pid": pid_of(s.get("tracer", "?")),
            "tid": int(s["trace_id"][-8:], 16),
            "ts": s["start"] * 1e6, "dur": s["duration_ms"] * 1e3,
            "args": {"trace_id": s["trace_id"], "span_id": s["span_id"],
                     "parent_id": s["parent_id"],
                     **s.get("annotations", {})},
        })
    for e in ledger:
        tid = int(e["trace_id"][-8:], 16) if e.get("trace_id") else 0
        events.append({
            "ph": "X", "name": f"{e['kind']}:{e['op']}",
            "cat": "device_ledger",
            "pid": pid_of(f"device:{e.get('proc', '?')}"),
            "tid": tid, "ts": e["t0"] * 1e6,
            "dur": max(e.get("dur_us", 0.0), 1.0),
            "args": {"trace_id": e.get("trace_id"),
                     "span_id": e.get("span_id"), "batch": e.get("batch"),
                     "bytes": e.get("bytes"), "kind": e["kind"]},
        })
    for c in counters:
        events.append({
            "ph": "C", "name": c["name"], "cat": "profiler",
            "pid": pid_of(f"profiler:{c.get('proc', '?')}"), "tid": 0,
            "ts": c["t"] * 1e6,
            "args": {"value": c["value"]},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}

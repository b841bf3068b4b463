"""Device dispatch ledger (port of hdrf_tpu/utils/device_ledger.py:
``dispatch`` device_ledger.py:91-116, ``pending`` :120-123,
``readback`` :126-146, ``stamp`` / ``delta`` :162-173).

Records the two moments the reduction path already has — a dispatch
(kernels enqueued on the CUDA stream) and the readback that waits for its
results — and never adds a synchronisation of its own.  Counters land in
the ``device_ledger`` metrics registry, events in a bounded ring that the
worker's ``traces`` op returns.  ``stamp()`` / ``delta()`` give a bench
round its counter movement (benchmarks.py).

``dispatch(op, key=...)``: the first sighting of an ``(op, key)`` pair
counts ``compiles_total`` and writes a ``compile`` event.  In the
reference that approximates a jit cache miss; the port compiles no
program per shape (its kernels are built once, at first use, by
ops/_build.py), so here a "compile" is the first launch of a shape — the
first time a kernel runs at a geometry, its allocator and occupancy
warm-up included.

The reference's profiler hooks (device wait spans on block timelines)
stay with the reference.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from typing import Any

from . import metrics, tracing

_M = metrics.registry("device_ledger")

# A readback wait past this is a stall.
STALL_BUDGET_S = 5.0

_RING_MAX = 4096
_ring: deque[dict[str, Any]] = deque(maxlen=_RING_MAX)
_lock = threading.Lock()
_seen_keys: set[tuple] = set()
_next_id = [0]
_PROC = f"{os.path.basename(sys.argv[0] or 'py')}:{os.getpid()}"


class _Pending:
    """Timing token returned by dispatch(); closed by readback()."""

    __slots__ = ("op", "t0_wall", "t0", "batch", "h2d")

    def __init__(self, op: str, batch: int, h2d: int) -> None:
        self.op = op
        self.t0_wall = time.time()
        self.t0 = time.perf_counter()
        self.batch = batch
        self.h2d = h2d


def _event(op: str, kind: str, *, t0: float, dur_us: float, batch: int,
           nbytes: int) -> int:
    ctx = tracing.current_context()
    ev = {
        "proc": _PROC, "op": op, "kind": kind, "t0": t0,
        "dur_us": round(dur_us, 1), "batch": batch, "bytes": nbytes,
        "trace_id": None if ctx is None else f"{ctx[0]:016x}",
        "span_id": None if ctx is None else f"{ctx[1]:016x}",
    }
    with _lock:
        _next_id[0] += 1
        ev["id"] = _next_id[0]
        _ring.append(ev)
    return ev["id"]


def dispatch(op: str, *, batch: int = 1, h2d_bytes: int = 0,
             key: tuple | None = None) -> _Pending:
    """Record an enqueued device computation; returns the timing token the
    matching ``readback`` closes.  ``key`` is a hashable shape signature:
    its first sighting counts as a compile (the first launch of a shape)."""
    _M.incr("dispatch_total")
    _M.incr("dispatch_batch_total", batch)
    if h2d_bytes:
        _M.incr("h2d_bytes_total", h2d_bytes)
    if key is not None:
        k = (op, key)
        with _lock:
            fresh = k not in _seen_keys
            _seen_keys.add(k)
        if fresh:
            _M.incr("compiles_total")
            _event(op, "compile", t0=time.time(), dur_us=0.0, batch=batch,
                   nbytes=0)
    _event(op, "enqueue", t0=time.time(), dur_us=0.0, batch=batch,
           nbytes=h2d_bytes)
    return _Pending(op, batch, h2d_bytes)


def pending(op: str, *, batch: int = 1) -> _Pending:
    """Timing token WITHOUT counting a dispatch — for aggregate readbacks
    whose constituent dispatches were already recorded one by one."""
    return _Pending(op, batch, 0)


def readback(tok: _Pending | None, *, d2h_bytes: int = 0) -> None:
    """Record the forced completion of ``tok``'s dispatch.  Call AFTER the
    caller's own waiting readback — the ledger never synchronises itself."""
    if tok is None:
        return
    dur = time.perf_counter() - tok.t0
    _M.incr("readback_total")
    if d2h_bytes:
        _M.incr("d2h_bytes_total", d2h_bytes)
    _M.observe("wait_us", dur * 1e6)
    _M.observe(f"wait_us|op={tok.op}", dur * 1e6)
    if dur > STALL_BUDGET_S:
        _M.incr("stall_total")
        _event(tok.op, "stall", t0=tok.t0_wall, dur_us=dur * 1e6,
               batch=tok.batch, nbytes=d2h_bytes)
    _event(tok.op, "dispatch", t0=tok.t0_wall, dur_us=dur * 1e6,
           batch=tok.batch, nbytes=tok.h2d + d2h_bytes)


def transfer(kind: str, op: str, nbytes: int) -> None:
    """Record a bare transfer (kind ``h2d`` or ``d2h``) with no compute."""
    _M.incr(f"{kind}_bytes_total", nbytes)
    _M.incr(f"{kind}_transfer_total")
    _event(op, kind, t0=time.time(), dur_us=0.0, batch=1, nbytes=nbytes)


def events_snapshot(limit: int = _RING_MAX) -> list[dict[str, Any]]:
    """Newest-last copy of the event ring (msgpack/JSON-safe dicts)."""
    with _lock:
        evs = list(_ring)
    return evs[-limit:]


COUNTERS = ("dispatch_total", "readback_total", "compiles_total",
            "stall_total", "h2d_bytes_total", "d2h_bytes_total")


def stamp() -> dict[str, int]:
    """Cheap counter stamp for delta accounting across a bench round."""
    snap = _M.snapshot()["counters"]
    return {k: snap.get(k, 0) for k in COUNTERS}


def delta(before: dict[str, int]) -> dict[str, int]:
    """Counter movement since ``before`` (a ``stamp()`` result)."""
    now = stamp()
    return {k: now[k] - before.get(k, 0) for k in now}

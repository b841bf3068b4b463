"""Write-path critical-path profiler: phase-attributed block timelines
(port of hdrf_tpu/utils/profiler.py, over the port's ``utils/tracing``:
phases, block and read timelines, the overlap accountant, counter
tracks, the per-packet ``timed_iter`` and the watchdog's
``thread_phase`` probe; the device ledger records its own waits).

The reference measures its write path with coarse per-op rate counters
(DataNodeMetrics.java:553-560 ``addWriteBlockOp``/``addPacketAckRoundTripTimeNanos``)
— enough to say *that* a write was slow, never *where* the time went.  This
module is the missing decomposition:

- Every block write opens a :class:`BlockTimeline` (ambient via contextvar,
  the bf1-buffer lifetime of BlockReceiver.java:877-897) into which named
  phase spans land — ``recv``, ``dedup_lookup``, ``wal_commit``,
  ``device_wait``, ``container_io``, ``mirror_stream``, ``ack`` — each a
  plain ``(phase, t0, t1, thread)`` tuple (one list append; no locks on the
  hot path, no syncs).  :func:`bind_timeline` adopts a timeline in a helper
  thread (the read coalescer binds its lead reader's).
- :func:`profile_spans` is the overlap accountant: it partitions a wall-clock
  window into four EXCLUSIVE classes — ``host_busy`` > ``device_busy`` >
  ``transport_wait`` > ``idle`` (priority order; host work owns the
  interpreter, so wait time under it is *hidden*, the desirable state) —
  and computes ``overlap_efficiency`` = hidden wait / hideable wait plus
  per-phase exclusive seconds.
- Counter tracks (in-flight blocks, WAL queue depth) sample on every
  change into a bounded ring; the worker's ``traces`` reply carries them.

Finished timelines observe per-phase latency histograms
(``phase_us|phase=<name>``) and overlap gauges into the ``write_profiler``
registry; READ timelines (:func:`read_timeline`: ``index_lookup`` /
``cache_probe`` / ``container_decode`` phases) into ``read_profiler``
(``phase_us|op=read,phase=<name>``).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Iterable, Iterator

from . import metrics, tracing

_M = metrics.registry("write_profiler")
_R = metrics.registry("read_profiler")

# Overlap classes, in wall-clock partition PRIORITY order (the host's
# interpreter is the scarce resource — an interval where host work runs
# counts host_busy even when device/transport waits are in flight; those
# waits are then HIDDEN, which is the state the pipeline wants).
HOST, DEVICE, TRANSPORT = "host", "device", "transport"
CLASSES = ("host_busy", "device_busy", "transport_wait", "idle")

PHASE_CLASS = {
    "recv": TRANSPORT, "mirror_stream": TRANSPORT, "ack": TRANSPORT,
    "dedup_lookup": HOST, "wal_commit": HOST, "container_io": HOST,
    "reduce_compute": HOST, "checksum": HOST, "buffer_assemble": HOST,
    "pipeline_submit": HOST,
    "device_wait": DEVICE,
    # Read-path phases (server/block_sender.py serve_read/read_logical):
    # index/cache/decode burn host time; stripe gathers and the
    # packet run to the client are network waits the host could hide.
    "index_lookup": HOST, "cache_probe": HOST, "container_decode": HOST,
    "ec_gather": TRANSPORT, "net_send": TRANSPORT,
    # A reader parked on the read coalescer's shared decode future
    # (server/read_plane.py): a hideable wait — the real decode burns host
    # time under the LEAD reader's mirrored container_decode span, which
    # wins the interval's class, so this only attributes the queue/window
    # slack that nothing else covers.
    "decode_wait": TRANSPORT,
    # Control-plane RPC service-time phases (proto/rpc.py _serve_one):
    # frame/reply socket IO are transport waits; everything between them
    # is NN host work.  lock_wait is deliberately HOST, not transport —
    # the whole dispatch sits inside the covering ``handler`` span (HOST),
    # and the exclusive sweep resolves same-class overlaps by PHASE_ORDER,
    # so classifying it transport would hide every queued-on-the-namesystem
    # second under ``handler`` and the contention table would read clean.
    "frame_read": TRANSPORT, "reply": TRANSPORT,
    "dispatch_queue": HOST, "lock_wait": HOST, "locked": HOST,
    "serialize": HOST, "handler": HOST,
}

# Deterministic attribution order when several phases of the winning class
# overlap inside one elementary interval (rare: host phases are serial on
# this host) — first match wins.  Nested read phases (index_lookup inside a
# container_decode window) resolve to the innermost by listing it first.
PHASE_ORDER = ("device_wait", "wal_commit", "container_io", "dedup_lookup",
               "reduce_compute", "checksum", "buffer_assemble",
               "pipeline_submit", "index_lookup", "cache_probe",
               "container_decode",
               # RPC phases: lock_wait/locked win attribution inside the
               # covering ``handler`` window; handler last among them so it
               # only owns the time no finer phase explains.
               "lock_wait", "locked", "dispatch_queue", "serialize",
               "handler",
               "recv", "mirror_stream", "ack",
               "ec_gather", "decode_wait", "net_send", "frame_read", "reply")


def phase_class(name: str) -> str:
    """Overlap class of a phase; unknown names default to host work."""
    return PHASE_CLASS.get(name, HOST)


def _now() -> float:
    # Wall clock: phase spans must share a time base with tracing.Span.t0
    # and the device ledger's event t0 so one chrome export aligns them all.
    return time.time()


_PROC = f"{os.path.basename(sys.argv[0] or 'py')}:{os.getpid()}"

_RING_MAX = 1024          # finished timelines
_SPAN_RING_MAX = 65536    # raw spans (window_profile's source)
_COUNTER_RING_MAX = 8192  # counter-track samples

_lock = threading.Lock()
_timelines: deque["BlockTimeline"] = deque(maxlen=_RING_MAX)
_read_timelines: deque["BlockTimeline"] = deque(maxlen=_RING_MAX)
_span_ring: deque[tuple] = deque(maxlen=_SPAN_RING_MAX)
_counter_ring: deque[dict[str, Any]] = deque(maxlen=_COUNTER_RING_MAX)
_counters: dict[str, float] = {}
_counter_id = [0]
_thread_phase: dict[int, list[str]] = {}

_current: contextvars.ContextVar["BlockTimeline | None"] = \
    contextvars.ContextVar("hdrf_block_timeline", default=None)


# ------------------------------------------------------------ block timeline


class BlockTimeline:
    """Phase spans + device-ledger links for one block write."""

    __slots__ = ("block_id", "nbytes", "trace_id", "t0", "t1", "spans",
                 "ledger_ids")

    def __init__(self, block_id: int, nbytes: int = 0,
                 t0: float | None = None) -> None:
        self.block_id = block_id
        self.nbytes = nbytes
        ctx = tracing.current_context()
        self.trace_id = None if ctx is None else f"{ctx[0]:016x}"
        self.t0 = _now() if t0 is None else t0
        self.t1: float | None = None
        self.spans: list[tuple] = []          # (phase, t0, t1, thread)
        self.ledger_ids: list[int] = []       # device-ledger event ids

    def add_span(self, phase: str, t0: float, t1: float,
                 thread: int = 0) -> None:
        self.spans.append((phase, t0, t1, thread))

    def finish(self, t1: float | None = None) -> None:
        if self.t1 is None:
            self.t1 = _now() if t1 is None else t1

    def profile(self) -> dict[str, Any]:
        end = self.t1 if self.t1 is not None else _now()
        return profile_spans(self.spans, self.t0, end, nbytes=self.nbytes)

    def snapshot(self) -> dict[str, Any]:
        """JSON-safe dump (the gap_report/--input interchange shape)."""
        return {"block_id": self.block_id, "nbytes": self.nbytes,
                "trace_id": self.trace_id, "t0": self.t0, "t1": self.t1,
                "spans": [[p, a, b] for p, a, b, _ in self.spans],
                "ledger_ids": list(self.ledger_ids),
                "profile": self.profile()}


# --------------------------------------------------------- overlap accountant


def profile_spans(spans: Iterable, t0: float, t1: float,
                  nbytes: int = 0) -> dict[str, Any]:
    """Partition [t0, t1] into the four exclusive overlap classes and
    per-phase exclusive seconds via a boundary sweep.

    ``spans`` yields ``(phase, s0, s1)`` or ``(phase, s0, s1, thread)``.
    The class partition sums exactly to the wall clock (``idle`` is the
    remainder by construction).  ``overlap_efficiency`` = wait time hidden
    under host work / total device+transport wait time (1.0 when there was
    nothing to hide); ``attributed_frac`` = share of wall covered by at
    least one named phase (the >= 95% gap_report acceptance bar).
    """
    wall = max(t1 - t0, 0.0)
    classes = dict.fromkeys(CLASSES, 0.0)
    phases: dict[str, float] = {}
    hidden = hideable = 0.0
    events: list[tuple[float, int, str]] = []
    for sp in spans:
        name, s0, s1 = sp[0], max(sp[1], t0), min(sp[2], t1)
        if s1 > s0:
            events.append((s0, 1, name))
            events.append((s1, -1, name))
    events.sort(key=lambda e: e[0])

    active: dict[str, int] = {}
    cls_active = {HOST: 0, DEVICE: 0, TRANSPORT: 0}
    prev = t0
    i, n = 0, len(events)
    while i < n:
        t = events[i][0]
        if t > prev:
            dt = t - prev
            if cls_active[HOST] > 0:
                win, wc = "host_busy", HOST
            elif cls_active[DEVICE] > 0:
                win, wc = "device_busy", DEVICE
            elif cls_active[TRANSPORT] > 0:
                win, wc = "transport_wait", TRANSPORT
            else:
                win, wc = "idle", None
            classes[win] += dt
            if cls_active[DEVICE] > 0 or cls_active[TRANSPORT] > 0:
                hideable += dt
                if win == "host_busy":
                    hidden += dt
            if wc is not None:
                attr = None
                for name in PHASE_ORDER:
                    if active.get(name, 0) > 0 and phase_class(name) == wc:
                        attr = name
                        break
                if attr is None:  # phase outside the canonical order
                    for name in sorted(active):
                        if active[name] > 0 and phase_class(name) == wc:
                            attr = name
                            break
                if attr is not None:
                    phases[attr] = phases.get(attr, 0.0) + dt
            prev = t
        while i < n and events[i][0] == t:
            _, kind, name = events[i]
            active[name] = active.get(name, 0) + kind
            cls_active[phase_class(name)] += kind
            i += 1
    used = (classes["host_busy"] + classes["device_busy"]
            + classes["transport_wait"])
    classes["idle"] = wall - used  # exact partition by construction
    out = {
        "wall_s": wall,
        "classes": classes,
        "phases": phases,
        "hidden_wait_s": hidden,
        "hideable_wait_s": hideable,
        "overlap_efficiency": hidden / hideable if hideable > 0 else 1.0,
        "attributed_frac": used / wall if wall > 0 else 1.0,
    }
    if nbytes:
        out["bytes"] = nbytes
        out["mb_per_s"] = nbytes / wall / (1 << 20) if wall > 0 else 0.0
    return out


# --------------------------------------------------------------- ambient API


@contextlib.contextmanager
def block_timeline(block_id: int, nbytes: int = 0) -> Iterator[BlockTimeline]:
    """Open the ambient timeline for one block write; on exit the finished
    timeline lands in the ring and its per-phase histograms + overlap gauges
    are observed into the ``write_profiler`` registry."""
    tl = BlockTimeline(block_id, nbytes)
    tok = _current.set(tl)
    counter_add("inflight_blocks", 1)
    try:
        yield tl
    finally:
        _current.reset(tok)
        counter_add("inflight_blocks", -1)
        tl.finish()
        with _lock:
            _timelines.append(tl)
        _observe_finished(tl)


@contextlib.contextmanager
def read_timeline(block_id: int, nbytes: int = 0) -> Iterator[BlockTimeline]:
    """Open the ambient timeline for one block READ (serve_read /
    short-circuit serve / EC degraded read).  Same BlockTimeline machinery
    and exclusive-class partition as the write side — reconstruct code
    below it records ``index_lookup``/``container_decode``/``ec_gather``
    phases via the ordinary :func:`phase` ambient channel, and the device
    ledger's readback hook still lands ``device_wait`` spans — but finished
    timelines ring separately and observe into the ``read_profiler``
    registry as ``phase_us|op=read,phase=<name>`` histograms, so the read
    families sit next to the write families on /prom."""
    tl = BlockTimeline(block_id, nbytes)
    tok = _current.set(tl)
    counter_add("inflight_reads", 1)
    try:
        yield tl
    finally:
        _current.reset(tok)
        counter_add("inflight_reads", -1)
        tl.finish()
        with _lock:
            _read_timelines.append(tl)
        _observe_finished_read(tl)


def _observe_finished_read(tl: BlockTimeline) -> None:
    prof = tl.profile()
    for name, s in prof["phases"].items():
        _R.observe(f"phase_us|op=read,phase={name}", s * 1e6)
    _R.observe("read_wall_us", prof["wall_s"] * 1e6)
    _R.gauge("overlap_efficiency", prof["overlap_efficiency"])
    _R.gauge("attributed_frac", prof["attributed_frac"])
    _R.incr("reads_profiled")


def read_timelines_snapshot(limit: int = _RING_MAX) -> list[dict[str, Any]]:
    """Newest-last finished READ timelines as JSON-safe dicts — the
    read-path acceptance smoke's and slo_report's in-process source."""
    with _lock:
        tls = list(_read_timelines)
    return [t.snapshot() for t in tls[-limit:]]


def current_timeline() -> BlockTimeline | None:
    return _current.get()


@contextlib.contextmanager
def bind_timeline(tl: BlockTimeline | None) -> Iterator[BlockTimeline | None]:
    """Adopt an EXISTING timeline as this thread's ambient one.

    Contextvars do not propagate into worker threads, so the write
    pipeline's helper threads (the ack/checksum pump, the device-batch
    coalescer — server/write_pipeline.py) would otherwise record their
    spans ring-only and the per-block overlap accountant would never see
    the work they hid.  Binding does NOT finish the timeline or touch the
    inflight counter — ownership stays with the opening
    :func:`block_timeline` frame."""
    tok = _current.set(tl)
    try:
        yield tl
    finally:
        _current.reset(tok)


def _observe_finished(tl: BlockTimeline) -> None:
    prof = tl.profile()
    for name, s in prof["phases"].items():
        _M.observe(f"phase_us|phase={name}", s * 1e6)
    _M.observe("block_wall_us", prof["wall_s"] * 1e6)
    _M.gauge("overlap_efficiency", prof["overlap_efficiency"])
    _M.gauge("attributed_frac", prof["attributed_frac"])
    _M.incr("blocks_profiled")


def _record(name: str, t0: float, t1: float, thread: int) -> None:
    tl = _current.get()
    if tl is not None:
        tl.add_span(name, t0, t1, thread)
    with _lock:
        _span_ring.append((name, t0, t1, thread))


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Record a named phase span (ambient timeline + global ring).  Cost is
    two clock reads, one list append and one deque append — safe on the
    per-packet path."""
    tid = threading.get_ident()
    stack = _thread_phase.setdefault(tid, [])
    stack.append(name)
    t0 = _now()
    try:
        yield
    finally:
        t1 = _now()
        try:
            stack.pop()
        except IndexError:
            pass
        _record(name, t0, t1, tid)


def timed_iter(name: str, it: Iterable) -> Iterator:
    """Wrap an iterator so each ``next()`` wait becomes one phase span —
    the per-packet ``recv`` attribution of the client-stream wait."""
    src = iter(it)
    tid = threading.get_ident()
    stack = _thread_phase.setdefault(tid, [])
    while True:
        stack.append(name)
        t0 = _now()
        try:
            item = next(src)
        except StopIteration:
            return
        finally:
            try:
                stack.pop()
            except IndexError:
                pass
        _record(name, t0, _now(), tid)
        yield item


def thread_phase(thread_id: int | None = None) -> str | None:
    """Innermost phase currently open on a thread — the watchdog's
    cross-thread stall attribution probe."""
    if thread_id is None:
        thread_id = threading.get_ident()
    stack = _thread_phase.get(thread_id)
    if not stack:
        return None
    try:
        return stack[-1]
    except IndexError:
        return None


# ------------------------------------------------------------ counter tracks


def counter_add(name: str, delta: float) -> float:
    with _lock:
        v = _counters.get(name, 0.0) + delta
        _counters[name] = v
        _sample_locked(name, v)
    _M.gauge(name, v)
    return v


def counter_set(name: str, value: float) -> None:
    with _lock:
        _counters[name] = value
        _sample_locked(name, value)
    _M.gauge(name, value)


def _sample_locked(name: str, value: float) -> None:
    _counter_id[0] += 1
    _counter_ring.append({"t": _now(), "name": name, "value": value,
                          "proc": _PROC, "id": _counter_id[0]})


def counters_snapshot(limit: int = _COUNTER_RING_MAX) -> list[dict[str, Any]]:
    """Newest-last counter-track samples (chrome ``C`` event source)."""
    with _lock:
        out = list(_counter_ring)
    return out[-limit:]


# ----------------------------------------------------- run-level windowing


def mark() -> float:
    """Wall-clock stamp for window_profile (bench round boundaries)."""
    return _now()


def window_spans(t0: float, t1: float) -> list[tuple]:
    """Spans from ANY thread overlapping [t0, t1], clamped to it — the
    cross-thread view run-level accounting needs (the bench's commit worker
    records on its own thread; a contextvar would never see it)."""
    with _lock:
        spans = list(_span_ring)
    return [(p, max(s0, t0), min(s1, t1), tid)
            for p, s0, s1, tid in spans if s1 > t0 and s0 < t1]


def window_profile(t0: float, t1: float, nbytes: int = 0) -> dict[str, Any]:
    """Overlap profile of everything recorded in [t0, t1] across threads —
    the bench's ``phase_profile`` JSON stamp."""
    return profile_spans(window_spans(t0, t1), t0, t1, nbytes=nbytes)


# ------------------------------------------------------------- introspection


def timelines_snapshot(limit: int = _RING_MAX) -> list[dict[str, Any]]:
    """Newest-last finished timelines as JSON-safe dicts (profiles
    included) — gap_report's in-process source."""
    with _lock:
        tls = list(_timelines)
    return [t.snapshot() for t in tls[-limit:]]


def reset() -> None:
    """Drop rings + counters (tests / gap_report smoke isolation); the
    write_profiler registry's cumulative metrics are left alone."""
    with _lock:
        _timelines.clear()
        _read_timelines.clear()
        _span_ring.clear()
        _counter_ring.clear()
        _counters.clear()

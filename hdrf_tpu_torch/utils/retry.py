"""Resilience primitives (port of hdrf_tpu/utils/retry.py): deadline
budgets (``Deadline`` retry.py:58), capped backoff (:142-180), hedged
quorums (``hedged_quorum`` :194), circuit breakers (``CircuitBreaker``
:283).

- :class:`Deadline` is an absolute time budget.  It propagates hop-by-hop
  as a REMAINING-SECONDS header (``_deadline`` on RPC kwargs / DT op
  fields, riding beside ``_trace``): wall clocks are not synchronized
  across hosts, so each hop rebinds the remaining budget against its own
  monotonic clock (``remaining_header`` / ``bind_remaining``).  The
  active deadline is ambient (contextvar, like tracing's current span);
  the admission controller (utils/qos.py) sheds an op whose ambient
  budget cannot cover its service estimate.
- :func:`backoff_delays` / :func:`call_with_retries`: capped exponential
  backoff with full jitter under the ambient deadline.
- :func:`hedged_quorum`: concurrent legs with an any-k quorum and hedge
  legs launched on a failure or after a delay (the EC tier's k+delta
  stripe gather).
- :class:`CircuitBreaker` and the per-edge registry (``breaker``,
  ``all_breakers``, ``reset_breakers``): closed -> open after N
  consecutive failures, one half-open probe after the reset time.  Clocks
  are injectable so tests drive every transition without sleeping.

Counters go to the ``resilience`` metrics registry under the reference's
names.
"""

from __future__ import annotations

import contextlib
import contextvars
import queue
import random
import threading
import time
from typing import Any, Callable, Iterator

from hdrf_tpu_torch.utils import metrics

_M = metrics.registry("resilience")

#: reserved header key — rides RPC kwargs and DT op fields beside ``_trace``
DEADLINE_KEY = "_deadline"


class DeadlineExceeded(TimeoutError):
    """The operation's time budget is exhausted (raised BEFORE issuing
    further network work, so a spent budget costs zero connect attempts)."""


class Deadline:
    """Absolute time budget against an injectable monotonic clock."""

    __slots__ = ("_expires", "_clock")

    def __init__(self, budget_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._expires = clock() + float(budget_s)

    def remaining(self) -> float:
        """Seconds left (never negative)."""
        return max(0.0, self._expires - self._clock())

    @property
    def expired(self) -> bool:
        return self._clock() >= self._expires

    def check(self, what: str = "operation") -> None:
        if self.expired:
            _M.incr("deadline_exceeded_total")
            raise DeadlineExceeded(f"{what}: deadline budget exhausted")

    def extend(self, extra_s: float) -> None:
        """Grow the budget (payload-scaled deadlines accrue per streamed
        MiB because stream sizes are only known as bytes arrive)."""
        self._expires += float(extra_s)

    def timeout(self, cap_s: float | None = None) -> float:
        """A socket/step timeout honoring both the budget and ``cap_s``."""
        rem = self.remaining()
        return rem if cap_s is None else min(rem, cap_s)

    def header(self) -> float:
        """The hop-by-hop wire form: remaining seconds (receivers rebind
        against their own clock, which is the decrement)."""
        return self.remaining()


_current_deadline: contextvars.ContextVar[Deadline | None] = \
    contextvars.ContextVar("hdrf_deadline", default=None)


def current() -> Deadline | None:
    """The ambient deadline, if any (the tracing.current_context analog)."""
    return _current_deadline.get()


def remaining_header() -> float | None:
    """Remaining-seconds header for outbound calls; None = no deadline."""
    d = _current_deadline.get()
    return None if d is None else d.header()


@contextlib.contextmanager
def bind(deadline: Deadline | None) -> Iterator[Deadline | None]:
    """Make ``deadline`` ambient for the body (None = explicitly unbound)."""
    tok = _current_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _current_deadline.reset(tok)


@contextlib.contextmanager
def bind_remaining(remaining_s: float | None,
                   clock: Callable[[], float] = time.monotonic,
                   ) -> Iterator[Deadline | None]:
    """Rebind an inbound ``_deadline`` header (remaining seconds) against
    the local clock; no header = no ambient deadline for this handler."""
    if remaining_s is None:
        yield None
        return
    with bind(Deadline(float(remaining_s), clock=clock)) as d:
        yield d


def effective_budget(budget_s: float) -> float:
    """Clamp a local per-op budget by the ambient deadline (a hop may
    never outlive the end-to-end budget it inherited)."""
    d = _current_deadline.get()
    return budget_s if d is None else min(budget_s, d.remaining())


def backoff_delays(attempts: int, base_s: float = 0.05, cap_s: float = 2.0,
                   rng: random.Random | None = None) -> Iterator[float]:
    """Capped exponential backoff with full jitter: attempt i sleeps
    U(0, min(cap_s, base_s * 2**i)).  Yields ``attempts`` delays."""
    rng = rng or random
    for i in range(attempts):
        yield rng.uniform(0.0, min(cap_s, base_s * (2.0 ** i)))


def call_with_retries(fn: Callable[[], Any], attempts: int = 3,
                      retry_on: tuple = (ConnectionError, OSError),
                      base_s: float = 0.05, cap_s: float = 2.0,
                      sleep: Callable[[float], None] = time.sleep,
                      rng: random.Random | None = None,
                      on_retry: Callable[[Exception], None] | None = None,
                      ) -> Any:
    """Run ``fn`` with capped-exponential-full-jitter retries, honoring the
    ambient deadline: a spent budget raises :class:`DeadlineExceeded`
    instead of sleeping into it."""
    last: Exception | None = None
    delays = backoff_delays(max(0, attempts - 1), base_s, cap_s, rng)
    for attempt in range(attempts):
        d = _current_deadline.get()
        if d is not None:
            d.check("retry loop")
        try:
            return fn()
        except retry_on as e:  # type: ignore[misc]
            last = e
            _M.incr("retries_total")
            if on_retry is not None:
                on_retry(e)
        if attempt < attempts - 1:
            delay = next(delays)
            if d is not None:
                delay = min(delay, d.remaining())
            if delay > 0:
                sleep(delay)
    raise last  # type: ignore[misc]


class QuorumFailed(IOError):
    """A hedged fan-out could not land its quorum: fewer than k legs
    succeeded after every launched leg (primaries + hedges) resolved or
    the overall budget expired.  ``errors`` holds (leg_index, exception)
    pairs for per-leg attribution."""

    def __init__(self, msg: str, errors: list | None = None):
        super().__init__(msg)
        self.errors = errors or []


def hedged_quorum(primaries: list, hedges: list, k: int,
                  hedge_after_s: float, timeout_s: float | None = None,
                  on_hedge: Callable[[], None] | None = None,
                  clock: Callable[[], float] = time.monotonic):
    """Hedged-call fan-out with an any-k quorum ack (the coded mirror
    plane's scheduling core; the "defer hedge until p95" discipline of
    the tied-requests design the reference's pipeline lacks entirely —
    SURVEY.md §0 fact 3, DataStreamer.java:765 forwards serially).

    Launches every ``primaries`` thunk concurrently.  The ``hedges``
    thunks launch when EITHER (a) any primary leg fails (fail-fast: a
    dead peer or open breaker should not burn the hedge timer) or (b)
    ``hedge_after_s`` elapses with fewer than k successes (straggler).
    Returns ``(wins, errors, hedged)`` as soon as k legs succeed —
    stragglers keep running on their daemon threads and resolve off the
    caller's critical path.  ``wins``/``errors`` are (leg_index, payload)
    pairs; hedge legs are indexed after the primaries.  Raises
    :class:`QuorumFailed` when k successes become impossible, and honors
    the ambient deadline through ``effective_budget``.
    """
    results: queue.Queue = queue.Queue()

    def _run(idx: int, fn: Callable[[], Any]) -> None:
        try:
            results.put((idx, True, fn()))
        except Exception as e:  # noqa: BLE001 — resolved at the quorum
            results.put((idx, False, e))

    for i, fn in enumerate(primaries):
        threading.Thread(target=_run, args=(i, fn), daemon=True,
                         name=f"hedge-leg-{i}").start()
    total = len(primaries)
    hedged = False

    def _launch_hedges() -> None:
        nonlocal total, hedged
        if hedged or not hedges:
            return
        hedged = True
        _M.incr("hedges_fired_total")
        if on_hedge is not None:
            on_hedge()
        for j, fn in enumerate(hedges):
            threading.Thread(target=_run, args=(len(primaries) + j, fn),
                             daemon=True,
                             name=f"hedge-leg-h{j}").start()
        total += len(hedges)

    overall = Deadline(effective_budget(
        timeout_s if timeout_s is not None else 60.0), clock=clock)
    hedge_at = clock() + max(0.0, float(hedge_after_s))
    wins: list = []
    errors: list = []
    while len(wins) < k:
        if len(wins) + len(errors) >= total:
            if hedged or not hedges:
                break  # every launched leg resolved; quorum unreachable
            _launch_hedges()
            continue
        wait = overall.remaining()
        if not hedged and hedges:
            wait = min(wait, max(0.0, hedge_at - clock()))
        try:
            idx, ok, payload = results.get(timeout=max(wait, 0.001))
        except queue.Empty:
            if not hedged and hedges and clock() >= hedge_at:
                _launch_hedges()
                continue
            if overall.expired:
                break
            continue
        if ok:
            wins.append((idx, payload))
        else:
            errors.append((idx, payload))
            _launch_hedges()  # fail-fast: don't wait out the timer
    if len(wins) < k:
        _M.incr("quorum_failures_total")
        raise QuorumFailed(
            f"hedged quorum missed: {len(wins)}/{k} legs landed "
            f"({len(errors)} failed)", errors)
    return wins, errors, hedged


class BreakerOpen(IOError):
    """Fail-fast refusal: the edge's breaker is open (no connect attempt
    was made — callers fall straight into their degraded path)."""


class CircuitBreaker:
    """Consecutive-failure circuit breaker with a single half-open probe.

    closed --N consecutive failures--> open --reset_s elapsed--> half-open
    (exactly one caller admitted as the probe) --success--> closed /
    --failure--> open again.  ``clock`` is injectable so tests drive every
    transition deterministically.
    """

    _STATE_NUM = {"closed": 0, "half_open": 1, "open": 2}

    def __init__(self, name: str, failure_threshold: int = 3,
                 reset_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_s = float(reset_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0          # consecutive
        self._opened_at = 0.0
        self._probe_inflight = False
        self._export()

    # ------------------------------------------------------------- queries

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def allow(self) -> bool:
        """May a call proceed?  open = no; half-open admits ONE probe."""
        with self._lock:
            self._maybe_half_open()
            if self._state == "closed":
                return True
            if self._state == "half_open" and not self._probe_inflight:
                self._probe_inflight = True
                _M.incr("breaker_probes_total")
                return True
            _M.incr("breaker_rejections_total")
            return False

    def check(self) -> None:
        """``allow`` that raises :class:`BreakerOpen` instead."""
        if not self.allow():
            raise BreakerOpen(f"circuit breaker '{self.name}' is open")

    # ----------------------------------------------------------- outcomes

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != "closed":
                self._state = "closed"
                _M.incr("breaker_close_total")
            self._export()

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            was = self._state
            if was == "half_open" or (was == "closed" and
                                      self._failures
                                      >= self.failure_threshold):
                self._state = "open"
                self._opened_at = self._clock()
                self._probe_inflight = False
                if was != "open":
                    _M.incr("breaker_open_total")
            self._export()

    # ----------------------------------------------------------- internals

    def _maybe_half_open(self) -> None:
        """Caller holds the lock."""
        if self._state == "open" \
                and self._clock() - self._opened_at >= self.reset_s:
            self._state = "half_open"
            self._probe_inflight = False
            self._export()

    def _export(self) -> None:
        """Caller holds the lock.  Gauges keep per-edge state visible in
        /prom; the transition counters above are family-wide."""
        _M.gauge(f"breaker_state.{self.name}",
                 self._STATE_NUM[self._state])


_breakers: dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker(name: str, failure_threshold: int = 3, reset_s: float = 5.0,
            clock: Callable[[], float] = time.monotonic) -> CircuitBreaker:
    """Process-wide per-edge breaker registry (one breaker per edge name,
    e.g. ``dn-0->worker``); parameters apply only on first creation."""
    with _breakers_lock:
        b = _breakers.get(name)
        if b is None:
            b = _breakers[name] = CircuitBreaker(
                name, failure_threshold=failure_threshold,
                reset_s=reset_s, clock=clock)
        return b


def all_breakers() -> dict[str, CircuitBreaker]:
    with _breakers_lock:
        return dict(_breakers)


def reset_breakers() -> None:
    """Drop every registered breaker (test isolation)."""
    with _breakers_lock:
        _breakers.clear()

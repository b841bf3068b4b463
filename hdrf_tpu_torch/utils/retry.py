"""Deadline budgets (port of hdrf_tpu/utils/retry.py:50-141, its deadline
half: ``Deadline``, ``DeadlineExceeded``, the ambient ``current`` /
``bind``; the header rebinding, backoff, hedged-quorum and
circuit-breaker half comes with the worker supervision and the EC tier,
later slices).

A :class:`Deadline` is an absolute time budget.  It propagates hop-by-hop
as a REMAINING-SECONDS header (``_deadline`` on RPC kwargs / DT op
fields, riding beside ``_trace``): wall clocks are not synchronized
across hosts, so each hop rebinds the remaining budget against its own
monotonic clock.  The active deadline is ambient (contextvar, like
tracing's current span); the admission controller (utils/qos.py) sheds
an op whose ambient budget cannot cover its service estimate.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Iterator

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


@contextlib.contextmanager
def bind(deadline: Deadline | None) -> Iterator[Deadline | None]:
    """Make ``deadline`` ambient for the body (None = explicitly unbound)."""
    tok = _current_deadline.set(deadline)
    try:
        yield deadline
    finally:
        _current_deadline.reset(tok)

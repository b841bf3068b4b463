"""Per-tenant QoS admission: token buckets, weighted-fair dequeue, and
deadline-aware load shedding (port of hdrf_tpu/utils/qos.py: ``FairQueue``,
``AdmissionController``, ``current_tenant``, ``ShedError``).

Generalizes utils/throttler.py:20 (DataTransferThrottler.java:28's blocking
token bucket) into the NON-blocking admission discipline the overload plane
needs: a flooding tenant must be REFUSED with a structured retryable error,
not parked on a lock it will monopolize.  Re-expression of the reference's
FairCallQueue line — fair scheduling (FairCallQueue.java:46's per-priority
sub-queues drained weighted round-robin, here per-TENANT), backoff-instead-
of-queueing (CallQueueManager.java:92 ``shouldBackOff`` →
RetriableException with a retry hint), and the cost-based user accounting
of DecayRpcScheduler.java:57 — folded onto this repo's existing planes:
tenancy attribution rides utils/tenants.py:1's ``_client`` channel,
deadline budgets ride utils/retry.py:64's ambient :class:`Deadline`, and
service-time estimates come from utils/rollwin.py:117's ``WindowMap``.

Three cooperating pieces:

- :class:`TenantBucket` / :class:`AdmissionController` — per-tenant deficit
  token buckets (``admit`` charges nothing; ``charge`` debits ACTUAL bytes
  after the op, possibly driving the bucket negative — byte counts are
  unknown at admission for streamed writes).  ``admit`` also sheds when the
  ambient ``_deadline`` budget cannot cover the rolling-p95 service
  estimate times ``shed_p95_mult`` — rejecting at admission instead of
  burning a slot to time out mid-pipeline (CallQueueManager.java:92's
  backoff-when-overloaded, with the deadline spine as the signal).
- :class:`ShedError` — the structured retryable refusal.  ``retry_after_s``
  is the hint a client should wait before retrying (RetriableException +
  RetryPolicies.java:178's exponential-backoff contract, made explicit).
- :class:`FairQueue` — a queue.Queue-compatible weighted-fair dequeue
  (put / get / get_nowait, queue.Empty, ``None`` close sentinel) whose
  per-tenant lanes drain round-robin (FairCallQueue.java:214
  ``MultiplexedProcessor``), so the coalescer queues in
  server/write_pipeline.py and server/read_plane.py serve a light tenant's
  items interleaved with — not behind — a flood.

The ambient-tenant contextvar (``bind_tenant`` / ``current_tenant``)
threads attribution through call stacks that cannot carry a parameter
(scheme.reconstruct → ReadCoalescer.fetch), mirroring how retry.py binds
deadlines.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from collections import deque
from queue import Empty  # the contract exception FairQueue.get raises

from hdrf_tpu_torch.utils import fault_injection, metrics, retry, rollwin, tenants

_M = metrics.registry("qos")

# Sentinel distinct from None: the close protocol of the pipeline queues
# uses None as a real item (the stop sentinel), so "no item available"
# needs its own marker inside FairQueue.
_MISSING = object()


class ShedError(IOError):
    """Structured retryable admission refusal.

    ``retry_after_s`` is the server's hint for when a retry is likely to
    be admitted (bucket refill time or the service-estimate budget a
    deadline-shed retry would need).  Subclasses IOError so transports
    that fold server errors into IOError stay compatible; clients that
    recognize the type can honor the hint instead of blind backoff."""

    def __init__(self, msg: str, retry_after_s: float = 0.0,
                 tenant: str | None = None, op: str | None = None):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.tenant = tenant
        self.op = op


# ------------------------------------------------------- tenant attribution

_tenant_var: contextvars.ContextVar = contextvars.ContextVar(
    "hdrf_qos_tenant", default=None)


@contextlib.contextmanager
def bind_tenant(tenant: str | None):
    """Make ``tenant`` ambient for the with-block (reset on exit)."""
    token = _tenant_var.set(tenant)
    try:
        yield
    finally:
        _tenant_var.reset(token)


def current_tenant() -> str | None:
    return _tenant_var.get()


# The control-lane tenant: background bulk work (stripe repair gathers,
# demote pushes, scrubber decode checks — server/coded_exchange.py) binds
# this sentinel so the admission gate recognizes it structurally: never
# shed, never debited against a foreground tenant's bucket, never fed to
# the deadline estimator.  The queue-side face of the same idea is
# FairQueue's control lane (FairCallQueue.java:214's control-priority
# analog); pacing comes from the balance throttle instead of admission.
BACKGROUND_TENANT = "__background__"


@contextlib.contextmanager
def background():
    """Bind the background control lane for the with-block: every op
    inside admits as :data:`BACKGROUND_TENANT` (auditable via the
    ``qos.admit`` fault point) and can never shed foreground traffic."""
    with bind_tenant(BACKGROUND_TENANT):
        yield


def is_background(tenant: str | None = None) -> bool:
    """Is ``tenant`` (default: the ambient one) the control lane?"""
    t = tenant if tenant is not None else current_tenant()
    return t == BACKGROUND_TENANT


# --------------------------------------------------- deficit token buckets


class TenantBucket:
    """Non-blocking deficit token bucket for one tenant.

    Unlike throttler.Throttler (which parks the caller), ``try_admit``
    answers immediately: 0.0 when the bucket is positive, else the seconds
    until it refills past zero — the shed's retry-after hint.  ``charge``
    debits actual bytes AFTER the op and may drive the level negative
    (deficit), so a tenant that burst past its budget pays the overdraft
    before its next admit."""

    def __init__(self, rate_bytes_s: float, burst_bytes: float,
                 clock=time.monotonic):
        self.rate = float(rate_bytes_s)
        self.burst = float(burst_bytes)
        self._clock = clock
        self._level = self.burst
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._level = min(self._level + (now - self._last) * self.rate,
                          self.burst)
        self._last = now

    def try_admit(self) -> float:
        """0.0 = admitted; else seconds until the level turns positive."""
        self._refill()
        if self._level > 0:
            return 0.0
        return (-self._level) / self.rate if self.rate > 0 else 1.0

    def charge(self, nbytes: int) -> None:
        self._refill()
        self._level -= float(nbytes)

    @property
    def level(self) -> float:
        self._refill()
        return self._level


class AdmissionController:
    """The DN-wide admission gate shared by the write and read planes.

    ``admit(tenant, op)`` raises :class:`ShedError` when either
    (a) the tenant's token bucket is in deficit (``rate_mb_s`` > 0), or
    (b) an ambient deadline's remaining budget cannot cover the rolling-p95
    service estimate for ``op`` times ``shed_p95_mult`` — the op would
    time out mid-pipeline anyway, so refuse it before it holds a slot.
    ``charge`` books the op's actual bytes and service latency afterward.

    The service estimator requires ``_MIN_SAMPLES`` observations per op
    before deadline-shedding trusts it (a cold window must not shed)."""

    _MIN_SAMPLES = 5

    def __init__(self, rate_mb_s: float = 0.0, burst_mb: float = 8.0,
                 shed_p95_mult: float = 3.0, clock=time.monotonic):
        self.rate_bytes_s = float(rate_mb_s) * (1 << 20)
        self.burst_bytes = float(burst_mb) * (1 << 20)
        self.shed_p95_mult = float(shed_p95_mult)
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: dict[str, TenantBucket] = {}
        # rolling per-op service times (seconds), 5-minute window — the
        # deadline-shed estimator (rollwin.py:117 WindowMap)
        self._svc = rollwin.WindowMap(window_s=300.0, maxlen=128)
        self._sheds: dict[str, int] = {}

    # -- internals ---------------------------------------------------------

    def _bucket(self, tenant: str) -> TenantBucket:
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = TenantBucket(
                self.rate_bytes_s, self.burst_bytes, clock=self._clock)
        return b

    def _svc_p95_s(self, op: str) -> float | None:
        s = self._svc.summaries(now=self._clock()).get(op)
        if s is None or s["count"] < self._MIN_SAMPLES:
            return None
        return s["p95"]

    def _shed(self, tenant: str, op: str, why: str,
              retry_after_s: float) -> ShedError:
        fault_injection.point("qos.shed", tenant=tenant, op=op, why=why)
        _M.incr("sheds_total")
        _M.incr(f"tenant_sheds|tenant={tenant},op={op}")
        _M.observe("shed_retry_after_ms", retry_after_s * 1e3)
        with self._lock:
            self._sheds[tenant] = self._sheds.get(tenant, 0) + 1
        return ShedError(
            f"admission shed ({why}): tenant={tenant} op={op} "
            f"retry_after={retry_after_s:.3f}s",
            retry_after_s=retry_after_s, tenant=tenant, op=op)

    # -- the gate ----------------------------------------------------------

    def admit(self, tenant: str | None, op: str,
              deadline: retry.Deadline | None = None) -> None:
        """Admission check: raises ShedError, never blocks, charges
        nothing (see ``charge``)."""
        if tenant == BACKGROUND_TENANT:
            # control lane: background exchanges are paced by the balance
            # throttle, never shed, and never touch tenant buckets — but
            # they still pass the gate so the audit trail (fault point +
            # counter) proves what lane every op ran under
            fault_injection.point("qos.admit", tenant=tenant, op=op)
            _M.incr("background_admits")
            return
        tenant = tenant or tenants.DEFAULT_TENANT
        fault_injection.point("qos.admit", tenant=tenant, op=op)
        # (a) token bucket: only with a configured rate
        if self.rate_bytes_s > 0:
            with self._lock:
                wait = self._bucket(tenant).try_admit()
            if wait > 0:
                raise self._shed(tenant, op, "rate", wait)
        # (b) deadline-aware shed: budget cannot cover the p95 estimate
        d = deadline if deadline is not None else retry.current()
        if d is not None and self.shed_p95_mult > 0:
            p95 = self._svc_p95_s(op)
            if p95 is not None:
                need = p95 * self.shed_p95_mult
                if d.remaining() < need:
                    raise self._shed(tenant, op, "deadline", need)
        _M.incr("admits_total")

    def charge(self, tenant: str | None, op: str, nbytes: int = 0,
               latency_s: float | None = None) -> None:
        """Book the op's actual cost: bucket debit + service estimator."""
        if tenant == BACKGROUND_TENANT:
            return  # control lane: no bucket debit, no estimator samples
        tenant = tenant or tenants.DEFAULT_TENANT
        if self.rate_bytes_s > 0 and nbytes > 0:
            with self._lock:
                self._bucket(tenant).charge(nbytes)
        if latency_s is not None:
            self._svc.note(op, latency_s, now=self._clock())

    def note_latency(self, op: str, latency_s: float) -> None:
        """Feed the service estimator without a bucket debit."""
        self._svc.note(op, latency_s, now=self._clock())

    # -- observability -----------------------------------------------------

    def sheds_total(self) -> int:
        with self._lock:
            return sum(self._sheds.values())

    def shed_retry_after_p50_ms(self) -> float:
        with _M._lock:
            h = _M._histograms.get("shed_retry_after_ms")
            return h.quantile(0.5) if h is not None else 0.0

    def report(self) -> dict:
        """Heartbeat / read-plane-report face: shed totals per tenant."""
        with self._lock:
            per_tenant = dict(self._sheds)
        return {"sheds_total": sum(per_tenant.values()),
                "tenant_sheds": per_tenant,
                "rate_mb_s": self.rate_bytes_s / (1 << 20),
                "shed_p95_mult": self.shed_p95_mult}


# ------------------------------------------------------ weighted-fair queue


class FairQueue:
    """queue.Queue-compatible weighted-fair dequeue over per-tenant lanes.

    ``put(item)`` routes by ``item.tenant`` (``None``/missing → the
    default tenant lane); ``get`` drains lanes round-robin so each tenant
    with queued work gets one item per cycle regardless of lane depth
    (FairCallQueue.java:214).  A ``None`` item is the pipelines' close
    sentinel: it parks in a control lane served only once every data lane
    is empty, preserving the FIFO close contract (queued work drains
    before the stop)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._lanes: dict[str, deque] = {}
        self._rr: deque[str] = deque()       # lane service order
        self._control: deque = deque()       # close sentinels

    def put(self, item) -> None:
        with self._cv:
            if item is None:
                self._control.append(item)
            else:
                t = getattr(item, "tenant", None) or tenants.DEFAULT_TENANT
                lane = self._lanes.get(t)
                if lane is None:
                    lane = self._lanes[t] = deque()
                    self._rr.append(t)
                lane.append(item)
            self._cv.notify()

    def _next_locked(self):
        for _ in range(len(self._rr)):
            t = self._rr[0]
            self._rr.rotate(-1)
            lane = self._lanes[t]
            if lane:
                return lane.popleft()
        if self._control:
            return self._control.popleft()
        return _MISSING

    def get(self, block: bool = True, timeout: float | None = None):
        with self._cv:
            end = (None if timeout is None
                   else time.monotonic() + max(timeout, 0.0))
            while True:
                item = self._next_locked()
                if item is not _MISSING:
                    return item
                if not block:
                    raise Empty
                if end is None:
                    self._cv.wait()
                else:
                    remain = end - time.monotonic()
                    if remain <= 0:
                        raise Empty
                    self._cv.wait(remain)

    def get_nowait(self):
        return self.get(block=False)

    def qsize(self) -> int:
        with self._cv:
            return (sum(len(v) for v in self._lanes.values())
                    + len(self._control))

    def depth_by_tenant(self) -> dict[str, int]:
        with self._cv:
            return {t: len(v) for t, v in self._lanes.items() if v}

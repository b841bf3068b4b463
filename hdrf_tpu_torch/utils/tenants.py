"""Per-tenant (client) attribution: op/byte counters + rolling SLO gauges
(port of hdrf_tpu/utils/tenants.py, whole).

The reference has no per-client metrics at all — DataNodeMetrics.java:553-560
counts ops per daemon and NameNode audit logging (FSNamesystem.java:8040
``logAuditEvent``) records *who* called but never aggregates per caller — so
a noisy neighbor is invisible until it moves the daemon-wide p99.  Here every
RPC and data-transfer op carries a ``_client`` id on the existing side-channel
(proto/rpc.py:123-145's ``_trace``/``_dtoken``/``_user`` kwarg strip;
proto/datatransfer.py:74-83's header-field stamp), and the serving daemons
feed one process-wide tracker:

- cumulative ``tenant_ops|tenant=<t>,op=<kind>`` /
  ``tenant_bytes|tenant=<t>,op=<kind>`` counters (utils/prom.py renders the
  ``|k=v`` suffix as labels, so /prom gets real per-tenant series);
- rolling p50/p95/p99 latency gauges (``tenant_p50_ms`` etc.) over decayed
  windows (utils/rollwin.py:27-74's RollingWindow via the nearest-rank
  ``quantiles()`` extension) — the per-tenant SLO surface ROADMAP item 2's
  QoS/admission work will act on.

Tenancy here is attribution, not authentication: the ``_client`` id is the
client's self-reported name (client/filesystem.py stamps it), exactly like
the reference's clientName field on writeBlock (DataTransferProtocol.java's
clientname) — the authenticated principal stays ``_user``.
"""

from __future__ import annotations

import threading
import time

from . import metrics, rollwin

_M = metrics.registry("tenants")

DEFAULT_TENANT = "anon"  # ops arriving without a _client id

_PCTS = (50, 95, 99)


class TenantTracker:
    """Process-wide per-tenant accounting: cumulative counters into the
    ``tenants`` registry plus decayed latency windows per (tenant, op)."""

    def __init__(self, window_s: float = 300.0, maxlen: int = 128,
                 clock=time.monotonic):
        self._lat = rollwin.WindowMap(window_s, maxlen, clock)
        self._lock = threading.Lock()
        self._seen: set[str] = set()

    def note_op(self, tenant: str | None, op: str, nbytes: int = 0,
                latency_s: float | None = None,
                now: float | None = None) -> None:
        """One served op for ``tenant``: bumps the op counter, adds
        ``nbytes`` to the byte counter, and (when a latency is supplied)
        folds it into the rolling window and refreshes that series'
        p50/p95/p99 gauges."""
        t = tenant or DEFAULT_TENANT
        with self._lock:
            self._seen.add(t)
        _M.incr(f"tenant_ops|tenant={t},op={op}")
        if nbytes:
            _M.incr(f"tenant_bytes|tenant={t},op={op}", int(nbytes))
        if latency_s is not None:
            self._lat.note((t, op), latency_s * 1e3, now=now)
            with self._lat._lock:
                win = self._lat._wins.get((t, op))
            qs = win.quantiles(_PCTS, now=now) if win is not None else None
            if qs:
                for p in _PCTS:
                    _M.gauge(f"tenant_p{p}_ms|tenant={t},op={op}", qs[f"p{p}"])

    def tenant_count(self) -> int:
        """Distinct tenants seen since process start (cumulative — decayed
        windows don't shrink it; the bench's ``tenant_count`` stamp)."""
        with self._lock:
            return len(self._seen)

    def summaries(self, now: float | None = None) -> dict:
        """``"<tenant>/<op>" -> {"p50","p95","p99"}`` over live windows —
        the JSON shape /health and the flight recorder embed."""
        out = {}
        for (t, op), s in self._lat.summaries(now).items():
            with self._lat._lock:
                win = self._lat._wins.get((t, op))
            qs = win.quantiles(_PCTS, now=now) if win is not None else None
            if qs is not None:
                out[f"{t}/{op}"] = qs
        return out

    def reset(self) -> None:
        """Drop windows + the seen set (test isolation); the cumulative
        ``tenants`` registry counters are left alone, like profiler.reset."""
        with self._lock:
            self._seen.clear()
        with self._lat._lock:
            self._lat._wins.clear()


TRACKER = TenantTracker()


def note_op(tenant: str | None, op: str, nbytes: int = 0,
            latency_s: float | None = None, now: float | None = None) -> None:
    TRACKER.note_op(tenant, op, nbytes=nbytes, latency_s=latency_s, now=now)


def tenant_count() -> int:
    return TRACKER.tenant_count()


def summaries(now: float | None = None) -> dict:
    return TRACKER.summaries(now)

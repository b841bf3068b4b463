"""Time-series flight recorder: fixed-cadence gauge snapshots per daemon
(port of hdrf_tpu/utils/flight_recorder.py, whole).

Every surface the daemons already expose is a point-in-time read — /prom and
/metrics (server/status_http.py:52-77) answer "what is the value NOW", and
the reference is no better: Hadoop's MutableRollingAverages keeps a few
windowed means but nothing per-daemon you can plot.  ROADMAP item 3's honest
production number is a *curve* ("tracks storage_ratio and read latency over
time, not just at first write"), so each daemon runs one of these: a sampler
thread that, every ``interval_s``, calls the daemon-supplied ``sample_fn()``
(a dozen key gauges — storage ratio, dedup ratio, cache hit rate, read/write
p95, inflight, breaker states from utils/retry.py:393-395's
``all_breakers``) and appends the dict into a bounded ring.

The ring serves as ``/timeseries`` JSON on status_http + the gateway and is
rendered by tools/slo_report.py (the over-time sibling of
tools/gap_report.py:60-99's one-shot aggregation).  Deterministic for tests:
clocks are injectable and ``sample_once()`` drives the sampler inline — the
thread is just a cadence, never the semantics.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

from . import metrics

_M = metrics.registry("flight_recorder")


class FlightRecorder:
    """Bounded time-series ring of gauge snapshots, sampled on a cadence.

    ``sample_fn() -> dict[str, float]`` is the daemon's gauge set; each
    sample lands as ``{"t": <wall>, "mono": <monotonic>, **gauges}``.
    Oldest samples fall off once ``capacity`` is reached, bounding memory
    to ``capacity`` dicts regardless of uptime."""

    def __init__(self, name: str, sample_fn: Callable[[], dict],
                 interval_s: float = 1.0, capacity: int = 512,
                 clock=time.monotonic, wall=time.time, archive=None):
        self.name = name
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self._sample_fn = sample_fn
        self._clock = clock
        self._wall = wall
        self._ring: deque[dict[str, Any]] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.archive = archive
        if archive is not None:
            # Restart survival: re-seed the ring from the archive's tail
            # (utils/flight_archive.py replay — torn tails already
            # dropped), so /timeseries shows pre-crash history at once.
            for s in archive.replay(limit=self.capacity):
                self._ring.append(s)

    def sample_once(self) -> dict[str, Any]:
        """Take one sample inline (the thread's body; tests call it
        directly for determinism).  A sample_fn error is counted, not
        raised — the recorder must never take its daemon down."""
        try:
            gauges = self._sample_fn() or {}
        except Exception:  # noqa: BLE001 — recorder outlives gauge bugs
            _M.incr("sample_errors")
            gauges = {}
        sample = {"t": self._wall(), "mono": self._clock(), **gauges}
        with self._lock:
            self._ring.append(sample)
        if self.archive is not None:
            try:
                self.archive.append(sample)
            except (OSError, ValueError):  # ValueError: closed archive
                _M.incr("archive_errors")
        _M.incr("samples_total")
        return sample

    def snapshot(self) -> dict[str, Any]:
        """The ``/timeseries`` JSON body: ring contents oldest-first plus
        the cadence metadata a renderer needs to put time on an axis."""
        with self._lock:
            samples = list(self._ring)
        return {"daemon": self.name, "interval_s": self.interval_s,
                "capacity": self.capacity, "samples": samples}

    # ------------------------------------------------------------ lifecycle

    def start(self) -> "FlightRecorder":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"flight-recorder-{self.name}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

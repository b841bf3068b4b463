"""Crash-safe flight-recorder archive + cluster time-series math (port of
hdrf_tpu/utils/flight_archive.py, whole).

Long-horizon half of the flight plane (utils/flight_recorder.py:33-76):
every in-memory surface so far — the gauge ring, the device ledger, the
trace sink — dies with its daemon, yet the honest production number is a
*curve over restarts*.  This module persists each
daemon's flight samples with the same durability discipline the chunk
index WAL established (index/chunk_index.py:19-27, utils/wal.py:44-60;
the FSEditLog.java:124 lineage):

- **Append-only JSONL segments**: one compact JSON object per line,
  appended to the active segment ``flight-<seq>.jsonl``; sample dicts are
  JSON-plain by construction (flight_recorder.py snapshot contract).
- **Fsync'd rotation**: when the active segment exceeds
  ``segment_bytes`` it is flushed, fsync'd, and sealed (directory entry
  fsync'd too — the tmp+fsync+replace cousin used by container seals);
  a sealed segment is durable history, the active one is best-effort
  until sealed (or ``sync()`` is called).
- **Size/age-bounded GC**: after each rotation, oldest sealed segments
  are deleted until the directory fits ``max_bytes``; segments older
  than ``max_age_s`` (0 = disabled) age out regardless of size.
- **Torn-tail-tolerant replay**: a crash mid-append leaves a final line
  without a newline or with broken JSON; replay keeps each segment's
  good prefix and drops the tail (the WAL ``scan()`` good-prefix rule,
  utils/wal.py:29-41), and re-opening for append truncates the torn tail
  first so post-crash samples never land behind garbage.

Also hosts the cluster-series math the gateway's
``/timeseries?scope=cluster`` endpoint needs (server/http_gateway.py):
``filter_series`` (``?metric=``/``?since=``), ``merge_cluster`` (align
per-daemon samples into time buckets; quantile-class gauges merge as the
MAX across nodes — quantiles cannot be averaged, and the slowest node's
tail is the cluster tail a client actually sees — additive gauges sum,
ratios take the mean), and ``rollup`` (step-bucketed min/max/mean/last
downsampling so a million-sample archive renders bounded).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Iterable

from . import metrics

_M = metrics.registry("flight_archive")

SEGMENT_PREFIX = "flight-"
SEGMENT_SUFFIX = ".jsonl"


def _segment_name(seq: int) -> str:
    return f"{SEGMENT_PREFIX}{seq:08d}{SEGMENT_SUFFIX}"


def _segment_seq(name: str) -> int | None:
    if not (name.startswith(SEGMENT_PREFIX)
            and name.endswith(SEGMENT_SUFFIX)):
        return None
    body = name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)]
    return int(body) if body.isdigit() else None


def list_segments(directory: str) -> list[str]:
    """Segment file names under ``directory``, oldest first."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    segs = [(s, n) for n in names
            if (s := _segment_seq(n)) is not None]
    return [n for _, n in sorted(segs)]


def scan_lines(data: bytes) -> tuple[list[dict], int]:
    """Good-prefix scan of one segment's bytes: parsed samples plus the
    byte length of the intact prefix.  Stops at the first line that fails
    to parse or lacks its terminating newline (torn tail)."""
    samples: list[dict] = []
    good = 0
    pos = 0
    n = len(data)
    while pos < n:
        nl = data.find(b"\n", pos)
        if nl < 0:
            break  # torn tail: bytes without a newline
        line = data[pos:nl]
        if line:
            try:
                doc = json.loads(line)
            except ValueError:
                break  # corrupt line: keep the good prefix only
            if not isinstance(doc, dict):
                break
            samples.append(doc)
        pos = nl + 1
        good = pos
    return samples, good


def replay_dir(directory: str, limit: int | None = None,
               since: float | None = None) -> list[dict]:
    """Read-only replay of every segment, oldest first, torn tails
    dropped — the shape ``slo_report --input <dir>`` and the query
    surfaces consume.  Never truncates (offline viewers must not mutate
    a live daemon's archive)."""
    out: list[dict] = []
    for name in list_segments(directory):
        try:
            with open(os.path.join(directory, name), "rb") as f:
                data = f.read()
        except OSError:
            continue
        samples, good = scan_lines(data)
        if good < len(data):
            _M.incr("torn_tail_drops")
        out.extend(samples)
    if since is not None:
        out = [s for s in out if float(s.get("t", 0.0)) >= since]
    if limit is not None and len(out) > limit:
        out = out[-limit:]
    _M.incr("replayed_samples", len(out))
    return out


class FlightArchive:
    """Append-only JSONL segment store for one daemon's flight samples."""

    def __init__(self, directory: str, max_bytes: int = 64 << 20,
                 segment_bytes: int = 1 << 20, max_age_s: float = 0.0,
                 wall=time.time):
        self.directory = directory
        self.max_bytes = int(max_bytes)
        self.segment_bytes = int(segment_bytes)
        self.max_age_s = float(max_age_s)
        self._wall = wall
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        segs = list_segments(directory)
        self._seq = (_segment_seq(segs[-1]) or 0) if segs else 1
        self._open_active()
        self.gc()

    # ------------------------------------------------------------ append

    def _active_path(self) -> str:
        return os.path.join(self.directory, _segment_name(self._seq))

    def _open_active(self) -> None:
        """Open the active segment for append, truncating any torn tail
        first (utils/wal.py:44-60 ``recover``'s rule: records appended
        behind garbage would be unreachable by the next replay)."""
        path = self._active_path()
        if os.path.exists(path):
            with open(path, "rb") as f:
                data = f.read()
            _, good = scan_lines(data)
            if good < len(data):
                _M.incr("torn_tail_drops")
                with open(path, "r+b") as f:
                    f.truncate(good)
        self._f = open(path, "ab")

    def append(self, sample: dict) -> None:
        """Append one sample (one line).  Flushed to the OS on every
        append — a process crash loses nothing; only a host crash can
        tear the active segment's tail, which replay drops."""
        line = (json.dumps(sample, separators=(",", ":"),
                           default=float) + "\n").encode()
        with self._lock:
            self._f.write(line)
            self._f.flush()
            _M.incr("appends_total")
            if self._f.tell() >= self.segment_bytes:
                self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Seal the active segment (fsync file + directory) and open the
        next one; then GC.  The fsync here is what upgrades best-effort
        appends into durable history."""
        os.fsync(self._f.fileno())
        self._f.close()
        self._fsync_dir()
        self._seq += 1
        self._f = open(self._active_path(), "ab")
        _M.incr("segments_rotated")
        self._gc_locked()

    def _fsync_dir(self) -> None:
        try:
            dfd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # platforms without directory fsync

    def sync(self) -> None:
        """Force-durability point (daemon shutdown): fsync the active
        segment without sealing it."""
        with self._lock:
            self._f.flush()
            os.fsync(self._f.fileno())

    # ---------------------------------------------------------------- gc

    def _gc_locked(self) -> int:
        """Delete oldest SEALED segments until the byte budget holds and
        every survivor is younger than ``max_age_s``.  The active segment
        is never deleted — the tail of history always survives."""
        removed = 0
        now = self._wall()
        active = _segment_name(self._seq)
        sealed = [n for n in list_segments(self.directory) if n != active]
        sizes = {}
        for n in list_segments(self.directory):
            try:
                sizes[n] = os.path.getsize(os.path.join(self.directory, n))
            except OSError:
                sizes[n] = 0
        total = sum(sizes.values())
        for n in list(sealed):
            path = os.path.join(self.directory, n)
            age = 0.0
            if self.max_age_s > 0:
                try:
                    age = now - os.path.getmtime(path)
                except OSError:
                    age = 0.0
            over_budget = total > self.max_bytes
            too_old = self.max_age_s > 0 and age > self.max_age_s
            if not (over_budget or too_old):
                break  # oldest survivor fits: younger ones fit too
            try:
                os.remove(path)
            except OSError:
                break
            total -= sizes.get(n, 0)
            removed += 1
            _M.incr("segments_gc")
        _M.gauge("archive_bytes", total)
        return removed

    def gc(self) -> int:
        with self._lock:
            return self._gc_locked()

    # ------------------------------------------------------------- reads

    def total_bytes(self) -> int:
        return sum(os.path.getsize(os.path.join(self.directory, n))
                   for n in list_segments(self.directory)
                   if os.path.exists(os.path.join(self.directory, n)))

    def replay(self, limit: int | None = None,
               since: float | None = None) -> list[dict]:
        """Samples across every segment, oldest first, torn tails
        dropped.  Reads see appended-but-unsealed lines too (same file)."""
        with self._lock:
            self._f.flush()
        return replay_dir(self.directory, limit=limit, since=since)

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            self._f.close()


# ===================================================== cluster series math

# Gauges that are per-node tallies: the cluster value is the SUM.
SUM_GAUGES = ("blocks", "inflight", "stalls", "sheds_total",
              "garbage_bytes", "scrub_corrupt_total", "fsck_violations",
              "breakers_open", "breakers_half_open", "tenant_count",
              "datanodes", "datanodes_live", "under_replicated",
              "pending_replication", "pending_recovery")
# Gauges that are latency quantiles: quantiles cannot be averaged, and
# the cluster tail a client experiences is governed by the slowest node,
# so the merge is the MAX (a conservative envelope).
QUANTILE_SUFFIXES = ("_p50_ms", "_p95_ms", "_p99_ms")


def merge_value(name: str, vals: list[float]) -> float:
    """One gauge's cluster value from its per-node values."""
    if name.endswith(QUANTILE_SUFFIXES):
        return max(vals)
    if name in SUM_GAUGES:
        return float(sum(vals))
    return sum(vals) / len(vals)


def filter_series(samples: Iterable[dict], metric: str | None = None,
                  since: float | None = None) -> list[dict]:
    """The ``?metric=``/``?since=`` projection: keep only the requested
    gauge(s) (comma-separated; clock stamps always survive) and samples
    at or after ``since`` (wall seconds)."""
    keep = None
    if metric:
        keep = {m.strip() for m in metric.split(",") if m.strip()}
    out = []
    for s in samples:
        if since is not None and float(s.get("t", 0.0)) < since:
            continue
        if keep is None:
            out.append(s)
        else:
            out.append({k: v for k, v in s.items()
                        if k in ("t", "mono") or k in keep})
    return out


def merge_cluster(series: list[tuple[str, list[dict]]],
                  step_s: float = 1.0) -> list[dict]:
    """Align per-daemon sample streams into one cluster series: bucket by
    ``floor(t / step_s)``, then fold each gauge across every sample that
    landed in the bucket with :func:`merge_value`.  Each output sample
    carries ``t`` (bucket start), ``nodes`` (distinct daemons that
    contributed), and the merged gauges — deterministic for injected
    clocks (tests pin the quantile/sum/mean arithmetic)."""
    step = max(float(step_s), 1e-9)
    buckets: dict[int, dict[str, list[float]]] = {}
    contributors: dict[int, set[str]] = {}
    for daemon, samples in series:
        for s in samples:
            b = int(float(s.get("t", 0.0)) // step)
            vals = buckets.setdefault(b, {})
            contributors.setdefault(b, set()).add(daemon)
            for k, v in s.items():
                if k in ("t", "mono") or not isinstance(v, (int, float)):
                    continue
                vals.setdefault(k, []).append(float(v))
    out = []
    for b in sorted(buckets):
        merged: dict[str, Any] = {"t": b * step,
                                  "nodes": len(contributors[b])}
        for name, vals in sorted(buckets[b].items()):
            merged[name] = merge_value(name, vals)
        out.append(merged)
    return out


def rollup(samples: list[dict], step_s: float) -> list[dict]:
    """Step-bucketed downsampling: one output row per ``step_s`` bucket
    with ``{min, max, mean, last}`` per gauge — the bounded-response
    rendering of an archive too long to ship sample-by-sample."""
    step = max(float(step_s), 1e-9)
    buckets: dict[int, list[dict]] = {}
    for s in samples:
        buckets.setdefault(int(float(s.get("t", 0.0)) // step),
                           []).append(s)
    out = []
    for b in sorted(buckets):
        group = buckets[b]
        gauges: dict[str, dict] = {}
        for s in group:
            for k, v in s.items():
                if k in ("t", "mono", "nodes") \
                        or not isinstance(v, (int, float)):
                    continue
                g = gauges.setdefault(
                    k, {"min": float(v), "max": float(v),
                        "sum": 0.0, "n": 0, "last": float(v)})
                g["min"] = min(g["min"], float(v))
                g["max"] = max(g["max"], float(v))
                g["sum"] += float(v)
                g["n"] += 1
                g["last"] = float(v)
        row = {"t": b * step, "n": len(group), "gauges": {}}
        for k, g in sorted(gauges.items()):
            row["gauges"][k] = {"min": g["min"], "max": g["max"],
                                "mean": g["sum"] / g["n"],
                                "last": g["last"]}
        out.append(row)
    return out


def query(recorder, archive: FlightArchive | None = None,
          metric: str | None = None, since: float | None = None,
          limit: int = 2048) -> dict:
    """One daemon's ``/timeseries`` answer over ring + archive: archived
    (restart-survived) history first, the live ring on top, de-duplicated
    by the ``(t, mono)`` clock stamp pair (ring samples were also
    appended to the archive), filtered, and tail-limited.  Shared by the
    DN ``flight_timeseries`` op and the NN ``flight_query`` RPC."""
    snap = recorder.snapshot()
    samples: list[dict] = []
    seen: set[tuple] = set()
    archived = archive.replay() if archive is not None else []
    for s in archived + list(snap["samples"]):
        key = (s.get("t"), s.get("mono"))
        if key in seen:
            continue
        seen.add(key)
        samples.append(s)
    samples = filter_series(samples, metric=metric, since=since)
    if len(samples) > limit:
        samples = samples[-limit:]
    return {"daemon": snap["daemon"], "interval_s": snap["interval_s"],
            "capacity": snap["capacity"], "archived": len(archived),
            "samples": samples}

"""Prometheus text exposition for the metrics registries (port of
hdrf_tpu/utils/prom.py ``render``; the same registry contents render to
the same bytes).

Equivalent of the reference's metrics2 sink layer (Hadoop's
``PrometheusMetricsSink`` rendering DataNodeMetrics.java:53 /
NameNodeMetrics.java:42 records as text exposition format): every
MetricsRegistry snapshot becomes ``# TYPE``-annotated families with the
registry name as a label.  Conventions:

- counters  -> ``hdrf_<key>_total{registry="r"} v``   (``_total`` appended
  once — keys already ending in ``_total`` are not doubled)
- gauges    -> ``hdrf_<key>{registry="r"} v``
- histograms-> ``hdrf_<key>_bucket{registry="r",le="<bound>"}`` CUMULATIVE
  counts (utils/metrics.py Histogram.snapshot), ``le="+Inf"`` == ``_count``,
  plus ``_sum`` and ``_count`` series.
- a metric key may carry a ``|k=v,k2=v2`` label suffix (e.g. the device
  ledger's per-op ``wait_us|op=sha256`` or the profiler's
  ``phase_us|phase=wal_commit``): the part before ``|`` names the family,
  the pairs become extra labels after ``registry`` — so labeled series
  share one family with their unlabeled aggregate.

One ``# TYPE`` line per family name across ALL registries (the format forbids
repeats), so same-named metrics from different registries share a family and
differ only in the ``registry`` label.
"""

from __future__ import annotations

import re
from typing import Any

_SAN = re.compile(r"[^a-zA-Z0-9_:]")


def _name(key: str) -> str:
    n = _SAN.sub("_", key)
    if n and n[0].isdigit():
        n = "_" + n
    return "hdrf_" + n


def _fmt(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _split_key(key: str) -> tuple[str, str]:
    """Split ``base|k=v,k2=v2`` into (base, rendered extra labels)."""
    if "|" not in key:
        return key, ""
    base, _, rest = key.partition("|")
    parts = []
    for pair in rest.split(","):
        k, _, v = pair.partition("=")
        v = v.replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{_SAN.sub("_", k)}="{v}"')
    return base, "," + ",".join(parts)


def render(snapshots: dict[str, Any]) -> str:
    """Render ``metrics.all_snapshots()``-shaped dicts as exposition text."""
    families: dict[str, tuple[str, list[str]]] = {}

    def fam(name: str, ptype: str) -> list[str]:
        got = families.get(name)
        if got is None:
            got = families[name] = (ptype, [])
        return got[1]

    for reg_name, snap in sorted(snapshots.items()):
        lbl = f'registry="{_SAN.sub("_", reg_name)}"'
        for key, v in sorted(snap.get("counters", {}).items()):
            raw, extra = _split_key(key)
            base = _name(raw)
            if not base.endswith("_total"):
                base += "_total"
            fam(base, "counter").append(f"{base}{{{lbl}{extra}}} {_fmt(v)}")
        for key, v in sorted(snap.get("gauges", {}).items()):
            raw, extra = _split_key(key)
            base = _name(raw)
            fam(base, "gauge").append(f"{base}{{{lbl}{extra}}} {_fmt(v)}")
        for key, h in sorted(snap.get("histograms", {}).items()):
            raw, extra = _split_key(key)
            base = _name(raw)
            rows = fam(base, "histogram")
            for bound, cum in h.get("buckets", []):
                rows.append(
                    f'{base}_bucket{{{lbl}{extra},le="{_fmt(bound)}"}} '
                    f"{_fmt(cum)}")
            rows.append(f'{base}_bucket{{{lbl}{extra},le="+Inf"}} '
                        f"{_fmt(h['count'])}")
            rows.append(f"{base}_sum{{{lbl}{extra}}} {_fmt(h.get('sum', 0.0))}")
            rows.append(f"{base}_count{{{lbl}{extra}}} {_fmt(h['count'])}")

    out: list[str] = []
    for name, (ptype, rows) in sorted(families.items()):
        out.append(f"# TYPE {name} {ptype}")
        out.extend(rows)
    return "\n".join(out) + "\n" if out else "\n"

"""Gap-attribution report over write-path profiler timelines (port of
hdrf_tpu/tools/gap_report.py; its smoke runs on the port's MiniCluster).

The observability artifact the write path's gains are judged against: the
reference ships nothing comparable (its closest relative is the rate summary
``dfsadmin -report`` prints from DatanodeInfo.java:519-560 — throughput with
no decomposition), so this tool is where the profiler's per-block phase
spans (utils/profiler.py) become an engineering answer: "the write path
does X MB/s; serialized WAL commit costs Y MB/s, awaited device dispatch Z,
…".  For each phase it computes the rate the run would reach if that phase's
EXCLUSIVE (non-overlapped) seconds vanished — the classic critical-path
what-if — and for the run as a whole the overlap-efficiency ratio (hidden /
hideable wait).

Sources, in order of preference:

- ``--input FILE``: a JSON list of BlockTimeline snapshots (a
  /traces-style capture), OR bench.py's single JSON output line itself
  (the ``phase_profile`` object is lifted out), OR a bare window/phase
  profile object — so ``python bench.py > out.json`` pipes straight in;
- default: run an in-process MiniCluster smoke write (the tiny-corpus
  analog of ``HDRF_BENCH_SMOKE``) and report over its timelines — the
  zero-setup mode the acceptance gate drives
  (``python -m hdrf_tpu_torch.tools.gap_report``).
"""

from __future__ import annotations

import argparse
import json
import sys

from hdrf_tpu_torch.utils import profiler

SMOKE_BLOCKS = 4
SMOKE_BLOCK_MB = 1


def run_smoke(n_blocks: int = SMOKE_BLOCKS,
              block_mb: int = SMOKE_BLOCK_MB) -> list[dict]:
    """Write a tiny dedup corpus through a MiniCluster and return the
    finished BlockTimeline snapshots (deterministic data: half fresh
    pseudo-random bytes, half a repeat of the first block so dedup_lookup
    and container_io both see realistic hit/miss mixes)."""
    import random

    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    profiler.reset()
    rng = random.Random(0x6A9)
    fresh = bytes(rng.getrandbits(8) for _ in range(block_mb << 20))
    with MiniCluster(n_datanodes=1, replication=1,
                     block_size=block_mb << 20) as mc:
        with mc.client("gap-report") as c:
            for i in range(n_blocks):
                payload = fresh if i % 2 else fresh[::-1]
                c.write(f"/gap/blk{i}", payload, scheme="dedup")
    return profiler.timelines_snapshot()


def aggregate(timelines: list[dict]) -> dict:
    """Fold per-block profiles into one run-level attribution table."""
    wall = nbytes = 0.0
    hidden = hideable = 0.0
    classes = dict.fromkeys(profiler.CLASSES, 0.0)
    phases: dict[str, float] = {}
    for tl in timelines:
        prof = tl.get("profile") or {}
        wall += prof.get("wall_s", 0.0)
        nbytes += tl.get("nbytes", 0) or 0
        hidden += prof.get("hidden_wait_s", 0.0)
        hideable += prof.get("hideable_wait_s", 0.0)
        for k, v in (prof.get("classes") or {}).items():
            classes[k] = classes.get(k, 0.0) + v
        for k, v in (prof.get("phases") or {}).items():
            phases[k] = phases.get(k, 0.0) + v
    rate = nbytes / wall / (1 << 20) if wall > 0 else 0.0
    rows = []
    for name, excl in phases.items():
        # rate if this phase's exclusive time vanished (critical-path
        # what-if); "lost" is the MB/s that phase costs the run
        without = nbytes / (wall - excl) / (1 << 20) if wall > excl else 0.0
        rows.append({"phase": name, "exclusive_s": excl,
                     "share": excl / wall if wall > 0 else 0.0,
                     "lost_mb_per_s": max(without - rate, 0.0)})
    rows.sort(key=lambda r: (-r["exclusive_s"], r["phase"]))
    attributed = (classes["host_busy"] + classes["device_busy"]
                  + classes["transport_wait"])
    return {
        "blocks": len(timelines),
        "bytes": int(nbytes),
        "wall_s": wall,
        "mb_per_s": rate,
        "classes": classes,
        "attributed_frac": attributed / wall if wall > 0 else 1.0,
        "overlap_efficiency": hidden / hideable if hideable > 0 else 1.0,
        "hidden_wait_s": hidden,
        "hideable_wait_s": hideable,
        "phases": rows,
    }


def format_table(agg: dict) -> str:
    """Deterministic text rendering (golden-tested)."""
    out = []
    out.append(f"write path: {agg['blocks']} blocks, "
               f"{agg['bytes'] / (1 << 20):.2f} MiB in {agg['wall_s']:.3f} s "
               f"= {agg['mb_per_s']:.1f} MB/s")
    out.append(f"attributed: {agg['attributed_frac'] * 100.0:.1f}% of wall "
               f"clock in named phase/overlap classes")
    out.append(f"overlap efficiency: {agg['overlap_efficiency'] * 100.0:.1f}%"
               f" ({agg['hidden_wait_s']:.3f} s of "
               f"{agg['hideable_wait_s']:.3f} s wait hidden under host work)")
    out.append("")
    out.append(f"{'class':<16} {'seconds':>9} {'share':>7}")
    wall = agg["wall_s"] or 1.0
    for cls in profiler.CLASSES:
        v = agg["classes"].get(cls, 0.0)
        out.append(f"{cls:<16} {v:>9.3f} {v / wall * 100.0:>6.1f}%")
    out.append("")
    out.append(f"{'phase':<16} {'excl s':>9} {'share':>7} {'lost MB/s':>10}")
    for r in agg["phases"]:
        out.append(f"{r['phase']:<16} {r['exclusive_s']:>9.3f} "
                   f"{r['share'] * 100.0:>6.1f}% {r['lost_mb_per_s']:>10.1f}")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="hdrf_tpu_torch.tools.gap_report",
        description="Gap-attribution table over write-path timelines")
    p.add_argument("--input", help="JSON file of BlockTimeline snapshots "
                   "(default: run a MiniCluster smoke write)")
    p.add_argument("--blocks", type=int, default=SMOKE_BLOCKS,
                   help="smoke-mode block count")
    p.add_argument("--json", action="store_true",
                   help="emit the aggregate as JSON instead of the table")
    args = p.parse_args(argv)
    if args.input:
        with open(args.input) as f:
            doc = json.load(f)
        if isinstance(doc, dict):
            # bench.py's JSON line (lift its phase_profile) or a bare
            # window-profile object: view it as one pseudo-timeline so
            # the same aggregation serves both shapes
            prof = doc.get("phase_profile", doc)
            doc = [{"nbytes": prof.get("bytes", 0), "profile": prof}]
        timelines = doc
    else:
        timelines = run_smoke(n_blocks=args.blocks)
    agg = aggregate(timelines)
    if args.json:
        print(json.dumps(agg))
    else:
        print(format_table(agg))
    return 0


if __name__ == "__main__":
    sys.exit(main())

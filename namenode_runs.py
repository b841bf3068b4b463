#!/usr/bin/env python3
"""Run chip_smoke.py's NAMENODE phase several times in one process on the
card, with the DataNodes' command log on.

    python3 namenode_runs.py [--runs 8] [--seed 0] [--block-mib 128]

The kernels build first (``_build.library()``, a ``BUILD`` line).  Each
pass is ``chip_smoke.namenode_phase`` at its defaults: the port's
NameNode at ``NameNodeConfig()`` defaults, four port DataNodes on
``cuda:0``, the ``reduce`` corpus in 128 MiB blocks, and its steps (a)
write and read, (b) NameNode restart, (c) re-replication and excess
pruning, (d) demotion and stripe repair (no DataNode above m stripes of
a group after either, unless a repair had no room), (e) metadata ops,
each holding ``DN_FAULTS`` to no change.  ``chip_smoke.DnCommandLog`` prints every
``replicate``'s outcome, every command that raises and every OSError an
xceiver op swallows (``NAMENODE log`` lines).

Each pass prints one ``NNRUN`` JSON line: its index, ``ok`` or the
failure, its seconds, each step's seconds, the re-replication and
demotion waits, the command counters of steps (b), (c) and (d), and
(d)'s slow peers, lost holder, most stripes of a group on one DataNode
after the demotion and after the repair, and repairs placed past m.  The last
lines are one ``NNRUNS`` JSON object (passes, failures, the seconds of
each step over the passes) and the card's name and power limit.  Exits
1 if any pass failed, 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import chip_smoke as cs
from hdrf_tpu_torch.ops import _build


def one_pass(i: int, args) -> dict:
    t0 = time.perf_counter()
    try:
        with cs.DnCommandLog() as log:
            nm = cs.namenode_phase(args)
    except cs.SmokeFailure as e:
        return {"run": i, "ok": False, "error": str(e),
                "seconds": time.perf_counter() - t0}
    return {"run": i, "ok": True, "seconds": nm["seconds"],
            "steps": {k: nm[k]["seconds"] for k in "abcde"},
            "rereplicated_s": nm["c"]["rereplicated_s"],
            "rereplicated_blocks": nm["c"]["rereplicated_blocks"],
            "demote_s": nm["d"]["demote_s"],
            "commands_b": nm["b"]["commands"],
            "commands_c": nm["c"]["commands"],
            "commands_d": nm["d"]["commands"],
            "slow_peers": nm["d"]["slow_peers"],
            "lost_holder": nm["d"]["lost_holder"],
            "most_stripes_a_datanode": {
                w: max(max(g.values()) for g in nm["d"][key].values())
                for w, key in (("demoted", "stripes_demoted"),
                               ("repaired", "stripes_repaired_to"))},
            "repairs_over_m": nm["d"]["repairs_over_m"],
            "log_entries": len(log.entries)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="namenode_runs")
    p.add_argument("--runs", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--block-mib", type=int, default=128)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(torch.device("cuda", 0))
    # the kernels build before the first pass, as in the whole smoke: a
    # build inside (a)'s first write would hold that one-block file past
    # its 60 s lease
    t0 = time.perf_counter()
    _build.library()
    print(f"BUILD {time.perf_counter() - t0:.1f}s", flush=True)
    rows = []
    for i in range(args.runs):
        row = one_pass(i, args)
        rows.append(row)
        print("NNRUN " + json.dumps(row), flush=True)
    ok = [r for r in rows if r["ok"]]
    print("NNRUNS " + json.dumps({
        "passes": len(ok), "failures": len(rows) - len(ok),
        "seconds": [r["seconds"] for r in rows],
        "steps": {k: [r["steps"][k] for r in ok] for k in "abcde"},
        "rereplicated_s": [r["rereplicated_s"] for r in ok],
        "demote_s": [r["demote_s"] for r in ok]}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0 if len(ok) == len(rows) else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the reference DataNode and the port's on the same op stream, on
the CPU at the ``native`` backend.

    JAX_PLATFORMS=cpu python3 datanode_times.py [--blocks 8]
        [--block-mib 16] [--streams 4] [--order ref,port,port,ref]

Each run starts three DataNodes of one package on fresh directories
under a temporary root, at ``DataNodeConfig()`` / ``ReductionConfig()``
defaults (``dedup_lz4``, 32 MiB containers) but for the ``native``
backend, beside a stand-in NameNode (``tests/_dn_standin.py``).  It
writes chip_smoke.py's reduce corpus (``main_path_corpus``, cut to
``--block-mib``) at replication 3: DN1 with targets DN2 and DN3, so the
mirror legs carry the reduced form (hashes, the need list, the chunk
delta), over ``--streams`` concurrent client streams.  Every write must
be acked with success, no mirror leg may fail, and the last DataNode of
the chain must read every block back equal.

Each run prints one ``DNTIME`` JSON line: the package, ms a block from
first packet to final ack on the client clock (median, range),
aggregate MiB/s, the host cores the process used meanwhile (its user
and system CPU seconds, every thread's, over the wall), and the
exclusive phase ms a block of each hop's ``BlockTimeline``
(``primary``, ``mirror1``, ``mirror2``: a block's three timelines in
order of start).  Runs alternate packages in ``--order`` so that drift
of the host shows as a spread, not as a gap.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import _dn_standin as standin  # noqa: E402
from chip_smoke import main_path_corpus  # noqa: E402

HOPS = ("primary", "mirror1", "mirror2")


class _Patch:
    """The ``setattr`` half of pytest's monkeypatch, for
    :func:`standin.guard_reference_stat_race` outside a test."""

    @staticmethod
    def setattr(obj, name, value) -> None:
        setattr(obj, name, value)


def _package(name: str):
    """(DataNode factory, profiler, metrics) of ``name``."""
    if name == "ref":
        from hdrf_tpu.utils import metrics, profiler
        standin.guard_reference_stat_race(_Patch)
        return standin.ref_dn, profiler, metrics
    from hdrf_tpu_torch.utils import metrics, profiler
    return standin.port_dn, profiler, metrics


def _hop_phases(profiler, first_id: int, n: int) -> dict:
    """Exclusive phase ms a block of each hop, a block's timelines taken
    in order of start (the primary opens its own before it pushes).  A
    timeline closes just after its final ack is sent, so wait for all."""
    t_end = time.monotonic() + 30
    while True:
        by_block: dict[int, list] = {}
        for t in profiler.timelines_snapshot():
            if first_id <= t["block_id"] < first_id + n:
                by_block.setdefault(t["block_id"], []).append(t)
        if sum(map(len, by_block.values())) == n * len(HOPS) \
                or time.monotonic() > t_end:
            break
        time.sleep(0.05)
    out = {h: {} for h in HOPS}
    for bid, tls in by_block.items():
        assert len(tls) == len(HOPS), f"block {bid}: {len(tls)} timelines"
        for hop, t in zip(HOPS, sorted(tls, key=lambda t: t["t0"])):
            ph = dict(t["profile"]["phases"], wall=t["profile"]["wall_s"])
            for p, v in ph.items():
                out[hop][p] = out[hop].get(p, 0.0) + v * 1e3 / n
    return out


def run(name: str, blocks: list, streams: int) -> dict:
    make_dn, profiler, metrics = _package(name)
    br = metrics.registry("block_receiver")
    fail0 = br.counter("mirror_failures")
    root = tempfile.mkdtemp(prefix=f"dntime_{name}_")
    nn = standin.StandInNN()
    dns = []
    try:
        red = {"container_size": 32 << 20}
        dns = [make_dn(os.path.join(root, f"dn{i}"), nn.addr, f"dn{i}",
                       red=red) for i in range(1, 4)]
        tg = [standin.target(d) for d in dns[1:]]
        datas = [b.tobytes() for b in blocks]
        profiler.reset()

        def write(i: int) -> float:
            t0 = time.perf_counter()
            acks = standin.write_block(dns[0].addr, 1000 + i, datas[i],
                                       targets=tg)
            ms = (time.perf_counter() - t0) * 1e3
            assert standin.write_ok(acks, datas[i]), f"block {i}: {acks[-2:]}"
            return ms

        c0, t0 = os.times(), time.perf_counter()
        with ThreadPoolExecutor(streams) as pool:
            ms = list(pool.map(write, range(len(datas))))
        wall, c1 = time.perf_counter() - t0, os.times()
        fails = br.counter("mirror_failures") - fail0
        assert fails == 0, f"{name}: {fails} mirror legs failed"
        phases = _hop_phases(profiler, 1000, len(datas))
        for i, d in enumerate(datas):
            hdr, got = standin.read_block(dns[2].addr, 1000 + i)
            assert got == d, f"{name}: block {i} on dn3 != written"
    finally:
        for d in dns:
            d.stop()
        nn.stop()
        shutil.rmtree(root, ignore_errors=True)
    return {"package": name, "blocks": len(datas),
            "block_mib": blocks[0].size / (1 << 20), "streams": streams,
            "ms_per_block": {"median": statistics.median(ms),
                             "min": min(ms), "max": max(ms)},
            "aggregate_mib_s": sum(b.size for b in blocks) / (1 << 20) / wall,
            "host_cores_used": (c1.user - c0.user + c1.system - c0.system)
            / wall, "host_cores": os.cpu_count(),
            "phase_ms_per_block": phases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--block-mib", type=int, default=16)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--order", default="ref,port,port,ref")
    args = ap.parse_args(argv)
    blocks = main_path_corpus(args.seed, args.blocks, args.block_mib)
    for name in args.order.split(","):
        print("DNTIME " + json.dumps(run(name, blocks, args.streams)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

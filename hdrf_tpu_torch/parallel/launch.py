"""Multi-process launcher for the sharded reduction pipeline (port of
hdrf_tpu/parallel/launch.py: ``initialize`` launch.py:44, ``global_mesh``
:57, ``_selftest`` :87, ``main`` :131).

The reference brings up ``jax.distributed``: every host runs the module,
rank 0 doubles as coordinator, and the hosts' chips merge into one global
device set that ``parallel/sharded.py``'s mesh spans.  Here every process
runs this module and joins a ``torch.distributed`` process group (``nccl``
for the card, ``gloo`` for the CPU, ``tcp://`` rendezvous at rank 0's
address), and :func:`global_mesh` spans every rank's local devices.  A
process feeds only its own shards (``sharded._put_global``) and reads
every shard back (``sharded._fetch_global``, an all-reduce of each rank's
parts), so the host cut selection stays a pure function replicated on all
ranks, as in the single-process path.

A rank's local devices are every card it sees (give each rank its own
cards with ``CUDA_VISIBLE_DEVICES``), or the CPU with ``--device cpu``.

Ops entry point::

    python -m hdrf_tpu_torch.parallel.launch --coordinator HOST:PORT \\
        --nprocs N --rank R [--n-data D] [--selftest MB] [--device cuda|cpu]

Without ``--coordinator`` the process runs alone, its mesh over its own
devices.  ``--with-worker`` also starts a supervised co-located reduction
worker on this host (:func:`supervised_worker`, the reference's), on the
device ``--device`` names.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from hdrf_tpu_torch.ops.dispatch import resolve_device


def initialize(coordinator: str, num_processes: int, process_id: int,
               device="cuda") -> None:
    """Join (or form) the process group: ``nccl`` when ``device`` is a
    card (raises without one), ``gloo`` for the CPU."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_devices(dev)[0])
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def local_devices(device="cuda") -> list[torch.device]:
    """This process's devices: every visible card, or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_mesh(n_data: int = 1, device="cuda"):
    """('data', 'seq') mesh over every rank's local devices, in rank order
    (the reference's mesh over ``jax.devices()``)."""
    import torch.distributed as dist

    from hdrf_tpu_torch.parallel.sharded import Mesh

    mine = [str(d) for d in local_devices(device)]
    if dist.is_available() and dist.is_initialized():
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
    else:
        every = [mine]
    flat = [(r, d) for r, devs in enumerate(every) for d in devs]
    if len(flat) % n_data:
        raise ValueError(f"{len(flat)} devices do not split into {n_data} "
                         "data rows")
    n_seq = len(flat) // n_data
    rows = [flat[i * n_seq:(i + 1) * n_seq] for i in range(n_data)]
    return Mesh([[d for _, d in row] for row in rows],
                ranks=[[r for r, _ in row] for row in rows])


def run_reduce(data, cdc=None, n_data: int = 1, device="cuda"):
    """Multi-process entry for one block's (cuts, digests)."""
    from hdrf_tpu_torch.config import CdcConfig
    from hdrf_tpu_torch.parallel.sharded import reduce_sharded

    return reduce_sharded(data, cdc or CdcConfig(),
                          global_mesh(n_data, device))


def _selftest(mb: int, n_data: int, device="cuda") -> bool:
    """Every rank reduces the same seeded block on the global mesh and
    checks bit-identity against the native host oracle."""
    import torch.distributed as dist

    from hdrf_tpu_torch import native
    from hdrf_tpu_torch.config import CdcConfig
    from hdrf_tpu_torch.ops.dispatch import gear_mask

    cdc = CdcConfig()
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, mb << 20, dtype=np.uint8)
    # make it structured so cuts are non-trivial
    data[::3] = 0
    mesh = global_mesh(n_data, device)
    cuts, digests = run_reduce(data, cdc, n_data=n_data, device=device)
    pos = native.gear_candidates(data, gear_mask(cdc))
    want_cuts = native.cdc_select(pos, data.size, cdc.min_chunk,
                                  cdc.max_chunk)
    ok = np.array_equal(cuts, want_cuts)
    starts = np.concatenate([[0], want_cuts[:-1]]).astype(np.uint64)
    want_digs = native.sha256_batch(data, starts, want_cuts - starts)
    ok = ok and np.array_equal(digests, want_digs)
    multi = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if multi else 0
    world = dist.get_world_size() if multi else 1
    print(f"rank {rank}/{world}: devices={len(mesh.keys())} "
          f"mesh={mesh.shape['data']}x{mesh.shape['seq']} "
          f"chunks={len(cuts)} oracle_match={ok}", flush=True)
    return ok


def supervised_worker(backend: str = "auto"):
    """Spawn a supervised co-located reduction worker on this host (the
    per-host daemon bring-up role of the reference's ``hdfs --daemon``
    scripts, with the supervision the reference leaves to init systems):
    returns the started WorkerSupervisor — the worker is respawned with
    capped backoff if it dies, and ``supervisor.addr`` always names the
    live incarnation."""
    from hdrf_tpu_torch.server.reduction_worker import WorkerSupervisor

    sup = WorkerSupervisor(backend=backend)
    sup.start()
    return sup


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hdrf-torch-launch")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (omit to run alone)")
    ap.add_argument("--nprocs", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--n-data", type=int, default=1,
                    help="'data' axis size of the mesh")
    ap.add_argument("--selftest", type=int, default=0, metavar="MB",
                    help="reduce a seeded MB-sized block and verify "
                         "against the native oracle")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (nccl) or the CPU's plain versions "
                         "(gloo)")
    ap.add_argument("--with-worker", action="store_true",
                    help="also spawn a SUPERVISED co-located reduction "
                         "worker on this host (auto-respawn on death)")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    if args.coordinator is not None:
        initialize(args.coordinator, args.nprocs, args.rank, args.device)
    sup = None
    if args.with_worker:
        sup = supervised_worker(args.device)
        print(f"supervised reduction worker listening on "
              f"{sup.addr[0]}:{sup.addr[1]}", flush=True)
    try:
        if args.selftest:
            return 0 if _selftest(args.selftest, args.n_data,
                                  args.device) else 1
        mesh = global_mesh(args.n_data, args.device)
        print(f"rank {args.rank}/{args.nprocs} up; "
              f"{len(mesh.local_keys())} local / {len(mesh.keys())} global "
              f"devices", flush=True)
        return 0
    finally:
        if sup is not None:
            sup.stop()
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What paces a block's packet stream on this machine.

    python3 stream_probe.py [--mib 128] [--skip-cluster]

Prints one line a measurement:

- ``STREAM acks=<end|concurrent> nodelay_receiver=<0|1>``: MiB/s of
  ``--mib`` MiB sent over loopback in 64 KiB packets
  (``proto/datatransfer.stream_bytes``) to a receiver that answers each
  packet with a 9-byte ack (``send_ack``), the sender reading the acks
  after its last packet (the reference client's and DataNode's order) or
  on a second thread as they come (the port's
  ``proto/datatransfer.AckPump``, the client's and the DataNode's),
  with and without ``TCP_NODELAY`` on the receiving side (the DataNode
  sets it on every accepted socket).
- ``DISK``: MiB/s of the same bytes written in 64 KiB writes to the temp
  directory, and the fsync's seconds.
- ``WRITE rep=<1|3> <scheme>``: the port client's write of one block of
  that size to a port MiniCluster (native DataNodes) on the client clock,
  the host cores the process used, and each hop's phase ms
  (``chip_smoke._hop_phases``); ``READ``: the read back.

The first line names the machine (CPUs, kernel, the TCP buffer sysctls,
the temp directory's file system).  Runs on the CPU; no card needed.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import socket
import subprocess
import tempfile
import threading
import time

import numpy as np

from hdrf_tpu_torch.proto import datatransfer as dt

MIB = 1 << 20
PKT = dt.DEFAULT_PACKET


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return "unknown"


def stream(data: bytes, concurrent: bool, nodelay_receiver: bool) -> float:
    """MiB/s of ``data`` through one loopback packet stream."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def receiver() -> None:
        c, _ = srv.accept()
        if nodelay_receiver:
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with c:
            for seq, _data, _last in dt.iter_packets(c):
                dt.send_ack(c, seq)
    rt = threading.Thread(target=receiver, daemon=True)
    rt.start()
    npkts = -(-len(data) // PKT) + 1
    with socket.create_connection(srv.getsockname()) as s:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        t0 = time.perf_counter()
        if concurrent:
            acks = dt.stream_acked(s, data, PKT)
        else:
            dt.stream_bytes(s, data, PKT)
            acks = [dt.read_ack(s) for _ in range(npkts)]
        dt_s = time.perf_counter() - t0
    rt.join(60)
    srv.close()
    assert len(acks) == npkts
    return len(data) / MIB / dt_s


def disk(data: bytes) -> dict:
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "probe.bin")
        t0 = time.perf_counter()
        with open(p, "wb") as f:
            for off in range(0, len(data), PKT):
                f.write(data[off:off + PKT])
            t1 = time.perf_counter()
            f.flush()
            os.fsync(f.fileno())
        t2 = time.perf_counter()
    return {"write_mib_s": len(data) / MIB / (t1 - t0), "fsync_s": t2 - t1}


def cluster_writes(data: bytes) -> None:
    import chip_smoke as cs
    from hdrf_tpu_torch.testing.minicluster import MiniCluster
    from hdrf_tpu_torch.utils import profiler

    block = np.frombuffer(data, np.uint8)
    for n in (1, 3):
        with MiniCluster(n_datanodes=n, replication=n, block_size=len(data),
                         container_size=32 * MIB, heartbeat_s=1.0,
                         dead_node_s=6.0) as mc:
            with mc.client("probe", device="cpu") as c:
                for scheme in ("direct", "dedup_lz4"):
                    since = profiler._now()
                    c0, t0 = os.times(), time.perf_counter()
                    ms = cs._timed_write(c, f"/{scheme}", [block],
                                         scheme=scheme)
                    cores = cs._cores(c0, time.perf_counter() - t0)
                    bids = [b["block_id"] for b in c._call(
                        "get_block_locations", path=f"/{scheme}")["blocks"]]
                    print(f"WRITE rep={n} {scheme} ms={ms[0]:.1f} "
                          f"cores={cores:.2f} "
                          + json.dumps(cs._hop_phases(bids, since)),
                          flush=True)
                    t0 = time.perf_counter()
                    if c.read(f"/{scheme}") != data:
                        raise SystemExit(f"READ rep={n} {scheme}: mismatch")
                    print(f"READ rep={n} {scheme} "
                          f"ms={(time.perf_counter() - t0) * 1e3:.1f}",
                          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="stream_probe")
    p.add_argument("--mib", type=int, default=128)
    p.add_argument("--skip-cluster", action="store_true")
    args = p.parse_args(argv)
    tmp = tempfile.gettempdir()
    df = subprocess.run(["df", "-T", tmp], capture_output=True,
                        text=True).stdout.strip().splitlines()
    print("MACHINE " + json.dumps({
        "cpus": os.cpu_count(), "kernel": platform.release(),
        "tcp_rmem": _read("/proc/sys/net/ipv4/tcp_rmem"),
        "tcp_wmem": _read("/proc/sys/net/ipv4/tcp_wmem"),
        "tmp": tmp, "tmp_fs": df[-1].split()[1] if len(df) > 1 else "?"}),
        flush=True)
    data = np.random.default_rng(0).integers(
        0, 256, args.mib * MIB, dtype=np.uint8).tobytes()
    for concurrent in (False, True):
        for nodelay in (False, True):
            print(f"STREAM acks={'concurrent' if concurrent else 'end'} "
                  f"nodelay_receiver={int(nodelay)} MiB/s="
                  f"{stream(data, concurrent, nodelay):.1f}", flush=True)
    print("DISK " + json.dumps(disk(data)), flush=True)
    if not args.skip_cluster:
        cluster_writes(data)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

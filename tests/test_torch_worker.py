"""The port's reduction worker (hdrf_tpu_torch.server.reduction_worker)
driven by the reference's unmodified client and DataNode, plus the wire
codec and the import boundary.

The worker runs on ``backend="cpu"`` (each kernel's plain version); the
protocol, the replies and the cluster plumbing are what a card run uses.
"""

import dataclasses
import os
import re
import socket
import subprocess
import sys
import zlib

import msgpack
import numpy as np
import pytest
import torch

from hdrf_tpu.config import CdcConfig as RefCdc
from hdrf_tpu.ops import dispatch as ref_dispatch
from hdrf_tpu.ops.lz4_tpu import TpuLz4
from hdrf_tpu.server.reduction_worker import WorkerClient as RefClient
from hdrf_tpu.server.reduction_worker import WorkerError
from hdrf_tpu.testing.minicluster import MiniCluster
from hdrf_tpu.utils import metrics, tracing
from hdrf_tpu_torch import native
from hdrf_tpu_torch.ops import dispatch
from hdrf_tpu_torch.proto import datatransfer as dt
from hdrf_tpu_torch.proto import rpc
from hdrf_tpu_torch.ops import cdc_cuda
from hdrf_tpu_torch.server.reduction_worker import (ReductionWorker,
                                                    WorkerClient,
                                                    kernel_launches)
from hdrf_tpu_torch.utils import metrics as port_metrics


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are per-op bound on small tensors; one intra-op
    thread keeps them off the cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = RefCdc(mask_bits=10, min_chunk=256, max_chunk=4096)
RNG = np.random.default_rng(61)


def _bytes(n: int) -> bytes:
    return RNG.integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def worker():
    w = ReductionWorker(backend="cpu").start()
    yield w
    w.stop()


# ------------------------------------------------------------------ codec

FRAMES = [
    {"op": "reduce", "mask_bits": 13, "min_chunk": 2048, "max_chunk": 65536,
     "_trace": [0xFEDCBA9876543210, 1], "_deadline": 119.5},
    {"op": "compress_batch", "codec": "lz4", "sizes": [60_000, 0, 1 << 20]},
    {"cuts": np.arange(5, dtype=np.int64).tobytes(), "digests": b"\x07" * 160},
    {"error": "NotImplementedError", "message": "lz4 seal not ported yet"},
    {"ok": True, "backend": "cuda"},
    {"blocks_reduced": 3, "bytes_reduced": 1 << 33, "compress_jobs": 0},
    {"daemon": "reduction_worker", "spans": [{"a": None, "t": -1.25}],
     "ledger": [], "counters": []},
    [1, -1, -33, -200, -70_000, -(1 << 40), 255, 256, 1 << 16, 1 << 40,
     "x" * 31, "y" * 32, "é" * 300, b"z" * 300, [None] * 16,
     {str(i): i for i in range(16)}, {1: "int key"}, 0.0, False],
]


@pytest.mark.parametrize("frame", FRAMES, ids=[str(i) for i in
                                               range(len(FRAMES))])
def test_codec_matches_msgpack(frame):
    packed = msgpack.packb(frame)
    assert rpc.packb(frame) == packed
    assert rpc.unpackb(packed) == msgpack.unpackb(packed, raw=False,
                                                  strict_map_key=False)


def test_codec_rejects_unsupported():
    with pytest.raises(TypeError):
        rpc.packb({1, 2})
    with pytest.raises(ValueError):
        rpc.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    with pytest.raises(ValueError):
        rpc.unpackb(msgpack.packb([1, 2])[:-1])


# ----------------------------------------------------------------- worker

def test_reference_client_reduce_matches_reference_native(worker):
    """The unmodified reference WorkerClient (streaming in 64 KiB packets,
    stamping _trace and _deadline) against the port's worker; replies equal
    the reference's native chunk_and_fingerprint."""
    data = _bytes(150_000)
    c = RefClient(worker.addr, deadline_s=60.0)
    pkts = [data[i:i + dt.DEFAULT_PACKET]
            for i in range(0, len(data), dt.DEFAULT_PACKET)]
    with tracing.tracer("test").span("dn.write") as sp:
        cuts, digs = c.reduce_stream(iter(pkts), SMALL)
    wc, wd = ref_dispatch.chunk_and_fingerprint(
        np.frombuffer(data, np.uint8), SMALL, "native")
    np.testing.assert_array_equal(cuts, wc.astype(np.int64))
    np.testing.assert_array_equal(digs, wd)
    spans = c.traces()["spans"]
    assert any(s["name"] == "worker.reduce"
               and s["parent_id"] == f"{sp.span_id:016x}" for s in spans)
    c.close()


def test_port_client_ping_stats_and_empty_block(worker):
    c = WorkerClient(worker.addr)
    assert c.ping() == {"ok": True, "backend": "cpu"}
    before = c.stats()["blocks_reduced"]
    cdc = dispatch.from_reference_cdc(dataclasses.asdict(SMALL))
    cuts, digs = c.reduce(b"", cdc)
    assert cuts.size == 0 and digs.shape == (0, 32)
    data = _bytes(20_000)
    cuts, digs = c.reduce(data, cdc)
    wc, wd = ref_dispatch.chunk_and_fingerprint(
        np.frombuffer(data, np.uint8), SMALL, "native")
    np.testing.assert_array_equal(cuts, wc.astype(np.int64))
    np.testing.assert_array_equal(digs, wd)
    assert c.stats()["blocks_reduced"] == before + 2
    c.close()


def test_stats_carry_the_wrappers_launch_counters(worker):
    """``stats`` carries the worker process's kernel launch counters
    beside the reference's keys, read from the wrappers when it answers;
    on the CPU a reduce and a seal run the plain versions and count
    none."""
    c = WorkerClient(worker.addr)
    st0 = c.stats()
    assert set(st0) == {"blocks_reduced", "bytes_reduced", "compress_jobs",
                        "kernel_launches"}
    assert st0["kernel_launches"] == kernel_launches()
    assert set(st0["kernel_launches"]) == {
        "cdc_scan", "cdc_select", "gather_pad", "sha256", "match_deltas",
        "sort_rows", "be_image", "gather_raw"}
    cdc = dispatch.from_reference_cdc(dataclasses.asdict(SMALL))
    c.reduce(_bytes(20_000), cdc)
    c.compress("lz4", _bytes(50_000))
    st1 = c.stats()
    assert st1["blocks_reduced"] == st0["blocks_reduced"] + 1
    assert st1["compress_jobs"] == st0["compress_jobs"] + 1
    assert st1["kernel_launches"] == st0["kernel_launches"]
    n0 = cdc_cuda.scan_launches
    try:
        cdc_cuda.scan_launches = n0 + 3      # as three launches would
        assert c.stats()["kernel_launches"]["cdc_scan"] == n0 + 3
    finally:
        cdc_cuda.scan_launches = n0
    c.close()


def test_concurrent_clients_stress(worker):
    """More client threads than cores on one worker, with a short switch
    interval: every reply is right and the locked stats lose no update."""
    import threading

    tiny = RefCdc(mask_bits=6, min_chunk=16, max_chunk=128)
    cdc = dispatch.from_reference_cdc(dataclasses.asdict(tiny))
    datas = [_bytes(3_000 + 97 * i) for i in range((os.cpu_count() or 4) + 2)]
    want = [ref_dispatch.chunk_and_fingerprint(
        np.frombuffer(d, np.uint8), tiny, "native") for d in datas]
    before = WorkerClient(worker.addr).stats()["blocks_reduced"]
    errors: list = []

    def client(i: int) -> None:
        try:
            c = WorkerClient(worker.addr)
            cuts, digs = c.reduce(datas[i], cdc)
            np.testing.assert_array_equal(cuts, want[i][0].astype(np.int64))
            np.testing.assert_array_equal(digs, want[i][1])
            c.close()
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(datas))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    after = WorkerClient(worker.addr).stats()["blocks_reduced"]
    assert after - before == len(datas)


def _ref_engine_like(port_engine):
    """A reference TpuLz4 in the state of the port's engine, so both emit
    the same bytes for the same payloads from here on."""
    ref = TpuLz4()
    for f in ("stride", "min_len", "min_device", "_p1", "_p2", "_p3",
              "_flood_streak", "_bypass_left", "BYPASS_AFTER", "BYPASS_RUN"):
        setattr(ref, f, getattr(port_engine, f))
    return ref


def _text(rng, n: int) -> bytes:
    vocab = [rng.integers(97, 123, size=rng.integers(2, 9),
                          dtype=np.uint8).tobytes() for _ in range(300)]
    return b" ".join(vocab[i] for i in rng.integers(0, 300, size=n // 5))[:n]


def test_compress_ops_reply_typed_error_frame(worker):
    """compress / compress_batch answer with the reference TpuLz4's bytes,
    through a raw socket and through the reference client; a bad ``sizes``
    frame and an unknown op still answer typed error frames, and the
    connection stays in step."""
    rng = np.random.default_rng(5)
    datas = [_text(rng, 300_000), _bytes(100_000),
             _text(rng, 270_000), _text(rng, 270_000)]
    ref = _ref_engine_like(dispatch.lz4_engine("cpu"))
    before = WorkerClient(worker.addr).stats()["compress_jobs"]
    s = socket.create_connection(worker.addr, timeout=120)
    try:
        rpc.send_frame(s, {"op": "compress", "codec": "lz4"})
        dt.stream_bytes(s, datas[0])
        assert rpc.recv_frame(s) == {"data": ref.compress(datas[0])}
        rpc.send_frame(s, {"op": "compress_batch", "codec": "lz4",
                           "sizes": [10, 20]})
        dt.stream_bytes(s, _bytes(31))
        assert rpc.recv_frame(s)["error"] == "ValueError"
        rpc.send_frame(s, {"op": "compress_batch", "codec": "lz4",
                           "sizes": [len(d) for d in datas[2:]]})
        dt.stream_bytes(s, b"".join(datas[2:]))
        assert rpc.recv_frame(s) == {"datas": ref.compress_many(datas[2:])}
        rpc.send_frame(s, {"op": "nope"})
        assert rpc.recv_frame(s)["error"] == "NoSuchOp"
        rpc.send_frame(s, {"op": "ping"})
        assert rpc.recv_frame(s)["ok"] is True
    finally:
        s.close()
    c = RefClient(worker.addr, deadline_s=120.0)
    assert c.compress("lz4", datas[1]) == ref.compress(datas[1])
    assert c.compress_batch("lz4", datas[:2]) == ref.compress_many(datas[:2])
    got = c.compress("gzip", datas[1])
    assert zlib.decompress(got) == datas[1]
    c.close()
    pc = WorkerClient(worker.addr)
    assert pc.compress("lz4", datas[0]) == ref.compress(datas[0])
    assert pc.compress_batch("lz4", datas[2:]) == ref.compress_many(datas[2:])
    for d, out in zip(datas, pc.compress_batch("lz4", datas)):
        assert native.lz4_decompress(out, len(d)) == d
    assert pc.stats()["compress_jobs"] == before + 1 + 2 + 1 + 2 + 1 + 1 \
        + 2 + 4
    pc.close()


def _device_scans() -> int:
    """Seals whose records came from the port's device match scan."""
    c = port_metrics.registry("lz4_device").snapshot()["counters"]
    return c.get("emits", 0) + c.get("native_fallbacks", 0)


def test_minicluster_dedup_lz4_write_through_port_worker(worker):
    """An hdrf_tpu MiniCluster DataNode seals its dedup_lz4 containers
    through the port's worker: containers roll over (512 KiB) and reach the
    device path, the data reads back bit-identical, the worker counts
    compress jobs, and the DataNode never fell back to its own encoder."""
    dn = metrics.registry("datanode")
    fallbacks = dn.counter("worker_fallbacks")
    c0 = WorkerClient(worker.addr).stats()["compress_jobs"]
    scans0 = _device_scans()
    rng = np.random.default_rng(17)
    data = _text(rng, 1 << 20) + _bytes(400_000) + _text(rng, 700_000)
    with MiniCluster(n_datanodes=1, replication=1, block_size=1 << 20,
                     container_size=1 << 19,
                     reduction_overrides={
                         "worker_addr": list(worker.addr),
                         "container_codec": "lz4",
                         "cdc": RefCdc(**dataclasses.asdict(SMALL))}) as mc:
        with mc.client("w") as c:
            c.write("/t/lz", data, scheme="dedup_lz4")
            assert c.read("/t/lz") == data
    assert WorkerClient(worker.addr).stats()["compress_jobs"] > c0
    assert _device_scans() > scans0
    assert dn.counter("worker_fallbacks") == fallbacks


def test_minicluster_dedup_write_through_port_worker(worker):
    """An hdrf_tpu MiniCluster DataNode whose worker_addr points at the
    port's worker: a scheme="dedup" write streams through it, reads back
    bit-identical, and the DN counts worker_reduces."""
    br = metrics.registry("block_receiver")
    before = br.counter("worker_reduces")
    data = _bytes(300_000) + _bytes(100_000) * 2
    with MiniCluster(n_datanodes=1, replication=1, block_size=1 << 20,
                     reduction_overrides={
                         "worker_addr": list(worker.addr),
                         "container_codec": "none",
                         "cdc": RefCdc(**dataclasses.asdict(SMALL))}) as mc:
        with mc.client("w") as c:
            c.write("/t/f", data, scheme="dedup")
            assert c.read("/t/f") == data
    assert br.counter("worker_reduces") > before


# -------------------------------------------------------- process boundary

def _py(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_imports_no_jax_and_no_reference():
    code = ("import importlib, pkgutil, sys\n"
            "import hdrf_tpu_torch, chip_smoke, kernel_times, stream_probe\n"
            "for m in pkgutil.walk_packages(hdrf_tpu_torch.__path__,\n"
            "                               'hdrf_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'hdrf_tpu_torch.server.reduction_worker' in sys.modules\n"
            "from hdrf_tpu_torch.config import NameNodeConfig\n"
            "from hdrf_tpu_torch.proto.rpc import RpcServer, HaRpcClient\n"
            "for m in ('parallel.sharded', 'parallel.launch',\n"
            "          'config', 'utils.wal', 'utils.rollwin',\n"
            "          'utils.tenants', 'utils.retry', 'utils.qos',\n"
            "          'utils.profiler', 'reduction.accounting',\n"
            "          'reduction.scheme', 'reduction.dedup',\n"
            "          'storage.container_store', 'index.chunk_index',\n"
            "          'server.read_plane', 'ops.reconstruct',\n"
            "          'ops.gather_cuda', 'ops.rs', 'ops.rs_cuda',\n"
            "          'ops.ec_policy',\n"
            "          'storage.stripe_store', 'server.coded_exchange',\n"
            "          'server.ec_tier', 'utils.throttler',\n"
            "          'server.datanode', 'server.block_receiver',\n"
            "          'server.block_sender', 'server.write_pipeline',\n"
            "          'server.mirror_plane', 'storage.replica_store',\n"
            "          'storage.volumes', 'storage.version', 'security',\n"
            "          'utils.watchdog', 'utils.log',\n"
            "          'utils.flight_recorder', 'utils.outlier',\n"
            "          'utils.lockprof', 'utils.flight_archive',\n"
            "          'server.permissions', 'server.journal',\n"
            "          'server.editlog', 'server.namenode',\n"
            "          'server.failover', 'utils.checksum',\n"
            "          'client.oauth2', 'server.shortcircuit',\n"
            "          'client.striped', 'client.filesystem',\n"
            "          'testing.minicluster', 'utils.prom',\n"
            "          'server.status_http', 'storage.aliasmap',\n"
            "          'storage.simulated', 'server.scrubber',\n"
            "          'server.http_gateway', 'tools.cli',\n"
            "          'tools.slo_report', 'tools.gap_report',\n"
            "          'benchmarks', 'tools.check_parity'):\n"
            "    assert 'hdrf_tpu_torch.' + m in sys.modules\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'hdrf_tpu',\n"
            "                                    'msgpack'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = _py(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr


def test_worker_module_entry_point_serves():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "hdrf_tpu_torch.server.reduction_worker",
         "--port", "0", "--device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on ([\d.]+):(\d+)", line)
        assert m, line
        c = WorkerClient((m.group(1), int(m.group(2))))
        assert c.ping()["ok"]
        c.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_worker_backend_flag_spawns_like_the_reference():
    """The reference's spawn_local_worker command line (``--port 0
    --backend B``) starts the port's worker; its banner parses with the
    reference's regex and the worker answers ``ping``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "hdrf_tpu_torch.server.reduction_worker",
         "--port", "0", "--backend", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on ([\d.]+):(\d+)", line)
        assert m and "(cpu)" in line, line
        c = WorkerClient((m.group(1), int(m.group(2))))
        assert c.ping()["ok"]
        c.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_worker_backend_native_is_refused_until_ported():
    """``--backend native`` is ported (the host library): the worker
    starts on the host library instead of exiting; a ``--device`` that
    contradicts ``--backend`` is still refused."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "hdrf_tpu_torch.server.reduction_worker",
         "--port", "0", "--backend", "native"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert "(native) listening on" in line, line
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    r = _py(["-m", "hdrf_tpu_torch.server.reduction_worker", "--port", "0",
             "--backend", "cpu", "--device", "cuda"])
    assert r.returncode != 0 and "listening" not in r.stdout


def test_worker_backend_native_answers_reduce_like_native():
    """The worker spawned with the reference's ``--backend native``
    answers ``reduce`` (and ``compress``) with the reference native
    backend's cuts, digests and host-codec bytes."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "hdrf_tpu_torch.server.reduction_worker",
         "--port", "0", "--backend", "native"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        m = re.search(r"listening on ([\d.]+):(\d+)",
                      proc.stdout.readline())
        c = RefClient((m.group(1), int(m.group(2))), deadline_s=60.0)
        assert c.ping()["backend"] == "native"
        data = _bytes(300_000)
        cuts, digs = c.reduce(data, SMALL)
        wc, wd = ref_dispatch.chunk_and_fingerprint(
            np.frombuffer(data, np.uint8), SMALL, "native")
        np.testing.assert_array_equal(cuts, wc.astype(np.int64))
        np.testing.assert_array_equal(digs, wd)
        text = b"abcabcabd" * 5000
        assert c.compress("lz4", text) \
            == ref_dispatch.block_compress("lz4", text, "native")
        c.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_traces_reply_carries_profiler_counters(worker):
    """``traces`` returns the port profiler's counter samples, each with
    the reference's keys."""
    from hdrf_tpu.utils import profiler as ref_prof
    from hdrf_tpu_torch.utils import profiler

    profiler.counter_set("wal_queue_depth", 5)
    ref_prof.counter_set("wal_queue_depth", 5)
    got = RefClient(worker.addr).traces()["counters"]
    assert got and got[-1]["name"] == "wal_queue_depth"
    assert got[-1]["value"] == 5
    assert sorted(got[-1]) == sorted(ref_prof.counters_snapshot()[-1])


def test_worker_records_worker_bytes(worker):
    """Each ``reduce`` / ``compress`` / ``compress_batch`` stamps its
    bytes into reduction/accounting, as the reference's worker does."""
    from hdrf_tpu_torch.reduction import accounting

    def c(key):
        return accounting.snapshot()["counters"].get(key, 0)
    r0, k0 = c("worker_reduce_bytes"), c("worker_compress_bytes")
    wc = WorkerClient(worker.addr)
    cdc = dispatch.from_reference_cdc(dataclasses.asdict(SMALL))
    wc.reduce(_bytes(10_000), cdc)
    wc.compress("gzip", b"x" * 7_000)
    wc.compress_batch("gzip", [b"y" * 100, b"z" * 300])
    # the worker stamps after its reply; a ping on the same pooled
    # connection is served after the stamp
    wc.ping()
    wc.close()
    assert c("worker_reduce_bytes") - r0 == 10_000
    assert c("worker_compress_bytes") - k0 == 7_400


def test_card_entry_points_fail_without_a_card():
    """Without a GPU the worker's default device, chip_smoke.py and
    kernel_times.py refuse to run (exit non-zero, no result line) instead
    of using the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _py(["-m", "hdrf_tpu_torch.server.reduction_worker", "--port", "0"])
    assert r.returncode != 0 and "listening" not in r.stdout
    r = _py(["chip_smoke.py"])
    assert r.returncode != 0 and '"ok"' not in r.stdout
    r = _py(["kernel_times.py"])
    assert r.returncode != 0 and '"cdc_select"' not in r.stdout


def test_worker_binds_deadline_and_tracks_ops_like_reference(worker,
                                                             monkeypatch):
    """A request's ``_deadline`` is rebound around the op and the op is
    tracked by the worker's StallWatchdog, as in the reference worker
    (reduction_worker.py:86-121); before the repair the port accepted the
    header and ignored it, with no watchdog."""
    from hdrf_tpu.server import reduction_worker as ref_rw
    from hdrf_tpu.utils import retry as ref_retry
    from hdrf_tpu_torch.server import reduction_worker as rw
    from hdrf_tpu_torch.utils import retry

    ref_worker = ref_rw.ReductionWorker(backend="native").start()
    seen = []
    try:
        for w, mod, rt in ((worker, rw, retry),
                           (ref_worker, ref_rw, ref_retry)):
            def spy(codec, data, backend, w=w, rt=rt):
                d = rt.current()
                seen.append((None if d is None else round(d.remaining()),
                             [e["op"] for e in w.watchdog.inflight()]))
                return data
            monkeypatch.setattr(mod.ops_dispatch if mod is rw else
                                __import__("hdrf_tpu.ops.dispatch",
                                           fromlist=["x"]),
                                "block_compress", spy)
            s = socket.create_connection(w.addr, timeout=30)
            try:
                rpc.send_frame(s, {"op": "compress", "codec": "lz4",
                                   "_deadline": 30.0})
                dt.stream_bytes(s, b"q" * 1000)
                assert rpc.recv_frame(s) == {"data": b"q" * 1000}
                rpc.send_frame(s, {"op": "compress", "codec": "lz4"})
                dt.stream_bytes(s, b"r" * 10)
                assert rpc.recv_frame(s) == {"data": b"r" * 10}
            finally:
                s.close()
    finally:
        ref_worker.stop()
    assert seen[:2] == seen[2:] == [(30, ["worker.compress"]),
                                    (None, ["worker.compress"])]


def test_worker_client_deadline_and_breaker_like_reference(worker):
    """The client's payload-scaled deadline budget refuses a request
    under a spent ambient deadline (its connect gets no time), as the
    reference's WorkerClient does — the port's served it — its circuit
    breaker opens after three
    worker failures and then skips the connect, and ``set_addr``
    repoints it at a live worker."""
    from hdrf_tpu.server import reduction_worker as ref_rw
    from hdrf_tpu.utils import retry as ref_retry
    from hdrf_tpu_torch.server import reduction_worker as rw
    from hdrf_tpu_torch.utils import retry

    data = _bytes(5000)
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_addr = dead.getsockname()
    dead.close()
    outcomes = []
    port_cdc = dispatch.from_reference_cdc(dataclasses.asdict(SMALL))
    for mod, rt, cdc in ((rw, retry, port_cdc), (ref_rw, ref_retry, SMALL)):
        c = mod.WorkerClient(worker.addr, deadline_s=60,
                             deadline_s_per_mb=1.0)
        with rt.bind(rt.Deadline(0.0)):
            with pytest.raises((rt.DeadlineExceeded, mod.WorkerError)) as e0:
                c.reduce(data, cdc)
        refused = type(e0.value).__name__
        cuts, _ = c.reduce(data, cdc)
        br = rt.CircuitBreaker(f"test-{mod.__name__}", failure_threshold=3,
                               reset_s=60.0)
        c2 = mod.WorkerClient(dead_addr, deadline_s=5, breaker=br)
        kinds = []
        for _ in range(4):
            with pytest.raises(mod.WorkerError) as ei:
                c2.compress("lz4", b"x" * 100)
            kinds.append(getattr(ei.value, "breaker_open", False))
        c2.set_addr(worker.addr)
        br.reset_s = 0.0
        out = c2.compress("lz4", data)
        outcomes.append((refused, int(cuts[-1]), kinds, br.state,
                         native.lz4_decompress(out, len(data)) == data))
        c.close()
        c2.close()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1:] == (5000, [False, False, False, True], "closed",
                               True)

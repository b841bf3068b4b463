"""Co-located reduction worker on the card (port of
hdrf_tpu/server/reduction_worker.py, whole: the worker, its client,
``spawn_local_worker``, ``WorkerSupervisor`` and ``main``).

A separate process that owns the device and speaks the reference's framed
protocol, so an unmodified ``hdrf_tpu`` DataNode drives it through
``ReductionConfig.worker_addr``: one msgpack request frame, then (for data
ops) a packet run, then one reply frame.  Ops:

- ``reduce`` — packet stream -> ``{"cuts": int64 bytes, "digests": bytes}``
  via ops/resident.ResidentReducer (CDC, gather and SHA-256 kernels);
- ``compress`` — packet stream -> ``{"data": bytes}``, one container
  sealed by ops/dispatch.block_compress (``lz4``: device match scan over
  the match-delta and row-sort kernels, native emit);
- ``compress_batch`` — ``{"sizes": [...]}`` splits one packet stream into
  payloads -> ``{"datas": [bytes, ...]}`` through
  ops/dispatch.block_compress_batch (equal-length ``lz4`` payloads as one
  device batch); a ``sizes`` sum that is not the stream's length answers
  ``{"error": "ValueError", ...}``;
- ``ping``, ``stats``, ``traces`` — as the reference (``traces`` carries
  spans, device-ledger events and the profiler's counter samples);
  ``stats`` also carries ``kernel_launches``, this process's launch
  counters of the hand-written kernels (``kernel_launches()``; the
  plain versions on the CPU count none), which the reference's reply
  does not have.

Every data op stamps its bytes into ``reduction/accounting``
(``record_worker_bytes``), as the reference does.  Requests may carry
``_trace`` (resumed as the span parent) and ``_deadline``: the remaining
budget is rebound around the op (``retry.bind_remaining``), so the op's
sub-calls inherit what is left of it, and every data op is tracked by a
``StallWatchdog`` (utils/watchdog.py), as in the reference
(reduction_worker.py:86-121).
The ``compress`` payloads are collected on the host before the seal, as
in the reference (reduction_worker.py:223).

``WorkerClient`` is the reference's DataNode-side handle whole: a
payload-scaled deadline budget per op (``deadline_s`` + ``deadline_s_per_mb``
per streamed MiB, clamped by any ambient deadline), an optional circuit
breaker (``retry.CircuitBreaker``) checked before connecting, and
``set_addr`` to repoint at a respawned worker.

Backends (``--backend``, the reference spawner's names): ``auto``,
``tpu`` and ``cuda`` run on the card, ``cpu`` the plain versions,
``native`` the host C++ library (ops/dispatch.py).

**Streaming ingest** (replaces ``_reduce_streaming_tpu``,
reduction_worker.py:186-218): packets are copied into 4 MiB pinned host
stride buffers, and each full stride is copied into one preallocated
device block with ``non_blocking=True`` on the worker's CUDA stream while
later packets are still arriving.  The strides form a ring of three
buffers with a CUDA event each: a buffer is refilled only after the event
of its previous copy has completed, so the host never overwrites bytes a
copy is still reading.

Run standalone: ``python -m hdrf_tpu_torch.server.reduction_worker --port 0
--backend cuda`` (prints ``listening on host:port``).
"""

from __future__ import annotations

import contextlib
import os
import socket
import socketserver
import threading
import time

import numpy as np
import torch

from hdrf_tpu_torch.config import CdcConfig
from hdrf_tpu_torch.ops import cdc_cuda, gather_cuda, sha256_cuda, sort_cuda
from hdrf_tpu_torch.ops import dispatch as ops_dispatch
from hdrf_tpu_torch.ops.cdc_cuda import PAD_GRID
from hdrf_tpu_torch.ops.dispatch import resolve_device
from hdrf_tpu_torch.ops.resident import ResidentReducer
from hdrf_tpu_torch.proto import datatransfer as dt
from hdrf_tpu_torch.proto.rpc import recv_frame, send_frame
from hdrf_tpu_torch.reduction import accounting
from hdrf_tpu_torch.utils import (device_ledger, metrics, profiler, retry,
                                  tracing)
from hdrf_tpu_torch.utils.watchdog import StallWatchdog

_M = metrics.registry("reduction_worker")


def kernel_launches() -> dict[str, int]:
    """This process's launches of the reduce and seal kernels, from their
    wrappers' counters (a wrapper call of several launches counts one)."""
    return {"cdc_scan": cdc_cuda.scan_launches,
            "cdc_select": cdc_cuda.select_launches,
            "gather_pad": gather_cuda.launches,
            "sha256": sha256_cuda.launches,
            "match_deltas": sort_cuda.match_deltas_launches,
            "sort_rows": sort_cuda.sort_rows_launches,
            "be_image": cdc_cuda.image_launches,
            "gather_raw": gather_cuda.raw_launches}
_TR = tracing.tracer("reduction_worker")

# Host->device copy stride for streaming ingest and the ring depth.
_STRIDE = 4 << 20
_RING = 3
# First device block size: HDFS's default dfs.blocksize (128 MiB) + pad.
_INITIAL = (128 << 20) + PAD_GRID


class _DeviceIngest:
    """Packet bytes -> one zero-padded device block, through a ring of
    pinned stride buffers guarded by CUDA events."""

    def __init__(self, device: torch.device, stream) -> None:
        self.stream = stream
        self.block = torch.empty(_INITIAL, dtype=torch.uint8, device=device)
        self.ring = [torch.empty(_STRIDE, dtype=torch.uint8, pin_memory=True)
                     for _ in range(_RING)]
        self.views = [r.numpy() for r in self.ring]
        self.events: list = [None] * _RING
        self.cur = 0     # ring buffer being filled
        self.fill = 0    # bytes in it
        self.n = 0       # bytes already copied to the device

    def write(self, data: bytes) -> None:
        src = np.frombuffer(data, dtype=np.uint8)
        off = 0
        while off < src.size:
            if self.fill == 0 and self.events[self.cur] is not None:
                # the buffer's previous copy must finish before refilling
                self.events[self.cur].synchronize()
            take = min(_STRIDE - self.fill, src.size - off)
            self.views[self.cur][self.fill:self.fill + take] = \
                src[off:off + take]
            self.fill += take
            off += take
            if self.fill == _STRIDE:
                self._flush()

    def _flush(self) -> None:
        nb = self.fill
        need = self.n + nb + PAD_GRID
        if need > self.block.numel():  # longer than expected: grow
            grown = torch.empty(max(need, 2 * self.block.numel()),
                                dtype=torch.uint8, device=self.block.device)
            grown[:self.n].copy_(self.block[:self.n])
            self.block = grown
        self.block[self.n:self.n + nb].copy_(self.ring[self.cur][:nb],
                                             non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self.stream)
        self.events[self.cur] = ev
        self.n += nb
        self.cur = (self.cur + 1) % _RING
        self.fill = 0

    def finish(self) -> tuple[torch.Tensor, int]:
        """(block zero-padded to the 512-byte grid, true length)."""
        if self.fill:
            self._flush()
        n_pad = self.n + (-self.n) % PAD_GRID
        self.block[self.n:n_pad].zero_()
        return self.block[:n_pad], self.n


class ReductionWorker:
    """The worker daemon: thread per connection; device work from all
    connections is ordered on the worker's one CUDA stream."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 backend: str = "auto"):
        """``backend``, a dispatch name: ``auto``, ``tpu`` and ``cuda``
        the card, ``cpu`` the plain versions, ``native`` the host
        library (no device)."""
        self.backend = ops_dispatch.resolve_backend(backend)
        self.device = (None if self.backend == "native" else
                       resolve_device(self.backend))
        self._stream = (torch.cuda.Stream(self.device)
                        if self.backend == "cuda" else None)
        self._reducers: dict[tuple, ResidentReducer] = {}
        self._reducers_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {"blocks_reduced": 0, "bytes_reduced": 0,
                       "compress_jobs": 0}
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    while True:
                        outer._dispatch(sock, recv_frame(sock))
                except (ConnectionError, OSError):
                    return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self._thread: threading.Thread | None = None
        self.watchdog = StallWatchdog("reduction_worker", registry=_M)

    @property
    def addr(self) -> tuple[str, int]:
        return self._server.server_address

    def start(self) -> "ReductionWorker":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="reduction-worker", daemon=True)
        self._thread.start()
        self.watchdog.start()
        return self

    def stop(self) -> None:
        self.watchdog.stop()
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    # ------------------------------------------------------------- dispatch

    def _dispatch(self, sock: socket.socket, req: dict) -> None:
        op = req.get("op")
        trace = req.get("_trace")
        try:
            if op in ("reduce", "compress", "compress_batch"):
                # Rebind the caller's remaining deadline budget (the same
                # transport slot as _trace): a spent budget is refused here,
                # and sub-calls inherit what is left.
                with retry.bind_remaining(req.get(retry.DEADLINE_KEY)), \
                        self.watchdog.track(f"worker.{op}"), \
                        _TR.span(f"worker.{op}",
                                 parent=tuple(trace) if trace else None) as sp:
                    sp.annotate("backend", self.backend)
                    if op == "reduce":
                        self._op_reduce(sock, req)
                    elif op == "compress":
                        self._op_compress(sock, req)
                    else:
                        self._op_compress_batch(sock, req)
            elif op == "ping":
                send_frame(sock, {"ok": True, "backend": self.backend})
            elif op == "stats":
                with self._stats_lock:
                    send_frame(sock, {**self._stats,
                                      "kernel_launches": kernel_launches()})
            elif op == "traces":
                send_frame(sock, {
                    "daemon": "reduction_worker",
                    "spans": tracing.all_span_snapshots(),
                    "ledger": device_ledger.events_snapshot(),
                    "counters": profiler.counters_snapshot()})
            else:
                send_frame(sock, {"error": "NoSuchOp", "message": str(op)})
        except (ConnectionError, OSError):
            raise
        except Exception as e:  # noqa: BLE001 — errors cross the wire
            _M.incr("op_errors")
            send_frame(sock, {"error": type(e).__name__, "message": str(e)})

    def _reducer(self, cdc: CdcConfig) -> ResidentReducer:
        key = (cdc.mask_bits, cdc.min_chunk, cdc.max_chunk)
        with self._reducers_lock:
            r = self._reducers.get(key)
            if r is None:
                r = self._reducers[key] = ResidentReducer(cdc, self.device)
        return r

    def _op_reduce(self, sock: socket.socket, req: dict) -> None:
        cdc = CdcConfig(mask_bits=req["mask_bits"],
                        min_chunk=req["min_chunk"],
                        max_chunk=req["max_chunk"])
        if self.backend == "cuda":
            cuts, digs = self._reduce_streaming_cuda(sock, cdc)
        else:
            buf = np.frombuffer(dt.collect_packets(sock), dtype=np.uint8)
            if self.backend == "native":
                cuts, digs = ops_dispatch.chunk_and_fingerprint(
                    buf, cdc, "native")
            else:
                cuts, digs = self._reducer(cdc).reduce(buf)
        nbytes = int(cuts[-1]) if len(cuts) else 0
        with self._stats_lock:
            self._stats["blocks_reduced"] += 1
            self._stats["bytes_reduced"] += nbytes
        send_frame(sock, {"cuts": np.asarray(cuts, np.int64).tobytes(),
                          "digests": np.ascontiguousarray(digs).tobytes()})
        _M.incr("blocks_reduced")
        accounting.record_worker_bytes("reduce", nbytes)

    def _reduce_streaming_cuda(self, sock: socket.socket, cdc: CdcConfig):
        with torch.cuda.stream(self._stream):
            ingest = _DeviceIngest(self.device, self._stream)
            for _seq, data, _last in dt.iter_packets(sock):
                if data:
                    ingest.write(data)
            block, n = ingest.finish()
            if n == 0:
                return (np.empty(0, dtype=np.uint64),
                        np.empty((0, 32), dtype=np.uint8))
            r = self._reducer(cdc)
            job = r.submit(block, n=n)
            r.start_sha(job)
            return r.finish(job)

    def _on_stream(self):
        """Device work of this thread on the worker's one CUDA stream."""
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _op_compress(self, sock: socket.socket, req: dict) -> None:
        data = dt.collect_packets(sock)
        with self._on_stream():
            out = ops_dispatch.block_compress(req.get("codec", "lz4"), data,
                                              self.backend)
        with self._stats_lock:
            self._stats["compress_jobs"] += 1
        send_frame(sock, {"data": bytes(out)})
        _M.incr("compress_jobs")
        accounting.record_worker_bytes("compress", len(data))

    def _op_compress_batch(self, sock: socket.socket, req: dict) -> None:
        """N payloads in one round trip (a DataNode sealing several
        container lanes at once): ``req["sizes"]`` splits the one packet
        stream; equal-size ``lz4`` payloads run as one device batch."""
        sizes = [int(v) for v in req.get("sizes", [])]
        blob = dt.collect_packets(sock)
        if sum(sizes) != len(blob):
            send_frame(sock, {"error": "ValueError",
                              "message": f"sizes sum {sum(sizes)} != "
                                         f"stream length {len(blob)}"})
            return
        datas, off = [], 0
        for n in sizes:
            datas.append(blob[off:off + n])
            off += n
        with self._on_stream():
            outs = ops_dispatch.block_compress_batch(
                req.get("codec", "lz4"), datas, self.backend)
        with self._stats_lock:
            self._stats["compress_jobs"] += len(sizes)
        send_frame(sock, {"datas": [bytes(o) for o in outs]})
        _M.incr("compress_jobs", len(sizes))
        accounting.record_worker_bytes("compress", len(blob))


# ------------------------------------------------------------------ client


class WorkerError(IOError):
    """Worker-side failure (connect/protocol/compute).  DISTINCT from the
    caller's own stream errors: a DN forwarding client packets must treat a
    dead worker as 'fall back to in-process compute' but a dead CLIENT as a
    failed write — conflating them would commit truncated blocks."""


class WorkerClient:
    """DN-side handle on the co-located worker.  One pooled connection per
    concurrent job (connections are cheap on loopback; the pool bound comes
    from the DN's admission slots holding across the round trip).

    Resilience contract (utils/retry.py): every data-path op runs under a
    payload-scaled deadline budget — ``deadline_s`` base plus
    ``deadline_s_per_mb`` accrued per streamed MiB, clamped by any ambient
    end-to-end deadline — so a HUNG worker costs at most the remaining
    budget, not the reference's fixed 600 s socket timeout.  When a
    ``breaker`` (retry.CircuitBreaker) is attached, data-path ops check it
    BEFORE connecting: a DEAD worker costs zero connect attempts while the
    breaker is open, and the half-open probe re-admits the edge when the
    worker returns.  Worker-side failures record breaker outcomes; errors
    from the caller's own packet iterator never touch the breaker (they
    are not evidence about the worker).  ping/stats/traces stay outside
    the breaker so observability polls never consume the half-open probe.
    """

    def __init__(self, addr, timeout: float = 600.0,
                 deadline_s: float | None = None,
                 deadline_s_per_mb: float = 0.0,
                 breaker: "retry.CircuitBreaker | None" = None):
        self._addr = (addr[0], int(addr[1]))
        self._timeout = timeout if deadline_s is None else deadline_s
        self._per_mb = float(deadline_s_per_mb)
        self._breaker = breaker
        self._pool: list[socket.socket] = []
        self._lock = threading.Lock()

    def set_addr(self, addr) -> None:
        """Repoint at a respawned worker (it lands on a fresh ephemeral
        port); pooled connections to the old incarnation are dropped."""
        with self._lock:
            self._addr = (addr[0], int(addr[1]))
            for s in self._pool:
                s.close()
            self._pool.clear()

    def _deadline(self, nbytes: int = 0) -> retry.Deadline:
        budget = self._timeout + self._per_mb * (nbytes / float(1 << 20))
        return retry.Deadline(retry.effective_budget(budget))

    def _conn(self, dl: retry.Deadline,
              gated: bool = True) -> socket.socket:
        if gated and self._breaker is not None \
                and not self._breaker.allow():
            e = WorkerError(
                f"worker breaker '{self._breaker.name}' open: "
                "skipping connect")
            e.breaker_open = True  # not evidence of a NEW failure
            raise e
        with self._lock:
            if self._pool:
                s = self._pool.pop()
                s.settimeout(dl.timeout())
                return s
        try:
            _M.incr("connect_attempts")
            s = socket.create_connection(self._addr, timeout=dl.timeout())
        except OSError as e:
            err = WorkerError(f"worker unreachable: {e}")
            if gated:
                # connect refusal is the clearest dead-worker evidence, and
                # it raises BEFORE the callers' try/except-_fail blocks —
                # record it here (ungated observability polls stay outside)
                self._fail(err)
            raise err from e
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _release(self, s: socket.socket) -> None:
        with self._lock:
            if len(self._pool) < 8:
                self._pool.append(s)
                return
        s.close()

    def _ok(self) -> None:
        if self._breaker is not None:
            self._breaker.record_success()

    def _fail(self, e: BaseException) -> None:
        if self._breaker is not None \
                and not getattr(e, "breaker_open", False):
            self._breaker.record_failure()

    def _checked(self, resp: dict) -> dict:
        if "error" in resp:
            raise WorkerError(
                f"worker: {resp['error']}: {resp['message']}")
        return resp

    def _stamped(self, req: dict,
                 dl: "retry.Deadline | None" = None) -> dict:
        """Stamp the caller's span context (and remaining deadline budget)
        into the request frame (same contract as dt.send_op headers /
        RpcClient.call), so the worker's span nests under the DN pipeline
        span that drove it and its sub-calls inherit the budget."""
        tr = tracing.current_context()
        if tr is not None:
            req["_trace"] = list(tr)
        hdr = dl.header() if dl is not None else retry.remaining_header()
        if hdr is not None:
            req[retry.DEADLINE_KEY] = hdr
        return req

    def reduce_stream(self, packets, cdc: CdcConfig):
        """Forward an iterator of byte packets; returns (cuts, digests).
        This is the true streaming path: the DN calls it from inside its
        packet-receive loop, so client->DN->worker->HBM is one pipeline.
        The deadline budget accrues ``deadline_s_per_mb`` per streamed MiB
        (payload size is only known as it arrives).

        Exception taxonomy: worker-side failures raise :class:`WorkerError`;
        anything the ``packets`` iterator itself raises (the caller's OWN
        stream — e.g. the DN's client connection dying) propagates
        unchanged, so the caller can tell the two apart."""
        dl = self._deadline()
        s = self._conn(dl)
        try:
            try:
                send_frame(s, self._stamped(
                    {"op": "reduce", "mask_bits": cdc.mask_bits,
                     "min_chunk": cdc.min_chunk,
                     "max_chunk": cdc.max_chunk}, dl))
            except OSError as e:
                raise WorkerError(f"worker send failed: {e}") from e
            seq = 0
            it = iter(packets)
            while True:
                try:
                    data = next(it)  # caller errors propagate UNWRAPPED
                except StopIteration:
                    break
                if not data:
                    continue
                try:
                    dl.extend(self._per_mb * len(data) / float(1 << 20))
                    dl.check("worker reduce stream")
                    s.settimeout(dl.timeout())
                    dt.write_packet(s, seq, data)
                except OSError as e:
                    raise WorkerError(f"worker send failed: {e}") from e
                seq += 1
            try:
                dl.check("worker reduce")
                s.settimeout(dl.timeout())
                # the final drain IS the wait on device compute: the worker
                # answers only after its device reduce completes, so the DN-side
                # timeline books it as device_wait (its own ledger records
                # nothing — the dispatches live in the worker process)
                with profiler.phase("device_wait"):
                    dt.write_packet(s, seq, b"", last=True)
                    resp = self._checked(recv_frame(s))
            except (OSError, ConnectionError) as e:
                raise WorkerError(f"worker failed: {e}") from e
            cuts = np.frombuffer(resp["cuts"], np.int64)
            digs = np.frombuffer(resp["digests"],
                                 np.uint8).reshape(-1, 32)
            self._release(s)
            self._ok()
            return cuts, digs
        except BaseException as e:
            s.close()
            if isinstance(e, (WorkerError, retry.DeadlineExceeded)):
                self._fail(e)
            raise

    def reduce(self, data: bytes, cdc: CdcConfig):
        return self.reduce_stream([data], cdc)

    def compress(self, codec: str, data: bytes) -> bytes:
        dl = self._deadline(len(data))
        s = self._conn(dl)
        try:
            try:
                send_frame(s, self._stamped({"op": "compress",
                                             "codec": codec}, dl))
                dt.stream_bytes(s, data, 1 << 20)
                dl.check("worker compress")
                s.settimeout(dl.timeout())
                out = bytes(self._checked(recv_frame(s))["data"])
            except (OSError, ConnectionError) as e:
                raise WorkerError(f"worker failed: {e}") from e
            self._release(s)
            self._ok()
            return out
        except BaseException as e:
            s.close()
            if isinstance(e, (WorkerError, retry.DeadlineExceeded)):
                self._fail(e)
            raise

    def compress_batch(self, codec: str, datas: list) -> list:
        """Batched compress: one round trip, one worker-side device program
        for the group (see ReductionWorker._op_compress_batch)."""
        dl = self._deadline(sum(len(d) for d in datas))
        s = self._conn(dl)
        try:
            try:
                send_frame(s, self._stamped(
                    {"op": "compress_batch", "codec": codec,
                     "sizes": [len(d) for d in datas]}, dl))
                seq = 0
                for d in datas:
                    if d:
                        dt.write_packet(s, seq, d)
                        seq += 1
                dt.write_packet(s, seq, b"", last=True)
                dl.check("worker compress_batch")
                s.settimeout(dl.timeout())
                outs = [bytes(v)
                        for v in self._checked(recv_frame(s))["datas"]]
            except (OSError, ConnectionError) as e:
                raise WorkerError(f"worker failed: {e}") from e
            self._release(s)
            self._ok()
            return outs
        except BaseException as e:
            s.close()
            if isinstance(e, (WorkerError, retry.DeadlineExceeded)):
                self._fail(e)
            raise

    def ping(self) -> dict:
        s = self._conn(self._deadline(), gated=False)
        try:
            send_frame(s, {"op": "ping"})
            out = self._checked(recv_frame(s))
            self._release(s)
            return out
        except BaseException:
            s.close()
            raise

    def stats(self) -> dict:
        s = self._conn(self._deadline(), gated=False)
        try:
            send_frame(s, {"op": "stats"})
            out = self._checked(recv_frame(s))
            self._release(s)
            return out
        except BaseException:
            s.close()
            raise

    def traces(self) -> dict:
        """Worker-process spans + device-ledger events (the DN proxies this
        through its own trace_spans op for the gateway merge)."""
        s = self._conn(self._deadline(), gated=False)
        try:
            send_frame(s, {"op": "traces"})
            out = self._checked(recv_frame(s))
            self._release(s)
            return out
        except BaseException:
            s.close()
            raise

    def close(self) -> None:
        with self._lock:
            for s in self._pool:
                s.close()
            self._pool.clear()


def spawn_local_worker(backend: str = "auto"):
    """Launch a worker as a real SEPARATE PROCESS (the co-located
    deployment shape); returns (Popen, (host, port)).  The caller owns the
    process (terminate() when done).  The reference's command line with
    this package's module; the child finds the package through
    ``PYTHONPATH`` whatever the caller's working directory.  It starts
    from a fresh interpreter (fork + exec), so it inherits no CUDA context
    of the caller, and its first stdout line is the banner."""
    import re
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "hdrf_tpu_torch.server.reduction_worker",
         "--port", "0", "--backend", backend],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    line = proc.stdout.readline()
    m = re.search(r"listening on ([\d.]+):(\d+)", line)
    if not m:
        proc.terminate()
        raise RuntimeError(f"worker failed to start: {line!r}")
    return proc, (m.group(1), int(m.group(2)))


class WorkerSupervisor:
    """Supervised co-located worker: owns the process, detects death, and
    respawns with capped full-jitter backoff (the NodeManager service-
    restart role the reference delegates to init systems; DataNode.java has
    no analog for its in-process codecs — they die with the daemon).

    ``on_respawn(addr)`` fires after each successful respawn so the owner
    repoints its :class:`WorkerClient` (`set_addr`) — respawned workers
    land on a fresh ephemeral port.  Clock/sleep/spawn are injectable so
    tests drive the respawn schedule without wall-clock waits.  A process
    that stayed up longer than ``healthy_s`` resets the backoff streak.
    """

    def __init__(self, backend: str = "auto", base_s: float = 0.5,
                 cap_s: float = 15.0, healthy_s: float = 30.0,
                 on_respawn=None, clock=time.monotonic,
                 sleep=time.sleep, spawn=spawn_local_worker,
                 poll_s: float = 0.2):
        self._backend = backend
        self._base_s = float(base_s)
        self._cap_s = float(cap_s)
        self._healthy_s = float(healthy_s)
        self._on_respawn = on_respawn
        self._clock = clock
        self._sleep = sleep
        self._spawn = spawn
        self._poll_s = float(poll_s)
        self._proc = None
        self.addr: tuple[str, int] | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._spawned_at = 0.0
        self._streak = 0  # consecutive quick deaths
        self.respawns = 0

    def start(self) -> tuple[str, int]:
        """Spawn the first incarnation and the monitor thread; returns the
        worker address (startup failures propagate to the caller — only
        RE-spawns are retried with backoff)."""
        self._proc, self.addr = self._spawn(self._backend)
        self._spawned_at = self._clock()
        self._thread = threading.Thread(target=self._monitor,
                                        name="worker-supervisor",
                                        daemon=True)
        self._thread.start()
        return self.addr

    def _monitor(self) -> None:
        import random as _random

        while not self._stop.is_set():
            if self._proc.poll() is None:
                self._sleep(self._poll_s)
                continue
            if self._stop.is_set():
                return
            if self._clock() - self._spawned_at >= self._healthy_s:
                self._streak = 0
            delay = _random.uniform(0.0, min(
                self._cap_s, self._base_s * (2.0 ** self._streak)))
            self._streak += 1
            _M.incr("worker_deaths")
            if delay > 0:
                self._sleep(delay)
            if self._stop.is_set():
                return
            try:
                self._proc, self.addr = self._spawn(self._backend)
            except Exception:
                _M.incr("worker_respawn_failures")
                continue  # next lap backs off further
            self._spawned_at = self._clock()
            self.respawns += 1
            _M.incr("worker_respawns")
            if self._on_respawn is not None:
                try:
                    self._on_respawn(self.addr)
                except Exception:
                    _M.incr("worker_respawn_callback_errors")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except Exception:
                self._proc.kill()


# The reference's --backend names (hdrf_tpu/server/reduction_worker.py
# main, passed by its spawn_local_worker) and the port's own.
BACKENDS = ("auto", "cpu", "cuda", "native", "tpu")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="hdrf-torch-reduction-worker")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--backend", default=None, choices=BACKENDS,
                   help="the reference spawner's flag: auto (the default), "
                        "tpu and cuda select the card, cpu the plain "
                        "versions, native the host library")
    p.add_argument("--device", default=None,
                   help="alias of --backend: cuda (the card) or cpu (plain "
                        "versions, for tests)")
    args = p.parse_args(argv)
    backend = args.backend or "auto"
    if args.device is not None:
        alias = torch.device(args.device).type
        if args.backend is not None and \
                ops_dispatch.resolve_backend(args.backend) != alias:
            p.error(f"--backend {args.backend} selects "
                    f"{ops_dispatch.resolve_backend(args.backend)}, not "
                    f"--device {args.device}")
        backend = alias
    w = ReductionWorker(args.host, args.port, backend=backend).start()
    # The banner's "listening on host:port" substring is what launchers
    # parse (the reference's spawn_local_worker regex).
    print(f"reduction worker ({w.backend}) listening on "
          f"{w.addr[0]}:{w.addr[1]}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        w.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

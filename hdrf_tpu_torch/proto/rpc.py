"""Length-prefixed msgpack frames, the RPC server and the RPC clients (port
of hdrf_tpu/proto/rpc.py, whole: ``MAX_FRAME``/``RpcError``/``recv_exact``/
``send_frame``/``recv_frame`` rpc.py:54-92, ``RpcServer`` :99-451,
``normalize_addrs`` :453, ``HaRpcClient`` :465-667 and ``RpcClient``
:669-742).

An RPC is one frame ``[req_id, method, kwargs]`` answered by
``[req_id, status, payload, *extra]`` (status 0: payload is the result;
otherwise ``{"error", "message"}``, raised as :class:`RpcError`), the
reference's wire shape, so port and reference daemons and clients talk to
each other unchanged.  kwargs may carry the side-channel keys ``_trace``,
``_retry_id``, ``_dtoken``, ``_sid``, ``_user``, ``_groups``, ``_client``
and the deadline header (utils/retry.DEADLINE_KEY); ``RpcServer`` strips
them before dispatch.  A service exposing ``_rpc_state_id()`` (the
NameNode) gets that dict appended as a fourth reply element on every wire
response (the state stamp ``{"txid", "role", "lag_s"}``), which clients
track as ``last_seen_txid`` and present back as ``_sid`` to an observer.

``RpcServer`` is thread-per-connection, bounded by ``max_handlers`` (past
the cap the accept loop parks, so overload backs up into the TCP listen
queue), with a retry cache for replayed ``_retry_id``s, the per-method
latency histograms and phase decomposition (utils/profiler.profile_spans
over ``frame_read`` / ``dispatch_queue`` / ``handler`` / ``serialize`` /
``reply``, the lock phases from utils/lockprof.bind_request) and the
caller's identity set on the port's own server/permissions.

One frame = ``[u32 len][msgpack body]``.  The card's machine has no
``msgpack`` package, so this module carries its own encoder/decoder of
the subset the frames, the chunk index's WAL and snapshot, the replica
and segment files, the edit log and the fsimage use — dict, str, bytes,
int, float, bool, None, list/tuple — byte-compatible with
``msgpack.packb`` (its defaults: ``use_bin_type=True``, floats as
float64, smallest int encoding) and with ``msgpack.unpackb(raw=...,
use_list=..., strict_map_key=False)``: ``raw=False`` decodes str as
``str`` (the wire), ``raw=True`` as ``bytes`` (index/chunk_index.py reads
its records so, as the reference does); ``use_list=False`` decodes
arrays as tuples (the journal node's records).  Extension types are
refused with ``ValueError``.
"""

from __future__ import annotations

import contextlib
import socket
import socketserver
import struct
import threading
import time
from typing import Any

from hdrf_tpu_torch.utils import (fault_injection, lockprof, metrics,
                                  profiler, retry, rollwin, tenants, tracing)

_LEN = struct.Struct("<I")
MAX_FRAME = 64 * 1024 * 1024

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


# ------------------------------------------------------------------ encoder

def _pack_int(v: int, out: list) -> None:
    if v < -(1 << 5):
        if v < -(1 << 15):
            if v < -(1 << 31):
                if v < -(1 << 63):
                    raise OverflowError("int too small for msgpack")
                out.append(b"\xd3" + _q.pack(v))
            else:
                out.append(b"\xd2" + _i.pack(v))
        elif v < -(1 << 7):
            out.append(b"\xd1" + _h.pack(v))
        else:
            out.append(b"\xd0" + _b.pack(v))
    elif v < (1 << 7):
        out.append(_b.pack(v) if v < 0 else _B.pack(v))
    elif v < (1 << 8):
        out.append(b"\xcc" + _B.pack(v))
    elif v < (1 << 16):
        out.append(b"\xcd" + _H.pack(v))
    elif v < (1 << 32):
        out.append(b"\xce" + _I.pack(v))
    elif v < (1 << 64):
        out.append(b"\xcf" + _Q.pack(v))
    else:
        raise OverflowError("int too big for msgpack")


def _pack_len(n: int, fix_tag: int, fix_max: int, tags: tuple, out: list
              ) -> None:
    """Header of a sized type: fix form when it fits, else 8/16/32-bit
    length forms (``tags`` = (tag8 or None, tag16, tag32))."""
    if fix_tag is not None and n <= fix_max:
        out.append(_B.pack(fix_tag | n))
    elif tags[0] is not None and n < (1 << 8):
        out.append(bytes((tags[0], n)))
    elif n < (1 << 16):
        out.append(bytes((tags[1],)) + _H.pack(n))
    elif n < (1 << 32):
        out.append(bytes((tags[2],)) + _I.pack(n))
    else:
        raise ValueError("object too large for msgpack")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _d.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (same bytes as ``msgpack.packb(obj)``)."""
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# ------------------------------------------------------------------ decoder

class _Reader:
    __slots__ = ("buf", "pos", "tuples")

    def __init__(self, buf: bytes, use_list: bool = True) -> None:
        self.buf = memoryview(buf)
        self.pos = 0
        self.tuples = not use_list

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:end]
        self.pos = end
        return v

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


def _unpack(r: _Reader, raw: bool) -> Any:
    t = r.unpack(_B)
    if t <= 0x7F:
        return t
    if t >= 0xE0:
        return t - 0x100
    if 0x80 <= t <= 0x8F:
        return _map(r, t & 0x0F, raw)
    if 0x90 <= t <= 0x9F:
        return _array(r, t & 0x0F, raw)
    if 0xA0 <= t <= 0xBF:
        return _str(r.take(t & 0x1F), raw)
    if t == 0xC0:
        return None
    if t == 0xC2:
        return False
    if t == 0xC3:
        return True
    if t in (0xC4, 0xC5, 0xC6):
        n = r.unpack((_B, _H, _I)[t - 0xC4])
        return bytes(r.take(n))
    if t == 0xCA:
        return r.unpack(_f)
    if t == 0xCB:
        return r.unpack(_d)
    if 0xCC <= t <= 0xCF:
        return r.unpack((_B, _H, _I, _Q)[t - 0xCC])
    if 0xD0 <= t <= 0xD3:
        return r.unpack((_b, _h, _i, _q)[t - 0xD0])
    if t in (0xD9, 0xDA, 0xDB):
        n = r.unpack((_B, _H, _I)[t - 0xD9])
        return _str(r.take(n), raw)
    if t in (0xDC, 0xDD):
        n = r.unpack((_H, _I)[t - 0xDC])
        return _array(r, n, raw)
    if t in (0xDE, 0xDF):
        return _map(r, r.unpack((_H, _I)[t - 0xDE]), raw)
    raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def _array(r: _Reader, n: int, raw: bool):
    out = [_unpack(r, raw) for _ in range(n)]
    return tuple(out) if r.tuples else out


def _str(v: memoryview, raw: bool):
    return bytes(v) if raw else str(v, "utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, raw)
        out[k] = _unpack(r, raw)
    return out


def unpackb(data: bytes, raw: bool = False, use_list: bool = True) -> Any:
    """Decode one msgpack object (``msgpack.unpackb(raw=raw,
    use_list=use_list, strict_map_key=False)`` semantics on the supported
    subset)."""
    r = _Reader(data, use_list)
    obj = _unpack(r, raw)
    if r.pos != len(r.buf):
        raise ValueError("extra bytes after msgpack object")
    return obj


# ------------------------------------------------------------------- frames

class RpcError(Exception):
    """Server-side exception re-raised at the caller (RemoteException analog)."""

    def __init__(self, error: str, message: str):
        super().__init__(f"{error}: {message}")
        self.error = error
        self.message = message


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed connection")
        got += r
    return bytes(buf)


def send_frame(sock: socket.socket, body: Any) -> None:
    payload = packb(body)
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame too large: {len(payload)}")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(recv_exact(sock, _LEN.size))
    if n > MAX_FRAME:
        raise ConnectionError(f"oversized frame: {n}")
    return unpackb(recv_exact(sock, n))


@contextlib.contextmanager
def _null_ctx():
    yield


class RpcServer:
    """Serves ``rpc_*`` methods of a service object.

    >>> class Svc:
    ...     def rpc_add(self, a, b): return a + b
    >>> srv = RpcServer("127.0.0.1", 0, Svc(), "test"); srv.start()
    """

    def __init__(self, host: str, port: int, service: Any, name: str,
                 watchdog: Any | None = None,
                 max_handlers: int | None = None):
        """``watchdog``: optional utils.watchdog.StallWatchdog — every
        dispatched method is tracked so handler threads wedged past the
        budget (VM write-burst stalls) surface in stall_total/stacks.
        ``max_handlers``: cap on live handler threads (one per connection);
        past it the accept loop itself parks, so a metadata storm backs up
        into the TCP listen queue instead of spawning without bound."""
        self._service = service
        self._name = name
        self._metrics = metrics.registry(f"rpc.{name}")
        self._tracer = tracing.tracer(f"rpc.{name}")
        self._watchdog = watchdog
        # Metadata-plane latency axis (RpcMetrics#addRpcProcessingTime
        # analog): per-method histograms + one rolling window feeding a
        # p99 gauge into the NN flight record.  NN-only — the DN control
        # plane has no RPC server of its own worth the extra books.
        self._lat_win = (rollwin.RollingWindow(window_s=300.0, maxlen=512)
                        if name == "namenode" else None)
        # Cumulative phase-attribution accountant (NN only): how much of
        # the dispatched wall clock the named phases explain — the >= 95%
        # contention-observatory acceptance bar, cheap enough to keep
        # always-on (two float adds per request).
        self._attr_lock = threading.Lock()
        self._attr_wall_s = 0.0
        self._attr_used_s = 0.0
        self.max_handlers = max_handlers
        self._handler_sem = (threading.BoundedSemaphore(max_handlers)
                             if max_handlers else None)
        self._count_lock = threading.Lock()
        self._handler_threads = 0
        self._inflight = 0
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:  # one thread per connection
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                outer._conns.add(sock)
                try:
                    while True:
                        outer._serve_one(sock)
                except (ConnectionError, OSError):
                    return
                finally:
                    outer._conns.discard(sock)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

            def process_request(self, request, client_address):
                # Accept-loop backpressure: a full handler pool parks the
                # acceptor HERE, before the thread spawn — new connections
                # queue in the kernel listen backlog (the xceiver-cap
                # refusal analog, soft form).
                if outer._handler_sem is not None:
                    outer._handler_sem.acquire()
                super().process_request(request, client_address)

            def process_request_thread(self, request, client_address):
                outer._note_handler(+1)
                try:
                    super().process_request_thread(request, client_address)
                finally:
                    outer._note_handler(-1)
                    if outer._handler_sem is not None:
                        outer._handler_sem.release()

        self._server = Server((host, port), Handler)
        self._conns: set[socket.socket] = set()
        self._thread: threading.Thread | None = None
        self._retry_cache: dict[str, tuple[float, list]] = {}
        self._retry_lock = threading.Lock()

    def _note_handler(self, delta: int) -> None:
        with self._count_lock:
            self._handler_threads += delta
            self._metrics.gauge("rpc_handler_threads",
                                float(self._handler_threads))

    def _note_inflight(self, delta: int) -> None:
        with self._count_lock:
            self._inflight += delta
            self._metrics.gauge("rpc_inflight", float(self._inflight))

    @property
    def addr(self) -> tuple[str, int]:
        return self._server.server_address  # resolved (host, real_port)

    def rpc_p99_ms(self) -> float:
        """Rolling p99 RPC processing latency (ms) over the last window —
        the ``nn_rpc_p99_ms`` gauge the NN flight record samples."""
        if self._lat_win is None:
            return 0.0
        q = self._lat_win.quantiles((99,))
        return (q or {}).get("p99", 0.0) / 1e3

    def _serve_one(self, sock: socket.socket) -> None:
        """One request/response cycle with service-time decomposition.

        The block on the 4-byte length header happens OUTSIDE the profiled
        window — a keep-alive connection parked between calls is idle, not
        service time.  From the header's arrival on, every segment lands as
        a span: body read (``frame_read``), side-channel/auth/cache work
        (``dispatch_queue``), the handler (``handler``, refined by the
        instrumented lock's ``lock_wait``/``locked``), response pack
        (``serialize``) and the write back (``reply``)."""
        hdr = recv_exact(sock, _LEN.size)
        t0 = time.perf_counter()
        (n,) = _LEN.unpack(hdr)
        if n > MAX_FRAME:
            raise ConnectionError(f"oversized frame: {n}")
        body = recv_exact(sock, n)
        spans: list[tuple] = [("frame_read", t0, time.perf_counter())]
        req = unpackb(body)
        self._note_inflight(+1)
        try:
            resp = self._dispatch(req, spans=spans)
        finally:
            self._note_inflight(-1)
        # State-id stamp: one hook point covers every wire reply — success,
        # error, auth refusal and retry-cache replay alike — so the client's
        # txid high-water mark advances no matter how the call ended.
        state = self._state_stamp()
        if state is not None:
            resp = resp + [state]
        t_ser0 = time.perf_counter()
        payload = packb(resp)
        if len(payload) > MAX_FRAME:
            raise ValueError(f"frame too large: {len(payload)}")
        t_ser1 = time.perf_counter()
        spans.append(("serialize", t_ser0, t_ser1))
        sock.sendall(_LEN.pack(len(payload)) + payload)
        t1 = time.perf_counter()
        spans.append(("reply", t_ser1, t1))
        if self._lat_win is not None and isinstance(req, list) and len(req) == 3:
            self._profile_request(str(req[1]), spans, t0, t1)

    def _profile_request(self, method: str, spans: list, t0: float,
                         t1: float) -> None:
        """Exclusive-phase partition of one request's service time
        (profiler.profile_spans — same sweep as the DN block timelines),
        observed as ``nn_rpc_phase_us|method=,phase=`` histograms plus the
        cumulative attributed-fraction accountant."""
        prof = profiler.profile_spans(spans, t0, t1)
        for name, s in prof["phases"].items():
            self._metrics.observe(f"nn_rpc_phase_us|method={method},"
                                  f"phase={name}", s * 1e6)
        with self._attr_lock:
            self._attr_wall_s += prof["wall_s"]
            self._attr_used_s += prof["wall_s"] * prof["attributed_frac"]

    def attributed_frac(self) -> float:
        """Cumulative share of dispatched wall clock explained by named
        phases (1.0 before any wire request — nothing unattributed yet)."""
        with self._attr_lock:
            return (self._attr_used_s / self._attr_wall_s
                    if self._attr_wall_s > 0 else 1.0)

    def contention_summary(self) -> dict:
        """Per-method RPC service table for ``/contention``: calls, errors,
        p99 µs and per-phase mean µs (from the cumulative histograms), plus
        the server-wide attribution and handler-pool gauges."""
        snap = self._metrics.snapshot()
        counters, hists = snap["counters"], snap["histograms"]
        methods: dict[str, dict] = {}
        for key, h in hists.items():
            if not key.startswith("nn_rpc_us|method="):
                continue
            m = key.split("method=", 1)[1]
            methods[m] = {"calls": counters.get(f"{m}_calls", 0),
                          "errors": counters.get(f"{m}_errors", 0),
                          "p99_us": h["p99"], "mean_us": h["mean"],
                          "phase_us": {}}
        for key, h in hists.items():
            if not key.startswith("nn_rpc_phase_us|method="):
                continue
            label = key.split("method=", 1)[1]
            m, _, phase = label.partition(",phase=")
            if m in methods:
                methods[m]["phase_us"][phase] = round(h["mean"], 1)
        return {"rpc_p99_ms": self.rpc_p99_ms(),
                "attributed_frac": self.attributed_frac(),
                "inflight": self._inflight,
                "handler_threads": self._handler_threads,
                "max_handlers": self.max_handlers,
                "methods": methods}

    def _state_stamp(self) -> dict | None:
        """The service's reply-envelope state dict (None for stateless
        services — their replies stay 3 elements, old-wire compatible)."""
        hook = getattr(self._service, "_rpc_state_id", None)
        if hook is None:
            return None
        try:
            return hook()
        except Exception:  # noqa: BLE001 — a stamp must never kill a reply
            return None

    def _dispatch(self, req: list, spans: list | None = None) -> list:
        req_id, method, kwargs = req
        # dispatch_queue starts where frame_read ended: side-channel
        # parsing, auth and the retry cache all land in that phase.
        t_in = spans[0][2] if spans else time.perf_counter()
        trace = kwargs.pop("_trace", None)
        retry_id = kwargs.pop("_retry_id", None)
        dtoken = kwargs.pop("_dtoken", None)
        sid = kwargs.pop("_sid", None)
        # Hop-by-hop deadline budget (remaining seconds, riding beside
        # _trace): a request arriving with a spent budget is refused
        # BEFORE dispatch — the caller already gave up, so running the
        # handler would only waste the server's cycles.
        deadline_hdr = kwargs.pop(retry.DEADLINE_KEY, None)
        if deadline_hdr is not None and float(deadline_hdr) <= 0:
            self._metrics.incr(f"{method}_deadline_rejected")
            return [req_id, 1, {"error": "DeadlineExceeded",
                                "message": f"{method}: deadline budget "
                                           "exhausted before dispatch"}]
        # Caller identity (UGI analog): populated into a per-thread context
        # the service's permission checker reads.  Only set for WIRE calls —
        # in-process invocations act as the superuser, like the reference's
        # own NN threads.
        from hdrf_tpu_torch.server import permissions as _perm

        _perm.set_caller(kwargs.pop("_user", None),
                         kwargs.pop("_groups", None))
        # Tenant id for attribution only (utils/tenants.py) — stripped here
        # like the rest of the side-channel so handlers never see it.
        tenant = kwargs.pop("_client", None)
        fn = getattr(self._service, f"rpc_{method}", None)
        if fn is None:
            return [req_id, 1, {"error": "NoSuchMethod", "message": method}]
        auth = getattr(self._service, "_rpc_auth_hook", None)
        if auth is not None:
            try:
                auth(method, dtoken)
            except Exception as e:  # noqa: BLE001 — refusal crosses the wire
                self._metrics.incr(f"{method}_auth_rejected")
                return [req_id, 1, {"error": type(e).__name__,
                                    "message": str(e)}]
        # Observer read gate (_sid consistency check): on an observer this
        # refuses non-reads, waits out the bounded catch-up window for the
        # caller's state-id and enforces the staleness bound.  Runs before
        # the retry cache — a bounced read was never executed here.
        gate = getattr(self._service, "_rpc_observer_gate", None)
        if gate is not None:
            try:
                gate(method, sid)
            except Exception as e:  # noqa: BLE001 — bounce crosses the wire
                self._metrics.incr("observer_refused")
                return [req_id, 1, {"error": type(e).__name__,
                                    "message": str(e)}]
        if retry_id is not None:
            cached = self._retry_cache_get(retry_id)
            if cached is not None:
                self._metrics.incr("retry_cache_hits")
                return [req_id, *cached]
        track = (self._watchdog.track(f"rpc.{method}")
                 if self._watchdog is not None else _null_ctx())
        # Wire requests bind the ambient request context so the service's
        # instrumented lock attributes its wait/hold to this method and
        # lands lock_wait/locked spans in this request's decomposition;
        # in-process calls (spans is None) skip the stamp.
        req_ctx = (lockprof.bind_request(method, spans)
                   if spans is not None else _null_ctx())
        t_start = time.perf_counter()
        if spans is not None:
            spans.append(("dispatch_queue", t_in, t_start))
        with retry.bind_remaining(deadline_hdr), track, req_ctx, \
                self._tracer.span(method,
                                  parent=tuple(trace) if trace else None):
            try:
                fault_injection.point("rpc.dispatch", server=self._name,
                                      method=method)
                with self._metrics.time(f"{method}_us"):
                    result = fn(**kwargs)
                self._metrics.incr(f"{method}_calls")
                out = [0, result]
            except Exception as e:  # noqa: BLE001 — errors cross the wire
                self._metrics.incr(f"{method}_errors")
                out = [1, {"error": type(e).__name__, "message": str(e)}]
        t_h1 = time.perf_counter()
        if spans is not None:
            spans.append(("handler", t_start, t_h1))
        if self._lat_win is not None:
            dt_us = (time.perf_counter() - t_start) * 1e6
            self._metrics.observe(f"nn_rpc_us|method={method}", dt_us)
            self._lat_win.add(dt_us)
        if tenant is not None:  # wire calls carrying a client id only
            tenants.note_op(tenant, f"rpc.{method}",
                            latency_s=time.perf_counter() - t_start)
        if retry_id is not None:
            self._retry_cache_put(retry_id, out)
        if spans is not None:
            # tail bookkeeping (lat window, tenant note, retry cache) stays
            # attributed — a second dispatch_queue span, same exclusive
            # class, so the sweep folds it in without a dedicated phase
            spans.append(("dispatch_queue", t_h1, time.perf_counter()))
        return [req_id, *out]

    # RetryCache analog: replayed responses for at-least-once HA retries.
    _RETRY_TTL = 120.0

    def _retry_cache_get(self, rid: str):
        import time as _t

        with self._retry_lock:
            ent = self._retry_cache.get(rid)
            if ent and ent[0] > _t.monotonic():
                return ent[1]
            return None

    def _retry_cache_put(self, rid: str, out: list) -> None:
        import time as _t

        now = _t.monotonic()
        with self._retry_lock:
            self._retry_cache[rid] = (now + self._RETRY_TTL, out)
            if len(self._retry_cache) > 50_000:  # expire the stale half
                self._retry_cache = {k: v for k, v in
                                     self._retry_cache.items()
                                     if v[0] > now}

    def start(self) -> "RpcServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=f"rpc-{self._name}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        # Sever live connections too: a stopped server must look DEAD to its
        # peers (handler threads would otherwise keep answering RPCs — clients
        # of a restarted daemon would talk to the zombie forever).
        for s in list(self._conns):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()


def normalize_addrs(addr) -> list[tuple[str, int]]:
    """One (host, port) pair or any sequence of pairs -> list of tuples."""
    if (isinstance(addr, (list, tuple)) and addr
            and isinstance(addr[0], (list, tuple))):
        return [(a[0], int(a[1])) for a in addr]
    return [(addr[0], int(addr[1]))]


_HM = metrics.registry("client.ha")
_MISS = object()  # sentinel: no observer could answer; fall back to active


class HaRpcClient:
    """Failover proxy over an ordered NN list (the reference's
    ConfiguredFailoverProxyProvider + RetryProxy analog): on connection
    failure or StandbyError, rotate to the next address; remember the last
    good one.

    Observer routing (ObserverReadProxyProvider.java:60 analog): with
    ``observer_reads`` on, READ_METHODS are offered to every known observer
    first, carrying the proxy's ``last_seen_txid`` as the ``_sid``
    side-channel for read-your-writes.  A stale observer bounces the call
    with a typed ObserverStaleError — counted, retried on the active, never
    silently stale; a dead one trips its per-endpoint circuit breaker
    (utils/retry.py breaker registry) and is skipped until it half-opens.
    Endpoint roles are discovered lazily over ``ha_state`` and refreshed on
    a TTL, so a promotion or observer restart is picked up without
    reconfiguration."""

    RETRIABLE = ("StandbyError",)
    # Client-side mirror of the NN's observer-servable read set: only these
    # are worth offering to a read replica (everything else either mutates
    # or is NN-instance-specific admin plumbing).
    READ_METHODS = frozenset({
        "get_block_locations", "stat", "listing", "ec_status",
        "content_summary", "get_xattrs", "get_acl", "get_storage_policy",
        "list_snapshots", "snapshot_diff", "list_cache_pools",
        "list_cache_directives", "list_encryption_zones", "get_ez",
        "datanode_report", "cluster_status", "decommission_status",
        "slow_nodes_report", "slow_peers", "policy_violations",
        "get_events", "fsck", "check_delegation_token",
    })
    ROLE_TTL_S = 10.0

    def __init__(self, addrs: list[tuple[str, int]], timeout: float = 30.0,
                 observer_reads: bool = True):
        self._clients = [RpcClient(a, timeout) for a in normalize_addrs(addrs)]
        self._cur = 0
        self.observer_reads = observer_reads
        self._roles: list[str | None] = [None] * len(self._clients)
        self._roles_t = float("-inf")  # first use forces a discovery pass
        # High-water journal txid observed across ALL endpoints (the
        # ClientGSIContext the reference keeps per-proxy-provider).
        self.last_seen_txid = 0

    def _breaker(self, c: "RpcClient"):
        return retry.breaker(f"nn:{c._addr[0]}:{c._addr[1]}")

    def _note_state(self, c: "RpcClient") -> None:
        if c.last_seen_txid > self.last_seen_txid:
            self.last_seen_txid = c.last_seen_txid

    def _refresh_roles(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._roles_t < self.ROLE_TTL_S:
            return
        self._roles_t = now
        for i, c in enumerate(self._clients):
            br = self._breaker(c)
            if not br.allow():
                self._roles[i] = None
                continue
            try:
                st = c.call("ha_state")
            except (ConnectionError, OSError):
                br.record_failure()
                self._roles[i] = None
                continue
            except RpcError:
                br.record_success()  # endpoint alive, role just unknown
                self._roles[i] = None
                continue
            br.record_success()
            self._note_state(c)
            self._roles[i] = st.get("role")

    def _observer_call(self, method: str, kwargs: dict) -> Any:
        """Offer a read to each known observer; _MISS means none answered
        (no observers configured, all stale/bounced, or breakers open)."""
        self._refresh_roles()
        for i, role in enumerate(self._roles):
            if role != "observer":
                continue
            c = self._clients[i]
            br = self._breaker(c)
            if not br.allow():
                _HM.incr("observer_skipped_open")
                continue
            kw = dict(kwargs)
            kw["_sid"] = self.last_seen_txid
            try:
                out = c.call(method, **kw)
            except retry.DeadlineExceeded:
                raise
            except (ConnectionError, OSError):
                # dead observer: the BREAKER is the demotion — the role map
                # keeps the entry so the strike count accumulates across
                # reads (connect-refused fails fast), and once open,
                # allow() gates this endpoint to half-open probes only
                br.record_failure()
                _HM.incr("observer_demotions")
                continue
            except RpcError as e:
                br.record_success()
                self._note_state(c)
                if e.error == "ObserverStaleError":
                    _HM.incr("observer_bounces")
                    continue  # bounded-staleness bounce: active serves it
                if e.error == "StandbyError":
                    self._roles[i] = None  # role changed under us
                    continue
                raise  # real application error from a consistent read
            br.record_success()
            self._note_state(c)
            _HM.incr("observer_reads")
            return out
        return _MISS

    def msync(self, wait_s: float | None = None) -> dict:
        """Consistency barrier (FileSystem.msync analog): ask every
        reachable observer to catch up to this proxy's ``last_seen_txid``.
        Returns per-endpoint msync replies ({} with no observers — a
        single active is strongly consistent already)."""
        self._refresh_roles(force="observer" not in self._roles)
        out: dict[str, Any] = {}
        for i, role in enumerate(self._roles):
            if role != "observer":
                continue
            c = self._clients[i]
            kw: dict[str, Any] = {"txid": self.last_seen_txid}
            if wait_s is not None:
                kw["wait_s"] = wait_s
            try:
                out[f"{c._addr[0]}:{c._addr[1]}"] = c.call("msync", **kw)
                self._note_state(c)
            except (ConnectionError, OSError, RpcError):
                continue
        return out

    def call(self, method: str, **kwargs: Any) -> Any:
        if (self.observer_reads and method in self.READ_METHODS
                and "_sid" not in kwargs):
            out = self._observer_call(method, kwargs)
            if out is not _MISS:
                return out
        # One retry id per LOGICAL call: a mutation that succeeded just before
        # the connection died must not re-execute when the proxy retries — the
        # server's retry cache replays the original response instead (the
        # NameNode RetryCache that HDFS pairs with its failover proxy).
        import uuid as _uuid

        kwargs["_retry_id"] = _uuid.uuid4().hex
        last: Exception | None = None
        attempts = 2 * len(self._clients)
        # second lap onward: capped full-jitter backoff instead of a fixed
        # beat, so a thundering herd of proxies doesn't re-poll in lockstep
        delays = retry.backoff_delays(attempts, base_s=0.1, cap_s=2.0)
        # Known observers are not failover targets — skip them for free
        # (no attempt consumed) unless they are all we have.
        n_obs = sum(1 for r in self._roles if r == "observer")
        skip_observers = 0 < n_obs < len(self._clients)
        attempt = 0
        while attempt < attempts:
            dl = retry.current()
            if dl is not None:
                dl.check("namenode failover")  # spent budget: stop retrying
            if skip_observers and self._roles[self._cur] == "observer":
                self._cur = (self._cur + 1) % len(self._clients)
                continue
            c = self._clients[self._cur]
            attempt += 1
            try:
                out = c.call(method, **kwargs)
                self._note_state(c)
                return out
            except retry.DeadlineExceeded:
                raise
            except (ConnectionError, OSError) as e:
                last = e
            except RpcError as e:
                self._note_state(c)
                if e.error not in self.RETRIABLE:
                    raise
                last = e
            self._cur = (self._cur + 1) % len(self._clients)
            if attempt > len(self._clients):
                import time as _t

                delay = next(delays)
                if dl is not None:
                    delay = min(delay, dl.remaining())
                if delay > 0:
                    _t.sleep(delay)
        raise ConnectionError(f"all namenodes failed: {last}")

    def close(self) -> None:
        for c in self._clients:
            c.close()

    def __enter__(self) -> "HaRpcClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class RpcClient:
    """Blocking RPC client; one socket, requests serialized by a lock.
    Reconnects on the next call after a connection failure."""

    def __init__(self, addr: tuple[str, int], timeout: float = 30.0):
        self._addr = (addr[0], addr[1])
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._req_id = 0
        # the last reply's state stamp and the high-water journal txid seen
        self.last_state: dict | None = None
        self.last_seen_txid = 0

    @property
    def addr(self) -> tuple[str, int]:
        return self._addr

    def _connect(self) -> socket.socket:
        s = socket.create_connection(
            self._addr, timeout=retry.effective_budget(self._timeout))
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def call(self, method: str, **kwargs: Any) -> Any:
        tr = tracing.current_context()
        if tr is not None:
            kwargs["_trace"] = list(tr)
        # Ambient deadline: refuse a spent budget before touching the
        # socket, stamp the remaining seconds as the hop-by-hop header,
        # and clamp this call's socket timeout to the remainder.
        dl = retry.current()
        if dl is not None:
            dl.check(f"rpc {method}")
            kwargs[retry.DEADLINE_KEY] = dl.header()
        with self._lock:
            self._req_id += 1
            req_id = self._req_id
            try:
                if self._sock is None:
                    self._sock = self._connect()
                self._sock.settimeout(
                    dl.timeout(self._timeout) if dl is not None
                    else self._timeout)
                send_frame(self._sock, [req_id, method, kwargs])
                resp = recv_frame(self._sock)
            except (ConnectionError, OSError):
                self.close()
                raise
        rid, status, payload, *extra = resp
        if rid != req_id:
            self.close()
            raise ConnectionError(
                f"rpc response id mismatch: {rid} != {req_id}")
        if extra and isinstance(extra[0], dict):
            self.last_state = extra[0]
            txid = extra[0].get("txid")
            if isinstance(txid, int) and txid > self.last_seen_txid:
                self.last_seen_txid = txid
        if status != 0:
            raise RpcError(payload["error"], payload["message"])
        return payload

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self) -> "RpcClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

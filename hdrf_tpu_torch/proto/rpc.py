"""Length-prefixed msgpack frames and the blocking RPC client (port of
hdrf_tpu/proto/rpc.py:54-92 ``MAX_FRAME``/``RpcError``/``recv_exact``/
``send_frame``/``recv_frame``, :453 ``normalize_addrs`` and :669-742
``RpcClient``).

An RPC is one frame ``[req_id, method, kwargs]`` answered by
``[req_id, status, payload, *extra]`` (status 0: payload is the result;
otherwise ``{"error", "message"}``, raised as :class:`RpcError`), the
reference's wire shape, so the port's DataNode talks to a reference
NameNode unchanged.  The server side (``RpcServer``, ``HaRpcClient``)
comes with the NameNode.

One frame = ``[u32 len][msgpack body]``.  The card's machine has no
``msgpack`` package, so this module carries its own encoder/decoder of
the subset the worker's frames and the chunk index's WAL and snapshot use
— dict, str, bytes, int, float, bool, None, list/tuple — byte-compatible
with ``msgpack.packb`` (its defaults: ``use_bin_type=True``, floats as
float64, smallest int encoding) and with ``msgpack.unpackb(raw=...,
strict_map_key=False)``: ``raw=False`` decodes str as ``str`` (the wire),
``raw=True`` as ``bytes`` (index/chunk_index.py reads its records so, as
the reference does).  Extension types are refused with ``ValueError``.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Any

from hdrf_tpu_torch.utils import retry, tracing

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
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes) -> None:
        self.buf = memoryview(buf)
        self.pos = 0

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
        return [_unpack(r, raw) for _ in range(t & 0x0F)]
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
        return [_unpack(r, raw) for _ in range(n)]
    if t in (0xDE, 0xDF):
        return _map(r, r.unpack((_H, _I)[t - 0xDE]), raw)
    raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def _str(v: memoryview, raw: bool):
    return bytes(v) if raw else str(v, "utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, raw)
        out[k] = _unpack(r, raw)
    return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode one msgpack object (``msgpack.unpackb(raw=raw,
    strict_map_key=False)`` semantics on the supported subset)."""
    r = _Reader(data)
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


def normalize_addrs(addr) -> list[tuple[str, int]]:
    """One (host, port) pair or any sequence of pairs -> list of tuples."""
    if (isinstance(addr, (list, tuple)) and addr
            and isinstance(addr[0], (list, tuple))):
        return [(a[0], int(a[1])) for a in addr]
    return [(addr[0], int(addr[1]))]


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

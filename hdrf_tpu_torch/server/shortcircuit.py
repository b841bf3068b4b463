"""Short-circuit local reads: Unix-domain fd passing + shm slot revocation
(port of hdrf_tpu/server/shortcircuit.py, both halves: ``ShortCircuitRegistry``,
``ShortCircuitServer`` in the DataNode, ``ShortCircuitCache``, ``read_local``
and ``_verify`` in the client).  The wire is the reference's byte for byte
(JSON requests, length-prefixed JSON replies, the fd and the shm segment in
SCM_RIGHTS ancillary data), so either package's client reads from either
package's DataNode.

Re-expression of the reference's short-circuit stack — client
`hdfs/shortcircuit/ShortCircuitCache.java:72` + DN
`ShortCircuitRegistry.java:83` with `ShortCircuitShm` (REQUEST_SHORT_CIRCUIT_FDS
over a DomainSocket, fd passed with SCM_RIGHTS, a shared-memory segment of
per-replica slots the DN flips to revoke) — because Python's
``socket.send_fds`` and ``mmap`` wrap the same kernel facilities directly.

The DataNode listens on ``<data_dir>/sc.sock``.  A local client asks for a
block's fds; the DN replies with the replica metadata (scheme, lengths,
checksums) and, when the replica has a physical data file whose bytes ARE the
logical bytes (direct scheme), the open file descriptor.  Reduced replicas
(dedup/compress) answer metadata-only and the client falls back to the TCP
read path — reconstruction must run on the DN where the chunk store lives.

Revocation (the registry half the fd pass alone lacks): a client may CACHE
granted fds (``ShortCircuitCache``); a cached fd can outlive the replica
(delete) or serve stale bytes (append supersede).  So each grant carries a
SLOT in a shared-memory segment the client obtained from the DN (one shm
fd-passed per client connection set, slots byte-sized); the DN's registry
flips the slot to 0 when the replica is invalidated or superseded, and the
client checks its slot BEFORE every cached-fd read — invalid means drop the
fd and re-request (falling back to TCP when the block is gone)."""

from __future__ import annotations

import array
import json
import mmap
import os
import socket
import threading
from typing import TYPE_CHECKING

from hdrf_tpu_torch import native
from hdrf_tpu_torch.utils import metrics, profiler, tenants

if TYPE_CHECKING:
    from hdrf_tpu_torch.server.datanode import DataNode

_M = metrics.registry("shortcircuit")
MAX_REQ = 4096
SHM_SLOTS = 4096


class ShortCircuitRegistry:
    """DN-side grant registry (ShortCircuitRegistry.java:83 analog): shm
    segments per client, slot allocation per granted fd, revocation by
    slot write."""

    def __init__(self, directory: str):
        self._dir = directory
        self._lock = threading.Lock()
        self._next_shm = 0
        self._shms: dict[int, mmap.mmap] = {}
        self._free: dict[int, list[int]] = {}
        # per-slot generation: a recycled slot gets a NEW generation, so a
        # client still holding the old grant fails its gen compare instead
        # of being re-validated by an unrelated grant (the ABA hazard)
        self._gen: dict[tuple[int, int], int] = {}
        # block_id -> [(shm_id, slot)] of outstanding grants
        self._grants: dict[int, list[tuple[int, int]]] = {}

    def alloc_shm(self) -> tuple[int, int]:
        """Create a slot segment; returns (shm_id, fd).  The fd is passed
        to the client (both sides mmap the same file); the backing file is
        unlinked immediately — it lives as long as the fds/mmaps do.  The
        caller must arrange ``free_shm`` when the owning client goes away
        (the server ties it to the alloc connection's lifetime — the
        DomainSocketWatcher role)."""
        with self._lock:
            shm_id = self._next_shm
            self._next_shm += 1
        path = os.path.join(self._dir, f".scshm-{shm_id}")
        fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
        os.ftruncate(fd, SHM_SLOTS)
        os.unlink(path)
        mm = mmap.mmap(fd, SHM_SLOTS)
        with self._lock:
            self._shms[shm_id] = mm
            self._free[shm_id] = list(range(SHM_SLOTS - 1, -1, -1))
        _M.incr("shms_allocated")
        return shm_id, fd

    def free_shm(self, shm_id: int) -> None:
        """Client went away: release its segment and every grant in it."""
        with self._lock:
            mm = self._shms.pop(shm_id, None)
            self._free.pop(shm_id, None)
            for bid in list(self._grants):
                kept = [(s, sl) for s, sl in self._grants[bid]
                        if s != shm_id]
                if kept:
                    self._grants[bid] = kept
                else:
                    del self._grants[bid]
            for key in [k for k in self._gen if k[0] == shm_id]:
                del self._gen[key]
            if mm is not None:
                mm.close()
                _M.incr("shms_freed")

    def release(self, shm_id: int, slot: int, gen: int) -> None:
        """Client voluntarily dropped a cached fd (eviction, failed pread)
        — reclaim the slot (ReleaseShortCircuitAccessSlot analog); without
        this, long-lived clients touching many blocks would drain the
        segment and silently degrade to uncached reads.  The GENERATION
        must match: a release racing a concurrent revoke+re-grant of the
        same slot would otherwise free ANOTHER grant's slot and
        double-insert it into the free list."""
        with self._lock:
            mm = self._shms.get(shm_id)
            if mm is None or self._gen.get((shm_id, slot)) != gen:
                return   # stale release: the slot moved on
            for bid, grants in list(self._grants.items()):
                if (shm_id, slot) in grants:
                    grants.remove((shm_id, slot))
                    if not grants:
                        del self._grants[bid]
                    mm[slot] = 0
                    self._free[shm_id].append(slot)
                    _M.incr("slots_released")
                    return

    def grant(self, shm_id: int, block_id: int) -> tuple[int, int] | None:
        """Allocate + validate a slot for a granted fd; returns
        (slot, generation) or None when the shm is unknown or full (the
        client must then use the fd single-shot, uncached)."""
        with self._lock:
            mm = self._shms.get(shm_id)
            free = self._free.get(shm_id)
            if mm is None or not free:
                return None
            slot = free.pop()
            key = (shm_id, slot)
            gen = self._gen.get(key, 0) % 255 + 1   # 1..255, never 0
            self._gen[key] = gen
            mm[slot] = gen
            self._grants.setdefault(block_id, []).append(key)
            _M.incr("slots_granted")
            return slot, gen

    def revoke(self, block_id: int) -> int:
        """Replica deleted or superseded: invalidate every outstanding
        grant's slot so cached fds are dropped before the next read."""
        with self._lock:
            grants = self._grants.pop(block_id, [])
            for shm_id, slot in grants:
                mm = self._shms.get(shm_id)
                if mm is not None:
                    mm[slot] = 0
                    self._free[shm_id].append(slot)
            if grants:
                _M.incr("slots_revoked", len(grants))
            return len(grants)

    def close(self) -> None:
        with self._lock:
            for mm in self._shms.values():
                mm.close()
            self._shms.clear()
            self._grants.clear()
            self._gen.clear()


def _entok(token: dict | None) -> dict | None:
    """Block token for the JSON request: the HMAC sig is bytes, hex it."""
    if token is None:
        return None
    t = dict(token)
    t["sig"] = bytes(t["sig"]).hex()
    return t


def _detok(token: dict | None) -> dict | None:
    if token is None or "sig" not in token:
        return token
    t = dict(token)
    try:
        t["sig"] = bytes.fromhex(t["sig"])
    except (TypeError, ValueError):
        pass  # malformed sig: verification will reject it
    return t


class ShortCircuitServer:
    """DN side: serve REQUEST_SHORT_CIRCUIT_FDS on a unix socket."""

    def __init__(self, dn: "DataNode", sock_path: str):
        self._dn = dn
        self.path = sock_path
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(sock_path)
        self._sock.listen(16)
        self.registry = ShortCircuitRegistry(os.path.dirname(sock_path)
                                             or ".")
        # open liveness (alloc_shm) connections: stop() must sever them so
        # clients learn the registry died — daemon handler threads outlive
        # an in-process restart and would otherwise keep the channel open
        self._live_conns: set = set()
        self._live_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve,
                                        name="dn-shortcircuit", daemon=True)

    def start(self) -> "ShortCircuitServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        with self._live_lock:
            conns = list(self._live_conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if os.path.exists(self.path):
            os.unlink(self.path)

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def stop_registry(self) -> None:
        self.registry.close()

    def _handle(self, conn: socket.socket) -> None:
        try:
            req = json.loads(conn.recv(MAX_REQ).decode())
            if req.get("op") == "alloc_shm":
                # hand the client its slot segment (ShortCircuitShm): the
                # fd rides the ancillary data, the id routes future
                # grants.  The connection then STAYS OPEN as the client's
                # liveness channel (DomainSocketWatcher role): EOF means
                # the client is gone and its segment + grants are freed.
                shm_id, fd = self.registry.alloc_shm()
                try:
                    with self._live_lock:
                        self._live_conns.add(conn)
                    payload = json.dumps({"status": "ok",
                                          "shm_id": shm_id}).encode()
                    prefix = len(payload).to_bytes(4, "little")
                    try:
                        socket.send_fds(conn, [prefix], [fd])
                    finally:
                        os.close(fd)
                    conn.sendall(payload)
                    try:
                        while conn.recv(1):
                            pass   # client never writes; EOF = disconnect
                    except OSError:
                        pass
                finally:
                    # freed on ANY exit — a client killed mid-handshake
                    # must not leak the segment
                    with self._live_lock:
                        self._live_conns.discard(conn)
                    self.registry.free_shm(shm_id)
                return
            if req.get("op") == "release":
                self.registry.release(int(req["shm_id"]), int(req["slot"]),
                                      int(req.get("gen", -1)))
                payload = json.dumps({"status": "ok"}).encode()
                conn.sendall(len(payload).to_bytes(4, "little") + payload)
                return
            block_id = req["block_id"]
            # Same gate as the TCP read path: when block tokens are enabled,
            # REQUEST_SHORT_CIRCUIT_FDS requires a READ token (the reference
            # enforces this in DataXceiver.requestShortCircuitFds) — a local
            # process that can reach sc.sock must not bypass authorization.
            try:
                self._dn.tokens.verify(_detok(req.get("token")), block_id, "r")
            except PermissionError:
                _M.incr("token_rejected")
                payload = json.dumps({"status": "denied"}).encode()
                conn.sendall(len(payload).to_bytes(4, "little") + payload)
                return
            # The fd-grant serve is a (tiny) read too: its timeline rings
            # beside the TCP serve_read ones so short-circuit latency is
            # attributed on the same read families.
            with profiler.read_timeline(block_id):
                with profiler.phase("index_lookup"):
                    meta = self._dn.replicas.get_meta(block_id)
                if meta is None:
                    payload = json.dumps({"status": "no_block"}).encode()
                    conn.sendall(len(payload).to_bytes(4, "little") + payload)
                    return
                resp = {"status": "ok", "scheme": meta.scheme,
                        "logical_len": meta.logical_len,
                        "physical_len": meta.physical_len,
                        "checksum_chunk": meta.checksum_chunk,
                        "checksums": meta.checksums,
                        # never pass an fd for an in-flight (hflush-visible)
                        # replica: its rbw file is still growing and the
                        # granted checksums would go stale — network reads
                        # serve the visible prefix instead
                        "fd": (meta.scheme == "direct"
                               and meta.physical_len > 0
                               and not self._dn.replicas.is_rbw(block_id))}
                if resp["fd"] and "shm_id" in req:
                    # revocable grant: the slot index + generation the client
                    # must check before every cached-fd read
                    g = self.registry.grant(int(req["shm_id"]), block_id)
                    if g is not None:
                        resp["slot"], resp["slot_gen"] = g
                # Length-prefixed reply: checksum lists for large blocks run
                # to tens of KB, far past any single recv.  The fd rides the
                # ancillary data of the 4-byte prefix send.
                payload = json.dumps(resp).encode()
                prefix = len(payload).to_bytes(4, "little")
                # Book the op BEFORE the reply hits the wire so a client
                # that just read its payload observes the tenant counter.
                tenants.note_op(req.get("_client"), "read_sc")
                with profiler.phase("net_send"):
                    if resp["fd"]:
                        fd = os.open(self._dn.replicas.data_path(block_id),
                                     os.O_RDONLY)
                        try:
                            socket.send_fds(conn, [prefix], [fd])
                        finally:
                            os.close(fd)  # receiver holds its own copy
                        conn.sendall(payload)
                        _M.incr("fds_passed")
                    else:
                        conn.sendall(prefix + payload)
                        _M.incr("metadata_only")
        except (OSError, ValueError, KeyError):
            _M.incr("errors")
        finally:
            conn.close()


def _request(sock_path: str, req: dict,
             keep_conn: bool = False
             ) -> tuple[dict | None, list[int], socket.socket | None]:
    """One round trip on the unix socket; returns (response, passed fds,
    connection).  The caller owns any returned fds; the connection is
    returned open only with ``keep_conn`` (the shm liveness channel),
    otherwise closed."""
    try:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(10)
        conn.connect(sock_path)
    except OSError:
        return None, [], None
    fds: list[int] = []
    try:
        conn.sendall(json.dumps(req).encode())
        prefix, fds, _, _ = socket.recv_fds(conn, 4, 1)
        fds = list(fds)
        while len(prefix) < 4:
            more = conn.recv(4 - len(prefix))
            if not more:
                raise OSError("short prefix")
            prefix += more
        want = int.from_bytes(prefix[:4], "little")
        buf = bytearray()
        while len(buf) < want:
            piece = conn.recv(want - len(buf))
            if not piece:
                raise OSError("short body")
            buf += piece
        resp = json.loads(bytes(buf).decode())
        if keep_conn:
            return resp, fds, conn
        conn.close()
        return resp, fds, None
    except (OSError, ValueError):
        for fd in fds:
            os.close(fd)
        conn.close()
        return None, [], None


class ShortCircuitCache:
    """Client-side fd cache (ShortCircuitCache.java:72 analog): granted
    fds are kept and re-used across reads, each guarded by its shm slot —
    the DN zeroes the slot when the replica is deleted/superseded, and the
    next read drops the stale fd and re-requests instead of serving stale
    bytes."""

    def __init__(self):
        self._lock = threading.Lock()
        # sock_path -> (shm mmap|None, shm_id|None, liveness conn|None)
        self._shm: dict[str, tuple] = {}
        # (sock_path, block_id) -> (fd, slot, slot_gen, resp meta); only
        # slot-guarded grants are cached — an unguarded fd would be
        # unrevocable and could serve stale bytes forever
        self._fds: dict[tuple[str, int], tuple[int, int, int, dict]] = {}

    def _shm_for(self, sock_path: str):
        with self._lock:
            if sock_path in self._shm:
                return self._shm[sock_path]
        # the connection stays OPEN both ways: the DN frees the segment on
        # our EOF, and WE learn the DN died/restarted from its EOF — an
        # orphaned mmap would otherwise keep stale gen values forever
        resp, fds, conn = _request(sock_path, {"op": "alloc_shm"},
                                   keep_conn=True)
        mm = shm_id = None
        if resp and resp.get("status") == "ok" and fds:
            try:
                mm = mmap.mmap(fds[0], SHM_SLOTS)
                shm_id = resp["shm_id"]
            except (OSError, ValueError):
                mm = shm_id = None
        for fd in fds:
            os.close(fd)
        if mm is None:
            # transient failure: do NOT cache it, the next read retries
            if conn is not None:
                conn.close()
            return (None, None, None)
        conn.setblocking(False)
        with self._lock:
            if sock_path in self._shm:   # lost a setup race: keep first
                conn.close()
                mm.close()
            else:
                self._shm[sock_path] = (mm, shm_id, conn)
            return self._shm[sock_path]

    def _dn_alive(self, sock_path: str, conn) -> bool:
        """Poll the liveness connection: EOF/error means the DN (or its
        registry) is gone — every grant from it is void."""
        if conn is None:
            return False
        try:
            if conn.recv(1) == b"":
                raise OSError("EOF")
            return True           # DN never writes; data would be a bug
        except (BlockingIOError, InterruptedError):
            return True
        except OSError:
            with self._lock:
                ent = self._shm.pop(sock_path, None)
                dead = [k for k in self._fds if k[0] == sock_path]
                fds = [self._fds.pop(k)[0] for k in dead]
            for fd in fds:
                os.close(fd)
            if ent is not None:
                if ent[2] is not None:
                    ent[2].close()
                if ent[0] is not None:
                    ent[0].close()
            _M.incr("shm_channels_lost")
            return False

    def _drop(self, key: tuple[str, int], release: bool = True) -> None:
        with self._lock:
            ent = self._fds.pop(key, None)
            shm = self._shm.get(key[0])
        if ent is None:
            return
        os.close(ent[0])
        if release and shm is not None and shm[1] is not None:
            # hand the slot back (ReleaseShortCircuitAccessSlot): not
            # doing so would drain the segment over a client's lifetime;
            # the generation guards against racing a revoke+re-grant
            _request(key[0], {"op": "release", "shm_id": shm[1],
                              "slot": ent[1], "gen": ent[2]})

    def read(self, sock_path: str, block_id: int, offset: int,
             length: int, token: dict | None = None,
             client_name: str | None = None) -> bytes | None:
        key = (sock_path, block_id)
        with self._lock:
            ent = self._fds.get(key)
        mm, shm_id, conn = self._shm_for(sock_path)
        if ent is not None:
            fd, slot, gen, resp = ent
            if mm is None or not self._dn_alive(sock_path, conn):
                # DN gone/restarted: _dn_alive dropped every cached fd;
                # try a fresh segment right away (restart case)
                mm, shm_id, conn = self._shm_for(sock_path)
            elif mm[slot] != gen:
                # revoked (slot zeroed) or recycled to another grant (gen
                # mismatch): either way this fd may map dead bytes; the
                # slot is already back in the DN's free list
                _M.incr("cached_fd_revoked")
                self._drop(key, release=False)
            else:
                out = self._pread(fd, offset, length, resp)
                if out is not None:
                    _M.incr("cached_fd_reads")
                    return out
                self._drop(key)  # stale/corrupt: refetch below
        req = {"block_id": block_id, "token": _entok(token)}
        if client_name:
            req["_client"] = client_name  # tenant attribution (utils/tenants.py)
        if shm_id is not None:
            req["shm_id"] = shm_id
        resp, fds, _ = _request(sock_path, req)
        if not resp or resp.get("status") != "ok" or not resp.get("fd") \
                or not fds:
            for fd in fds:
                os.close(fd)
            return None
        fd = fds[0]
        for extra in fds[1:]:
            os.close(extra)
        out = self._pread(fd, offset, length, resp)
        slot, gen = resp.get("slot"), resp.get("slot_gen")
        if out is None or slot is None or gen is None:
            # no revocation guard (shm full/unavailable): single-use fd —
            # caching it would make delete/append invisible to this client
            os.close(fd)
            return out
        with self._lock:
            old = self._fds.get(key)
            self._fds[key] = (fd, slot, gen, resp)
        if old is not None:
            os.close(old[0])
        return out

    @staticmethod
    def _pread(fd: int, offset: int, length: int,
               resp: dict) -> bytes | None:
        end = resp["logical_len"] if length < 0 else min(
            offset + length, resp["logical_len"])
        try:
            data = os.pread(fd, end - offset, offset)
        except OSError:
            return None
        if len(data) != end - offset:
            return None  # truncated replica: fall back, let the scanner act
        if not _verify(data, offset, resp):
            _M.incr("checksum_failures")
            return None  # corrupt local replica: fall back to another copy
        _M.incr("local_reads")
        _M.incr("local_bytes", len(data))
        return data

    def close(self) -> None:
        with self._lock:
            for fd, _, _, _ in self._fds.values():
                os.close(fd)
            self._fds.clear()
            for mm, _, conn in self._shm.values():
                if conn is not None:
                    conn.close()   # EOF -> DN frees the segment + grants
                if mm is not None:
                    mm.close()
            self._shm.clear()


def read_local(sock_path: str, block_id: int, offset: int,
               length: int, token: dict | None = None,
               client_name: str | None = None) -> bytes | None:
    """Uncached one-shot short-circuit read: fd fetched, pread, closed —
    no shm allocation (a throwaway segment per call would grow the DN's
    registry for nothing)."""
    req = {"block_id": block_id, "token": _entok(token)}
    if client_name:
        req["_client"] = client_name  # tenant attribution (utils/tenants.py)
    resp, fds, _ = _request(sock_path, req)
    if not resp or resp.get("status") != "ok" or not resp.get("fd") \
            or not fds:
        for fd in fds:
            os.close(fd)
        return None
    try:
        return ShortCircuitCache._pread(fds[0], offset, length, resp)
    finally:
        for fd in fds:
            os.close(fd)


def _verify(data: bytes, offset: int, resp: dict) -> bool:
    """The same end-to-end crc32c verification the TCP read path applies
    (client/filesystem.py) — a passed fd must not bypass it."""
    cchunk = resp.get("checksum_chunk", 0)
    stored = resp.get("checksums") or []
    if not cchunk or not stored or offset % cchunk:
        return True  # unaligned range: verified end-to-end only via TCP path
    logical = resp["logical_len"]
    first = offset // cchunk
    for i in range((len(data) + cchunk - 1) // cchunk):
        piece = data[i * cchunk:(i + 1) * cchunk]
        full = len(piece) == cchunk or offset + len(data) == logical
        if full and first + i < len(stored):
            if native.crc32c(piece) != stored[first + i]:
                return False
    return True

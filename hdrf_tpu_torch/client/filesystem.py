"""Client: filesystem API over the control RPC + data transfer protocol
(port of hdrf_tpu/client/filesystem.py, whole: ``HdrfClient`` and
``HdrfOutputStream``).

The port's one addition is the device of the client's own kernel: the
GF(2^8) RS kernel of striped EC writes (parity) and degraded reads
(decode), client/striped.py.  ``HdrfClient(..., device="cuda")``, the
default, runs it on the card and raises without one; ``device="cpu"``
runs its plain version.  Everything else keeps the reference's names,
signatures and wire, with two departures.  One is how the wire is read: a
block's per-packet acks are read on a second thread while its packets
are sent (``proto/datatransfer.AckPump``, the DFSOutputStream
ResponseProcessor role), where the reference reads them all after the
last packet.  The bytes on the wire are the same.  The other: the
leases of a client's open writes are renewed on a timer
(``LeaseRenewer``), where the reference renews only between blocks.

Re-expression of the reference's client stack — DistributedFileSystem ->
DFSClient (DFSClient.java:204; open :967, create :1116), DFSOutputStream +
DataStreamer (block write pipeline, DataStreamer.java:655, pipeline setup
:1655/:1702), DFSInputStream (read with location failover,
DFSInputStream.java:817 -> blockSeekTo :539) — as a compact synchronous
client:

- ``write``: create -> per block: add_block -> stream packets to the first
  target (which mirrors downstream) -> final aggregated ack -> complete.
  Pipeline failure recovery is block-granular: abandon the block and
  re-request targets (the reference swaps the bad node mid-block,
  DataStreamer pipeline recovery; block-granular retry is the simpler
  equivalent with identical durability).
- ``read``: get_block_locations -> per block: try each replica location in
  order, failing over on connection/checksum errors (read failover,
  DFSInputStream.java:621+).  Range reads request only the overlapping
  blocks and byte ranges (reconstruction stays chunk-granular end-to-end).
- observer metadata plane: reads route to observer NNs through
  the HA proxy's state-id protocol (ObserverReadProxyProvider.java:60),
  ``msync`` exposes the consistency barrier, and an opt-in LRU+TTL
  metadata cache (block locations + stats) is invalidated by txid
  generation, so hot-path re-reads skip the NN fleet entirely.
"""

from __future__ import annotations

import collections
import contextlib
import socket
import threading
import time
import uuid

from hdrf_tpu_torch import native
from hdrf_tpu_torch.config import ClientConfig
from hdrf_tpu_torch.proto import datatransfer as dt
from hdrf_tpu_torch.proto.rpc import RpcClient, recv_frame
from hdrf_tpu_torch.utils import metrics, qos, retry, rollwin, tracing

_M = metrics.registry("client")
_TR = tracing.tracer("client")


class LeaseRenewer:
    """Renews a client's leases on a timer while any of its writes is open
    (HDFS's LeaseRenewer thread, which renews every half soft limit): one
    daemon thread per client, started by the first write and stopped by
    ``HdrfClient.close``.  It sends the reference's ``renew_lease`` RPC,
    so the NameNode and the wire are unchanged.

    A departure from the reference, whose client renews only between two
    blocks of a write: there a block that takes longer than the
    NameNode's lease expiry (``LeaseManager.expiry_s``, 60 s) loses the
    file to lease recovery.  Here the lease is renewed every
    ``INTERVAL_S`` while the block is still streaming.  A failed renewal
    is counted (``client.lease_renew_failures``) and retried at the next
    interval."""

    INTERVAL_S = 20.0   # a third of the NameNode's 60 s expiry

    def __init__(self, client: "HdrfClient"):
        self._c = client
        self._cv = threading.Condition()
        self._open = 0
        self._closed = False
        self._thread: threading.Thread | None = None

    def begin(self) -> None:
        """A write of the client opened: renew from now on."""
        with self._cv:
            self._open += 1
            if self._thread is None and not self._closed:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"{self._c.name}-lease-renewer")
                self._thread.start()
            self._cv.notify_all()

    def end(self) -> None:
        """A write of the client completed or was abandoned."""
        with self._cv:
            self._open -= 1
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def _loop(self) -> None:
        due = None   # when the next renewal is due; None while no write
        with self._cv:
            while not self._closed:
                if not self._open:
                    due = None
                    self._cv.wait()
                    continue
                now = time.monotonic()
                if due is None:
                    due = now + self.INTERVAL_S
                if now < due:
                    self._cv.wait(due - now)
                    continue
                due = now + self.INTERVAL_S
                self._cv.release()
                try:
                    self._c._call("renew_lease", client=self._c.name)
                    _M.incr("lease_renewals")
                except Exception:  # noqa: BLE001 — the thread must live
                    _M.incr("lease_renew_failures")
                finally:
                    self._cv.acquire()


class HdrfClient:
    def __init__(self, namenode_addr,
                 config: ClientConfig | None = None, name: str | None = None,
                 user: str | None = None, groups: list[str] | None = None,
                 device: str = "cuda"):
        """``namenode_addr``: one (host, port) or an ordered list of them —
        a list engages the HA failover proxy (retry across NNs on
        StandbyError / connection failure).  ``user``/``groups``: the
        caller identity presented to the NameNode's permission checker
        (UGI analog); defaults to the OS user.  ``device``: where the
        striped path's RS kernel runs (``cuda``, or ``cpu`` for its plain
        version); resolved when an EC file is written or decoded."""
        import getpass

        self.config = config or ClientConfig()
        self.name = name or f"client-{uuid.uuid4().hex[:8]}"
        self.user = user or getpass.getuser()
        self.groups = list(groups or [])
        self.device = device
        from hdrf_tpu_torch.proto.rpc import HaRpcClient, normalize_addrs

        addrs = normalize_addrs(namenode_addr)
        self._nn = (HaRpcClient(addrs,
                                observer_reads=self.config.observer_reads)
                    if len(addrs) > 1 else RpcClient(addrs[0]))
        self._sc_cache = None  # lazy ShortCircuitCache (fd + shm slots)
        # Client-side metadata cache (block locations + stats; LRU with
        # TTL) invalidated by txid GENERATION: entries remember the
        # highest journal txid this client had observed at insert and are
        # served only while that hasn't moved — any mutation the client
        # sees (its own writes included, via the reply-envelope state
        # stamp) invalidates the whole generation at once.  Off unless
        # metadata_cache_ttl_s > 0.
        self._meta_cache: collections.OrderedDict = collections.OrderedDict()
        self._meta_lock = threading.Lock()
        # Rolling window of successful block-read latencies: its p95 sets
        # the hedged-read trigger (utils/rollwin.py, the same discipline
        # as the mirror plane's per-peer hedge windows).
        self._read_lat = rollwin.RollingWindow(window_s=300.0, maxlen=128)
        self._dtoken: dict | None = None
        self._renewer = LeaseRenewer(self)
        if self.config.use_delegation_tokens:
            self._dtoken = self._nn.call("get_delegation_token",
                                         renewer=self.name, owner=self.name)

    def _op_deadline(self):
        """End-to-end budget for one public op: binds the ambient deadline
        (propagated hop-by-hop as the _deadline header by RpcClient and
        dt.send_op) when ``ClientConfig.op_deadline_s`` is set; otherwise a
        no-op that leaves any caller-bound deadline in place."""
        import contextlib as _ctx

        b = self.config.op_deadline_s
        if not b:
            return _ctx.nullcontext()
        return retry.bind(retry.Deadline(float(b)))

    def _call(self, method: str, **kw):
        """NameNode RPC with the client's delegation token and caller
        identity attached (the UGI-token-selector analog: every call
        authenticates — and is permission-checked — when the cluster
        requires it).  Paths through symlinks answer SymlinkRedirect with
        the resolved path; the client retries, bounded (the reference's
        UnresolvedPathException client-side resolution)."""
        from hdrf_tpu_torch.proto.rpc import RpcError

        if self._dtoken is not None:
            kw["_dtoken"] = self._dtoken
        kw["_user"] = self.user
        kw["_client"] = self.name  # tenant attribution (utils/tenants.py)
        if self.groups:
            kw["_groups"] = self.groups
        for _ in range(16):
            try:
                return self._nn.call(method, **kw)
            except RpcError as e:
                if e.error != "SymlinkRedirect":
                    raise
                orig, _, resolved = e.message.partition("\n")

                def norm(p):
                    return "/" + "/".join(x for x in str(p).split("/") if x)

                hit = False
                for k, v in list(kw.items()):
                    if isinstance(v, str) and not k.startswith("_") \
                            and norm(v) == orig:
                        kw[k] = resolved
                        hit = True
                    elif isinstance(v, list) and v and \
                            all(isinstance(x, str) for x in v):
                        kw[k] = [resolved if norm(x) == orig else x
                                 for x in v]
                        hit = hit or kw[k] != v
                if not hit:
                    raise
        raise IOError("too many levels of symbolic links")

    def _cached_meta(self, method: str, path: str):
        """``stat``/``get_block_locations`` through the LRU+TTL metadata
        cache.  A hit requires the entry to be unexpired AND inserted at
        the client's CURRENT txid generation — ``last_seen_txid`` advances
        on every reply that observed a newer journal state, so a bumped
        generation invalidates everything older in one comparison."""
        ttl = self.config.metadata_cache_ttl_s
        if ttl <= 0:
            return self._call(method, path=path)
        gen = getattr(self._nn, "last_seen_txid", 0)
        key = (method, path)
        now = time.monotonic()
        with self._meta_lock:
            ent = self._meta_cache.get(key)
            if ent is not None and ent[0] > now and ent[1] == gen:
                self._meta_cache.move_to_end(key)
                _M.incr("meta_cache_hits")
                return ent[2]
        _M.incr("meta_cache_misses")
        out = self._call(method, path=path)
        gen = getattr(self._nn, "last_seen_txid", 0)  # post-reply generation
        with self._meta_lock:
            self._meta_cache[key] = (now + ttl, gen, out)
            self._meta_cache.move_to_end(key)
            while len(self._meta_cache) > self.config.metadata_cache_entries:
                self._meta_cache.popitem(last=False)
        return out

    def msync(self, wait_s: float | None = None) -> dict:
        """Consistency barrier (FileSystem.msync analog): wait until every
        reachable observer has applied this client's last-seen txid, so
        subsequent observer reads are read-your-writes.  A single-NN
        client talks straight to the active — already consistent — and
        returns {}."""
        ms = getattr(self._nn, "msync", None)
        return ms(wait_s=wait_s) if ms is not None else {}

    def renew_delegation_token(self) -> float:
        return self._call("renew_delegation_token", token=self._dtoken)

    def cancel_delegation_token(self) -> bool:
        out = self._call("cancel_delegation_token", token=self._dtoken)
        self._dtoken = None
        return out

    def close(self) -> None:
        self._renewer.close()
        if self._sc_cache is not None:
            self._sc_cache.close()
            self._sc_cache = None
        self._nn.close()

    @contextlib.contextmanager
    def _lease_held(self):
        """Keep the lease renewer running around one write."""
        self._renewer.begin()
        try:
            yield
        finally:
            self._renewer.end()

    def __enter__(self) -> "HdrfClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------- namespace ops

    def mkdir(self, path: str) -> bool:
        return self._call("mkdir", path=path)

    @staticmethod
    def _trash_root() -> str:
        """Keyed to the OS user (fs.trash keys on the HDFS user the same
        way) — NOT the per-process client id, or every CLI invocation would
        orphan its own trash dir."""
        import getpass

        return f"/.Trash/{getpass.getuser()}"

    def delete(self, path: str, skip_trash: bool = True) -> bool:
        """``skip_trash=False`` moves into the user's trash instead of
        deleting (the fs.trash interval behavior; `expunge` empties).  Paths
        already inside the trash are always deleted permanently."""
        if skip_trash or path.startswith("/.Trash/"):
            return self._call("delete", path=path)
        import time as _t

        if not self.exists(path):
            return False  # same contract as the direct delete
        name = path.strip("/").replace("/", "%2F")
        base = f"{self._trash_root()}/{int(_t.time())}-{name}"
        for attempt in range(100):  # same-second re-delete of a recreated
            # path: disambiguate like HDFS's .1/.2 suffixes
            dst = base if attempt == 0 else f"{base}.{attempt}"
            try:
                return self._call("rename", src=path, dst=dst)
            except Exception as e:
                if getattr(e, "error", "") != "FileExistsError":
                    raise
        raise IOError(f"could not find a free trash slot for {path}")

    def expunge(self, older_than_s: float = 0.0) -> int:
        """Delete trash entries older than ``older_than_s`` (dfs -expunge)."""
        import time as _t

        removed = 0
        try:
            entries = self.ls(self._trash_root())
        except Exception as e:
            if getattr(e, "error", "") == "FileNotFoundError":
                return 0  # nothing ever trashed
            raise
        cutoff = _t.time() - older_than_s
        for e in entries:
            try:
                ts = int(e["name"].split("-", 1)[0].split(".", 1)[0])
            except ValueError:
                continue
            if ts <= cutoff:
                if self._call(
                        "delete", path=f"{self._trash_root()}/{e['name']}"):
                    removed += 1
        return removed

    def rename(self, src: str, dst: str) -> bool:
        return self._call("rename", src=src, dst=dst)

    def ls(self, path: str) -> list[dict]:
        return self._call("listing", path=path)

    def stat(self, path: str) -> dict:
        return self._cached_meta("stat", path)

    def exists(self, path: str) -> bool:
        try:
            self._call("stat", path=path)
            return True
        except Exception:
            return False

    def datanode_report(self) -> list[dict]:
        return self._call("datanode_report")

    # ------------------------------------------------------ cache directives

    def add_cache_pool(self, name: str, limit: int = -1) -> bool:
        return self._call("add_cache_pool", name=name, limit=limit)

    def remove_cache_pool(self, name: str) -> bool:
        return self._call("remove_cache_pool", name=name)

    def list_cache_pools(self) -> dict:
        return self._call("list_cache_pools")

    def add_cache_directive(self, path: str, pool: str) -> int:
        return self._call("add_cache_directive", path=path, pool=pool)

    def remove_cache_directive(self, directive_id: int) -> bool:
        return self._call("remove_cache_directive",
                          directive_id=directive_id)

    def list_cache_directives(self) -> list[dict]:
        return self._call("list_cache_directives")

    # ------------------------- storage policy / replication / times / links

    def set_storage_policy(self, path: str, policy: str) -> bool:
        return self._call("set_storage_policy", path=path, policy=policy)

    def get_storage_policy(self, path: str) -> dict:
        return self._call("get_storage_policy", path=path)

    def set_replication(self, path: str, replication: int) -> bool:
        return self._call("set_replication", path=path,
                          replication=replication)

    def set_times(self, path: str, mtime: float = -1.0) -> bool:
        return self._call("set_times", path=path, mtime=mtime)

    def concat(self, dst: str, srcs: list[str]) -> bool:
        return self._call("concat", dst=dst, srcs=srcs)

    def create_symlink(self, link: str, target: str) -> bool:
        return self._call("create_symlink", link=link, target=target)

    # -------------------------------------- permissions / ACLs / xattrs

    def chmod(self, path: str, mode: int) -> bool:
        return self._call("set_permission", path=path, mode=mode)

    def chown(self, path: str, owner: str = "", group: str = "") -> bool:
        return self._call("set_owner", path=path, owner=owner, group=group)

    def getfacl(self, path: str) -> dict:
        return self._call("get_acl", path=path)

    def setfacl(self, path: str, spec: str = "", default_spec: str = "",
                remove_all: bool = False,
                remove_default: bool = False) -> bool:
        return self._call("set_acl", path=path, spec=spec,
                          default_spec=default_spec, remove_all=remove_all,
                          remove_default=remove_default)

    def setfattr(self, path: str, name: str, value: bytes) -> bool:
        return self._call("set_xattr", path=path, name=name, value=value)

    def getfattr(self, path: str, names: list[str] | None = None) -> dict:
        return self._call("get_xattrs", path=path, names=names)

    def removefattr(self, path: str, name: str) -> bool:
        return self._call("remove_xattr", path=path, name=name)

    # ------------------------------------------------- snapshots and quotas

    def allow_snapshot(self, path: str) -> bool:
        return self._call("allow_snapshot", path=path)

    def create_snapshot(self, path: str, name: str) -> bool:
        return self._call("create_snapshot", path=path, name=name)

    def delete_snapshot(self, path: str, name: str) -> bool:
        return self._call("delete_snapshot", path=path, name=name)

    def list_snapshots(self, path: str) -> list[str]:
        return self._call("list_snapshots", path=path)

    def snapshot_diff(self, path: str, from_snap: str,
                      to_snap: str = "") -> dict:
        """Diff report between two snapshots (getSnapshotDiffReport,
        SnapshotDiffInfo.java:44); empty ``to_snap`` diffs against the
        current tree.  Entries: {type: CREATE|DELETE|MODIFY|RENAME, path,
        [target]} with paths relative to the snapshot root."""
        return self._call("snapshot_diff", path=path, from_snap=from_snap,
                          to_snap=to_snap)

    def set_quota(self, path: str, namespace_quota: int = -1,
                  space_quota: int = -1) -> bool:
        return self._call("set_quota", path=path,
                             namespace_quota=namespace_quota,
                             space_quota=space_quota)

    def content_summary(self, path: str) -> dict:
        return self._call("content_summary", path=path)

    def events(self, since_seq: int = 0, poll_s: float = 0.2):
        """Namespace event iterator (DFSInotifyEventInputStream analog):
        yields event dicts forever; break when done.  Raises IOError when the
        server's ring trimmed events past this consumer (the
        MissingEventsException analog) — resync via a listing and a fresh
        iterator."""
        import time as _t

        seq = since_seq
        while True:
            resp = self._call("get_events", since_seq=seq)
            if seq and resp["trimmed_through"] > seq:
                raise IOError(
                    f"event stream gap: events through "
                    f"{resp['trimmed_through']} were trimmed, consumer at "
                    f"{seq}")
            for ev in resp["events"]:
                yield ev
                seq = ev["seq"]
            if not resp["events"]:
                # no events in (seq, last_seq]: those edits emit no events,
                # so skipping ahead is safe and keeps the next poll cheap
                seq = max(seq, resp["last_seq"])
                _t.sleep(poll_s)

    # ----------------------------------------------------------------- write

    def open_for_write(self, path: str,
                       replication: int | None = None) -> "HdrfOutputStream":
        """Open a streaming writer with hflush/hsync support
        (DFSOutputStream.java:573 hflush / :580 hsync — the mid-write
        durability API WAL-shaped workloads depend on).  Blocks written
        through the stream are stored under the ``direct`` scheme: bytes
        must reach replicas incrementally, which is incompatible with
        whole-block reduction (the reference likewise reduces only blocks
        that arrive whole)."""
        info = self._call("create", path=path, client=self.name,
                          replication=replication, scheme="direct")
        if info.get("encryption"):
            raise IOError("streaming writes inside encryption zones are "
                          "not supported (use write())")
        return HdrfOutputStream(self, path, info["block_size"])

    def write(self, path: str, data: bytes, scheme: str | None = None,
              replication: int | None = None, ec: str | None = None) -> None:
        """Write a whole file (the put path, §3.1 of SURVEY.md).  ``ec`` is an
        erasure-coding policy name ('rs-6-3-64k'): the file is cell-striped
        over k+m DataNodes instead of replicated (client/striped.py)."""
        with self._op_deadline(), self._lease_held(), \
                _TR.span("write") as sp:
            sp.annotate("path", path)
            sp.annotate("bytes", len(data))
            if ec is not None:
                from hdrf_tpu_torch.client.striped import StripedWriter

                StripedWriter(self).write(path, data, ec)
                _M.incr("files_written")
                return
            info = self._call("create", path=path, client=self.name,
                                 replication=replication, scheme=scheme)
            if info.get("encryption"):
                # transparent client-side encryption (the DFSClient
                # CryptoOutputStream role): ChaCha20 stream over the file
                # bytes under the per-file DEK; the DN stores ciphertext
                enc = info["encryption"]
                data = native.chacha20_xor(bytes(enc["dek"]),
                                           bytes(enc["iv"]), data)
                _M.incr("encrypted_writes")
            block_size = info["block_size"]
            lengths: dict[int, int] = {}
            off = 0
            while True:   # the lease renewer keeps the lease meanwhile
                block = data[off:off + block_size]
                bid = self._write_block(path, block)
                lengths[bid] = len(block)
                off += block_size
                if off >= len(data):
                    break
            self._complete(path, lengths)
            _M.incr("files_written")
            _M.incr("bytes_written", len(data))

    def append(self, path: str, data: bytes) -> None:
        """Append to a complete file (DFSClient.append analog).  The last
        partial block is REWRITTEN under a bumped generation stamp
        (block-granular copy-on-append — the design that stays coherent
        with reduced storage; the re-reduction dedups against the block's
        own old chunks), full blocks are appended as usual."""
        if not data:
            return
        with self._lease_held(), _TR.span("append") as sp:
            sp.annotate("path", path)
            info = self._call("append", path=path, client=self.name)
            block_size = info["block_size"]
            lengths: dict[int, int] = {}
            last = info.get("last_block")
            if last is not None:
                # prefix = the partial last block's current bytes
                prefix = self.read(path, offset=info["file_length"]
                                   - last["length"], length=last["length"])
                merged = prefix + data[:block_size - last["length"]]
                alloc = self._call("append_block", path=path,
                                   client=self.name)
                self._stream_block(alloc, merged)
                lengths[alloc["block_id"]] = len(merged)
                data = data[block_size - last["length"]:]
            off = 0
            while off < len(data):
                block = data[off:off + block_size]
                lengths[self._write_block(path, block)] = len(block)
                off += block_size
            self._complete(path, lengths)
            _M.incr("appends")

    def truncate(self, path: str, new_length: int) -> bool:
        return self._call("truncate", path=path, new_length=new_length)

    def _complete(self, path: str, lengths: dict[int, int],
                  timeout: float = 30.0) -> None:
        """completeFile retry loop: the NN answers False until every block
        has a reported location (IBRs are asynchronous).  Polls under a
        retry.Deadline — clamped by any ambient op budget."""
        import time as _t

        dl = retry.Deadline(retry.effective_budget(timeout))
        while True:
            if self._call("complete", path=path, client=self.name,
                             block_lengths=lengths):
                return
            if dl.expired:
                raise IOError(f"complete({path}) timed out awaiting replicas")
            _t.sleep(min(0.05, max(dl.remaining(), 0.0)))

    def _write_block(self, path: str, block: bytes, retries: int = 3) -> int:
        """Block-granular pipeline recovery with capped full-jitter backoff
        between attempts (replacing the immediate hot-loop retry — the
        DataStreamer's sleepy recovery, DataStreamer.java:655); a spent
        ambient deadline stops retrying instead of sleeping into it."""
        import time as _t

        last_err: Exception | None = None
        delays = retry.backoff_delays(max(0, retries - 1),
                                      base_s=0.05, cap_s=2.0)
        for attempt in range(retries):
            dl = retry.current()
            if dl is not None:
                dl.check("block write retry")
            alloc = self._call("add_block", path=path, client=self.name)
            bid = alloc["block_id"]
            shed_hint = None
            try:
                self._stream_block(alloc, block)
                return bid
            except qos.ShedError as e:
                # structured admission refusal: retry, but wait the DN's
                # own estimate instead of blind backoff
                last_err = e
                shed_hint = e.retry_after_s
                _M.incr("write_sheds_seen")
                self._call("abandon_block", path=path, client=self.name,
                              block_id=bid)
                # futile retry: the DN says admission needs longer than
                # the whole remaining budget — surface the shed now
                # instead of sleeping the deadline away
                if shed_hint and dl is not None \
                        and shed_hint > dl.remaining():
                    raise last_err
            except (OSError, ConnectionError, IOError) as e:
                last_err = e
                _M.incr("block_write_retries")
                self._call("abandon_block", path=path, client=self.name,
                              block_id=bid)
            if attempt < retries - 1:
                delay = next(delays)
                if shed_hint:
                    delay = max(delay, shed_hint)
                if dl is not None:
                    delay = min(delay, dl.remaining())
                if delay > 0:
                    _t.sleep(delay)
        if isinstance(last_err, qos.ShedError):
            raise last_err  # keep the structured retryable type + hint
        raise IOError(f"block write failed after {retries} attempts: {last_err}")

    def _stream_block(self, alloc: dict, block: bytes) -> None:
        targets = alloc["targets"]
        sock = socket.create_connection(tuple(targets[0]["addr"]),
                                        timeout=retry.effective_budget(120.0))
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock = dt.secure_socket(sock, alloc.get("token"),
                                    self.config.encrypt_data_transfer)
            dt.send_op(sock, dt.WRITE_BLOCK, block_id=alloc["block_id"],
                       gen_stamp=alloc["gen_stamp"], scheme=alloc["scheme"],
                       token=alloc.get("token"), targets=targets[1:],
                       storage_type=targets[0].get("storage_type"),
                       _client=self.name)
            psz = self.config.packet_size
            # Per-packet acks, read as they come; the final one carries
            # pipeline status.  A shed ack's seqno field carries the DN's
            # retry-after hint in ms (datatransfer.py ACK_SHED — the block
            # was refused at admission, nothing was stored).
            hint, status = dt.stream_acked(sock, block, psz)[-1]
            if status == dt.ACK_SHED:
                raise qos.ShedError(
                    f"block {alloc['block_id']} shed at admission",
                    retry_after_s=hint / 1e3)
            if status != dt.ACK_SUCCESS:
                raise IOError(f"pipeline returned status {status}")
        finally:
            sock.close()

    # ------------------------------------------------------------------ read

    def read(self, path: str, offset: int = 0, length: int = -1) -> bytes:
        """Read [offset, offset+length) of a file (whole file by default)."""
        with self._op_deadline(), _TR.span("read") as sp:
            sp.annotate("path", path)
            loc = self._cached_meta("get_block_locations", path)
            if not loc.get("ec") and any(not b["locations"]
                                         for b in loc["blocks"]):
                # Observer block maps are eventually consistent: IBRs race
                # the journal tail, so a freshly-completed block can show
                # zero locations there even after msync (which fences the
                # NAMESPACE txid only).  Bounce the locations fetch to the
                # active (_sid in kwargs skips observer routing) and drop
                # the stale cache entry rather than failing the read.
                _M.incr("observer_empty_locations")
                with self._meta_lock:
                    self._meta_cache.pop(("get_block_locations", path),
                                         None)
                loc = self._call("get_block_locations", path=path,
                                 _sid=getattr(self._nn, "last_seen_txid",
                                              0))
            total = loc["length"]
            end = total if length < 0 else min(offset + length, total)
            if offset >= end:
                return b""
            if loc.get("ec"):
                from hdrf_tpu_torch.client.striped import StripedReader

                data = StripedReader(self).read(loc, offset, end)
                _M.incr("files_read")
                _M.incr("bytes_read", len(data))
                return data
            out = bytearray()
            pos = 0
            for binfo in loc["blocks"]:
                blen = binfo["length"]
                bstart, bend = pos, pos + blen
                pos = bend
                if bend <= offset or bstart >= end:
                    continue
                lo = max(offset, bstart) - bstart
                hi = min(end, bend) - bstart
                out += self._read_block(binfo, lo, hi - lo)
            if loc.get("encrypted") and out:
                # CryptoInputStream role: offset-aware ChaCha20 decrypt —
                # seek the keystream to the 64-byte block containing
                # ``offset`` and discard the intra-block prefix.  The DEK
                # rides the locations response (FileEncryptionInfo).
                enc = loc.get("encryption") or self._call("decrypt_edek",
                                                          path=path)
                pre = offset % 64
                ks = native.chacha20_xor(
                    bytes(enc["dek"]), bytes(enc["iv"]),
                    b"\x00" * pre + bytes(out), counter=1 + offset // 64)
                out = ks[pre:]
                _M.incr("encrypted_reads")
            _M.incr("files_read")
            _M.incr("bytes_read", len(out))
            return bytes(out)

    def _read_block(self, binfo: dict, offset: int, length: int) -> bytes:
        locations = binfo["locations"]
        if not locations:
            raise IOError(f"block {binfo['block_id']} has no live locations")
        # Short-circuit: a co-located DN passes the replica fd over its unix
        # socket and we pread directly.  Granted fds are CACHED across
        # reads (ShortCircuitCache.java:72), each guarded by a DN-owned
        # shm slot: delete/append revokes the slot and the next read
        # re-fetches instead of serving stale bytes.
        if self.config.short_circuit:
            if self._sc_cache is None:
                from hdrf_tpu_torch.server.shortcircuit import ShortCircuitCache

                self._sc_cache = ShortCircuitCache()
            for loc in locations:
                sc = loc.get("sc_path")
                if sc and loc["addr"][0] in ("127.0.0.1", "localhost"):
                    data = self._sc_cache.read(sc, binfo["block_id"], offset,
                                               length,
                                               token=binfo.get("token"),
                                               client_name=self.name)
                    if data is not None:
                        _M.incr("short_circuit_reads")
                        return data
        if self.config.hedged_reads and len(locations) > 1:
            return self._read_hedged(binfo, locations, offset, length)
        last_err: Exception | None = None
        for loc in locations:  # failover across replicas
            try:
                return self._read_from(tuple(loc["addr"]), binfo["block_id"],
                                       offset, length,
                                       token=binfo.get("token"))
            except (OSError, ConnectionError, IOError) as e:
                last_err = e
                _M.incr("read_failovers")
        raise IOError(f"all {len(locations)} locations failed for block "
                      f"{binfo['block_id']}: {last_err}")

    def _read_hedged(self, binfo: dict, locations: list, offset: int,
                     length: int) -> bytes:
        """Tied-request replica reads (the reference's hedged-read pool,
        DFSInputStream.java:1131 hedgedFetchBlockByteRange, rebuilt on
        utils/retry.hedged_quorum): the first location is the primary leg;
        the rest launch once the primary exceeds the rolling-p95 latency
        deadline (ClientConfig.read_hedge_p95_mult over the client's block-
        read window) — or immediately on primary failure, preserving the
        serial loop's fail-fast failover."""
        def leg(loc):
            def run():
                t0 = time.monotonic()
                data = self._read_from(tuple(loc["addr"]),
                                       binfo["block_id"], offset, length,
                                       token=binfo.get("token"))
                self._read_lat.add(time.monotonic() - t0)
                return data
            return run

        s = self._read_lat.summary()
        hedge_after = max(
            (s["p95"] if s else 0.0) * self.config.read_hedge_p95_mult,
            self.config.read_hedge_floor_s)
        try:
            wins, errors, _hedged = retry.hedged_quorum(
                [leg(locations[0])], [leg(l) for l in locations[1:]],
                k=1, hedge_after_s=hedge_after,
                on_hedge=lambda: _M.incr("read_hedges_fired"))
        except retry.QuorumFailed as e:
            _M.incr("read_failovers", len(locations))
            raise IOError(f"all {len(locations)} locations failed for block "
                          f"{binfo['block_id']}: {e}") from e
        if errors:
            _M.incr("read_failovers", len(errors))
        idx, data = wins[0]
        if idx >= 1:  # a hedge leg answered first (leg 0 is the primary)
            _M.incr("read_hedge_wins")
        return data

    # ------------------------------------------------------- file checksum

    def get_file_checksum(self, path: str) -> dict:
        """Whole-file checksum from per-block chunk CRCs
        (FileChecksumHelper.java:56; BlockChecksumHelper.java:61 computes
        the per-block half on the DN, :328 the striped block-group
        variant).  COMPOSITE-CRC32C semantics (HDFS-13056): the combinable
        CRC of the LOGICAL byte stream, so identical content yields the
        identical checksum across replicated and EC-striped layouts — and
        equals ``crc32c(file_bytes)`` outright.  No block data is read
        except partial/misaligned EC tail cells.  Encryption-zone files
        checksum their stored ciphertext (as the reference does)."""
        from hdrf_tpu_torch.utils.checksum import compose_chunks, crc32c_combine

        loc = self._call("get_block_locations", path=path)
        crc, pos = 0, 0
        if loc.get("ec"):
            from hdrf_tpu_torch.ops import rs

            k, _m, cell = rs.parse_policy(loc["ec"])
            for grp in loc["groups"]:
                glen = max(grp["length"], 0)
                shard_info: dict[int, tuple] = {}

                def info_of(i, _grp=grp, _cache=shard_info):
                    if i not in _cache:
                        _cache[i] = self._block_checksum(_grp["blocks"][i])
                    return _cache[i]

                gpos, c = 0, 0
                while gpos < glen:
                    take = min(cell, glen - gpos)
                    row = c // k
                    done = False
                    if take == cell:   # tail cells never need the DN CRCs
                        crcs, cchunk, _ln = info_of(c % k)
                        if cell % cchunk == 0:
                            i0 = row * cell // cchunk
                            for cc in crcs[i0:i0 + cell // cchunk]:
                                crc = cc if pos == 0 else \
                                    crc32c_combine(crc, cc, cchunk)
                                pos += cchunk
                            done = True
                    if not done:
                        # partial tail cell (or cell not a chunk multiple):
                        # the stored chunk CRC covers the zero PAD too, so
                        # read the logical bytes and hash directly
                        piece = self.read(path, offset=pos, length=take)
                        pc = native.crc32c(piece)
                        crc = pc if pos == 0 else \
                            crc32c_combine(crc, pc, len(piece))
                        pos += take
                    gpos += take
                    c += 1
        else:
            for binfo in loc["blocks"]:
                blen = max(binfo["length"], 0)
                if blen == 0:
                    continue
                crcs, cchunk, ln = self._block_checksum(binfo)
                if ln == blen:
                    bcrc, _ = compose_chunks(crcs, cchunk, blen)
                else:
                    # replica length disagrees with the located length (the
                    # block grew past an hflush, or pipeline recovery
                    # resized it): the tail chunk CRC no longer covers the
                    # right span, so hash the block's bytes directly
                    bcrc = native.crc32c(
                        self.read(path, offset=pos, length=blen))
                crc = bcrc if pos == 0 else crc32c_combine(crc, bcrc, blen)
                pos += blen
        _M.incr("file_checksums")
        return {"algorithm": "COMPOSITE-CRC32C", "length": pos,
                "crc": crc, "bytes": f"{crc:08x}"}

    def _block_checksum(self, binfo: dict) -> tuple[list[int], int, int]:
        """(chunk_crcs, chunk_size, logical_len) via the BLOCK_CHECKSUM op,
        failing over across replica locations."""
        last_err: Exception | None = None
        for loc in binfo["locations"]:
            sock = None
            try:
                sock = socket.create_connection(tuple(loc["addr"]),
                                                timeout=60)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock = dt.secure_socket(sock, binfo.get("token"),
                                        self.config.encrypt_data_transfer)
                dt.send_op(sock, dt.BLOCK_CHECKSUM,
                           block_id=binfo["block_id"],
                           token=binfo.get("token"))
                hdr = recv_frame(sock)
                if hdr["status"] != 0:
                    raise IOError(f"{hdr['error']}: {hdr['message']}")
                return (list(hdr["checksums"]), hdr["checksum_chunk"],
                        hdr["logical_len"])
            except (OSError, ConnectionError, IOError) as e:
                last_err = e
            finally:
                if sock is not None:
                    sock.close()
        raise IOError(f"block checksum failed for {binfo['block_id']}: "
                      f"{last_err}")

    def _read_from(self, addr: tuple[str, int], block_id: int, offset: int,
                   length: int, token: dict | None = None) -> bytes:
        sock = socket.create_connection(addr,
                                        timeout=retry.effective_budget(120.0))
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock = dt.secure_socket(sock, token,
                                    self.config.encrypt_data_transfer)
            dt.send_op(sock, dt.READ_BLOCK, block_id=block_id, offset=offset,
                       length=length, token=token, _client=self.name)
            hdr = recv_frame(sock)
            if hdr["status"] != 0:
                if hdr.get("error") == "ShedError":
                    # structured admission refusal: typed + retry-after so
                    # callers can wait exactly as long as the DN estimated
                    raise qos.ShedError(
                        f"datanode shed: {hdr.get('message', '')}",
                        retry_after_s=float(hdr.get("retry_after_s") or 0.0))
                raise IOError(f"datanode error: {hdr['error']}: {hdr['message']}")
            data = dt.collect_packets(sock)
            if len(data) != hdr["length"]:
                raise IOError(f"short read: {len(data)} != {hdr['length']}")
            # End-to-end verify when the range aligns with checksum chunks
            # (full-block reads always do).
            cchunk = hdr["checksum_chunk"]
            if hdr["checksums"] and offset % cchunk == 0:
                stored = hdr["checksums"][offset // cchunk:]
                for i in range(0, len(data) // cchunk + (1 if len(data) % cchunk else 0)):
                    piece = data[i * cchunk:(i + 1) * cchunk]
                    if (len(piece) == cchunk or offset + len(data) == hdr["logical_len"]) \
                            and i < len(stored):
                        if native.crc32c(piece) != stored[i]:
                            raise IOError(f"checksum mismatch at chunk {i}")
            return data
        finally:
            sock.close()


class HdrfOutputStream:
    """Streaming output with mid-write durability (DFSOutputStream analog).

    ``write`` buffers; a full block's bytes stream down one pipeline socket
    held open across calls (DataStreamer's block lifetime).  ``hflush``
    pushes the buffered bytes as packets whose final one carries FLAG_FLUSH
    — every pipeline DN exposes the prefix to readers before acking — then
    persists the visible length at the NameNode (ClientProtocol.fsync), so
    a NEW reader sees every hflush'd byte (DFSOutputStream.java:573).
    ``hsync`` flags FLAG_SYNC instead: DNs also fsync the partial replica,
    so the prefix survives a DataNode crash (:580).

    Pipeline failure before any flush in the current block retries
    block-granularly (abandon + re-request, as HdrfClient.write does); after
    a flush the block's bytes are already reader-visible, so the error
    propagates — the caller's recovery is recover_lease + reopen, matching
    the reference's semantics when pipeline recovery exhausts datanodes."""

    def __init__(self, client: HdrfClient, path: str, block_size: int):
        self._c = client
        self._path = path
        self._bs = block_size
        self._buf = bytearray()        # bytes not yet sent down the pipeline
        self._block = bytearray()      # ALL bytes of the current block (retry)
        self._lengths: dict[int, int] = {}
        self._sock = None
        self._acks: dt.AckPump | None = None   # the pipeline's acks
        self._alloc: dict | None = None
        self._seqno = 0
        self._flushed_in_block = False
        self._closed = False
        client._renewer.begin()   # until close or abort

    # ------------------------------------------------------------- pipeline

    def _open_pipeline(self) -> None:
        alloc = self._c._call("add_block", path=self._path,
                              client=self._c.name)
        targets = alloc["targets"]
        sock = socket.create_connection(tuple(targets[0]["addr"]),
                                        timeout=120)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock = dt.secure_socket(sock, alloc.get("token"),
                                self._c.config.encrypt_data_transfer)
        dt.send_op(sock, dt.WRITE_BLOCK, block_id=alloc["block_id"],
                   gen_stamp=alloc["gen_stamp"], scheme="direct",
                   token=alloc.get("token"), targets=targets[1:],
                   storage_type=targets[0].get("storage_type"),
                   _client=self._c.name)
        self._sock, self._alloc, self._seqno = sock, alloc, 0
        self._acks = dt.AckPump(sock)

    def _close_pipeline(self) -> None:
        if self._acks is not None:
            self._acks.close()
        if self._sock is not None:
            self._sock.close()
        self._sock = self._acks = self._alloc = None

    def _teardown(self) -> None:
        self._close_pipeline()
        self._seqno = 0
        self._flushed_in_block = False

    def _send(self, flags: int = 0, last: bool = False) -> None:
        """Packetize the unsent buffer; ``flags`` ride the FINAL packet of
        the batch (the flush barrier), ``last`` ends the block.  Drains one
        ack per packet sent — the final ack carries aggregated downstream
        status."""
        if self._sock is None:
            self._open_pipeline()
        psz = self._c.config.packet_size
        pkts: list[bytes] = [bytes(self._buf[i:i + psz])
                             for i in range(0, len(self._buf), psz)]
        if last:
            pkts.append(b"")           # empty LAST trailer
        elif flags and not pkts:
            pkts.append(b"")           # pure flush marker, no new bytes
        if not pkts:
            return
        del self._buf[:]
        self._acks.expect(len(pkts))
        for i, p in enumerate(pkts):
            fin = i == len(pkts) - 1
            dt.write_packet(self._sock, self._seqno, p,
                            last=last and fin,
                            flags=flags if fin and not last else 0)
            self._seqno += 1
        status = max(self._acks.read_ack()[1] for _ in pkts)
        if status != dt.ACK_SUCCESS:
            raise IOError(f"pipeline returned status {status}")

    def _finish_block(self) -> None:
        """End the current block: empty LAST packet, final aggregated ack,
        record its length."""
        if self._sock is None and not self._block:
            return
        self._send(last=True)
        bid = self._alloc["block_id"]
        self._lengths[bid] = len(self._block)
        self._last_finished = (bid, len(self._block))
        self._close_pipeline()
        self._seqno = 0
        del self._block[:]
        self._flushed_in_block = False

    def _retryable(self, op) -> None:
        """Run a pipeline op; on connection failure with no flush exposure
        in this block, abandon and replay the whole current block on a
        fresh pipeline (block-granular recovery)."""
        try:
            op()
            return
        except (OSError, ConnectionError, IOError):
            if self._flushed_in_block:
                raise
            _M.incr("block_write_retries")
            bid = self._alloc["block_id"] if self._alloc else None
            self._teardown()
            if bid is not None:
                self._c._call("abandon_block", path=self._path,
                              client=self._c.name, block_id=bid)
        self._buf = bytearray(self._block)   # replay from block start
        op()

    # ------------------------------------------------------------------ api

    def write(self, data: bytes) -> None:
        assert not self._closed, "stream closed"
        off = 0
        while off < len(data):
            room = self._bs - len(self._block)
            take = data[off:off + min(room, len(data) - off)]
            self._buf += take
            self._block += take
            off += len(take)
            if len(self._block) >= self._bs:
                self._retryable(self._finish_block)
                # Persist the finished block's length while the file stays
                # open (the reference commits the previous block's length
                # in the next addBlock call) — without it a reader of the
                # open file sees length 0 for this block until complete().
                # OUTSIDE the retry wrapper: the block is already finalized
                # on every DN, and a replay here would allocate a duplicate.
                bid, ln = self._last_finished
                self._c._call("fsync", path=self._path, client=self._c.name,
                              block_id=bid, length=ln)

    def hflush(self, sync: bool = False) -> None:
        """Push buffered bytes to every pipeline DN and make them visible
        to new readers; ``sync=True`` (= hsync) also fsyncs each replica."""
        assert not self._closed, "stream closed"
        if not self._block and not self._buf:
            return  # nothing in the current block; prior blocks are final
        flag = dt.FLAG_SYNC if sync else dt.FLAG_FLUSH
        self._retryable(lambda: self._send(flags=flag))
        self._flushed_in_block = True
        self._c._call("fsync", path=self._path, client=self._c.name,
                      block_id=self._alloc["block_id"],
                      length=len(self._block))
        _M.incr("hsyncs" if sync else "hflushes")

    def hsync(self) -> None:
        self.hflush(sync=True)

    def close(self) -> None:
        if self._closed:
            return
        if self._block or self._buf or self._sock is not None:
            self._retryable(self._finish_block)
        self._c._complete(self._path, self._lengths)
        self._closed = True
        self._c._renewer.end()
        _M.incr("files_written")

    def abort(self) -> None:
        """Tear the stream down without completing the file: the pipeline
        socket closes (the DN persists the acked prefix as a partial
        replica) and the dangling lease is left for lease recovery — the
        DFSOutputStream.abort analog."""
        self._teardown()
        if not self._closed:
            self._c._renewer.end()
        self._closed = True

    def __enter__(self) -> "HdrfOutputStream":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
        else:
            self.abort()

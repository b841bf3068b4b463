"""HTTP gateway: the WebHDFS REST surface + status pages (port of
hdrf_tpu/server/http_gateway.py ``HttpGateway`` over the port's
``HdrfClient``; ``device`` is where its clients run the striped path's RS
kernel, as ``MiniCluster.client(device=)``; tokens ride the port's own
codec, proto/rpc.packb, byte for byte the reference's msgpack).

Re-expression of the reference's HTTP layer — `hdfs/web/WebHdfsFileSystem`
(client, 4.0 kLoC) + the NN/DN webapps (`webapps/{hdfs,datanode}`) and JMX
endpoints — as one stateless gateway process over the control/data
protocols, with the reference's protocol shapes:

- **Two-step CREATE/APPEND/OPEN** (`WebHdfsFileSystem.java:136`'s redirect
  dance): the namespace op answers `307 Temporary Redirect` with a
  Location (or, with ``noredirect=true``, `200 {"Location": ...}`), and
  the client re-issues the op WITH data against the redirect target — so
  bulk bytes never ride the first request (the reference redirects to the
  chosen DataNode's web server; this gateway redirects to its own
  data-serving endpoint, the op shape and client contract identical).
- **Delegation tokens in query params**: ``&delegation=<urlsafe-b64>``
  authenticates any op (token-selector analog);
  ``op=GETDELEGATIONTOKEN`` issues one.  ``user.name=<u>`` carries the
  simple-auth identity otherwise.
- FileSystem-parity ops: LISTSTATUS, GETFILESTATUS, GETCONTENTSUMMARY,
  GETHOMEDIRECTORY, OPEN (ranged), CREATE, APPEND, MKDIRS, RENAME,
  DELETE, TRUNCATE, SETPERMISSION, SETOWNER, SETREPLICATION,
  CREATESYMLINK, GETDELEGATIONTOKEN, RENEWDELEGATIONTOKEN,
  CANCELDELEGATIONTOKEN.

  GET  /status   cluster overview; GET /metrics  JMX/metrics2 analog;
  GET  /prom     Prometheus text exposition (gateway + NameNode registries,
                 the PrometheusMetricsSink analog);
  GET  /traces   cross-daemon trace assembly: local + NameNode + every live
                 DataNode's spans, device-ledger events and profiler
                 counter tracks merged by trace_id (``?trace_id=`` filters;
                 ``?format=chrome`` renders Chrome/Perfetto trace_event
                 JSON with counter tracks) — the pull-model replacement for
                 the reference's HTrace span receivers;
  GET  /stacks   live thread stacks (HttpServer2 StackServlet analog);
  GET  /timeseries  the NameNode flight recorder's bounded gauge ring
                 (utils/flight_recorder.py; per-DN rings on each DN's own
                 status endpoint);
  /dfshealth /datanode /journal /explorer  web UIs.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, quote, unquote, urlparse

from hdrf_tpu_torch.client.filesystem import HdrfClient
from hdrf_tpu_torch.proto import rpc
from hdrf_tpu_torch.utils import (device_ledger, flight_archive, log, metrics,
                                  prom, tracing)

_M = metrics.registry("http_gateway")
_LOG = log.get_logger("http_gateway")
PREFIX = "/webhdfs/v1"


def encode_token(token: dict) -> str:
    """Delegation token -> URL-safe string (the reference's
    Token.encodeToUrlString)."""
    return base64.urlsafe_b64encode(rpc.packb(token)).decode()


def decode_token(s: str) -> dict:
    return rpc.unpackb(base64.urlsafe_b64decode(s.encode()), raw=False)


class HttpGateway:
    def __init__(self, namenode_addr: tuple[str, int], host: str = "127.0.0.1",
                 port: int = 0, oauth2_introspect_url: str | None = None,
                 gate_token_issue: bool = False, device: str = "cuda"):
        """``oauth2_introspect_url``: RFC 7662 endpoint; when set,
        ``Authorization: Bearer`` tokens authenticate requests (the
        server-side counterpart of the reference's web/oauth2 client
        providers) and the introspected username becomes the acting
        identity.  ``gate_token_issue``: refuse GETDELEGATIONTOKEN to
        unauthenticated callers — without it the op mints a token for
        whatever ``user.name`` claims, which is only acceptable on
        simple-auth clusters (the reference gates issuance behind
        Kerberos).  ``device``: where the gateway's clients run the
        striped path's RS kernel (``cuda``, or ``cpu`` for its plain
        version)."""
        self._nn_addr = namenode_addr
        self._device = device
        self._introspect_url = oauth2_introspect_url
        self._gate_token_issue = gate_token_issue
        self._bearer_cache: dict[str, tuple[str, float]] = {}
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _html(self, body: str) -> None:
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _bytes(self, data: bytes) -> None:
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _text(self, body: str, ctype: str) -> None:
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _dispatch(self, method: str) -> None:
                _M.incr("requests")
                u = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                try:
                    if u.path == "/explorer":
                        return self._html(gateway.explorer(
                            q.get("path", "/")))
                    if u.path in ("/", "/dfshealth"):
                        return self._html(gateway.dfshealth())
                    if u.path == "/datanode":
                        return self._html(gateway.datanode_page(
                            q.get("id", "")))
                    if u.path == "/journal":
                        return self._html(gateway.journal_page())
                    if u.path == "/status":
                        return self._json(200, gateway.status())
                    if u.path == "/health":
                        return self._json(200, gateway.health())
                    if u.path == "/metrics":
                        return self._json(200, gateway.metrics())
                    if u.path == "/prom":
                        return self._text(gateway.prom_text(),
                                          "text/plain; version=0.0.4")
                    if u.path == "/traces":
                        out = gateway.traces(trace_id=q.get("trace_id"))
                        if q.get("format") == "chrome":
                            out = tracing.chrome_trace(
                                out["spans"], out["ledger"],
                                trace_id=q.get("trace_id"),
                                counters=out.get("counters", []))
                        return self._json(200, out)
                    if u.path == "/stacks":
                        return self._json(200, gateway.stacks())
                    if u.path == "/timeseries":
                        return self._json(200, gateway.timeseries(
                            scope=q.get("scope"),
                            metric=q.get("metric"),
                            since=q.get("since"),
                            step=q.get("step")))
                    if u.path == "/fsck":
                        return self._json(200, gateway.fsck())
                    if u.path == "/contention":
                        return self._json(200, gateway.contention())
                    if not u.path.startswith(PREFIX):
                        return self._json(404, {"error": "not found"})
                    path = unquote(u.path[len(PREFIX):]) or "/"
                    op = q.get("op", "").upper()
                    # _bearer is a GATEWAY-INTERNAL marker: strip any
                    # attacker-supplied query param of that name before the
                    # Bearer branch may set it (otherwise ?_bearer=1 would
                    # spoof an authenticated caller past gate_token_issue)
                    q.pop("_bearer", None)
                    auth = self.headers.get("Authorization", "")
                    if auth.startswith("Bearer "):
                        user = gateway._bearer_user(auth[7:])
                        if user is None:
                            return self._json(401, {
                                "error": "AccessControlException",
                                "message": "invalid bearer token"})
                        q["user.name"] = user
                        q["_bearer"] = "1"
                    with gateway._client(q) as c:
                        return self._op(c, method, op, path, q)
                except Exception as e:  # noqa: BLE001 — HTTP boundary
                    # RPC errors carry the server-side exception name
                    # (RemoteException analog); map it onto HTTP semantics.
                    name = getattr(e, "error", type(e).__name__)
                    code = {"FileNotFoundError": 404, "IsADirectoryError": 400,
                            "NotADirectoryError": 400, "FileExistsError": 409,
                            "PermissionError": 403}.get(name, 500)
                    self._json(code, {"error": name, "message": str(e)})

            def _redirect(self, path: str, q: dict) -> None:
                """Step 1 of the two-step write/open protocol: answer with
                the data endpoint's URL (307, or JSON with noredirect) —
                the client re-issues the op THERE with the payload."""
                # drain any body a non-conforming client sent on step 1:
                # unread bytes would be parsed as the next request line on
                # this keep-alive connection (HTTP/1.1 desync)
                self._body()
                keep = {k: v for k, v in q.items()
                        if k not in ("noredirect", "_bearer")}
                keep["step"] = "2"
                loc = (f"http://{self.headers.get('Host', 'localhost')}"
                       f"{PREFIX}{quote(path)}?"
                       + "&".join(f"{k}={quote(str(v), safe='')}"
                                  for k, v in keep.items()))
                if q.get("noredirect", "").lower() == "true":
                    return self._json(200, {"Location": loc})
                body = b""
                self.send_response(307)
                self.send_header("Location", loc)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n)

            def _op(self, c: HdrfClient, method: str, op: str, path: str,
                    q: dict) -> None:
                two_step = "step" not in q
                if method == "GET" and op == "LISTSTATUS":
                    self._json(200, {"FileStatuses": {
                        "FileStatus": c.ls(path)}})
                elif method == "GET" and op == "GETFILESTATUS":
                    self._json(200, {"FileStatus": c.stat(path)})
                elif method == "GET" and op == "GETCONTENTSUMMARY":
                    self._json(200, {"ContentSummary":
                                     c._call("content_summary", path=path)})
                elif method == "GET" and op == "GETHOMEDIRECTORY":
                    self._json(200, {"Path": f"/user/{c.user}"})
                elif method == "GET" and op == "OPEN":
                    if two_step:
                        # the reference always redirects OPEN to the data
                        # endpoint; GET clients follow 307 transparently
                        return self._redirect(path, q)
                    data = c.read(path, offset=int(q.get("offset", 0)),
                                  length=int(q.get("length", -1)))
                    self._bytes(data)
                elif method == "PUT" and op == "MKDIRS":
                    self._json(200, {"boolean": c.mkdir(path)})
                elif method == "PUT" and op == "CREATE":
                    if two_step:
                        return self._redirect(path, q)
                    body = self._body()
                    c.write(path, body, scheme=q.get("scheme"),
                            ec=q.get("ec"))
                    self._json(201, {"length": len(body)})
                elif method == "POST" and op == "APPEND":
                    if two_step:
                        return self._redirect(path, q)
                    body = self._body()
                    c.append(path, body)
                    self._json(200, {"length": len(body)})
                elif method == "POST" and op == "TRUNCATE":
                    ok = c._call("truncate", path=path,
                                 new_length=int(q["newlength"]))
                    self._json(200, {"boolean": ok})
                elif method == "PUT" and op == "RENAME":
                    self._json(200, {"boolean": c.rename(
                        path, q["destination"])})
                elif method == "PUT" and op == "SETPERMISSION":
                    c._call("set_permission", path=path,
                            mode=int(q.get("permission", "755"), 8))
                    self._json(200, {})
                elif method == "PUT" and op == "SETOWNER":
                    c._call("set_owner", path=path,
                            owner=q.get("owner", ""),
                            group=q.get("group", ""))
                    self._json(200, {})
                elif method == "PUT" and op == "SETREPLICATION":
                    ok = c._call("set_replication", path=path,
                                 replication=int(q.get("replication", 3)))
                    self._json(200, {"boolean": ok})
                elif method == "PUT" and op == "CREATESYMLINK":
                    c._call("create_symlink", link=path,
                            target=q["destination"])
                    self._json(200, {})
                elif method == "DELETE" and op == "DELETE":
                    self._json(200, {"boolean": c.delete(path)})
                elif method == "GET" and op == "GETFILECHECKSUM":
                    fc = c.get_file_checksum(path)
                    self._json(200, {"FileChecksum": {
                        "algorithm": fc["algorithm"],
                        "bytes": fc["bytes"],
                        "length": fc["length"]}})
                elif method == "PUT" and op == "ALLOWSNAPSHOT":
                    c.allow_snapshot(path)
                    self._json(200, {})
                elif method == "GET" and op == "GETSNAPSHOTDIFF":
                    # oldsnapshotname is REQUIRED (an omitted/typo'd param
                    # must not silently diff the current tree against
                    # itself and report "nothing changed") — and its
                    # absence is the CALLER's error: a 400 with the
                    # parameter named, not a KeyError-shaped 500.
                    if "oldsnapshotname" not in q:
                        return self._json(400, {
                            "error": "IllegalArgumentException",
                            "message": "GETSNAPSHOTDIFF requires the "
                                       "oldsnapshotname parameter"})
                    rep = c.snapshot_diff(
                        path, q["oldsnapshotname"],
                        q.get("snapshotname", ""))
                    self._json(200, {"SnapshotDiffReport": {
                        "snapshotRoot": rep["path"],
                        "fromSnapshot": rep["from"],
                        "toSnapshot": rep["to"],
                        "diffList": rep["entries"]}})
                elif method == "PUT" and op == "CREATESNAPSHOT":
                    c.create_snapshot(path, q["snapshotname"])
                    self._json(200, {"Path":
                                     f"{path}/.snapshot/"
                                     f"{q['snapshotname']}"})
                elif method == "DELETE" and op == "DELETESNAPSHOT":
                    c.delete_snapshot(path, q["snapshotname"])
                    self._json(200, {})
                elif method == "GET" and op == "GETDELEGATIONTOKEN":
                    # With gate_token_issue, issuance requires an already
                    # AUTHENTICATED identity (bearer or existing
                    # delegation token) — otherwise any HTTP caller could
                    # mint a token for any claimed user.name (the
                    # reference gates this leg behind Kerberos; plain
                    # simple-auth deployments leave the gate off)
                    if gateway._gate_token_issue and "_bearer" not in q:
                        # a delegation param only authenticates if the NN
                        # VERIFIES it (decode_token alone checks nothing —
                        # a forged {'owner':'root'} blob must not pass)
                        ok = False
                        if "delegation" in q:
                            try:
                                ok = c._nn.call(
                                    "check_delegation_token",
                                    token=decode_token(q["delegation"]))
                            except Exception:  # noqa: BLE001
                                ok = False
                        if not ok:
                            return self._json(403, {
                                "error": "AccessControlException",
                                "message": "token issuance requires an "
                                           "authenticated caller"})
                    tok = c._nn.call("get_delegation_token",
                                     renewer=q.get("renewer", c.user),
                                     owner=c.user)
                    self._json(200, {"Token":
                                     {"urlString": encode_token(tok)}})
                elif method == "PUT" and op == "RENEWDELEGATIONTOKEN":
                    exp = c._nn.call("renew_delegation_token",
                                     token=decode_token(q["token"]))
                    self._json(200, {"long": exp})
                elif method == "PUT" and op == "CANCELDELEGATIONTOKEN":
                    c._nn.call("cancel_delegation_token",
                               token=decode_token(q["token"]))
                    self._json(200, {})
                else:
                    self._json(400, {"error": "UnsupportedOperationException",
                                     "message": f"{method} {op}"})

            def do_POST(self):
                self._dispatch("POST")

            def do_GET(self):
                self._dispatch("GET")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="http-gateway", daemon=True)

    @property
    def addr(self) -> tuple[str, int]:
        return self._server.server_address

    def _bearer_user(self, token: str) -> str | None:
        """RFC 7662 introspection with a short positive cache; None =
        inactive/invalid.  No introspection endpoint configured = no
        bearer auth (the header is rejected rather than trusted)."""
        import time as _t
        import urllib.parse
        import urllib.request

        if not self._introspect_url:
            return None
        hit = self._bearer_cache.get(token)
        if hit and hit[1] > _t.monotonic():
            return hit[0]
        try:
            req = urllib.request.Request(
                self._introspect_url,
                data=urllib.parse.urlencode({"token": token}).encode(),
                method="POST",
                headers={"Content-Type":
                         "application/x-www-form-urlencoded"})
            with urllib.request.urlopen(req, timeout=10) as r:
                out = json.loads(r.read())
        except OSError:
            return None
        if not out.get("active"):
            return None
        user = out.get("username") or out.get("sub") or "oauth2-user"
        self._bearer_cache[token] = (user, _t.monotonic() + 30.0)
        if len(self._bearer_cache) > 1024:
            self._bearer_cache.clear()   # crude bound; entries re-fetch
        _M.incr("bearer_auths")
        return user

    def _client(self, q: dict) -> HdrfClient:
        """Per-request client with the caller's identity: a delegation
        token from the query params (its owner becomes the acting user —
        the token-selector analog) or simple-auth ``user.name``."""
        tok = None
        user = q.get("user.name")
        if "delegation" in q:
            tok = decode_token(q["delegation"])
            user = tok.get("owner") or user
        c = HdrfClient(self._nn_addr, name="http-gw", user=user,
                       device=self._device)
        if tok is not None:
            c._dtoken = tok
        return c

    def start(self) -> "HttpGateway":
        self._thread.start()
        _LOG.info("http gateway started",
                  addr=f"{self.addr[0]}:{self.addr[1]}")
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def status(self) -> dict:
        with HdrfClient(self._nn_addr, name="http-gw",
                        device=self._device) as c:
            report = c.datanode_report()
            cluster = c._call("cluster_status")
        return {"datanodes": report,
                "live": sum(1 for d in report if d["alive"]),
                "dead": sum(1 for d in report if not d["alive"]),
                "dedup_ratio": cluster.get("dedup_ratio"),
                "slow_peers": cluster.get("slow_peers"),
                "slow_volumes": cluster.get("slow_volumes"),
                # EC cold tier: striped census + stripe-tier footprint
                "ec_demoted_blocks": cluster.get("ec_demoted_blocks", 0),
                "striped_containers": cluster.get("striped_containers", 0),
                "stripe_logical_bytes":
                    cluster.get("stripe_logical_bytes", 0),
                "stripe_physical_bytes":
                    cluster.get("stripe_physical_bytes", 0)}

    def health(self) -> dict:
        """Cluster health verdict for load balancers / dashboards: DN
        liveness buckets, safemode, the outlier detector's slow-peer /
        slow-volume flags (slow_nodes_report RPC) and the cluster-wide
        reduction effectiveness — one JSON fetch, no namespace access
        required (the dfshealth JMX-scrape replacement)."""
        try:
            with HdrfClient(self._nn_addr, name="http-gw",
                            device=self._device) as c:
                cluster = c._call("cluster_status")
                slow = c._call("slow_nodes_report")
        except (OSError, ConnectionError):
            _M.incr("health_nn_unreachable")
            _LOG.warning("health probe: namenode unreachable",
                         namenode=str(self._nn_addr))
            return {"status": "unreachable", "namenode": str(self._nn_addr)}
        degraded_nodes = slow.get("degraded_nodes") or []
        fsck_violations = int(cluster.get("fsck_violations", 0))
        scrub_corrupt = int(cluster.get("scrub_corrupt_total", 0))
        degraded = (cluster["dead"] > 0 or cluster["safemode"]
                    or cluster["under_replicated"] > 0
                    or slow["slow_peers"] or slow["slow_volumes"]
                    or bool(degraded_nodes)
                    # integrity plane: invariant-census violations or
                    # scrub-confirmed corruption flip the verdict too
                    or fsck_violations > 0 or scrub_corrupt > 0)
        return {"status": "degraded" if degraded else "healthy",
                "role": cluster["role"],
                "safemode": cluster["safemode"],
                "live": cluster["live"], "dead": cluster["dead"],
                "blocks": cluster["blocks"],
                "under_replicated": cluster["under_replicated"],
                "slow_peers": slow["slow_peers"],
                "slow_volumes": slow["slow_volumes"],
                # DNs running passthrough (worker breaker open/probing):
                # writes succeed but reduction is off on these nodes
                "degraded_nodes": degraded_nodes,
                "mirror_failures": slow.get("mirror_failures") or {},
                "dedup_ratio": cluster["dedup_ratio"],
                "dedup_logical_bytes": cluster["dedup_logical_bytes"],
                "dedup_unique_bytes": cluster["dedup_unique_bytes"],
                # EC cold tier (physical/logical ≈ (k+m)/k for striped
                # containers vs the replicated tier's factor)
                "ec_demoted_blocks": cluster.get("ec_demoted_blocks", 0),
                "striped_containers": cluster.get("striped_containers", 0),
                "stripe_logical_bytes":
                    cluster.get("stripe_logical_bytes", 0),
                "stripe_physical_bytes":
                    cluster.get("stripe_physical_bytes", 0),
                # integrity plane: the census + scrub verdicts
                # behind the degraded expression above
                "fsck_violations": fsck_violations,
                "scrub_corrupt_total": scrub_corrupt,
                # overload plane: admission sheds are intentional refusals
                # (kept out of the degraded verdict — a shedding cluster is
                # protecting itself, not failing)
                "qos_sheds_total": cluster.get("qos_sheds_total", 0),
                "garbage_bytes": cluster.get("garbage_bytes", 0),
                "scrub_repairs_triggered":
                    cluster.get("scrub_repairs_triggered", 0),
                # observer plane: one row per configured NN —
                # role, applied txid and tail lag, so a dashboard sees the
                # read replicas and their staleness without namespace access
                "namenodes": self._namenode_rows()}

    def _namenode_rows(self) -> list[dict]:
        """Per-NN role/txid/lag rows for ``/health`` via each endpoint's
        ``ha_state`` (the haadmin -haStatus analog; unreachable NNs get a
        ``reachable: False`` row rather than poisoning the probe)."""
        from hdrf_tpu_torch.proto.rpc import RpcClient, normalize_addrs

        rows = []
        for addr in normalize_addrs(self._nn_addr):
            try:
                with RpcClient(addr, timeout=2.0) as c:
                    st = c.call("ha_state")
            except (OSError, ConnectionError):
                rows.append({"addr": f"{addr[0]}:{addr[1]}",
                             "reachable": False})
                continue
            rows.append({"addr": f"{addr[0]}:{addr[1]}", "reachable": True,
                         "role": st.get("role"),
                         "applied_txid": st.get("applied_txid",
                                                st.get("seq", 0)),
                         "lag_s": st.get("lag_s", 0.0)})
        return rows

    def fsck(self) -> dict:
        """Gateway face of the NN invariant census (``rpc_fsck``): runs the
        reconciliation NOW and relays the per-class verdict."""
        try:
            with HdrfClient(self._nn_addr, name="http-gw",
                            device=self._device) as c:
                return c._call("fsck")
        except (OSError, ConnectionError):
            _M.incr("fsck_nn_unreachable")
            return {"status": "unreachable",
                    "namenode": str(self._nn_addr)}

    def metrics(self) -> dict:
        with HdrfClient(self._nn_addr, name="http-gw",
                        device=self._device) as c:
            return c._call("metrics")

    def prom_text(self) -> str:
        """Prometheus exposition over the gateway's own registries merged
        with the NameNode's (same-name registries keep the gateway-local
        view; they are the same families either way)."""
        snaps = dict(metrics.all_snapshots())
        try:
            with HdrfClient(self._nn_addr, name="http-gw",
                            device=self._device) as c:
                for name, snap in c._call("metrics").items():
                    snaps.setdefault(name, snap)
        except (OSError, ConnectionError):
            _M.incr("prom_nn_unreachable")
        return prom.render(snaps)

    def traces(self, trace_id: str | None = None) -> dict:
        """Cross-daemon trace assembly: this process's spans + ledger +
        profiler counter samples, the NameNode's (trace_spans RPC), and
        every live DataNode's (trace_spans xceiver op; each DN proxies its
        co-located worker).  Spans dedupe by span_id, ledger events and
        counter samples by (proc, id) — a daemon polled twice (e.g. NN
        also reachable as a peer) merges clean."""
        import socket as _socket

        from hdrf_tpu_torch.proto import datatransfer as dt
        from hdrf_tpu_torch.proto.rpc import recv_frame
        from hdrf_tpu_torch.utils import profiler

        spans = list(tracing.all_span_snapshots())
        ledger = list(device_ledger.events_snapshot())
        counters = list(profiler.counters_snapshot())
        report = []
        try:
            with HdrfClient(self._nn_addr, name="http-gw",
                            device=self._device) as c:
                report = c.datanode_report()
                nn = c._call("trace_spans")
                spans.extend(nn.get("spans") or ())
                ledger.extend(nn.get("ledger") or ())
                counters.extend(nn.get("counters") or ())
        except (OSError, ConnectionError):
            _M.incr("traces_nn_unreachable")
        for d in report:
            if not d.get("alive"):
                continue
            try:
                with _socket.create_connection(
                        tuple(d["addr"]), timeout=5.0) as s:
                    dt.send_op(s, "trace_spans")
                    out = recv_frame(s)
                spans.extend(out.get("spans") or ())
                ledger.extend(out.get("ledger") or ())
                counters.extend(out.get("counters") or ())
            except (OSError, ConnectionError):
                _M.incr("traces_dn_unreachable")
        seen_sp: set = set()
        seen_ev: set = set()
        seen_ct: set = set()
        uspans = [s for s in spans
                  if s.get("span_id") not in seen_sp
                  and not seen_sp.add(s.get("span_id"))]
        uledger = [e for e in ledger
                   if (e.get("proc"), e.get("id")) not in seen_ev
                   and not seen_ev.add((e.get("proc"), e.get("id")))]
        ucounters = [c for c in counters
                     if (c.get("proc"), c.get("id")) not in seen_ct
                     and not seen_ct.add((c.get("proc"), c.get("id")))]
        if trace_id is not None:
            uspans = [s for s in uspans if s.get("trace_id") == trace_id]
            uledger = [e for e in uledger
                       if e.get("trace_id") == trace_id]
            ucounters = []  # counter samples have no trace affinity
        return {"spans": uspans, "ledger": uledger, "counters": ucounters}

    def stacks(self) -> dict:
        """Gateway-process thread stacks (per-daemon stacks live on each
        daemon's own status endpoint)."""
        from hdrf_tpu_torch.utils.watchdog import thread_stacks

        return {"daemon": "http_gateway", "threads": thread_stacks()}

    def contention(self) -> dict:
        """The NN's control-plane contention table (rpc_contention RPC:
        per-method calls/p99/lock-share + the instrumented namesystem
        lock's books) — one fetch for the storm-triage
        dashboard."""
        try:
            with HdrfClient(self._nn_addr, name="http-gw",
                            device=self._device) as c:
                return c._call("contention")
        except (OSError, ConnectionError):
            _M.incr("contention_nn_unreachable")
            return {"status": "unreachable", "namenode": str(self._nn_addr)}

    def timeseries(self, scope: str | None = None,
                   metric: str | None = None, since=None,
                   step=None) -> dict:
        """The flight-data query plane (the time-series slo_report plots).

        Default scope: the NameNode flight recorder's ring+archive
        (flight_query RPC), ``?metric=``/``?since=`` projected
        server-side.  ``?scope=cluster``: pull every live DN's
        ring+archive too (flight_timeseries xceiver op, the /traces
        fan-out pattern), align the per-daemon streams into one cluster
        series with proper per-gauge merge semantics — quantile-class
        gauges take the MAX across nodes, per-node tallies SUM, ratios
        average (utils/flight_archive.py merge_cluster) — and, when
        ``?step=`` is given, downsample to min/max/mean/last rollup
        buckets so an archive of any length renders in one bounded
        response."""
        since_f = float(since) if since is not None else None
        step_f = float(step) if step is not None else None
        try:
            with HdrfClient(self._nn_addr, name="http-gw",
                            device=self._device) as c:
                nn = c._call("flight_query", metric=metric, since=since_f)
                report = (c.datanode_report()
                          if scope == "cluster" else [])
        except (OSError, ConnectionError):
            _M.incr("timeseries_nn_unreachable")
            return {"daemon": "namenode", "interval_s": 0.0, "capacity": 0,
                    "samples": [], "error": "namenode unreachable"}
        if scope != "cluster":
            if step_f:
                nn["rollup"] = flight_archive.rollup(nn["samples"], step_f)
                nn["samples"] = []
            return nn
        import socket as _socket

        from hdrf_tpu_torch.proto import datatransfer as dt
        from hdrf_tpu_torch.proto.rpc import recv_frame

        series = [("namenode", nn.get("samples") or [])]
        for d in report:
            if not d.get("alive"):
                continue
            try:
                with _socket.create_connection(
                        tuple(d["addr"]), timeout=5.0) as s:
                    dt.send_op(s, "flight_timeseries",
                               metric=metric, since=since_f)
                    out = recv_frame(s)
                series.append((out.get("daemon") or d.get("dn_id", "dn"),
                               out.get("samples") or []))
            except (OSError, ConnectionError):
                _M.incr("timeseries_dn_unreachable")
        bucket = step_f or 1.0
        merged = flight_archive.merge_cluster(series, step_s=bucket)
        out = {"scope": "cluster", "step_s": bucket,
               "daemons": [name for name, _ in series],
               "samples": merged}
        if step_f:
            out["rollup"] = flight_archive.rollup(merged, step_f)
        return out

    # ------------------------------------------------------------- web UIs

    _NAV = ('<p><a href="/dfshealth">[overview]</a> '
            '<a href="/explorer?path=%2F">[explorer]</a> '
            '<a href="/journal">[journal]</a> '
            '<a href="/status">[status.json]</a> '
            '<a href="/metrics">[metrics.json]</a> '
            '<a href="/prom">[prom]</a> '
            '<a href="/traces">[traces]</a></p>')

    @staticmethod
    def _page(title: str, body: str) -> str:
        import html

        return (f"<html><head><title>{html.escape(title)}</title>"
                "<style>body{font-family:sans-serif;margin:2em}"
                "table{border-collapse:collapse}"
                "td,th{border:1px solid #ccc;padding:4px 10px}"
                "th{background:#eee}</style></head>"
                f"<body><h2>{html.escape(title)}</h2>"
                f"{HttpGateway._NAV}{body}</body></html>")

    @staticmethod
    def _gb(n) -> str:
        return f"{(n or 0) / 2**30:.2f} GB"

    def dfshealth(self) -> str:
        """NameNode overview (webapps/hdfs/dfshealth.html analog): safemode,
        HA role, capacity, block totals, and the live/dead/decommissioning
        DataNode table with per-DN drill-down links."""
        import html
        from urllib.parse import quote

        with HdrfClient(self._nn_addr, name="http-gw",
                        device=self._device) as c:
            cs = c._call("cluster_status")
            report = c.datanode_report()
        rows = []
        for d in sorted(report, key=lambda x: x["dn_id"]):
            st = d.get("stats") or {}
            state = "live" if d["alive"] else "dead"
            url = "/datanode?id=" + quote(d["dn_id"], safe="")
            rows.append(
                f'<tr><td><a href="{html.escape(url, quote=True)}">'
                f'{html.escape(d["dn_id"])}</a></td>'
                f"<td>{html.escape(':'.join(map(str, d['addr'])))}</td>"
                f"<td>{state}</td><td align=right>{d['blocks']}</td>"
                f"<td align=right>{self._gb(st.get('logical_bytes'))}</td>"
                f"<td align=right>{self._gb(st.get('physical_bytes'))}</td>"
                "</tr>")
        summary = (
            f"<table><tr><th>role</th><td>{html.escape(cs['role'])}</td></tr>"
            f"<tr><th>safemode</th><td>{'ON' if cs['safemode'] else 'off'}"
            "</td></tr>"
            f"<tr><th>blocks</th><td>{cs['blocks']}</td></tr>"
            f"<tr><th>under-replicated</th><td>{cs['under_replicated']}"
            "</td></tr>"
            f"<tr><th>pending replication</th>"
            f"<td>{cs['pending_replication']}</td></tr>"
            f"<tr><th>logical data</th>"
            f"<td>{self._gb(cs['logical_bytes'])}</td></tr>"
            f"<tr><th>physical (reduced) data</th>"
            f"<td>{self._gb(cs['physical_bytes'])}</td></tr>"
            f"<tr><th>edit log seq</th><td>{cs['editlog_seq']}</td></tr>"
            f"<tr><th>datanodes</th><td>{cs['live']} live / {cs['dead']} "
            f"dead / {cs['decommissioning']} decommissioning</td></tr>"
            "</table>")
        dn_table = ("<h3>DataNodes</h3><table><tr><th>id</th><th>addr</th>"
                    "<th>state</th><th>blocks</th><th>logical</th>"
                    "<th>physical</th></tr>" + "".join(rows) + "</table>")
        return self._page("hdrf_tpu NameNode", summary + dn_table)

    def datanode_page(self, dn_id: str) -> str:
        """Per-DataNode detail (webapps/datanode analog), rendered from the
        stats the DN ships in heartbeats: replica/container bytes, pinned
        cache, chunk-index state, peer-latency reports."""
        import html

        with HdrfClient(self._nn_addr, name="http-gw",
                        device=self._device) as c:
            report = c.datanode_report()
        d = next((x for x in report if x["dn_id"] == dn_id), None)
        if d is None:
            return self._page(f"datanode {dn_id}", "<p>unknown datanode</p>")
        st = d.get("stats") or {}
        idx = st.get("index") or {}
        rows = [
            ("state", "live" if d["alive"] else "dead"),
            ("address", ":".join(map(str, d["addr"]))),
            ("blocks", d["blocks"]),
            ("logical bytes", self._gb(st.get("logical_bytes"))),
            ("physical bytes", self._gb(st.get("physical_bytes"))),
            ("cached blocks", len(st.get("cached_blocks") or [])),
            ("cache used", self._gb(st.get("cache_used"))),
        ] + [(f"index {k}", v) for k, v in sorted(idx.items())] + [
            (f"peer {p} median s/MB", f"{m:.3f} ({n} samples)")
            for p, (m, n) in sorted((st.get("peer_transfer") or {}).items())
        ]
        body = "<table>" + "".join(
            f"<tr><th>{html.escape(str(k))}</th>"
            f"<td>{html.escape(str(v))}</td></tr>" for k, v in rows) \
            + "</table>"
        return self._page(f"hdrf_tpu DataNode {dn_id}", body)

    def journal_page(self) -> str:
        """JournalNode quorum state (webapps/journal analog): per-node
        epoch, accepted/committed sequence, storage dir."""
        import html

        from hdrf_tpu_torch.proto.rpc import RpcClient

        with HdrfClient(self._nn_addr, name="http-gw",
                        device=self._device) as c:
            cs = c._call("cluster_status")
        addrs = cs.get("journal_addrs") or []
        if not addrs:
            body = ("<p>no quorum journal configured (shared-directory "
                    f"edit log; seq {cs['editlog_seq']})</p>")
            return self._page("hdrf_tpu Journal", body)
        rows = []
        for a in addrs:
            addr = (a[0], int(a[1]))
            try:
                # short probe timeout: a packet-dropping (not refusing) JN
                # must not stall the page for the default 30 s per node
                with RpcClient(addr, timeout=2.0) as jc:
                    s = jc.call("jn_state")
                cells = [f"{a[0]}:{a[1]}", "up"] + [
                    str(s.get(k)) for k in ("promised", "wepoch",
                                            "last_seq", "earliest")]
            except (OSError, ConnectionError) as e:
                cells = [f"{a[0]}:{a[1]}", f"down ({type(e).__name__})",
                         "-", "-", "-", "-"]
            rows.append("<tr>" + "".join(
                f"<td>{html.escape(c)}</td>" for c in cells) + "</tr>")
        body = ("<table><tr><th>node</th><th>state</th>"
                "<th>promised epoch</th><th>write epoch</th>"
                "<th>last seq</th><th>earliest</th></tr>"
                + "".join(rows) + "</table>")
        return self._page("hdrf_tpu Journal", body)

    def explorer(self, path: str) -> str:
        """Minimal namespace browser (the NN webapp's explorer.html analog).
        Paths are URL-quoted inside hrefs AND html-escaped as attribute
        values: legal filenames contain &, #, %, quotes — unencoded they
        break links and open an attribute-injection (XSS) hole."""
        import html
        from urllib.parse import quote

        def href(url: str) -> str:
            return html.escape(url, quote=True)

        with HdrfClient(self._nn_addr, name="http-gw",
                        device=self._device) as c:
            entries = c.ls(path)
        base = path.rstrip("/")
        rows = []
        for e in sorted(entries, key=lambda x: (x["type"] != "dir", x["name"])):
            name = html.escape(e["name"])
            child = f"{base}/{e['name']}"
            if e["type"] == "dir":
                url = "/explorer?path=" + quote(child, safe="")
                link = f'<a href="{href(url)}">{name}/</a>'
                size = ""
            else:
                url = "/webhdfs/v1" + quote(child) + "?op=OPEN"
                link = f'<a href="{href(url)}">{name}</a>'
                size = f"{e.get('length', 0):,}"
            extra = e.get("scheme", "") if e["type"] == "file" else ""
            rows.append(f"<tr><td>{link}</td><td align=right>{size}</td>"
                        f"<td>{html.escape(str(extra))}</td></tr>")
        up = base.rsplit("/", 1)[0] or "/"
        up_url = "/explorer?path=" + quote(up, safe="")
        return (f"<html><head><title>hdrf {html.escape(path)}</title></head>"
                f"<body><h2>hdrf_tpu — {html.escape(path)}</h2>"
                f'<p><a href="{href(up_url)}">[up]</a> '
                f'<a href="/status">[status]</a> '
                f'<a href="/metrics">[metrics]</a></p>'
                f"<table border=0 cellpadding=4>"
                f"<tr><th>name</th><th>size</th><th>scheme</th></tr>"
                f"{''.join(rows)}</table></body></html>")

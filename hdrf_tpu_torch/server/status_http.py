"""Per-daemon status HTTP server: /prom, /metrics, /traces, /stacks (port
of hdrf_tpu/server/status_http.py ``StatusHttpServer``, over the port's
metrics, device ledger, profiler, tracing and watchdog).

Equivalent of the reference's per-daemon HttpServer2 servlet set (every
Hadoop daemon serves /jmx, /metrics, /stacks and /conf on its info port;
DataNode.java:499 wires it at startup): a tiny threaded HTTP server each daemon
opts into via ``status_port`` config, serving

- ``/prom``    — Prometheus text exposition over this process's registries
  (utils/prom.py; the PrometheusMetricsSink analog),
- ``/metrics`` — raw JSON registry snapshots (the /jmx analog),
- ``/traces``  — this process's finished spans + device-ledger events +
  profiler counter-track samples (raw JSON; ``?format=chrome`` renders
  Perfetto JSON with counter tracks; the gateway's /traces merges these
  across daemons),
- ``/stacks``  — live thread stacks plus the watchdog's recent stall
  captures (the HttpServer2 StackServlet analog),
- ``/timeseries`` — the daemon's flight-recorder ring (bounded over-time
  gauge samples, utils/flight_recorder.py; nothing in the reference
  serves a curve — MutableRollingAverages keeps a few windowed means and
  discards the series),
- ``/contention`` — the daemon's lock/RPC contention table (per-method
  calls/p99/lock-share + the instrumented namesystem lock's books,
  utils/lockprof.py; the FSNamesystemLock.java:60 metrics plus the RPC
  decomposition RpcMetrics.java:118 never had, served nowhere in the
  reference).

The server threads are daemonic and shut down with the owning daemon.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from hdrf_tpu_torch.utils import device_ledger, metrics, profiler, prom, tracing
from hdrf_tpu_torch.utils.watchdog import StallWatchdog, thread_stacks


class StatusHttpServer:
    def __init__(self, name: str, host: str = "127.0.0.1", port: int = 0,
                 watchdog: StallWatchdog | None = None,
                 recorder=None, contention=None):
        """``recorder``: optional utils.flight_recorder.FlightRecorder —
        when set, ``/timeseries`` serves its bounded gauge ring.
        ``contention``: optional zero-arg callable returning the daemon's
        contention table (the NN passes rpc_contention) —
        when set, ``/contention`` serves it."""
        self.name = name
        self._watchdog = watchdog
        self._recorder = recorder
        self._contention = contention
        status = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                if u.path == "/prom":
                    body = prom.render(metrics.all_snapshots()).encode()
                    return self._send(200, body,
                                      "text/plain; version=0.0.4")
                if u.path == "/metrics":
                    return self._send(
                        200, json.dumps(metrics.all_snapshots()).encode(),
                        "application/json")
                if u.path == "/traces":
                    out = status.traces(trace_id=q.get("trace_id"))
                    if q.get("format") == "chrome":
                        out = tracing.chrome_trace(
                            out["spans"], out["ledger"],
                            trace_id=q.get("trace_id"),
                            counters=out.get("counters", []))
                    return self._send(200, json.dumps(out).encode(),
                                      "application/json")
                if u.path == "/stacks":
                    return self._send(200,
                                      json.dumps(status.stacks()).encode(),
                                      "application/json")
                if u.path == "/timeseries":
                    out = status.timeseries(metric=q.get("metric"),
                                            since=q.get("since"))
                    return self._send(200, json.dumps(out).encode(),
                                      "application/json")
                if u.path == "/contention":
                    return self._send(
                        200, json.dumps(status.contention()).encode(),
                        "application/json")
                self._send(404, b'{"error": "not found"}',
                           "application/json")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name=f"status-http-{name}", daemon=True)

    @property
    def addr(self) -> tuple[str, int]:
        return self._server.server_address

    def start(self) -> "StatusHttpServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def traces(self, trace_id: str | None = None) -> dict:
        spans = tracing.all_span_snapshots()
        ledger = device_ledger.events_snapshot()
        counters = profiler.counters_snapshot()
        if trace_id is not None:
            spans = [s for s in spans if s["trace_id"] == trace_id]
            ledger = [e for e in ledger if e.get("trace_id") == trace_id]
            counters = []  # counter samples have no trace affinity
        return {"daemon": self.name, "spans": spans, "ledger": ledger,
                "counters": counters}

    def timeseries(self, metric: str | None = None,
                   since=None) -> dict:
        """The flight recorder's ring (utils/flight_recorder.py), or an
        empty shell when the daemon runs without a recorder — the endpoint
        shape stays stable either way.  ``?metric=`` (comma-separated
        gauge names) and ``?since=`` (wall seconds) project the ring down
        (utils/flight_archive.py filter_series) so pollers stop paying
        for the full dump."""
        if self._recorder is None:
            return {"daemon": self.name, "interval_s": 0.0, "capacity": 0,
                    "samples": []}
        out = self._recorder.snapshot()
        if metric or since is not None:
            from hdrf_tpu_torch.utils import flight_archive

            out["samples"] = flight_archive.filter_series(
                out["samples"], metric=metric,
                since=float(since) if since is not None else None)
        return out

    def contention(self) -> dict:
        """The daemon's lock/RPC contention table (utils/lockprof.py +
        proto/rpc.py contention_summary), or an empty shell for daemons
        that run without one — the endpoint shape stays stable."""
        if self._contention is None:
            return {"daemon": self.name, "methods": {}, "lock": None}
        out = dict(self._contention())
        out["daemon"] = self.name
        return out

    def stacks(self) -> dict:
        out = {"daemon": self.name, "threads": thread_stacks()}
        if self._watchdog is not None:
            out["stalls"] = self._watchdog.stalls()
            out["inflight"] = self._watchdog.inflight()
        return out

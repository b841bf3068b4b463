"""The port's configuration loader, OAuth2 providers, supervised worker and
MiniCluster against the reference.

- ``HdrfConfig.load`` (TOML file, then ``HDRF_*`` environment, then
  overrides) gives the reference's ``to_dict()`` and the reference's
  errors on the same inputs.
- The OAuth2 providers fetch, cache and refresh tokens from a local
  stand-in identity provider as the reference's do (the grants it serves
  are the same), and fail the same way.
- ``WorkerSupervisor``'s respawn schedule (every poll, backoff sleep,
  spawn and respawn callback, with the streak reset after a healthy run
  and a failed spawn) equals the reference's under an injected clock,
  sleep and spawn and the same ``random`` seed.
- ``spawn_local_worker(backend="native")`` and ``launch --with-worker``
  start the port's worker process; ``MiniCluster(tpu_worker=True)`` sends
  its ``reduce`` and seals to that process (``native`` and ``cpu``, the
  kernels' plain versions), degrades when it is killed and recovers on
  ``restart_worker``; a DataNode with ``worker_spawn`` owns a supervised
  worker that is respawned after a kill.
"""

from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import threading
import time
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mod(name: str, path: str):
    import importlib

    return importlib.import_module(
        ("hdrf_tpu." if name == "ref" else "hdrf_tpu_torch.") + path)


# ------------------------------------------------------------------ config

TOML = """
[namenode]
replication = 2
block_size = 262144
ec_data_shards = 3

[datanode]
port = 9866
volume_types = ["DISK", "SSD"]

[datanode.reduction]
default_scheme = "zstd"
container_size = 65536
shed_p95_mult = 2.5

[datanode.reduction.cdc]
mask_bits = 11

[client]
short_circuit = false
op_deadline_s = 5.0
"""

ENV = {"HDRF_DATANODE_REDUCTION_DEFAULT_SCHEME": "direct",
       "HDRF_CLIENT_PACKET_SIZE": "4096",
       "HDRF_CLIENT_HEDGED_READS": "false",
       "HDRF_CLIENT_READ_HEDGE_P95_MULT": "4.5",
       "HDRF_NAMENODE_REPLICATION": "4",
       "HDRF_BOGUS_KEY": "1",
       "PATH": "/usr/bin"}

OVERRIDES = {"client.hedged_reads": "yes", "namenode.replication": "5",
             "datanode.reduction.cdc.min_chunk": 1024,
             "client.metadata_cache_ttl_s": 2,
             "datanode.reduction.worker_addr": ["127.0.0.1", 7000]}


@pytest.mark.parametrize("layers", ["defaults", "file", "env", "overrides",
                                    "all"])
def test_hdrf_config_layers_match_reference(tmp_path, layers):
    path = tmp_path / "hdrf.toml"
    path.write_text(TOML)
    kw = {"path": str(path) if layers in ("file", "all") else None,
          "env": ENV if layers in ("env", "all") else {},
          "overrides": OVERRIDES if layers in ("overrides", "all") else None}
    got = {p: _mod(p, "config").HdrfConfig.load(**kw).to_dict()
           for p in ("ref", "port")}
    assert got["port"] == got["ref"]
    if layers == "all":
        assert got["port"]["namenode"]["replication"] == 5
        assert got["port"]["datanode"]["reduction"]["default_scheme"] == \
            "direct"
        assert got["port"]["client"]["short_circuit"] is False


@pytest.mark.parametrize("key,value", [("client.no_such_key", 1),
                                       ("datanode.reduction", 1),
                                       ("nosection.x", 1)])
def test_hdrf_config_errors_match_reference(key, value):
    errs = {}
    for p in ("ref", "port"):
        with pytest.raises(KeyError) as e:
            _mod(p, "config").HdrfConfig.load(env={},
                                             overrides={key: value})
        errs[p] = str(e.value)
    assert errs["port"] == errs["ref"]


def test_default_config_and_scalars_match_reference():
    ref, port = _mod("ref", "config"), _mod("port", "config")
    assert port.default_config().to_dict() == ref.default_config().to_dict()
    for raw in ("7", "-3", "2.5", "1e3", "true", "False", "abc", ""):
        assert port._parse_scalar(raw) == ref._parse_scalar(raw)
        assert type(port._parse_scalar(raw)) is type(ref._parse_scalar(raw))
    for v, t in (("on", bool), ("0", bool), (3, float), ("4", int),
                 (1, str), ([1], list)):
        assert port._coerce(v, t) == ref._coerce(v, t)


# ------------------------------------------------------------------ oauth2

class StubIdP:
    """A local OAuth2 token endpoint: client_credentials and
    refresh_token grants; secret ``empty`` answers 200 without a token."""

    def __init__(self):
        self.grants: list[str] = []
        idp = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                form = {k: v[0] for k, v in
                        parse_qs(self.rfile.read(n).decode()).items()}
                grant = form.get("grant_type", "")
                idp.grants.append(f"{grant}:{form.get('client_id')}")
                tok = f"at-{len(idp.grants)}"
                if grant == "client_credentials":
                    if form.get("client_secret") == "s3cret":
                        return self._json({"access_token": tok,
                                           "expires_in": 3600})
                    if form.get("client_secret") == "empty":
                        return self._json({"token_type": "bearer"})
                if grant == "refresh_token" and \
                        form.get("refresh_token") == "refresh-ok":
                    return self._json({"access_token": tok,
                                       "expires_in": 120})
                return self._json({"error": "invalid_grant"}, 400)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        host, port = self._server.server_address
        self.url = f"http://{host}:{port}/token"

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


def _oauth_run(pkg: str) -> dict:
    oa = _mod(pkg, "client.oauth2")
    idp = StubIdP()
    try:
        cred = oa.ConfCredentialBasedAccessTokenProvider(
            idp.url, "app", "s3cret")
        toks = [cred.access_token(), cred.access_token()]   # cached
        cred._expiry = 0.0                                  # expired
        toks.append(cred.access_token())
        ref = oa.ConfRefreshTokenBasedAccessTokenProvider(
            idp.url, "app2", "refresh-ok")
        toks.append(ref.access_token())
        margin = ref._expiry - time.time()
        errors = []
        for prov in (oa.ConfCredentialBasedAccessTokenProvider(
                         idp.url, "app", "wrong"),
                     oa.ConfCredentialBasedAccessTokenProvider(
                         idp.url, "app", "empty"),
                     oa.ConfRefreshTokenBasedAccessTokenProvider(
                         idp.url, "app2", "revoked")):
            with pytest.raises((urllib.error.HTTPError, PermissionError)) \
                    as e:
                prov.access_token()
            errors.append(type(e.value).__name__)
        return {"tokens": toks, "grants": idp.grants, "errors": errors,
                "margin": round(margin)}
    finally:
        idp.stop()


def test_oauth2_providers_match_reference():
    got = {p: _oauth_run(p) for p in ("ref", "port")}
    assert got["port"] == got["ref"]
    assert got["port"]["tokens"] == ["at-1", "at-1", "at-2", "at-3"]
    assert got["port"]["margin"] == 90          # 120 s less the 30 s buffer
    assert got["port"]["errors"] == ["HTTPError", "PermissionError",
                                     "HTTPError"]


# -------------------------------------------------------- worker supervisor

class _Proc:
    """A stand-in process alive for ``life`` polls (None: forever)."""

    def __init__(self, life):
        self.left = life

    def poll(self):
        if self.left is None:
            return None
        if self.left <= 0:
            return 1
        self.left -= 1
        return None

    def terminate(self):
        self.left = 0

    def wait(self, timeout=None):
        return 0

    def kill(self):
        self.left = 0


def _schedule(pkg: str, seed: int, lives: list, healthy_s: float) -> dict:
    """Drive one package's supervisor monitor loop to its end under an
    injected clock, sleep and spawn; every event in order."""
    rw = _mod(pkg, "server.reduction_worker")
    reg = _mod(pkg, "utils.metrics").registry("reduction_worker")
    keys = ("worker_deaths", "worker_respawns", "worker_respawn_failures",
            "worker_respawn_callback_errors")
    c0 = {k: reg.counter(k) for k in keys}
    clock = [100.0]
    events: list = []
    lives = list(lives)
    box: dict = {}

    def sleep(s):
        events.append(("sleep", s))
        clock[0] += s

    def spawn(backend):
        events.append(("spawn", backend, clock[0]))
        if not lives:
            box["sup"]._stop.set()
            return _Proc(None), ("127.0.0.1", 2000 + len(events))
        life = lives.pop(0)
        if life == "fail":
            raise RuntimeError("spawn failed")
        return _Proc(life), ("127.0.0.1", 2000 + len(events))

    def on_respawn(addr):
        events.append(("respawn", tuple(addr)))
        if addr[1] % 7 == 0:
            raise RuntimeError("callback failed")

    sup = rw.WorkerSupervisor(backend="native", base_s=0.5, cap_s=4.0,
                              healthy_s=healthy_s, on_respawn=on_respawn,
                              clock=lambda: clock[0], sleep=sleep,
                              spawn=spawn, poll_s=0.2)
    box["sup"] = sup
    sup._proc, sup.addr = sup._spawn(sup._backend)
    sup._spawned_at = sup._clock()
    random.seed(seed)
    sup._monitor()
    return {"events": events, "respawns": sup.respawns,
            "addr": sup.addr, "streak": sup._streak,
            "counters": {k: reg.counter(k) - c0[k] for k in keys}}


@pytest.mark.parametrize("seed,lives,healthy_s", [
    (0, [0, 0, 0, 0, 0], 30.0),
    (1, [3, "fail", "fail", 0, 200, 0, 1], 30.0),
    (7, [5, 0, 40, 0, "fail", 2, 0], 8.0),
])
def test_supervisor_schedule_matches_reference(seed, lives, healthy_s):
    got = {p: _schedule(p, seed, lives, healthy_s) for p in ("ref", "port")}
    assert got["port"] == got["ref"]
    sleeps = [e[1] for e in got["port"]["events"] if e[0] == "sleep"
              and e[1] != 0.2]
    assert sleeps and max(sleeps) <= 4.0        # capped backoff


def test_spawn_local_worker_native():
    from hdrf_tpu_torch.server.reduction_worker import (WorkerClient,
                                                        spawn_local_worker)

    proc, addr = spawn_local_worker(backend="native")
    try:
        c = WorkerClient(addr)
        assert c.ping() == {"ok": True, "backend": "native"}
        c.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_launch_with_worker_cpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "hdrf_tpu_torch.parallel.launch",
                        "--device", "cpu", "--with-worker"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert re.search(r"supervised reduction worker listening on "
                     r"[\d.]+:\d+", lines[0]), lines
    assert lines[1].startswith("rank 0/1 up"), lines


# ------------------------------------------------------------- minicluster

def _counter(reg: str, key: str) -> int:
    from hdrf_tpu_torch.utils import metrics

    return metrics.registry(reg).counter(key)


@pytest.mark.parametrize("worker_backend", ["native", "cpu"])
def test_minicluster_tpu_worker(tmp_path, worker_backend):
    from hdrf_tpu_torch.config import CdcConfig
    from hdrf_tpu_torch.server.reduction_worker import WorkerClient
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=300_000, dtype=np.uint8).tobytes()
    # the small CDC geometry: the plain SHA-256 steps once per 64-byte
    # block of the longest chunk
    cdc = CdcConfig(mask_bits=10, min_chunk=256, max_chunk=4096)
    with MiniCluster(n_datanodes=3, replication=2, block_size=256 << 10,
                     container_size=32 << 10, base_dir=str(tmp_path),
                     tpu_worker=True, worker_backend=worker_backend,
                     reduction_overrides={"cdc": cdc}) as mc:
        w = WorkerClient(mc._worker_addr)
        assert w.ping()["backend"] == worker_backend
        f0 = _counter("datanode", "worker_fallbacks")
        r0 = _counter("block_receiver", "worker_reduces")
        with mc.client("tw", device="cpu") as c:
            c.write("/tw/a", data, scheme="dedup_lz4")
            c.write("/tw/b", data[::-1], scheme="dedup_lz4")
            for dn in mc.datanodes:
                dn.containers.flush_open(on_seal=dn.index.seal_container)
            assert c.read("/tw/a") == data
            assert c.read("/tw/b", offset=70_001, length=99_999) == \
                data[::-1][70_001:170_000]
            st = w.stats()
            assert st["blocks_reduced"] >= 4 and st["compress_jobs"] > 0
            assert _counter("block_receiver", "worker_reduces") - r0 >= 4
            assert _counter("datanode", "worker_fallbacks") == f0
            if worker_backend == "native":
                # killed: writes degrade to the DataNodes' own codecs ...
                mc.kill_worker()
                c.write("/tw/c", data[:100_000], scheme="dedup_lz4")
                assert c.read("/tw/c") == data[:100_000]
                assert _counter("block_receiver", "degraded_writes") > 0
                # ... and a fresh worker takes over
                addr = mc.restart_worker()
                assert all(tuple(dn.config.reduction.worker_addr) == addr
                           for dn in mc.datanodes)
                r1 = _counter("block_receiver", "worker_reduces")
                c.write("/tw/d", data[100_000:], scheme="dedup_lz4")
                assert c.read("/tw/d") == data[100_000:]
                assert _counter("block_receiver", "worker_reduces") > r1
        w.close()


def test_datanode_worker_spawn_respawns(tmp_path):
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    data = np.random.default_rng(6).integers(
        0, 256, size=200_000, dtype=np.uint8).tobytes()
    with MiniCluster(n_datanodes=1, replication=1, block_size=256 << 10,
                     container_size=32 << 10, base_dir=str(tmp_path),
                     reduction_overrides={"worker_spawn": True,
                                          "worker_respawn_base_s": 0.1,
                                          "worker_respawn_cap_s": 0.2}) as mc:
        dn = mc.datanodes[0]
        sup = dn._worker_supervisor
        assert sup is not None and dn._worker is not None
        assert tuple(dn._worker._addr) == tuple(sup.addr)
        r0 = _counter("block_receiver", "worker_reduces")
        with mc.client("ws", device="cpu") as c:
            c.write("/ws/a", data, scheme="dedup_lz4")
            assert c.read("/ws/a") == data
            assert _counter("block_receiver", "worker_reduces") > r0
            first = sup.addr
            sup._proc.kill()
            deadline = time.monotonic() + 60
            while sup.respawns < 1 and time.monotonic() < deadline:
                time.sleep(0.05)
            assert sup.respawns == 1 and sup.addr != first
            assert tuple(dn._worker._addr) == tuple(sup.addr)
            r1 = _counter("block_receiver", "worker_reduces")
            c.write("/ws/b", data[::-1], scheme="dedup_lz4")
            assert c.read("/ws/b") == data[::-1]
            assert _counter("block_receiver", "worker_reduces") > r1
        proc = sup._proc
    assert proc.poll() is not None          # stopped with the DataNode

"""The port's WebHDFS gateway (hdrf_tpu_torch/server/http_gateway.py)
held against the reference's on the CPU: one op script over pure HTTP
(two-step CREATE / APPEND / OPEN, ranged reads, the FileSystem-parity
ops, delegation tokens in query params, the status endpoints) against
each package's gateway over its own MiniCluster gives the same replies,
up to clocks and token bytes; and the port's gateway clients run the
striped path where ``device`` says."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

VOLATILE = {"modificationTime", "accessTime", "mtime", "atime", "ctime",
            "urlString", "long", "expiry", "expiration", "owner", "group",
            "uptime_s", "fileId"}


class _HttpFs:
    """A WebHDFS client made of HTTP requests only."""

    def __init__(self, base: str, delegation: str | None = None):
        self.base = base
        self.delegation = delegation

    def url(self, path: str, op: str, **params) -> str:
        q = [f"op={op}"] + [f"{k}={v}" for k, v in params.items()]
        if self.delegation:
            q.append(f"delegation={self.delegation}")
        return f"{self.base}/webhdfs/v1{path}?" + "&".join(q)

    def req(self, method: str, url: str, data: bytes | None = None,
            follow: bool = True):
        r = urllib.request.Request(url, data=data, method=method)
        try:
            with urllib.request.urlopen(r, timeout=60) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 307 and follow:
                return self.req(method, e.headers["Location"], data,
                                follow=False)
            return e.code, e.read()

    def two_step(self, method: str, path: str, op: str, data: bytes,
                 **params):
        st, body = self.req(method, self.url(path, op, noredirect="true",
                                             **params))
        loc = json.loads(body)["Location"]
        return st, self.req(method, loc, data, follow=False)[0]

    def op(self, method: str, path: str, op: str, **params):
        st, body = self.req(method, self.url(path, op, **params))
        return st, (json.loads(body) if body else {})

    def get(self, path: str):
        return self.req("GET", self.base + path)


def _norm(v):
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items() if k not in VOLATILE}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    return v


def _script(http: _HttpFs, mc) -> list:
    payload = np.random.default_rng(3).integers(
        0, 256, 2_500_000, np.uint8).tobytes()
    out = [http.op("PUT", "/w/d", "MKDIRS"),
           http.two_step("PUT", "/w/d/f", "CREATE", payload)]
    st, body = http.req("GET", http.url("/w/d/f", "OPEN"))
    out.append((st, body == payload))
    st, body = http.req("GET", http.url("/w/d/f", "OPEN", offset=1_100_000,
                                        length=5000))
    out.append((st, body == payload[1_100_000:1_105_000]))
    out += [http.op("GET", "/w/d/f", "GETFILESTATUS"),
            http.op("GET", "/w", "GETCONTENTSUMMARY"),
            http.two_step("POST", "/w/d/f", "APPEND", b"tail-bytes")]
    st, body = http.req("GET", http.url("/w/d/f", "OPEN"))
    out.append((st, body == payload + b"tail-bytes"))
    out += [http.op("POST", "/w/d/f", "TRUNCATE", newlength=1000),
            http.op("GET", "/w/d/f", "GETFILECHECKSUM"),
            http.op("PUT", "/w/d/f", "RENAME", destination="/w/d/g"),
            http.op("GET", "/w/d", "LISTSTATUS"),
            http.op("PUT", "/w/d/g", "SETPERMISSION", permission="600"),
            http.op("PUT", "/w/d/g", "SETREPLICATION", replication=1),
            http.op("GET", "/w/d/g", "GETFILESTATUS"),
            http.op("PUT", "/w/link", "CREATESYMLINK",
                    destination="/w/d/g"),
            http.op("GET", "/", "GETHOMEDIRECTORY"),
            http.op("GET", "/w/missing", "GETFILESTATUS"),
            http.op("GET", "/w", "NOSUCHOP")]
    st, body = http.req("GET", http.url("/w/link", "OPEN"))
    out.append((st, body == payload[:1000]))
    # delegation tokens in query params against an NN that needs them
    st, tok = http.op("GET", "/", "GETDELEGATIONTOKEN", renewer="web")
    out.append((st, sorted(tok["Token"])))
    mc.namenode.config.require_token_auth = True
    try:
        authed = _HttpFs(http.base, tok["Token"]["urlString"])
        out.append(authed.two_step("PUT", "/t/f", "CREATE", b"token bytes"))
        out.append(authed.req("GET", authed.url("/t/f", "OPEN")))
        out.append(http.op("GET", "/t/f", "GETFILESTATUS")[0])
        out.append(authed.op("PUT", "/", "CANCELDELEGATIONTOKEN",
                             token=tok["Token"]["urlString"])[0])
        out.append(authed.op("GET", "/t/f", "GETFILESTATUS")[0])
    finally:
        mc.namenode.config.require_token_auth = False
    out.append(http.op("DELETE", "/w/d/g", "DELETE"))
    for path in ("/status", "/health", "/stacks", "/timeseries",
                 "/traces", "/traces?format=chrome"):
        st, body = http.get(path)
        out.append((path, st, sorted(json.loads(body))))
    # each package's own registries, whichever earlier tests created
    st, body = http.get("/metrics")
    out.append(("/metrics", st, type(json.loads(body)).__name__))
    st, body = http.get("/prom")
    out.append(("/prom", st, b'registry="http_gateway"' in body))
    for page in ("/dfshealth", "/explorer", "/nope"):
        st, body = http.get(page)
        out.append((page, st, body[:15]))
    return out


def test_gateway_replies_equal_reference():
    from hdrf_tpu.server.http_gateway import HttpGateway as RefGw
    from hdrf_tpu.testing.minicluster import MiniCluster as RefMC
    from hdrf_tpu_torch.server.http_gateway import HttpGateway
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    got = {}
    for pkg, mc_cls, gw_make in (
            ("port", MiniCluster,
             lambda a: HttpGateway(a, device="cpu")),
            ("ref", RefMC, lambda a: RefGw(a))):
        with mc_cls(n_datanodes=2, replication=2, block_size=1 << 20) as mc:
            gw = gw_make(mc.namenode.addr).start()
            try:
                got[pkg] = _norm(_script(
                    _HttpFs(f"http://{gw.addr[0]}:{gw.addr[1]}"), mc))
            finally:
                gw.stop()
    for i, (a, b) in enumerate(zip(got["port"], got["ref"])):
        assert a == b, (i, a, b)
    assert len(got["port"]) == len(got["ref"])


def test_token_codec_equal_reference():
    """Delegation tokens ride the port's own codec, byte for byte the
    reference's msgpack: each side decodes the other's string."""
    from hdrf_tpu.server import http_gateway as ref
    from hdrf_tpu_torch.server import http_gateway as port

    tok = {"owner": "alice", "renewer": "web", "issue": 1_700_000_000.25,
           "max": 1 << 40, "seq": 7, "sig": b"\x00\xff" * 16}
    assert port.encode_token(tok) == ref.encode_token(tok)
    assert port.decode_token(ref.encode_token(tok)) == tok
    assert ref.decode_token(port.encode_token(tok)) == tok


def test_gateway_striped_file_on_the_clients_device():
    """An RS-6-3 file written and read over HTTP through the port's
    gateway: its clients run the striped path's RS where ``device``
    says; a ``cuda`` gateway without a card refuses the striped write
    rather than falling back to the CPU."""
    import torch

    from hdrf_tpu_torch.ops import rs
    from hdrf_tpu_torch.server.http_gateway import HttpGateway
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    data = np.random.default_rng(8).integers(0, 256, 700_000,
                                             np.uint8).tobytes()
    devices = []
    real = rs._apply

    def spy(rows, surv, device):
        devices.append(device)
        return real(rows, surv, device)

    rs._apply = spy
    try:
        with MiniCluster(n_datanodes=9, replication=1,
                         block_size=1 << 20) as mc:
            gw = HttpGateway(mc.namenode.addr, device="cpu").start()
            try:
                http = _HttpFs(f"http://{gw.addr[0]}:{gw.addr[1]}")
                assert http.two_step("PUT", "/ec/f", "CREATE", data,
                                     ec="rs-6-3-64k") == (200, 201)
                st, body = http.req("GET", http.url("/ec/f", "OPEN"))
                assert st == 200 and body == data
                st, fs = http.op("GET", "/ec/f", "GETFILESTATUS")
                assert fs["FileStatus"]["ec"]
            finally:
                gw.stop()
            assert devices and set(devices) == {"cpu"}
            if not torch.cuda.is_available():
                gw = HttpGateway(mc.namenode.addr).start()
                try:
                    http = _HttpFs(f"http://{gw.addr[0]}:{gw.addr[1]}")
                    _, code = http.two_step("PUT", "/ec/g", "CREATE", data,
                                            ec="rs-6-3-64k")
                    assert code >= 400
                finally:
                    gw.stop()
    finally:
        rs._apply = real

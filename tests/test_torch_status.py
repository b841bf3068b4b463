"""The port's status plane (utils/prom.py, server/status_http.py, the
Chrome exporter of utils/tracing.py) held against the reference on the
CPU: the same registry contents render to the same ``/prom`` bytes, the
same spans and ledger events to the same Chrome trace, and the
DataNode's and NameNode's status servers answer with the reference's
endpoints and keys."""

import json
import tempfile
import urllib.error
import urllib.request

import pytest


def _fill(metrics, name: str) -> None:
    """One registry of every kind: plain, labelled and ``_total`` keys."""
    r = metrics.registry(name)
    r.incr("writes", 7)
    r.incr("bytes_total", 1 << 33)
    r.incr("wait_us|op=sha256", 12)
    r.incr("wait_us|op=cdc,dev=0", 3)
    r.gauge("ratio", 1.5)
    r.gauge("queue|lane=a", 0.0)
    r.gauge("big", 12345678901.25)
    for v in (0.5, 3.0, 77.0, 1e6, 2.5e9):
        r.observe("latency_us", v)
        r.observe("phase_us|phase=wal_commit", v / 2)


@pytest.mark.parametrize("name", ["prom_a", "prom-b.c"])
def test_prom_bytes_equal_reference(name):
    """Each package renders its own registry and the other's snapshot
    to the same exposition bytes."""
    from hdrf_tpu.utils import metrics as ref_metrics
    from hdrf_tpu.utils import prom as ref_prom
    from hdrf_tpu_torch.utils import metrics, prom

    _fill(metrics, name)
    _fill(ref_metrics, name)
    mine = {name: metrics.registry(name).snapshot()}
    theirs = {name: ref_metrics.registry(name).snapshot()}
    assert mine == theirs
    assert prom.render(mine) == ref_prom.render(theirs)
    assert prom.render(theirs) == ref_prom.render(mine)
    both = {name: mine[name], "other": {"counters": {"writes": 1},
                                        "gauges": {}, "histograms": {}}}
    assert prom.render(both) == ref_prom.render(both)


def test_chrome_trace_equal_reference():
    from hdrf_tpu.utils import tracing as ref_tracing
    from hdrf_tpu_torch.utils import tracing

    spans = [{"trace_id": "00ab" * 4, "span_id": "s1", "parent_id": None,
              "name": "write", "tracer": "datanode", "start": 10.5,
              "duration_ms": 3.25, "annotations": {"bytes": 9}},
             {"trace_id": "00ab" * 4, "span_id": "s2", "parent_id": "s1",
              "name": "seal", "tracer": "worker", "start": 10.6,
              "duration_ms": None},
             {"trace_id": "ffff0000" * 2, "span_id": "s3",
              "parent_id": None, "name": "read", "tracer": "datanode",
              "start": 11.0, "duration_ms": 0.5}]
    ledger = [{"kind": "dispatch", "op": "resident.cdc", "proc": 7,
               "trace_id": "00ab" * 4, "span_id": "s1", "t0": 10.55,
               "dur_us": 0.2, "batch": 2, "bytes": 1 << 27},
              {"kind": "readback", "op": "resident.sha", "t0": 10.7}]
    counters = [{"name": "inflight", "proc": 7, "t": 10.6, "value": 3}]
    for tid in (None, "00ab" * 4):
        assert tracing.chrome_trace(spans, ledger, trace_id=tid,
                                    counters=counters) == \
            ref_tracing.chrome_trace(spans, ledger, trace_id=tid,
                                     counters=counters)


def _get(addr, path):
    try:
        with urllib.request.urlopen(
                f"http://{addr[0]}:{addr[1]}{path}", timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


PATHS = ["/timeseries", "/timeseries?metric=stalls", "/stacks", "/metrics",
         "/traces", "/traces?format=chrome", "/traces?trace_id=x",
         "/contention", "/prom", "/nope"]


def _shape(code, ctype, body, path=""):
    if path == "/metrics":
        # each package's own registries, whichever earlier tests created
        return code, ctype, type(json.loads(body)).__name__
    if ctype.startswith("application/json"):
        doc = json.loads(body)
        return code, ctype, (sorted(doc) if isinstance(doc, dict)
                             else type(doc).__name__)
    return code, ctype, body[:7]


def test_namenode_status_server_equal_reference():
    """``NameNodeConfig.status_port`` constructs and serves on the port:
    every endpoint answers with the reference's code, type and keys."""
    from hdrf_tpu.config import NameNodeConfig as RefCfg
    from hdrf_tpu.server.namenode import NameNode as RefNN
    from hdrf_tpu_torch.config import NameNodeConfig
    from hdrf_tpu_torch.server.namenode import NameNode

    out = {}
    for pkg, cfg_cls, nn_cls in (("port", NameNodeConfig, NameNode),
                                 ("ref", RefCfg, RefNN)):
        nn = nn_cls(cfg_cls(meta_dir=tempfile.mkdtemp(), port=0,
                            status_port=0)).start()
        try:
            out[pkg] = {p: _shape(*_get(nn._status.addr, p), p)
                        for p in PATHS}
        finally:
            nn.stop()
    assert out["port"] == out["ref"]
    assert out["port"]["/contention"][0] == 200


def test_datanode_status_server_equal_reference(tmp_path):
    """A DataNode with ``status_port`` answers every endpoint as the
    reference's does, and its /prom carries the write it served."""
    from _dn_standin import StandInNN, port_dn, ref_dn, write_block, \
        write_ok

    nn = StandInNN()
    out = {}
    try:
        for pkg, make in (("port", port_dn), ("ref", ref_dn)):
            dn = make(str(tmp_path / pkg), nn.addr, f"dn-{pkg}",
                      dn={"status_port": 0, "flight_interval_s": 0.05})
            try:
                blk = bytes(range(256)) * 300
                assert write_ok(write_block(dn.addr, 90, blk), blk)
                dn.flight.sample_once()
                got = {p: _shape(*_get(dn._status.addr, p), p)
                       for p in PATHS}
                code, _, prom = _get(dn._status.addr, "/prom")
                got["prom_write"] = b'registry="datanode"' in prom
                _, _, ts = _get(dn._status.addr, "/timeseries")
                got["sample_keys"] = sorted(json.loads(ts)["samples"][-1])
                out[pkg] = got
            finally:
                dn.stop()
    finally:
        nn.stop()
    assert out["port"] == out["ref"]
    assert out["port"]["prom_write"]
    assert {"garbage_bytes", "scrub_corrupt_total"} <= \
        set(out["port"]["sample_keys"])

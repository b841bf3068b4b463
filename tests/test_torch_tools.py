"""The port's operator tools (hdrf_tpu_torch/tools: ``cli``,
``slo_report``, ``gap_report``) held against the reference's on the CPU:
the same CLI commands against each package's MiniCluster print the same
output for the same state (up to clocks), and the reports print the
same JSON and tables for the same input files, the flight-archive
directory source and the retune ``guard`` included."""

import io
import json
import random
import re
from contextlib import redirect_stdout

import numpy as np
import pytest


def _run(cli, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


TIME_KEYS = ("mtime", "atime", "ctime", "modificationTime", "uptime_s")


def _drop_times(doc):
    if isinstance(doc, dict):
        return {k: _drop_times(v) for k, v in doc.items()
                if k not in TIME_KEYS}
    if isinstance(doc, list):
        return [_drop_times(v) for v in doc]
    return doc


def _strip_times(text: str) -> str:
    """The output with clock fields dropped from its JSON documents (a
    whole-output document or one a line)."""
    try:
        return json.dumps(_drop_times(json.loads(text)), sort_keys=True)
    except ValueError:
        pass
    out = []
    for line in text.splitlines():
        try:
            out.append(json.dumps(_drop_times(json.loads(line)),
                                  sort_keys=True))
        except ValueError:
            out.append(line)
    return "\n".join(out)


def _cli_script(cli, mc, tmp_path, device_args) -> list:
    nn = f"{mc.namenode.addr[0]}:{mc.namenode.addr[1]}"
    dn = mc.datanodes[0]
    dn_addr = f"{dn.addr[0]}:{dn.addr[1]}"
    payload = np.random.default_rng(0).integers(0, 256, 100_000,
                                                np.uint8).tobytes()
    local = tmp_path / "in.bin"
    local.write_bytes(payload)
    out_file = tmp_path / "out.bin"
    dfs = ["dfs", "--namenode", nn, *device_args]
    adm = ["dfsadmin", "--namenode", nn, *device_args]
    script = [dfs + ["-mkdir", "/t"],
              dfs + ["--scheme", "dedup_lz4", "-put", str(local), "/t/f"],
              dfs + ["-put", str(local), "/t/plain"],
              dfs + ["-ls", "/t"], dfs + ["-stat", "/t/f"],
              dfs + ["-get", "/t/f", str(out_file)],
              dfs + ["-du", "/t"], dfs + ["-count", "/t"],
              dfs + ["-checksum", "/t/plain"],
              dfs + ["-chmod", "700", "/t/plain"],
              dfs + ["-setfattr", "-n", "user.k", "-v", "v1", "/t/plain"],
              dfs + ["-getfattr", "/t/plain"],
              dfs + ["-mv", "/t/f", "/t/g"], dfs + ["-rm", "/t/g"],
              dfs + ["-rm", "/t/g"],
              adm + ["-ecStatus"], adm + ["-fsck"],
              adm + ["-allowSnapshot", "/t"],
              dfs + ["-createSnapshot", "/t", "s1"],
              dfs + ["-lsSnapshots", "/t"],
              adm + ["-reconfig", dn_addr, "list"],
              adm + ["-reconfig", dn_addr, "cache_capacity", "12345"],
              adm + ["-reconfig", dn_addr, "cdc_mask_bits", "99"],
              adm + ["-reconfig", dn_addr, "cdc_max_chunk", "131072"],
              adm + ["-reconfig", dn_addr, "data_dir", "/x"],
              adm + ["-savenamespace"]]
    got = []
    for argv in script:
        rc, text = _run(cli, argv)
        tail = [a.replace(str(tmp_path), "TMP").replace(dn_addr, "DN")
                for a in argv[len(dfs):]]
        got.append((argv[0], tail, rc, _strip_times(text)))
    got.append(out_file.read_bytes() == payload)
    rc, text = _run(cli, ["oiv", mc.nn_config.meta_dir])
    got.append((rc, re.sub(r"/\d{9,}-", "/TRASHED-", text)))
    return got


def test_cli_output_equal_reference(tmp_path):
    from hdrf_tpu.testing.minicluster import MiniCluster as RefMC
    from hdrf_tpu.tools import cli as ref_cli
    from hdrf_tpu_torch.testing.minicluster import MiniCluster
    from hdrf_tpu_torch.tools import cli

    out = {}
    for pkg, mc_cls, mod, dev in (("port", MiniCluster, cli,
                                   ["--device", "cpu"]),
                                  ("ref", RefMC, ref_cli, [])):
        (tmp_path / pkg).mkdir()
        random.seed(0)
        with mc_cls(n_datanodes=3, replication=2) as mc:
            out[pkg] = _cli_script(mod, mc, tmp_path / pkg, dev)
    for i, (a, b) in enumerate(zip(out["port"], out["ref"])):
        assert a == b, i
    assert len(out["port"]) == len(out["ref"])


def test_storage_and_oev_equal_reference(tmp_path):
    """``storage version`` and ``oev`` of one package's meta dir print
    the same through both CLIs (the edit log is byte-identical across
    packages, so each CLI reads the other's)."""
    from hdrf_tpu.tools import cli as ref_cli
    from hdrf_tpu_torch.testing.minicluster import MiniCluster
    from hdrf_tpu_torch.tools import cli

    with MiniCluster(n_datanodes=1, replication=1) as mc:
        with mc.client("v", device="cpu") as c:
            c.mkdir("/viewer/after")
            c.write("/viewer/f", b"x" * 1000)
        meta = mc.nn_config.meta_dir
        for argv in (["oev", meta], ["storage", "version", meta],
                     ["storage", "version", str(tmp_path)]):
            assert _run(cli, argv) == _run(ref_cli, argv)
        rc, text = _run(cli, ["oev", meta])
        assert rc == 0 and any(json.loads(line)["op"] == "mkdir"
                               for line in text.splitlines())


def _samples(seed: int, n: int = 24) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        drift = 1.0 + (0.8 if i > n // 2 else 0.0)
        out.append({"t": 1000.0 + i, "mono": float(i),
                    "read_p95_ms": float(rng.normal(10, 1) * drift),
                    "write_p95_ms": float(rng.normal(20, 2)),
                    "dedup_ratio": float(2.0 - 0.5 * (i > n // 2)),
                    "cache_hit_ratio": float(rng.uniform(0.5, 0.9)),
                    "garbage_bytes": int(i * 1000),
                    "scrub_corrupt_total": 0, "stalls": int(i > 20),
                    "tenant": {"a": i}})
    return out


@pytest.mark.parametrize("shape", ["capture", "list", "bench"])
@pytest.mark.parametrize("mode", [[], ["--trend"]], ids=["window", "trend"])
def test_slo_report_input_file_equal_reference(tmp_path, shape, mode):
    from hdrf_tpu.tools import slo_report as ref
    from hdrf_tpu_torch.tools import slo_report

    samples = _samples(3)
    doc = {"capture": {"samples": samples}, "list": samples,
           "bench": {"read": samples[0], "other": 1}}[shape]
    path = tmp_path / "in.json"
    path.write_text(json.dumps(doc))
    for extra in (["--json"], []):
        argv = ["--input", str(path), *mode, *extra]
        assert _run(slo_report, argv) == _run(ref, argv)


def test_slo_report_archive_dir_and_guard_equal_reference(tmp_path):
    from hdrf_tpu.tools import slo_report as ref
    from hdrf_tpu.utils.flight_archive import FlightArchive
    from hdrf_tpu_torch.tools import slo_report

    arch = FlightArchive(str(tmp_path / "arch"), max_bytes=1 << 20)
    for s in _samples(5, 40):
        arch.append(s)
    arch.close()
    for extra in (["--json"], ["--trend", "--json"], []):
        argv = ["--input", str(tmp_path / "arch"), *extra]
        assert _run(slo_report, argv) == _run(ref, argv)
    s = _samples(7, 16)
    for gauges in (("write_p95_ms",), ("dedup_ratio", "read_p95_ms"), None):
        kw = {} if gauges is None else {"gauges": gauges}
        assert slo_report.guard(s[:8], s[8:], **kw) == \
            ref.guard(s[:8], s[8:], **kw)


def _timelines(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(5):
        phases = {p: float(rng.uniform(0.01, 0.2))
                  for p in ("recv", "dedup_lookup", "container_io",
                            "wal_commit", "device_wait")}
        out.append({"nbytes": int(rng.integers(1 << 20, 8 << 20)),
                    "profile": {"wall_s": sum(phases.values()) + 0.05,
                                "phases": phases,
                                "classes": {"host_busy": 0.3,
                                            "device_busy": 0.1,
                                            "transport_wait": 0.05,
                                            "idle": 0.02},
                                "hidden_wait_s": 0.04,
                                "hideable_wait_s": 0.09}})
    return out


@pytest.mark.parametrize("shape", ["timelines", "bench"])
def test_gap_report_input_equal_reference(tmp_path, shape):
    from hdrf_tpu.tools import gap_report as ref
    from hdrf_tpu_torch.tools import gap_report

    tl = _timelines(1)
    doc = tl if shape == "timelines" else {
        "phase_profile": dict(tl[0]["profile"], bytes=tl[0]["nbytes"])}
    path = tmp_path / "tl.json"
    path.write_text(json.dumps(doc))
    for extra in (["--json"], []):
        argv = ["--input", str(path), *extra]
        assert _run(gap_report, argv) == _run(ref, argv)

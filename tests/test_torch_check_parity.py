"""The port's lints (hdrf_tpu_torch/tools/check_parity.py) against the
reference's (hdrf_tpu/tools/check_parity.py): the same messages on the
same trees — the reference package itself and small mutated trees — and
the port's ``main`` clean over its own package.  The one difference is
by design: the port also reads README.md's "Port-only metrics" table."""

import ast
import contextlib
import io
import os

import pytest

import hdrf_tpu
import hdrf_tpu_torch
from hdrf_tpu.tools import check_parity as ref_lint
from hdrf_tpu_torch.tools import check_parity as port_lint

REF_ROOT = os.path.dirname(os.path.abspath(hdrf_tpu.__file__))
PORT_ROOT = os.path.dirname(os.path.abspath(hdrf_tpu_torch.__file__))
REPO = os.path.dirname(PORT_ROOT)
BENCH_KEYS = ("multichip", "mirror", "read", "read.chunk_cache_hit_ratio",
              "read.no_such_key_ever", "scrub", "qos.sheds",
              "longhorizon.storage_ratio_slope", "nn.observer_share")


def _main_output(mod, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


def test_same_messages_on_the_reference_tree():
    assert port_lint.check(REF_ROOT) == ref_lint.check(REF_ROOT)
    assert port_lint.declared_fault_points(REF_ROOT) \
        == ref_lint.declared_fault_points(REF_ROOT)
    assert port_lint.check_fault_points(REF_ROOT) \
        == ref_lint.check_fault_points(REF_ROOT)
    assert port_lint.declared_metrics(REF_ROOT) \
        == ref_lint.declared_metrics(REF_ROOT)
    assert port_lint.check_prom_metrics(REF_ROOT) \
        == ref_lint.check_prom_metrics(REF_ROOT)
    for key in BENCH_KEYS:
        assert port_lint.check_bench_contract(REF_ROOT, key=key) \
            == ref_lint.check_bench_contract(REF_ROOT, key=key), key
    assert port_lint.check_bench_contract(REF_ROOT,
                                          key="read.no_such_key_ever")
    assert _main_output(port_lint, [REF_ROOT]) \
        == _main_output(ref_lint, [REF_ROOT])


BENCH_TWO = '''import json
def _read_summary(x):
    return {"chunk_cache_hit_ratio": 1.0}
def fallback():
    print(json.dumps({"multichip": {}, "read": _read_summary(0)}))
def tpu():
    print(json.dumps({"multichip": {}, "read": {"other": 1}}))
'''


def _mutated_tree(tmp_path, arch: str, bench: str | None) -> str:
    pkg = tmp_path / "pkg"
    (pkg / "sub").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "good.py").write_text(
        '"""Cites Foo.java:12 and x.py:3-9."""\n'
        'fault_injection.point("good.point")\n'
        'R.incr("documented_total")\n')
    (pkg / "nodoc.py").write_text("x = 1\n")
    (pkg / "sub" / "uncited.py").write_text(
        '"""Says nothing of where it comes from."""\n'
        "fault_injection.point('lonely.point', 3)\n"
        'R.observe("undocumented_us", 1)\n'
        'R.incr(f"dynamic_{x}")\n'
        'R.gauge("labelled|op=x", 2)\n')
    (pkg / "broken.py").write_text("def (:\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_x.py").write_text('inject("good.point")\n')
    (tmp_path / "ARCHITECTURE.md").write_text(arch)
    if bench is not None:
        (tmp_path / "bench.py").write_text(bench)
    return str(pkg)


@pytest.mark.parametrize("arch,bench", [
    ("| `documented_total` | x |\n", BENCH_TWO),
    ("| `documented_total` | `labelled` | `undocumented_us` |\n", None),
    ("", "import json\nprint(json.dumps({'multichip': 1}))\n"),
], ids=["partial-docs", "no-bench", "one-branch"])
def test_same_messages_on_mutated_trees(tmp_path, arch, bench):
    root = _mutated_tree(tmp_path, arch, bench)
    for fn in ("check", "check_fault_points", "check_prom_metrics",
               "declared_metrics", "declared_fault_points"):
        assert getattr(port_lint, fn)(root) == getattr(ref_lint, fn)(root), fn
    for key in BENCH_KEYS:
        assert port_lint.check_bench_contract(root, key=key) \
            == ref_lint.check_bench_contract(root, key=key), key
    assert port_lint.check(root)    # nodoc, uncited, broken
    rc, out = _main_output(port_lint, [root])
    assert (rc, out) == _main_output(ref_lint, [root])
    assert rc == 1


def test_port_only_table_documents_a_name(tmp_path):
    root = _mutated_tree(tmp_path, "| `documented_total` |\n", BENCH_TWO)
    msgs = port_lint.check_prom_metrics(root)
    assert any("'undocumented_us'" in m for m in msgs)
    (tmp_path / "README.md").write_text(
        "# x\n\n### Port-only metrics\n\n| metric | what |\n|---|---|\n"
        "| `undocumented_us` | a port name |\n| `labelled` | another |\n"
        "\n## Later\n\n| `other_name` | outside the table |\n")
    assert port_lint.port_only_metrics(str(tmp_path / "README.md")) \
        == {"undocumented_us", "labelled"}
    assert port_lint.check_prom_metrics(root) == []
    # the reference reads ARCHITECTURE.md alone
    assert ref_lint.check_prom_metrics(root) == msgs


def test_port_tree_is_clean():
    """The four lints over hdrf_tpu_torch/ as a tier-1 gate: citations,
    fault points, metric docs (ARCHITECTURE.md + the port-only table),
    and the root bench contract."""
    assert port_lint.check(PORT_ROOT) == []
    assert "block_receiver.packet" in port_lint.declared_fault_points(
        PORT_ROOT)
    assert port_lint.check_fault_points(PORT_ROOT) == []
    names = port_lint.declared_metrics(PORT_ROOT)
    port_only = {"demotes_already_striped", "emits", "demote_open_sealed",
                 "replicate_source_missing", "replicas_already_held",
                 "lease_renewals", "lease_renew_failures",
                 "ec_demotions_deferred", "stripe_groups_unrecoverable",
                 "stripe_repairs_over_m"}
    assert port_only <= set(names)
    assert port_lint.port_only_metrics(os.path.join(REPO, "README.md")) \
        == port_only
    assert port_lint.check_prom_metrics(PORT_ROOT) == []
    rc, out = _main_output(port_lint, [])
    assert rc == 0, out
    assert out.strip().endswith("bench contract: clean")


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_import_statement_reaches_jax_or_the_reference():
    """Every import statement of the port and of the chip scripts, at any
    depth (the harnesses import inside their bodies): none names jax,
    msgpack or hdrf_tpu."""
    paths = [os.path.join(REPO, f) for f in
             ("chip_smoke.py", "kernel_times.py", "stream_probe.py")]
    for dirpath, _dirs, files in os.walk(PORT_ROOT):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    bad = {p: sorted(_imports(p) & {"jax", "jaxlib", "msgpack", "hdrf_tpu"})
           for p in paths}
    assert not {p: b for p, b in bad.items() if b}

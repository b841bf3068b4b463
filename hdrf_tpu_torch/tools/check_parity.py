"""Parity-citation, fault-point, metric-doc and bench-contract lints (port
of hdrf_tpu/tools/check_parity.py: ``check`` check_parity.py:54-74,
``check_fault_points`` :93-111, ``check_prom_metrics`` :132-146,
``check_bench_contract`` :169-208, ``main`` :211-254).

The repo convention is that each module's docstring names the
reference files it re-expresses with ``file:line`` citations, so the
component map stays verifiable against the code.  The four lints, with
the reference's regexes and messages:

1. every ``**/*.py`` module under the root (``__init__.py`` exempt) has
   a docstring with at least one citation;
2. every ``fault_injection.point("name", ...)`` declared under the root
   is referenced by at least one test under ``tests/``;
3. every metric name declared with a plain string literal through a
   registry's incr / observe / gauge / time call appears backticked in
   ``ARCHITECTURE.md``'s metrics table — or, for the port, in the
   "Port-only metrics" table of ``README.md``: the names the port has and
   the reference does not (``ARCHITECTURE.md`` documents the reference and
   is not edited by the port);
4. the root ``bench.py`` output contract: a summary key is a literal key
   of at least two ``json.dumps({...})`` branches (a dotted key also
   pins its sub-key).  It checks the reference's bench, unchanged; the
   port's own bench is still to come.

Run as ``python -m hdrf_tpu_torch.tools.check_parity [root]`` (exit 1 on
violations; the root defaults to ``hdrf_tpu_torch/``); wired as tier-1
tests in tests/test_torch_check_parity.py.
"""

from __future__ import annotations

import ast
import os
import re
import sys

# file.ext:NNN with an optional -NNN range, e.g. "OutlierDetector.java:61-103"
CITATION = re.compile(
    r"[A-Za-z0-9_][A-Za-z0-9_.\-/]*"
    r"\.(?:java|py|c|cc|cpp|h|hpp|proto|md|html|sh|json)"
    r":\d+(?:-\d+)?")

# fault_injection.point("name", ...) declarations in main code
FAULT_POINT = re.compile(
    r"fault_injection\.point\(\s*['\"]([A-Za-z0-9_.]+)['\"]")

# Plain-string metric declarations.  f-string names (per-phase/per-op
# families like f"wait_us|op={op}") never match: the ``f`` prefix sits
# between the open paren and the quote, which ``\s*`` rejects.
METRIC_CALL = re.compile(
    r"\.(?:incr|observe|gauge|time)\(\s*['\"]([A-Za-z0-9_.|=]+)['\"]")

# a row of README.md's "Port-only metrics" table: | `name` | ...
PORT_ONLY_ROW = re.compile(r"\|\s*`([A-Za-z0-9_.]+)`\s*\|")


def check(root: str) -> list[str]:
    """Return one message per violating module (empty = clean)."""
    problems: list[str] = []
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if not fn.endswith(".py") or fn == "__init__.py":
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, os.path.dirname(root))
            try:
                tree = ast.parse(open(path, encoding="utf-8").read(), path)
            except SyntaxError as e:
                problems.append(f"{rel}: unparseable ({e.msg})")
                continue
            doc = ast.get_docstring(tree)
            if not doc:
                problems.append(f"{rel}: no module docstring")
            elif not CITATION.search(doc):
                problems.append(f"{rel}: docstring has no file:line "
                                f"reference citation")
    return problems


def declared_fault_points(root: str) -> dict[str, str]:
    """Every fault point declared under ``root`` -> declaring file."""
    points: dict[str, str] = {}
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            src = open(path, encoding="utf-8").read()
            for name in FAULT_POINT.findall(src):
                points.setdefault(name,
                                  os.path.relpath(path,
                                                  os.path.dirname(root)))
    return points


def check_fault_points(root: str, tests_dir: str | None = None) -> list[str]:
    """Return one message per declared-but-untested fault point."""
    if tests_dir is None:
        tests_dir = os.path.join(os.path.dirname(root), "tests")
    corpus = []
    if os.path.isdir(tests_dir):
        for dirpath, _dirs, files in sorted(os.walk(tests_dir)):
            for fn in sorted(files):
                if fn.endswith(".py"):
                    corpus.append(
                        open(os.path.join(dirpath, fn),
                             encoding="utf-8").read())
    corpus = "\n".join(corpus)
    problems = []
    for name, where in sorted(declared_fault_points(root).items()):
        if f'"{name}"' not in corpus and f"'{name}'" not in corpus:
            problems.append(f"fault point '{name}' ({where}) is referenced "
                            f"by no test under {tests_dir}")
    return problems


def declared_metrics(root: str) -> dict[str, str]:
    """Every plain-literal metric name declared under ``root`` -> first
    declaring file.  Keys keep any ``|label=value`` suffix; the documented
    unit is the base name (``key.split("|")[0]``)."""
    names: dict[str, str] = {}
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            src = open(path, encoding="utf-8").read()
            for name in METRIC_CALL.findall(src):
                names.setdefault(name,
                                 os.path.relpath(path,
                                                 os.path.dirname(root)))
    return names


def port_only_metrics(readme: str) -> set[str]:
    """The backticked first-column names of the "Port-only metrics" table
    in ``readme`` (the section runs to the next heading)."""
    if not os.path.isfile(readme):
        return set()
    names: set[str] = set()
    inside = False
    for line in open(readme, encoding="utf-8"):
        if line.startswith("#"):
            inside = "Port-only metrics" in line
        elif inside and (m := PORT_ONLY_ROW.match(line)):
            names.add(m.group(1))
    return names


def check_prom_metrics(root: str, arch_md: str | None = None,
                       readme: str | None = None) -> list[str]:
    """Return one message per metric name absent from ARCHITECTURE.md's
    metrics table (matched as a backticked base name) and from the
    "Port-only metrics" table of README.md."""
    if arch_md is None:
        arch_md = os.path.join(os.path.dirname(root), "ARCHITECTURE.md")
    if readme is None:
        readme = os.path.join(os.path.dirname(root), "README.md")
    text = ""
    if os.path.isfile(arch_md):
        text = open(arch_md, encoding="utf-8").read()
    text += "".join(f"`{n}`" for n in sorted(port_only_metrics(readme)))
    problems = []
    for name, where in sorted(declared_metrics(root).items()):
        base = name.split("|")[0]
        if f"`{base}`" not in text:
            problems.append(f"metric '{base}' ({where}) is not documented "
                            f"in {os.path.basename(arch_md)}")
    return problems


def _value_carries_key(value: ast.expr, sub: str,
                       funcs: dict[str, ast.FunctionDef]) -> bool:
    """Does the expression bound to a top-level bench key provably carry
    ``sub`` as a literal dict key?  Two shapes are recognized: an inline
    ``{...}`` literal, and a call to a module-level helper (the
    ``_read_summary(tmp)`` pattern) whose ``return {...}`` literal is
    scanned one level deep."""
    dicts: list[ast.Dict] = []
    if isinstance(value, ast.Dict):
        dicts.append(value)
    elif (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
            and value.func.id in funcs):
        for node in ast.walk(funcs[value.func.id]):
            if isinstance(node, ast.Return) and isinstance(node.value,
                                                           ast.Dict):
                dicts.append(node.value)
    return any(isinstance(k, ast.Constant) and k.value == sub
               for d in dicts for k in d.keys)


def check_bench_contract(root: str, bench_py: str | None = None,
                         key: str = "multichip") -> list[str]:
    """Fourth lint: bench.py's output contract.  The bench emits its one
    JSON line from two branches (native CPU fallback and the TPU path);
    a summary block added to only one silently vanishes from whichever
    backend a run happens to land on.  Assert the ``key`` appears as
    a literal dict key in at least two ``json.dumps({...})`` calls.

    A dotted key (``read.chunk_cache_hit_ratio``) additionally pins a
    SUB-key of a summary block: each branch's value for the top key must
    carry the sub-key, either as an inline dict literal or inside the
    ``return {...}`` of the module-level helper the branch calls — so a
    metric dropped from a summary helper fails the lint even though both
    branches still name the block."""
    if bench_py is None:
        bench_py = os.path.join(os.path.dirname(root), "bench.py")
    if not os.path.isfile(bench_py):
        return [f"bench contract: {bench_py} missing"]
    tree = ast.parse(open(bench_py, encoding="utf-8").read(), bench_py)
    top, _, sub = key.partition(".")
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef)}
    hits = 0
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            if not sub:
                hits += any(isinstance(k, ast.Constant) and k.value == top
                            for k in d.keys)
                continue
            hits += any(isinstance(k, ast.Constant) and k.value == top
                        and _value_carries_key(v, sub, funcs)
                        for k, v in zip(d.keys, d.values))
    if hits < 2:
        return [f"bench contract: '{key}' key present in {hits} of the "
                f"expected 2+ json.dumps branches of bench.py"]
    return []


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    problems = (check(root) + check_fault_points(root)
                + check_prom_metrics(root) + check_bench_contract(root)
                + check_bench_contract(root, key="mirror")
                + check_bench_contract(root, key="read")
                + check_bench_contract(root, key="read.chunk_cache_hit_ratio")
                + check_bench_contract(root, key="read.read_batches")
                + check_bench_contract(
                    root, key="read.containers_decoded_per_read")
                + check_bench_contract(root, key="scrub")
                + check_bench_contract(root, key="qos")
                + check_bench_contract(root, key="qos.sheds")
                + check_bench_contract(root, key="qos.tenant_fairness_ratio")
                + check_bench_contract(root, key="qos.ec_hedge_wins")
                + check_bench_contract(root, key="cdc_adaptive")
                + check_bench_contract(root, key="cdc_adaptive.skip_ahead")
                + check_bench_contract(
                    root, key="cdc_adaptive.scan_slab_survivors")
                + check_bench_contract(
                    root, key="cdc_adaptive.mask_bits_effective")
                + check_bench_contract(root, key="cdc_adaptive.retunes")
                + check_bench_contract(root, key="coded_exchange")
                + check_bench_contract(
                    root, key="coded_exchange.repair_wire_ratio")
                + check_bench_contract(
                    root, key="coded_exchange.coded_repairs")
                + check_bench_contract(
                    root, key="coded_exchange.pack_saved_frac")
                + check_bench_contract(root, key="longhorizon")
                + check_bench_contract(
                    root, key="longhorizon.storage_ratio_slope")
                + check_bench_contract(root, key="nn")
                + check_bench_contract(root, key="nn.rpc_p99_ms")
                + check_bench_contract(root, key="nn.lock_saturation")
                + check_bench_contract(root, key="nn.observer_share"))
    for p in problems:
        print(p)
    print(f"{len(problems)} violation(s)" if problems
          else "parity citations + fault-point coverage + metric docs + "
               "bench contract: clean")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())

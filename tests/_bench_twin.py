"""Run one harness argv through the reference's and the port's
``benchmarks.main`` in this process and compare what they print
(tests/test_torch_benchmarks*.py)."""

import io
import json
from contextlib import redirect_stdout

from hdrf_tpu import benchmarks as ref_bench
from hdrf_tpu_torch import benchmarks as port_bench

# dict-valued keys whose keys are data, not schema (nn's top-8 methods)
DATA_KEYED = ("lock_share",)


def lines(mod, argv: list[str]) -> list[dict]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert mod.main(list(argv)) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


def key_paths(o, prefix: str = "") -> set[str]:
    """Every key of ``o`` as a dotted path, recursively through dicts."""
    out = set()
    for k, v in o.items():
        path = f"{prefix}{k}"
        out.add(path)
        if isinstance(v, dict) and k not in DATA_KEYED:
            out |= key_paths(v, path + ".")
    return out


def twin(ref_argv: list[str], port_extra: list[str] = ()
         ) -> tuple[list[dict], list[dict]]:
    """(reference lines, port lines) of one argv, the port's with
    ``port_extra`` appended; their counts and key sets are equal."""
    ref = lines(ref_bench, ref_argv)
    port = lines(port_bench, [*ref_argv, *port_extra])
    assert len(port) == len(ref), (ref, port)
    assert [key_paths(o) for o in port] == [key_paths(o) for o in ref]
    return ref, port


def port_only(argv: list[str]) -> list[dict]:
    return lines(port_bench, argv)

"""The port's device ledger (hdrf_tpu_torch/utils/device_ledger.py) held
against the reference's (hdrf_tpu/utils/device_ledger.py): the same call
sequence moves the same counters (``stamp`` / ``delta``) and writes the
same events; ``key=`` counts a compile at the first sighting of an
``(op, key)`` only; ``pending`` tokens count no dispatch."""

import itertools

import pytest

from hdrf_tpu.utils import device_ledger as ref_ledger
from hdrf_tpu_torch.utils import device_ledger as port_ledger

_run = itertools.count()


def _sequence(led, tag: str) -> None:
    a, agg = f"{tag}.a", f"{tag}.agg"
    t = led.dispatch(a, batch=2, h2d_bytes=100, key=(1, 2))
    led.readback(t, d2h_bytes=50)
    t = led.dispatch(a, key=(1, 2))             # seen: no compile
    led.readback(t)
    t = led.dispatch(a, batch=4, key=(3,))      # fresh key: a compile
    u = led.dispatch(f"{tag}.b")                # no key: never a compile
    p = led.pending(agg, batch=3)               # counts no dispatch
    led.readback(p, d2h_bytes=10)
    led.readback(t, d2h_bytes=7)
    led.readback(u)
    led.transfer("h2d", f"{tag}.put", 64)
    led.transfer("d2h", f"{tag}.get", 32)
    led.readback(None)


def _events_since(led, id0: int) -> list[tuple]:
    return [(e["op"].split(".", 1)[1], e["kind"], e["batch"], e["bytes"])
            for e in led.events_snapshot() if e["id"] > id0]


def _last_id(led) -> int:
    evs = led.events_snapshot()
    return evs[-1]["id"] if evs else 0


@pytest.mark.parametrize("stall", [False, True], ids=["clean", "stalled"])
def test_same_sequence_same_counters_and_events(monkeypatch, stall):
    if stall:   # every readback past the budget is a stall
        monkeypatch.setattr(ref_ledger, "STALL_BUDGET_S", -1.0)
        monkeypatch.setattr(port_ledger, "STALL_BUDGET_S", -1.0)
    n = next(_run)
    out = {}
    for name, led in (("ref", ref_ledger), ("port", port_ledger)):
        s0, id0 = led.stamp(), _last_id(led)
        _sequence(led, f"ledger{n}{stall}")
        out[name] = (led.delta(s0), _events_since(led, id0))
    (rd, rev), (pd, pev) = out["ref"], out["port"]
    assert pd == rd
    assert set(pd) == {"dispatch_total", "readback_total", "compiles_total",
                       "stall_total", "h2d_bytes_total", "d2h_bytes_total"}
    assert pd["dispatch_total"] == 4 and pd["compiles_total"] == 2
    assert pd["readback_total"] == 5           # the pending token's too
    assert pd["h2d_bytes_total"] == 164 and pd["d2h_bytes_total"] == 99
    assert pd["stall_total"] == (5 if stall else 0)
    assert pev == rev
    kinds = [k for _, k, _, _ in pev]
    assert kinds.count("compile") == 2 and kinds.count("enqueue") == 4


def test_a_key_compiles_once_per_op():
    """The same key under two ops is two shapes; under one op, one."""
    n = next(_run)
    for led in (ref_ledger, port_ledger):
        s0 = led.stamp()
        for op in (f"k{n}.x", f"k{n}.y", f"k{n}.x"):
            led.readback(led.dispatch(op, key=("shape", 8)))
        assert led.delta(s0)["compiles_total"] == 2


def test_delta_of_a_partial_stamp():
    """``delta`` takes missing keys of ``before`` as 0, as the reference."""
    for led in (ref_ledger, port_ledger):
        d = led.delta({})
        assert d == led.stamp()

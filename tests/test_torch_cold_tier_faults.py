"""The faults of the cold-tier command path, each pinned without timing.

A NameNode's ``replicate`` and ``stripe_demote`` commands reach a
DataNode in its heartbeat reply.  Four ways that path failed, each built
here directly (no cluster, no sleeps) on both packages' DataNodes, with
the reference's outcome asserted beside the port's:

- a full block report refused as a NameNode refuses an unregistered
  DataNode's (``RpcError`` KeyError: the NameNode restarted, or declared
  the DataNode dead, and the report came before the next heartbeat
  re-registered it): the reference's heartbeat loop raises, so its thread
  ends, while the lifeline keeps the DataNode alive at the NameNode and
  every command queued for it stays undelivered (the smoke's NAMENODE
  (c) on the card: ``replicate`` commands scheduled and never run); the
  port's counts ``block_report_failures`` and goes on;
- a command that raises ``OSError`` (a ``replicate`` whose push failed):
  the reference ends the reply's command loop there and counts
  ``heartbeat_failures``; the port counts ``command_errors`` for that
  command and runs the rest;
- a ``replicate`` pushed to a target that already holds the replica at
  its generation (the NameNode sends it again once its pending timeout
  passes): the reference's target commits the block's chunk references a
  second time and then refuses (``op_io_errors``); the port's
  acknowledges it and leaves its index as it was;
- a ``replicate`` sent to a source without the replica: the reference
  returns with no trace; the port counts ``replicate_source_missing`` and
  sends a full block report, so the NameNode drops the location.

One pass of a DataNode's heartbeat loop runs in the test's own thread
(``one_heartbeat``): the DataNodes are started with an hour's heartbeat
interval, so that their own heartbeat threads never tick.

The open container a demotion used to skip (NAMENODE (d)) is pinned in
tests/test_torch_ec.py (``test_block_whose_only_unstriped_container_is_open``).
"""

from __future__ import annotations

import socket
import threading

import numpy as np
import pytest

from _dn_standin import (StandInNN, guard_reference_stat_race, port_dn,
                         ref_dn, target, write_block, write_ok)

HOUR = 3600.0


@pytest.fixture(autouse=True)
def _reference_stat_race(monkeypatch):
    guard_reference_stat_race(monkeypatch)


class _OneTick:
    """A DataNode's ``_stop`` event that lets the calling thread through
    its heartbeat loop once; every other thread sees the real event."""

    def __init__(self, real: threading.Event) -> None:
        self.real, self.me, self.waits = real, threading.get_ident(), 0

    def wait(self, timeout=None):
        if threading.get_ident() != self.me:
            return self.real.wait(timeout)
        self.waits += 1
        return self.waits > 1

    def __getattr__(self, name):
        return getattr(self.real, name)


def one_heartbeat(dn) -> None:
    """One pass of ``dn``'s heartbeat loop in this thread: the heartbeat,
    every command of its reply, and the periodic full block report."""
    real = dn._stop
    dn._stop = _OneTick(real)
    try:
        dn._heartbeat_loop()
    finally:
        dn._stop = real


def _metrics(pkg: str):
    if pkg == "port":
        from hdrf_tpu_torch.utils import metrics
    else:
        from hdrf_tpu.utils import metrics
    return metrics


def _counts(pkg: str) -> dict:
    mx = _metrics(pkg)
    return {**mx.registry("datanode").snapshot()["counters"],
            **{f"br.{k}": v for k, v in
               mx.registry("block_receiver").snapshot()["counters"].items()}}


def _delta(c0: dict, c1: dict, *keys) -> dict:
    return {k: c1.get(k, 0) - c0.get(k, 0) for k in keys}


def _dn(pkg: str, root, nn, name: str):
    make = port_dn if pkg == "port" else ref_dn
    return make(str(root / name), nn.addr, name,
                dn={"heartbeat_interval_s": HOUR})


def _closed_port() -> list:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = list(s.getsockname())
    s.close()
    return addr


def _data(seed: int, size: int = 300_000) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


def _refcounts(dn, bid: int) -> list:
    return [dn.index.chunk_location(h).refcount
            for h in dn.index.get_block(bid).hashes]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_failed_command_leaves_the_rest_of_the_reply(tmp_path, pkg):
    """A reply of two commands: a ``replicate`` whose push is refused (a
    closed port: ``ConnectionRefusedError``) and an ``invalidate``.  The
    reference drops the ``invalidate`` and counts a heartbeat failure;
    the port runs it and counts the ``replicate``'s failure alone."""
    nn = StandInNN()
    dn = _dn(pkg, tmp_path, nn, "dn-a")
    try:
        for bid in (1, 2):
            assert write_ok(write_block(dn.addr, bid, _data(bid)),
                            _data(bid))
        nn.command("dn-a", {"cmd": "replicate", "block_id": 1,
                            "gen_stamp": 1, "targets": [
                                {"dn_id": "gone", "addr": _closed_port()}]})
        nn.command("dn-a", {"cmd": "invalidate", "block_ids": [2]})
        c0 = _counts(pkg)
        one_heartbeat(dn)
        got = _delta(c0, _counts(pkg), "heartbeat_failures",
                     "command_errors", "blocks_invalidated",
                     "blocks_replicated")
        if pkg == "ref":
            assert got == {"heartbeat_failures": 1, "command_errors": 0,
                           "blocks_invalidated": 0, "blocks_replicated": 0}
            assert dn.replicas.get_meta(2) is not None
        else:
            assert got == {"heartbeat_failures": 0, "command_errors": 1,
                           "blocks_invalidated": 1, "blocks_replicated": 0}
            assert dn.replicas.get_meta(2) is None
        assert dn.replicas.get_meta(1) is not None
    finally:
        dn.stop()
        nn.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_replicate_to_a_target_that_holds_the_replica(tmp_path, pkg):
    """Block 7 written through a pipeline A -> B, then a ``replicate`` of
    it from A to B.  The reference's B commits the block's chunk
    references again (every refcount doubles) and refuses the replica
    (``FileExistsError``: ``op_io_errors``), and A's push fails.  The
    port's B acknowledges it: A counts the block replicated, and B's
    replica and refcounts stay as they were."""
    nn = StandInNN()
    a = _dn(pkg, tmp_path, nn, "dn-a")
    b = _dn(pkg, tmp_path, nn, "dn-b")
    try:
        data = _data(7)
        assert write_ok(write_block(a.addr, 7, data, targets=[target(b)]),
                        data)
        assert b.await_xceivers(30.0)
        meta0 = b.replicas.get_meta(7)
        refs0 = _refcounts(b, 7)
        nn.command("dn-a", {"cmd": "replicate", "block_id": 7,
                            "gen_stamp": 1, "targets": [target(b)]})
        c0 = _counts(pkg)
        one_heartbeat(a)
        assert b.await_xceivers(30.0)
        got = _delta(c0, _counts(pkg), "op_io_errors", "heartbeat_failures",
                     "command_errors", "blocks_replicated")
        if pkg == "ref":
            assert got == {"op_io_errors": 1, "heartbeat_failures": 1,
                           "command_errors": 0, "blocks_replicated": 0}
            assert _refcounts(b, 7) == [2 * r for r in refs0]
        else:
            assert got == {"op_io_errors": 0, "heartbeat_failures": 0,
                           "command_errors": 0, "blocks_replicated": 1}
            assert _refcounts(b, 7) == refs0
            assert _delta(c0, _counts(pkg), "br.replicas_already_held") == \
                {"br.replicas_already_held": 1}
        meta1 = b.replicas.get_meta(7)
        assert (meta1.gen_stamp, meta1.logical_len, meta1.checksums) == \
            (meta0.gen_stamp, meta0.logical_len, meta0.checksums)
    finally:
        b.stop()
        a.stop()
        nn.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_replicate_from_a_source_without_the_replica(tmp_path, pkg):
    """A ``replicate`` of block 9 sent to a DataNode that does not hold
    it.  The reference returns and counts nothing.  The port counts
    ``replicate_source_missing`` and sends a full block report beside
    the heartbeat's periodic one."""
    nn = StandInNN()
    reports = []
    answer = nn._answer

    def counting(method, kw):
        if method == "block_report":
            reports.append([r[0] for r in kw["blocks"]])
        return answer(method, kw)
    nn._answer = counting
    dn = _dn(pkg, tmp_path, nn, "dn-a")
    try:
        nn.command("dn-a", {"cmd": "replicate", "block_id": 9,
                            "gen_stamp": 1, "targets": [
                                {"dn_id": "x", "addr": _closed_port()}]})
        c0 = _counts(pkg)
        del reports[:]
        one_heartbeat(dn)
        got = _delta(c0, _counts(pkg), "replicate_source_missing",
                     "heartbeat_failures", "command_errors",
                     "blocks_replicated")
        if pkg == "ref":
            assert got == {"replicate_source_missing": 0,
                           "heartbeat_failures": 0, "command_errors": 0,
                           "blocks_replicated": 0}
            assert reports == [[]]
        else:
            assert got == {"replicate_source_missing": 1,
                           "heartbeat_failures": 0, "command_errors": 0,
                           "blocks_replicated": 0}
            assert reports == [[], []]
    finally:
        dn.stop()
        nn.stop()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_refused_block_report_leaves_the_heartbeat_loop_running(tmp_path,
                                                                pkg):
    """A heartbeat whose reply carries an ``invalidate``, then the
    periodic full report refused (``unregistered datanode``).  Both run
    the command; the reference's loop then raises the ``RpcError`` (its
    heartbeat thread would end there), the port's counts the refusal and
    returns, and its next pass, the NameNode accepting again, reports."""
    nn = StandInNN()
    dn = _dn(pkg, tmp_path, nn, "dn-a")
    try:
        for bid in (1, 2):
            assert write_ok(write_block(dn.addr, bid, _data(bid)),
                            _data(bid))
        nn.command("dn-a", {"cmd": "invalidate", "block_ids": [2]})
        nn.refuse_reports = True
        c0 = _counts(pkg)
        if pkg == "ref":
            from hdrf_tpu.proto.rpc import RpcError
            with pytest.raises(RpcError, match="unregistered datanode"):
                one_heartbeat(dn)
        else:
            one_heartbeat(dn)
        assert dn.replicas.get_meta(2) is None
        got = _delta(c0, _counts(pkg), "block_report_failures",
                     "heartbeat_failures", "command_errors")
        assert got == {"block_report_failures": 0 if pkg == "ref" else 1,
                       "heartbeat_failures": 0, "command_errors": 0}
        if pkg == "port":
            nn.refuse_reports = False
            one_heartbeat(dn)
            assert [r[0] for r in nn.reports["dn-a"]] == [1]
    finally:
        dn.stop()
        nn.stop()

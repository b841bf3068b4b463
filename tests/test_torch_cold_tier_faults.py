"""The faults of the cold-tier command path, each pinned without timing.

A NameNode's ``replicate`` and ``stripe_demote`` commands reach a
DataNode in its heartbeat reply.  Five ways that path failed, each built
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
  sends a full block report, so the NameNode drops the location;
- two sources pushing one block to one target at once (two ``write_reduced``
  streams built here, interleaved at the need frame): the reference's
  target commits the block twice (every refcount doubled) and refuses the
  second replica; the port's runs one ingest of a block at a time
  (``BlockReceiver._one_ingest``), so the second push finds the replica
  held and is acknowledged.

One pass of a DataNode's heartbeat loop runs in the test's own thread
(``one_heartbeat``): the DataNodes are started with an hour's heartbeat
interval, so that their own heartbeat threads never tick.

The open container a demotion used to skip (NAMENODE (d)) is pinned in
tests/test_torch_ec.py (``test_block_whose_only_unstriped_container_is_open``).
"""

from __future__ import annotations

import socket
import threading
import time

import numpy as np
import pytest

from _dn_standin import (StandInNN, guard_reference_stat_race,
                         one_heartbeat, port_dn, ref_dn, target, write_block,
                         write_ok)

HOUR = 3600.0


@pytest.fixture(autouse=True)
def _reference_stat_race(monkeypatch):
    guard_reference_stat_race(monkeypatch)


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


def _ibrs_of_block(nn, dn_id: str, bid: int) -> int:
    return [ibr[0] for ibr in nn.ibrs_of(dn_id)].count(bid)


def _until(cond, timeout: float) -> None:
    t_end = time.monotonic() + timeout
    while not cond() and time.monotonic() < t_end:
        time.sleep(0.05)


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


class _Push:
    """One ``write_reduced`` push of a block held by ``src`` to ``dst``,
    as ``BlockReceiver.push_reduced`` sends it, split at the need frame
    so that a test can interleave two pushes."""

    def __init__(self, src, dst, bid: int) -> None:
        from hdrf_tpu_torch.proto import datatransfer as dt

        self.dt, self.src, self.bid = dt, src, bid
        self.entry = src.index.get_block(bid)
        meta = src.replicas.get_meta(bid)
        self.sock = socket.create_connection(tuple(dst.addr), timeout=60.0)
        dt.send_op(self.sock, "write_reduced", block_id=bid,
                   gen_stamp=meta.gen_stamp, scheme=meta.scheme,
                   logical_len=meta.logical_len,
                   checksums=list(meta.checksums),
                   checksum_chunk=src.checksum_chunk,
                   token=src.tokens.mint(bid, "w"),
                   hashes=self.entry.hashes, targets=[])
        self.need = None
        self.ack = None

    def read_need(self) -> None:
        from hdrf_tpu_torch.proto.rpc import recv_frame

        self.need = list(recv_frame(self.sock)["need"])

    def finish(self) -> None:
        """Send the needed chunks; ``ack`` is the target's status (None
        if it closed the connection)."""
        from hdrf_tpu_torch.proto.rpc import recv_frame

        uniq = list(dict.fromkeys(self.entry.hashes))
        hashes = [uniq[i] for i in self.need]
        locs = self.src.index.lookup_chunks(hashes)
        chunks = self.src.containers.read_chunks(
            [(locs[h].container_id, locs[h].offset, locs[h].length)
             for h in hashes])
        try:
            for seq, chunk in enumerate(chunks):
                self.dt.write_packet(self.sock, seq, chunk)
            self.dt.write_packet(self.sock, len(chunks), b"", last=True)
            recv_frame(self.sock)
            self.ack = self.dt.read_ack(self.sock)[1]
        except (ConnectionError, OSError):
            self.ack = None
        finally:
            self.sock.close()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_two_concurrent_pushes_of_one_block(tmp_path, pkg):
    """Two sources push block 7 (same generation, same bytes) to one
    target at once: the second push starts while the first is between
    its need frame and its chunks.  The reference's target answers both
    need frames with every chunk, commits the block twice (each refcount
    doubled) and refuses the second replica (``FileExistsError``:
    ``op_io_errors``).  The port's target holds the second push until the
    first has stored the replica, then answers it an empty need list and
    acknowledges it (``replicas_already_held``): one commit, refcounts as
    the sources have them, both pushes acknowledged."""
    nn = StandInNN()
    a1 = _dn(pkg, tmp_path, nn, "dn-a1")
    a2 = _dn(pkg, tmp_path, nn, "dn-a2")
    b = _dn(pkg, tmp_path, nn, "dn-b")
    try:
        data = _data(7)
        for src in (a1, a2):
            assert write_ok(write_block(src.addr, 7, data), data)
        refs = _refcounts(a1, 7)
        assert refs == _refcounts(a2, 7)
        c0 = _counts(pkg)
        p1 = _Push(a1, b, 7)
        p1.read_need()
        p2 = _Push(a2, b, 7)
        asked, p1_done = threading.Event(), threading.Event()

        def second():
            p2.read_need()
            asked.set()
            p1_done.wait(60.0)   # p2's chunks go after p1's ack
            p2.finish()
        t2 = threading.Thread(target=second, daemon=True)
        t2.start()
        # the reference answers p2's need at once, the port only after p1
        assert asked.wait(5.0 if pkg == "ref" else 1.0) is (pkg == "ref")
        p1.finish()
        p1_done.set()
        t2.join(timeout=60.0)
        assert not t2.is_alive()
        assert b.await_xceivers(30.0)
        uniq = len(dict.fromkeys(a1.index.get_block(7).hashes))
        assert p1.need == list(range(uniq)) and p1.ack == 0
        got = _delta(c0, _counts(pkg), "op_io_errors",
                     "br.replicas_already_held")
        if pkg == "ref":
            assert p2.need == p1.need and p2.ack is None
            assert got == {"op_io_errors": 1, "br.replicas_already_held": 0}
            assert _refcounts(b, 7) == [2 * r for r in refs]
        else:
            assert p2.need == [] and p2.ack == 0
            assert got == {"op_io_errors": 0, "br.replicas_already_held": 1}
            assert _refcounts(b, 7) == refs
        meta = b.replicas.get_meta(7)
        assert (meta.gen_stamp, meta.logical_len) == (1, len(data))
        # IBRs go out on the DataNode's own thread, after the acks
        want = 1 if pkg == "ref" else 2
        _until(lambda: _ibrs_of_block(nn, "dn-b", 7) >= want, 30.0)
        assert _ibrs_of_block(nn, "dn-b", 7) == want
    finally:
        for dn in (b, a2, a1):
            dn.stop()
        nn.stop()

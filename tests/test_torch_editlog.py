"""The port's edit log, journals and codec against the reference.

- the codec (proto/rpc.packb / unpackb) packs every kind of value an
  edit record or fsimage holds as ``msgpack.packb`` does, and decodes as
  ``msgpack.unpackb`` does with ``use_list`` True and False;
- ``EditLog`` (group commit, checkpoint) writes byte-identical
  ``edits.wal`` and ``fsimage`` files, and each package loads the other's;
- ``LocalJournal`` epochs fence across packages (one shared directory);
- ``JournalNode`` quorums of either package hold byte-identical files and
  serve the other package's ``QuorumJournal``, recovery included.
"""

from __future__ import annotations

import os
import random

import msgpack
import pytest

from hdrf_tpu.server import editlog as ref_editlog
from hdrf_tpu.server import journal as ref_journal
from hdrf_tpu_torch.proto.rpc import packb, unpackb
from hdrf_tpu_torch.server import editlog as port_editlog
from hdrf_tpu_torch.server import journal as port_journal

T = 1_700_000_123.456789

# one value of every kind an edit record or the fsimage carries
RECORDS = {
    "create": ["create", "/a/f", 3, "dedup_lz4", T, None, "hdfs", 0o644],
    "block_ids": ["add_block", "/a/f", (7 << 48) | 123456, 9,
                  ["dn-0", "dn-1"]],
    "complete": ["complete", "/a/f", {1: 1024, (3 << 48) | 2: -1,
                                      2 ** 40: 0}, T],
    "xattr_bytes": ["setxattr", "/z/f", "raw.hdrf.edek",
                    packb(["zk", os.urandom(12), os.urandom(48)])],
    "ezkey": ["ezkey", "zk", bytes(range(32))],
    "attrs": ["setacl", "/d", ["alice", "staff", 0o750, [["user", "bob", 5]],
                               [], {"user.x": b"\x00"}, "cold"]],
    "neg_float": ["set_times", "/t", -1.0, 0.1 + 0.2, float(2 ** 60)],
    "nested": ["ec_demote", 5, "dn-2",
               {"7": {"holders": [["dn-1", "h1", 1001]], "k": 6, "m": 3,
                      "stripe_len": 1 << 20, "length": (1 << 25) + 1}}],
    "ints": ["x", 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
             2 ** 32, 2 ** 63 - 1, -1, -32, -33, -128, -129, -32768,
             -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
    "sizes": ["s" * 31, "s" * 32, "s" * 255, "s" * 256, "s" * 70000,
              b"b" * 255, b"b" * 256, b"b" * 70000, list(range(15)),
              list(range(16)), list(range(70000)),
              {str(i): i for i in range(15)}, {i: i for i in range(16)}],
    "unicode": ["mkdir", "/ü/日本/🙂", True, False, None],
}


@pytest.mark.parametrize("name", sorted(RECORDS))
@pytest.mark.parametrize("use_list", [True, False])
def test_codec_matches_msgpack(name, use_list):
    rec = RECORDS[name]
    raw = packb(rec)
    assert raw == msgpack.packb(rec)
    assert unpackb(raw, use_list=use_list) == msgpack.unpackb(
        raw, raw=False, use_list=use_list, strict_map_key=False)
    got = unpackb(raw, use_list=use_list)
    ref = msgpack.unpackb(raw, raw=False, use_list=use_list,
                          strict_map_key=False)
    assert type(got) is type(ref)


def _script(seed: int, n: int) -> list[list]:
    rng = random.Random(seed)
    out = []
    for i in range(n):
        out.append(["op", f"/p{i}", rng.randrange(1 << 50), rng.random(),
                    {rng.randrange(1 << 40): rng.randrange(-1, 1 << 20)},
                    rng.randbytes(rng.randrange(40))])
    return out


def _drive(mod, d: str, recs: list, snap: dict, every: int = 1000) -> list:
    """Open, append in group-commit rounds, checkpoint half way, close;
    returns the records applied by a fresh replay of the directory."""
    log = mod.EditLog(d, checkpoint_every=every)
    log.claim_epoch()
    log.replay(lambda r: None)
    log.open_for_append(lambda: snap)
    half = len(recs) // 2
    for lo in range(0, len(recs), 5):
        seqs = [log.append_async(r) for r in recs[lo:lo + 5]]
        log.sync(seqs[-1])
        if lo <= half < lo + 5:
            log.checkpoint()
    log.close()
    return _replay(mod, d)


def _replay(mod, d: str) -> tuple:
    log = mod.EditLog(d)
    img = log.load_image()
    got = []
    log.claim_epoch()
    log.replay(got.append)
    log.close()
    return img, got


def test_editlog_files_match_reference(tmp_path):
    """Group commit + checkpoint: the same records give byte-identical
    edits.wal and fsimage; each package replays the other's directory."""
    recs = _script(1, 40)
    snap = {"ns": {"a": ["f", 3, "dedup_lz4", [1, 2], True, T, None,
                         ["hdfs", "supergroup", 420, [], [], {}, None], 4]},
            "next_block_id": (2 << 48) | 5, "lengths": {1: 1024, 2: -1}}
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    r = _drive(ref_editlog, ref_dir, recs, snap)
    p = _drive(port_editlog, port_dir, recs, snap)
    assert r == p
    for name in ("edits.wal", "fsimage", "epoch"):
        with open(os.path.join(ref_dir, name), "rb") as a, \
                open(os.path.join(port_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    # cross replay: each package reads the other's files
    assert _replay(port_editlog, ref_dir)[1] == _replay(ref_editlog,
                                                        port_dir)[1]
    img, tail = _replay(port_editlog, ref_dir)
    assert img == snap and tail == recs[25:]   # image covers 5 rounds


def test_local_journal_fences_across_packages(tmp_path):
    """Two writers on one shared directory: the later epoch claim (by
    either package) fences the other's appends."""
    d = str(tmp_path / "shared")
    port_log = port_editlog.EditLog(d)
    port_log.claim_epoch()
    port_log.replay(lambda r: None)
    port_log.open_for_append(lambda: None)
    port_log.append(["op", 1])
    ref_log = ref_editlog.EditLog(d)
    ref_log.claim_epoch()
    with pytest.raises(port_journal.FencedError):
        port_log.append(["op", 2])
    got = []
    ref_log.replay(got.append)
    assert got == [["op", 1]]
    ref_log.open_for_append(lambda: None)
    ref_log.append(["op", 3])
    port_log2 = port_editlog.EditLog(d)
    port_log2.claim_epoch()
    with pytest.raises(ref_journal.FencedError):
        ref_log.append(["op", 4])
    got = []
    port_log2.replay(got.append)
    assert got == [["op", 1], ["op", 3]]
    for log in (port_log, ref_log, port_log2):
        log.close()


def _payload(seq: int, tag: str = "op") -> bytes:
    return msgpack.packb([seq, tag, f"/p{seq}", T])


@pytest.fixture()
def quorums(tmp_path):
    """Three reference and three port JournalNodes."""
    made = {"ref": [ref_journal.JournalNode(str(tmp_path / f"r{i}")).start()
                    for i in range(3)],
            "port": [port_journal.JournalNode(str(tmp_path / f"p{i}"))
                     .start() for i in range(3)]}
    yield made
    for nodes in made.values():
        for n in nodes:
            try:
                n.stop()
            except Exception:  # noqa: BLE001
                pass


def _jn_files(jn) -> dict:
    out = {}
    for f in sorted(os.listdir(jn._dir)):
        with open(os.path.join(jn._dir, f), "rb") as fh:
            data = fh.read()
        if f == "VERSION":
            data = b"\n".join(ln for ln in data.split(b"\n")
                              if not ln.startswith(b"ctime"))
        out[f] = data
    return out


def test_journal_nodes_match_reference(quorums):
    """The same writer script over each package's quorum: equal reads,
    byte-identical JournalNode files (records, epochs, purge floor)."""
    got = {}
    for side, mod in (("ref", ref_journal), ("port", port_journal)):
        jns = quorums[side]
        q = mod.QuorumJournal([n.addr for n in jns])
        q.claim_epoch()
        q.append_frames([_payload(1), _payload(2)], first_seq=1)
        q.append_frames([_payload(3)], first_seq=3)
        q.purge(1)
        q.append_frames([_payload(4, "x")], first_seq=4)
        got[side] = (q.read(1), q.read(2, readonly=True))
        with pytest.raises(mod.JournalGapError):
            q.read(0)
        q.close()
    assert got["ref"] == got["port"]
    for a, b in zip(quorums["ref"], quorums["port"]):
        assert _jn_files(a) == _jn_files(b)


@pytest.mark.parametrize("writer,nodes", [("port", "ref"), ("ref", "port"),
                                          ("port", "mixed")])
def test_quorum_journal_across_packages(quorums, writer, nodes):
    """One package's QuorumJournal over the other's JournalNodes (or a
    mix): appends, a node down, epoch fencing, and segment recovery that
    re-journals the longest log."""
    wmod = {"ref": ref_journal, "port": port_journal}[writer]
    jns = (quorums[nodes] if nodes != "mixed"
           else [quorums["ref"][0], quorums["port"][1], quorums["ref"][2]])
    addrs = [n.addr for n in jns]
    old = wmod.QuorumJournal(addrs, timeout=2.0)
    old.claim_epoch()
    old.append_frames([_payload(1)], first_seq=1)
    # the old writer got seq 2 onto ONE node before dying
    jns[0].rpc_jn_journal(epoch=old._epoch, first_seq=2,
                          payloads=[_payload(2, "old")])
    other = port_journal if wmod is ref_journal else ref_journal
    new = other.QuorumJournal(addrs, timeout=2.0)
    new.claim_epoch()           # adopts the longest log, re-journals seq 2
    with pytest.raises(wmod.FencedError):
        old.append_frames([_payload(3)], first_seq=3)
    new.append_frames([_payload(3, "new")], first_seq=3)
    want = [_payload(1), _payload(2, "old"), _payload(3, "new")]
    assert new.read(0) == want
    for jn in jns:
        recs = jn.rpc_jn_read(after_seq=0)["records"]
        assert [bytes(p) for _, p in recs] == want
    old.close()
    new.close()

"""The port's EC cold tier against the reference's, on the CPU.

Modules: hdrf_tpu_torch/storage/stripe_store.py, server/coded_exchange.py,
server/ec_tier.py, utils/retry.py, utils/throttler.py, each held against
its hdrf_tpu twin on the same seeded inputs, tolerance zero.

``EcTier`` is driven as the reference's DataNode drives it, through the
stand-in of tests/_ec_standin.py (an owner and two peers, RS(6,3), stripe
slot i on holder i mod 3, peer ops over socket pairs in each package's
own wire codec).  The owner's containers and chunk index come from the
``dedup_lz4`` scheme of each package (64 KiB containers, the host lz4 on
both sides, as tests/test_torch_scheme.py), so both start from
byte-identical sealed files.  Both then demote every block, lose holder
p1 (every stripe it holds: data 1 and 4, parity 7), read every block
whole and ranged, repair through the coded exchange; lose the owner's
stripes 0, 3 and 6, read again, and repair by the classic full gather.
Stripe files, the WAL, the NameNode reports and the ``ec`` /
``coded_exchange`` counters must be equal, and each package reads and
repairs the other's state.  The reference runs RS through JAX on the
CPU; the port through the plain version (``backend="cpu"``).

The hedge timer is set to 30 s on both sides
(``mirror_hedge_floor_s``) and the owner's breakers, made fresh before
each round, reset after an hour instead of 5 s, so that on a loaded
machine neither a timed hedge nor a half-open probe fires in one run and
not the other: hedges still fire on a failed leg, which every degraded
gather here has, and breakers still open.

    python -m pytest tests/test_torch_ec.py -q
"""

import os
import random

import numpy as np
import pytest
import torch

import _ec_standin as standin
from hdrf_tpu.config import ReductionConfig as RefConfig
from hdrf_tpu.index.chunk_index import ChunkIndex as RefIndex
from hdrf_tpu.reduction import scheme as ref_schemes
from hdrf_tpu.reduction.scheme import ReductionContext as RefCtx
from hdrf_tpu.server import coded_exchange as ref_cx
from hdrf_tpu.storage import stripe_store as ref_ss
from hdrf_tpu.storage.container_store import ContainerStore as RefStore
from hdrf_tpu.utils import metrics as ref_metrics
from hdrf_tpu.utils import qos as ref_qos
from hdrf_tpu.utils import retry as ref_retry
from hdrf_tpu.utils import throttler as ref_throttler
from hdrf_tpu_torch.config import ReductionConfig
from hdrf_tpu_torch.index.chunk_index import ChunkIndex
from hdrf_tpu_torch.reduction import scheme as schemes
from hdrf_tpu_torch.reduction.scheme import ReductionContext
from hdrf_tpu_torch.server import coded_exchange as cx
from hdrf_tpu_torch.storage import stripe_store as ss
from hdrf_tpu_torch.storage.container_store import ContainerStore
from hdrf_tpu_torch.utils import metrics
from hdrf_tpu_torch.utils import qos, retry, throttler

CONTAINER = 1 << 16
K, M = standin.EC_K, standin.EC_M
P1_SLOTS = [1, 4, 7]      # holder p1's stripes (slot i on holder i % 3)
OWNER_SLOTS = [0, 3, 6]
KINDS = {
    "port": (ReductionConfig, ContainerStore, ChunkIndex, ReductionContext,
             schemes, metrics, retry, "cpu"),
    "ref": (RefConfig, RefStore, RefIndex, RefCtx, ref_schemes, ref_metrics,
            ref_retry, "native"),
}
COUNTED = ("ec", "coded_exchange")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks(seed: int) -> dict:
    rng = random.Random(seed)
    a = rng.randbytes(300_000)
    unit = rng.randbytes(30_000)
    return {1: a, 2: unit * 8, 3: a[12_345:250_000] + rng.randbytes(80_000),
            4: bytes(rng.randrange(97, 123) for _ in range(120_000))}


def _counters(mx) -> dict:
    return {name: dict(mx.registry(name).snapshot()["counters"])
            for name in COUNTED}


def _delta(c0: dict, c1: dict) -> dict:
    return {name: {k: v - c0[name].get(k, 0) for k, v in c1[name].items()
                   if v != c0[name].get(k, 0)} for name in c1}


def _files(root: str, sub: str) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        if os.path.basename(dirpath) != sub:
            continue
        for n in sorted(names):
            with open(os.path.join(dirpath, n), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, n), root)] = f.read()
    return out


class Node:
    """One package's owner context plus its stand-in cluster."""

    def __init__(self, kind: str, root: str, fresh: bool = True):
        cfg_cls, store_cls, index_cls, ctx_cls, sch, mx, rt, backend = \
            KINDS[kind]
        self.kind, self.root, self.scheme, self.mx, self.rt = \
            kind, root, sch.get("dedup_lz4"), mx, rt
        cfg = cfg_cls()
        cfg.cdc.mask_bits, cfg.cdc.min_chunk, cfg.cdc.max_chunk = 10, 256, 4096
        cfg.backend = backend
        cfg.mirror_hedge_floor_s = 30.0
        self.ctx = ctx_cls(
            config=cfg,
            containers=store_cls(os.path.join(root, "data", "containers"),
                                 container_size=CONTAINER, lanes=2),
            index=index_cls(os.path.join(root, "data", "index")),
            backend=backend)
        if fresh:
            for bid, data in _blocks(0).items():
                assert self.scheme.reduce(bid, data, self.ctx) == b""
            self.ctx.containers.flush_open(
                on_seal=self.ctx.index.seal_container)
        self.owner, self.peers, self.nn = standin.cluster(
            standin.modules(kind), root, self.ctx.containers, self.ctx.index,
            cfg, lambda d: store_cls(d, container_size=CONTAINER),
            index_cls)
        self.holders = [self.owner, *self.peers]

    def close(self):
        for h in self.holders:
            h.index.close()

    def striped(self) -> dict:
        return self.ctx.index.stripe_manifests()

    def lose(self, holder, slots) -> dict:
        """Unlink the holder's stripe files of ``slots`` for every striped
        container; drop the store's decoded-payload cache."""
        lost = {}
        for cid in self.striped():
            for s in slots:
                p = holder.ec.store._path(self.owner.dn_id, cid, s)
                with open(p, "rb") as f:
                    lost[(cid, s)] = f.read()
                os.unlink(p)
        with self.ctx.containers._cache_lock:
            self.ctx.containers._cache.clear()
        # fresh breakers that stay open once opened: a 5 s reset would let
        # a slow round probe a dead holder again in one run and not the
        # other, and the counters are compared
        self.rt.reset_breakers()
        for h in self.peers:
            self.rt.breaker(f"{self.owner.dn_id}->{h.dn_id}", reset_s=3600.0)
        return lost

    def read_all(self) -> bool:
        ok = True
        for bid, data in _blocks(0).items():
            got = self.scheme.reconstruct(bid, b"", len(data), self.ctx)
            ok &= got == data
            for off, ln in ((7, 4099), (len(data) - 3001, -1), (65_535, 1)):
                end = len(data) if ln < 0 else off + ln
                got = self.scheme.reconstruct(bid, b"", len(data), self.ctx,
                                              off, ln)
                ok &= got == data[off:end]
        return ok

    def repair(self, slots, target) -> None:
        for cid in sorted(self.striped()):
            self.owner.ec.repair({"cid": cid, "missing": list(slots),
                                  "targets": [target.target] * len(slots),
                                  "block_id": None})


def _flow(kind: str, root: str) -> dict:
    """Demote, lose p1, read, coded repair, lose the owner's stripes,
    read, classic repair; what each step left behind."""
    node = Node(kind, root)
    obs: dict = {}
    try:
        c0 = _counters(node.mx)
        tg = standin.targets(node.owner, node.peers)
        for bid in _blocks(0):
            node.owner.ec.demote({"block_id": bid, "k": K, "m": M,
                                  "targets": tg})
        obs["sealed_left"] = [
            cid for cid in node.ctx.containers.container_ids()
            if node.ctx.containers.sealed_file_bytes(cid) is not None]
        obs["striped"] = sorted(node.striped())
        obs["stripes"] = _files(root, "stripes")
        obs["wal_demote"] = _files(root, "index")
        obs["nn"] = list(node.nn.calls)
        obs["report"] = node.owner.ec.report()
        obs["physical"] = sum(h.ec.store.physical_bytes()
                              for h in node.holders)
        c1 = _counters(node.mx)
        lost1 = node.lose(node.peers[0], P1_SLOTS)
        obs["read_p1_lost"] = node.read_all()
        c2 = _counters(node.mx)
        node.repair(P1_SLOTS, node.peers[0])
        obs["repaired_p1"] = all(
            open(node.peers[0].ec.store._path(node.owner.dn_id, cid, s),
                 "rb").read() == data for (cid, s), data in lost1.items())
        c3 = _counters(node.mx)
        lost2 = node.lose(node.owner, OWNER_SLOTS)
        obs["read_owner_lost"] = node.read_all()
        node.ctx.config.ec_coded_repair = False
        c4 = _counters(node.mx)
        node.repair(OWNER_SLOTS, node.owner)
        obs["repaired_owner"] = all(
            open(node.owner.ec.store._path(node.owner.dn_id, cid, s),
                 "rb").read() == data for (cid, s), data in lost2.items())
        c5 = _counters(node.mx)
        obs["stripes_final"] = _files(root, "stripes")
        obs["wal_final"] = _files(root, "index")
        obs["nn_final"] = list(node.nn.calls)
        obs["counters"] = [_delta(a, b) for a, b in
                           ((c0, c1), (c1, c2), (c2, c3), (c3, c4), (c4, c5))]
        obs["manifests"] = node.striped()
        # a deleted striped container drops its local stripes and its
        # manifest (an ``unstripe`` WAL record) through the chained hook
        cid = min(obs["manifests"])
        node.ctx.containers.delete_container(cid)
        obs["deleted"] = (cid, cid in node.striped(),
                          node.owner.ec.store.local_indices(
                              node.owner.dn_id, cid))
        obs["wal_unstripe"] = _files(root, "index")
    finally:
        node.close()
    return obs


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    return {kind: _flow(kind, str(tmp_path_factory.mktemp(kind)))
            for kind in ("ref", "port")}


# ------------------------------------------------------------- the tier

def test_demote_stripes_every_sealed_container(flows):
    for kind in ("ref", "port"):
        f = flows[kind]
        assert f["sealed_left"] == [], kind
        assert len(f["striped"]) >= 5, kind
        assert len(f["stripes"]) == (K + M) * len(f["striped"])
        rep = f["report"]
        assert rep["striped_containers"] == len(f["striped"])
        ratio = f["physical"] / rep["stripe_logical_bytes"]
        assert 1.5 <= ratio < 1.5 + (K + M) * len(f["striped"]) \
            / rep["stripe_logical_bytes"]


def test_stripe_files_identical(flows):
    assert flows["port"]["stripes"] == flows["ref"]["stripes"]
    assert flows["port"]["stripes_final"] == flows["port"]["stripes"]
    assert flows["ref"]["stripes_final"] == flows["ref"]["stripes"]


def test_wal_records_identical(flows):
    assert flows["port"]["wal_demote"] == flows["ref"]["wal_demote"]
    assert flows["port"]["wal_final"] == flows["ref"]["wal_final"]
    assert flows["port"]["manifests"] == flows["ref"]["manifests"]


def test_deleted_container_unstripes_identically(flows):
    assert flows["port"]["deleted"] == flows["ref"]["deleted"]
    _, still, local = flows["port"]["deleted"]
    assert not still and local == []
    assert flows["port"]["wal_unstripe"] == flows["ref"]["wal_unstripe"]
    assert flows["port"]["wal_unstripe"] != flows["port"]["wal_final"]


def test_stripe_complete_reports_equal(flows):
    assert flows["port"]["nn"] == flows["ref"]["nn"]
    assert flows["port"]["nn_final"] == flows["ref"]["nn_final"]
    assert flows["port"]["report"] == flows["ref"]["report"]
    assert all(m == "stripe_complete" for m, _ in flows["port"]["nn_final"])


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_block_whose_containers_another_demotion_striped(tmp_path, kind):
    """Two blocks of the same bytes share every sealed container.  After
    the first block's demotion stripes them, the second's has nothing
    left to stripe: the reference never reports it (the NameNode commands
    it again at every pending timeout and it stays fully replicated);
    the port reports it demoted with no new groups (ROADMAP Queue C).
    Both read back equal from the stripes."""
    node = Node(kind, str(tmp_path), fresh=False)
    try:
        data = random.Random(5).randbytes(200_000)
        for bid in (101, 102):
            assert node.scheme.reduce(bid, data, node.ctx) == b""
        node.ctx.containers.flush_open(on_seal=node.ctx.index.seal_container)
        tg = standin.targets(node.owner, node.peers)
        for bid in (101, 102):
            node.owner.ec.demote({"block_id": bid, "k": K, "m": M,
                                  "targets": tg})
        reports = [(kw["block_id"], len(kw["containers"]))
                   for method, kw in node.nn.calls
                   if method == "stripe_complete"]
        assert reports[0][0] == 101 and reports[0][1] >= 1
        assert reports[1:] == ([] if kind == "ref" else [(102, 0)])
        for bid in (101, 102):
            assert node.scheme.reconstruct(bid, b"", len(data),
                                           node.ctx) == data
    finally:
        node.close()


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_block_with_a_container_still_open_is_left_unreported(tmp_path,
                                                              kind):
    """A block whose chunks lie in a container another block's demotion
    striped and in a container still open: the reference has nothing to
    stripe and leaves it unreported until that container seals, and the
    next demotion then stripes it and reports the block.  The port seals
    the open container at the first demotion (the block is cold) and
    reports the block at once (ROADMAP Queue C).  Both read back
    equal."""
    node = Node(kind, str(tmp_path), fresh=False)
    try:
        rnd = random.Random(6)
        first = rnd.randbytes(200_000)
        data = {101: first, 102: first + rnd.randbytes(3_000)}
        ctx = node.ctx
        assert node.scheme.reduce(101, data[101], ctx) == b""
        ctx.containers.flush_open(on_seal=ctx.index.seal_container)
        assert node.scheme.reduce(102, data[102], ctx) == b""  # tail: open
        tg = standin.targets(node.owner, node.peers)
        ec = node.mx.registry("ec")

        def demote(bid):
            node.owner.ec.demote({"block_id": bid, "k": K, "m": M,
                                  "targets": tg})
            return [(kw["block_id"], len(kw["containers"]))
                    for method, kw in node.nn.calls
                    if method == "stripe_complete"]
        demote(101)
        sealed0 = ec.counter("demote_open_sealed")
        reports = demote(102)
        if kind == "ref":
            assert [b for b, _ in reports] == [101]
            ctx.containers.flush_open(on_seal=ctx.index.seal_container)
            reports = demote(102)
        else:
            assert ec.counter("demote_open_sealed") - sealed0 == 1
        assert [b for b, _ in reports] == [101, 102] and reports[1][1] >= 1
        for bid, want in data.items():
            assert node.scheme.reconstruct(bid, b"", len(want), ctx) == want
    finally:
        node.close()


@pytest.mark.parametrize("kind", ["ref", "port"])
def test_block_whose_only_unstriped_container_is_open(tmp_path, kind):
    """Block 1 fills and seals container 0 and leaves its tail in the
    open container 1; block 2 is block 1's first part plus new bytes, so
    its chunks lie in container 0, the open container 1 and the other
    lane's open container.  Block 1's demotion stripes container 0.
    Block 2 then has nothing sealed left to stripe: the reference never
    reports it, however often the NameNode commands it (the smoke's
    NAMENODE (d) timeout: the third block re-commanded at every pending
    timeout on an idle DataNode).  The port seals both open containers
    and reports block 2 with their groups.  Both read back equal."""
    node = Node(kind, str(tmp_path), fresh=False)
    try:
        rnd = random.Random(7)
        one = rnd.randbytes(100_000)
        data = {201: one, 202: one[:90_000] + rnd.randbytes(20_000)}
        ctx = node.ctx
        for bid, blob in data.items():
            assert node.scheme.reduce(bid, blob, ctx) == b""
        cids = {bid: sorted({ctx.index.chunk_location(h).container_id
                             for h in ctx.index.get_block(bid).hashes})
                for bid in data}
        assert cids[201] == [0, 1] and cids[202] == [0, 1, 2]
        assert ctx.containers.sealed_file_bytes(0) is not None
        assert all(ctx.containers.sealed_file_bytes(c) is None
                   for c in (1, 2))
        tg = standin.targets(node.owner, node.peers)
        ec = node.mx.registry("ec")
        sealed0 = ec.counter("demote_open_sealed")

        def demote(bid):
            node.owner.ec.demote({"block_id": bid, "k": K, "m": M,
                                  "targets": tg})
            return [(kw["block_id"], sorted(int(g["cid"])
                                            for g in kw["containers"]))
                    for method, kw in node.nn.calls
                    if method == "stripe_complete"]
        if kind == "ref":
            assert demote(201) == [(201, [0])]
            for _ in range(3):
                assert demote(202) == [(201, [0])]
            assert sorted(node.striped()) == [0]
        else:
            assert demote(201) == [(201, [0, 1])]
            assert demote(202) == [(201, [0, 1]), (202, [2])]
            assert ec.counter("demote_open_sealed") - sealed0 == 2
            assert sorted(node.striped()) == [0, 1, 2]
        for bid, want in data.items():
            assert node.scheme.reconstruct(bid, b"", len(want), ctx) == want
    finally:
        node.close()


def test_degraded_reads_bit_identical(flows):
    for kind in ("ref", "port"):
        assert flows[kind]["read_p1_lost"], kind
        assert flows[kind]["read_owner_lost"], kind


def test_repairs_restore_stripes(flows):
    for kind in ("ref", "port"):
        assert flows[kind]["repaired_p1"], kind
        assert flows[kind]["repaired_owner"], kind


@pytest.mark.parametrize("step", ["demote", "read_p1_lost", "coded_repair",
                                  "read_owner_lost", "classic_repair"])
def test_counters_equal(flows, step):
    i = ["demote", "read_p1_lost", "coded_repair", "read_owner_lost",
         "classic_repair"].index(step)
    port, ref = flows["port"]["counters"][i], flows["ref"]["counters"][i]
    assert port == ref
    ec = port["ec"]
    want = {"demote": "containers_demoted", "read_p1_lost": "degraded_reads",
            "coded_repair": "coded_repairs",
            "read_owner_lost": "degraded_reads",
            "classic_repair": "stripes_repaired"}[step]
    assert ec.get(want, 0) > 0
    if step == "classic_repair":
        assert ec.get("coded_repairs", 0) == 0


def _cross(reader: str, root: str) -> bool:
    """``reader``'s tier over the other package's directory: lose p1,
    read every block, coded repair; lose the owner's stripes, read,
    classic repair; equal reads and the same stripe files."""
    before = _files(root, "stripes")
    node = Node(reader, root, fresh=False)
    try:
        assert sorted(node.striped()) == sorted(
            int(c) for c in node.owner.ec.report()["manifests"])
        node.lose(node.peers[0], P1_SLOTS)
        ok = node.read_all()
        node.repair(P1_SLOTS, node.peers[0])
        node.lose(node.owner, OWNER_SLOTS)
        ok &= node.read_all()
        node.ctx.config.ec_coded_repair = False
        node.repair(OWNER_SLOTS, node.owner)
    finally:
        node.close()
    return ok and _files(root, "stripes") == before


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_reads_and_repairs_the_others_state(tmp_path, writer,
                                                         reader):
    node = Node(writer, str(tmp_path))
    try:
        tg = standin.targets(node.owner, node.peers)
        for bid in _blocks(0):
            node.owner.ec.demote({"block_id": bid, "k": K, "m": M,
                                  "targets": tg})
    finally:
        node.close()
    assert _cross(reader, str(tmp_path))


# --------------------------------------------------------- stripe store

LENGTHS = [0, 1, 5, 6, 7, 12_345, 65_536 + 3]


@pytest.mark.parametrize("n", LENGTHS)
def test_encode_container_identical(n):
    blob = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    stripes, man = ss.encode_container(blob, K, M, device="cpu")
    r_stripes, r_man = ref_ss.encode_container(blob, K, M)
    assert stripes == r_stripes and man == r_man
    assert man["stripe_len"] == max(1, -(-n // K))
    assert ss.reconstruct_container(dict(enumerate(stripes)), man,
                                    device="cpu") == blob


@pytest.mark.parametrize("lost", [(), (0,), (5, 8), (0, 1, 2), (3, 6, 7)])
@pytest.mark.parametrize("n", [7, 12_345])
def test_reconstruct_container_identical(n, lost):
    blob = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    stripes, man = ss.encode_container(blob, K, M, device="cpu")
    have = {i: s for i, s in enumerate(stripes) if i not in lost}
    c0 = metrics.registry("ec").counter("degraded_reads")
    r0 = ref_metrics.registry("ec").counter("degraded_reads")
    assert ss.reconstruct_container(have, man, device="cpu") == blob
    assert ref_ss.reconstruct_container(have, man) == blob
    assert (metrics.registry("ec").counter("degraded_reads") - c0
            == ref_metrics.registry("ec").counter("degraded_reads") - r0
            == int(any(i < K for i in lost)))
    want = list(lost) or [0]
    got = ss.reconstruct_container(have if lost else dict(list(
        have.items())[1:]), man, want=want, device="cpu")
    assert got == {i: stripes[i] for i in want}


def test_corrupt_stripe_is_an_erasure():
    blob = np.random.default_rng(3).integers(0, 256, 5000,
                                             dtype=np.uint8).tobytes()
    stripes, man = ss.encode_container(blob, K, M, device="cpu")
    bad = dict(enumerate(stripes))
    bad[2] = bytes([bad[2][0] ^ 1]) + bad[2][1:]
    bad[4] = bad[4][:-1]
    c0 = metrics.registry("ec").counter("stripe_crc_errors")
    assert ss.reconstruct_container(bad, man, device="cpu") == blob
    assert ref_ss.reconstruct_container(bad, man) == blob
    assert metrics.registry("ec").counter("stripe_crc_errors") - c0 == 2
    del bad[0], bad[1]
    with pytest.raises(ss.StripeCorrupt):
        ss.reconstruct_container(bad, man, device="cpu")
    with pytest.raises(ref_ss.StripeCorrupt):
        ref_ss.reconstruct_container(bad, man)


def test_stripe_store_files_identical(tmp_path):
    stores = {"port": ss.StripeStore(str(tmp_path / "port")),
              "ref": ref_ss.StripeStore(str(tmp_path / "ref"))}
    rng = np.random.default_rng(4)
    seen = {}
    for kind, st in stores.items():
        for owner, cid, idx in (("dn-a", 1, 0), ("dn-a", 1, 7),
                                ("dn-b", 1, 3), ("dn-a", 2, 8)):
            data = rng.integers(0, 256, 100 + idx, dtype=np.uint8).tobytes()
            st.put_stripe(owner, cid, idx, data,
                          crc=ss.native.crc32c(data))
        with pytest.raises((ss.StripeCorrupt, ref_ss.StripeCorrupt)):
            st.put_stripe("dn-a", 3, 0, b"xyz", crc=1)
        seen[kind] = (st.local_indices("dn-a", 1), st.has_stripe("dn-b", 1, 3),
                      list(st.iter_stripes()), st.physical_bytes(),
                      st.stats(), st.quarantine("dn-a", 1, 7),
                      st.local_indices("dn-a", 1),
                      st.delete_stripes("dn-a", 2),
                      st.stats(),
                      sorted(os.listdir(tmp_path / kind)))
        rng = np.random.default_rng(4)
    assert seen["port"] == seen["ref"]
    for name in seen["port"][-1]:
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "ref" / name).read_bytes()


# ------------------------------------------------------- coded exchange

def _payloads():
    rng = np.random.default_rng(5)
    return [b"", b"a" * 63, b"a" * 64, rng.integers(0, 256, 4096,
                                                    dtype=np.uint8).tobytes(),
            bytes(5000), b"abcd" * 3000,
            rng.integers(97, 100, 700, dtype=np.uint8).tobytes()]


def _pack_script(mod, mx) -> list:
    c0 = mx.registry("coded_exchange").snapshot()["counters"]
    out = []
    for d in _payloads():
        p, e = mod.pack(d)
        out.append((p, e, mod.unpack(p, e, len(d)) == d))
    out.append(mod.pack_many(_payloads()))
    out.append(mod.pack_many([]))
    c1 = mx.registry("coded_exchange").snapshot()["counters"]
    out.append({k: v - c0.get(k, 0) for k, v in c1.items()})
    return out


def test_pack_unpack_equal_reference():
    got = _pack_script(cx, metrics)
    assert got == _pack_script(ref_cx, ref_metrics)
    pl = _payloads()
    for d, (p, e, back) in zip(pl, got):
        assert back and e == (1 if len(d) >= 64 and len(p) < len(d) else 0)
    assert got[1][:2] == (b"a" * 63, 0)     # tiny: no codec
    assert got[4][1] == 1                   # smaller-of: packed
    assert got[3][:2] == (pl[3], 0)         # incompressible: raw


def test_backend_for_maps_like_the_reference():
    for b in ("auto", "tpu", "cuda"):
        assert cx.backend_for(ReductionConfig(backend=b)) == "cuda"
    for b in ("cpu", "native"):
        assert cx.backend_for(ReductionConfig(backend=b)) == "native"
    assert ref_cx.backend_for(RefConfig(backend="native")) == "native"
    assert ref_cx.backend_for(RefConfig(backend="tpu")) == "tpu"


@pytest.mark.parametrize("backend,device", [
    ("auto", "cuda"), ("tpu", "cuda"), ("cuda", "cuda"), ("cpu", "cpu"),
    ("native", "cpu")])
def test_rs_device_follows_the_backend(backend, device):
    """RS runs on the card for the card's names; ``cpu`` and ``native``
    run the plain version on the CPU (the native library has no RS)."""
    from types import SimpleNamespace

    from hdrf_tpu_torch.server.ec_tier import EcTier

    dn = SimpleNamespace(reduction_ctx=SimpleNamespace(
        config=ReductionConfig(backend=backend)))
    assert EcTier.device.fget(SimpleNamespace(_dn=dn)) == device


@pytest.mark.parametrize("kind", ["port", "ref"])
def test_background_lane_admitted_never_shed(kind):
    q, cxm, thr = ((qos, cx, throttler) if kind == "port"
                   else (ref_qos, ref_cx, ref_throttler))
    calls = []

    class DN:
        dn_id = "dn-x"
        reduction_ctx = type("R", (), {"config": ReductionConfig()})
        balance_throttler = thr.Throttler(0)

        def _peer_call(self, addr, op, **f):
            calls.append((addr, op, q.current_tenant()))
            return {"ok": True}
    dn = DN()
    # one byte a second: any foreground op past the first sheds
    dn.qos = q.AdmissionController(rate_mb_s=1e-6, burst_mb=1e-6)
    dn.qos.admit("t1", "read")
    dn.qos.charge("t1", "read", 1 << 20)
    with pytest.raises(q.ShedError):
        dn.qos.admit("t1", "read")
    ex = cxm.CodedExchange(dn)
    for _ in range(5):
        assert ex.send(("h", 1), "stripe_read", 1 << 20) == {"ok": True}
    assert [c[2] for c in calls] == [q.BACKGROUND_TENANT] * 5
    assert q.current_tenant() != q.BACKGROUND_TENANT


# ----------------------------------------------------- retry, throttler

class FakeClock:
    def __init__(self):
        self.t = 100.0
        self.sleeps = []

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(round(s, 9))
        self.t += s


def _breaker_script(rt) -> list:
    rt.reset_breakers()
    clk = FakeClock()
    br = rt.breaker("a->b", failure_threshold=3, reset_s=5.0,
                    clock=clk.monotonic)
    seen = [br.state]
    for ev in ("f", "f", "s", "f", "f", "f", "allow", "t6", "allow", "allow",
               "f", "t6", "allow", "s", "allow"):
        if ev == "f":
            br.record_failure()
        elif ev == "s":
            br.record_success()
        elif ev == "allow":
            seen.append(br.allow())
        else:
            clk.t += 6
        seen.append(br.state)
    seen.append(sorted(rt.all_breakers()))
    rt.reset_breakers()
    seen.append(rt.all_breakers())
    return seen


def test_circuit_breakers_behave_as_reference():
    assert _breaker_script(retry) == _breaker_script(ref_retry)


def _retry_script(rt) -> list:
    out = []
    for fails, attempts in ((0, 3), (2, 3), (3, 3), (5, 6)):
        state = {"n": 0}
        clk = FakeClock()

        def fn():
            state["n"] += 1
            if state["n"] <= fails:
                raise ConnectionError(f"fail {state['n']}")
            return state["n"]
        try:
            r = rt.call_with_retries(fn, attempts=attempts, sleep=clk.sleep,
                                     rng=random.Random(7))
        except ConnectionError as e:
            r = f"raised {e}"
        out.append((r, clk.sleeps))
    out.append(list(rt.backoff_delays(5, rng=random.Random(3))))
    with rt.bind(rt.Deadline(0.0)):
        try:
            rt.call_with_retries(lambda: 1)
        except rt.DeadlineExceeded as e:
            out.append(str(e))
    return out


def test_call_with_retries_behaves_as_reference():
    assert _retry_script(retry) == _retry_script(ref_retry)


def _quorum_script(rt) -> list:
    import threading
    out = []
    gate = threading.Event()

    def ok(v):
        return lambda: v

    def bad(v):
        def f():
            raise IOError(v)
        return f

    def slow(v):
        def f():
            gate.wait(5)
            return v
        return f
    # a failed primary fires the hedges at once
    wins, errs, hedged = rt.hedged_quorum([ok(0), bad(1), ok(2)], [ok(3)],
                                          k=3, hedge_after_s=30)
    out.append((sorted(wins), [i for i, _ in errs], hedged))
    # no failure, no straggler: no hedge
    wins, errs, hedged = rt.hedged_quorum([ok(0), ok(1)], [ok(2)], k=2,
                                          hedge_after_s=30)
    out.append((sorted(wins), errs, hedged))
    # a straggler: the hedge fires after the delay and wins
    wins, errs, hedged = rt.hedged_quorum([ok(0), slow(1)], [ok(2)], k=2,
                                          hedge_after_s=0.05)
    out.append((sorted(wins), errs, hedged))
    gate.set()
    # too many failures: QuorumFailed with per-leg attribution
    try:
        rt.hedged_quorum([bad(0), bad(1)], [ok(2)], k=2, hedge_after_s=30)
    except rt.QuorumFailed as e:
        out.append(("quorum failed", sorted(i for i, _ in e.errors)))
    return out


def test_hedged_quorum_behaves_as_reference():
    assert _quorum_script(retry) == _quorum_script(ref_retry)


def test_remaining_header_and_budget_as_reference():
    for rt in (retry, ref_retry):
        assert rt.remaining_header() is None
        assert rt.effective_budget(5.0) == 5.0
        with rt.bind_remaining(None) as d:
            assert d is None
        with rt.bind_remaining(3.0) as d:
            assert 2.0 < rt.remaining_header() <= 3.0
            assert rt.effective_budget(5.0) <= 3.0
            assert rt.current() is d


def _throttle_script(mod, monkeypatch) -> list:
    # rates, sizes and idle gaps of binary fractions: the fake clock's
    # arithmetic stays exact, so a wait never rounds to no progress
    clk = FakeClock()
    clk.t = 0.0
    monkeypatch.setattr(mod, "time", clk)
    th = mod.Throttler(1024)
    for n in (128, 640, 2048, 0, 64):
        th.throttle(n)
        clk.t += 1 / 64
    th.set_rate(0)
    th.throttle(10 ** 9)
    return [clk.sleeps, th.throttled_bytes, th.rate]


def test_throttler_paces_as_reference(monkeypatch):
    assert _throttle_script(throttler, monkeypatch) \
        == _throttle_script(ref_throttler, monkeypatch)
    assert _throttle_script(throttler, monkeypatch)[0]   # it did wait

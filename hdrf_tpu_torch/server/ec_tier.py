"""DataNode half of the EC(6,3) cold tier: demotion, serving, repair (port
of hdrf_tpu/server/ec_tier.py).

Re-expresses the reference's DN-side erasure-coding worker stack —
ErasureCodingWorker.java:55 (reconstruction executor wired to NN
commands), StripedBlockReconstructor.java:41 (fan-in k shards, decode,
write back), StripedBlockReader.java:40 (per-shard fetch legs),
BlockECReconstructionCommand (DNA_ERASURE_CODING_RECONSTRUCTION) — on
top of the container abstraction: the striping unit is a **sealed
container file** (storage/stripe_store.py), not a raw block group, so
demotion multiplies the EC saving with the reduction ratio.  Three
roles live here:

- **Demote** (NN ``stripe_demote`` command): RS-encode every sealed
  container backing a cold block, push the k+m stripes to NN-chosen
  holders (peer ``stripe_write`` ops under the retry/deadline spine,
  utils/retry.py), WAL the manifest in the chunk index
  (index/chunk_index.py record_stripe — the commit point), then delete
  the local sealed file and report ``stripe_complete`` to the NN.
- **Degraded read** (ContainerStore ``_stripe_fallback`` hook): when a
  chunk gather misses the sealed file, gather any k surviving stripes —
  local disk first, then peers, skipping breaker-open edges (PR-5
  evidence) — and reassemble the exact sealed bytes, decoding through
  ops/rs.py only when a data stripe is lost.  With
  ``ec_read_hedge_delta`` > 0 the gather launches k primary legs PLUS
  δ hedged legs through utils/retry.py:1 ``hedged_quorum`` once the
  rolling per-holder p95 leg latency elapses, decoding from the first k
  to land — the k+δ speculative-fetch result of the straggler-coding
  line (arXiv 1802.03049; StripedBlockReader.java:40's serial legs are
  the tail it removes), with the old serial loop kept as the fallback
  when fewer than k legs can launch.  The reconstructed payload feeds
  the unchanged decompress + device chunk-gather path
  (ops/reconstruct.py), so reads stay bit-identical to the replicated
  tier.
- **Repair** (NN ``stripe_repair`` command): re-decode exactly the lost
  stripe indices from k survivors and push them to replacement holders,
  keeping the manifest's holder map current.  With ``ec_coded_repair``
  the gather runs as a partial-sum coded exchange
  (server/coded_exchange.py; ops/rs.py ``partial_sums``): one
  ``stripe_coded_read`` chained through the remote holders, each
  bit-matmuling its LOCAL stripes into a (|missing|, stripe_len)
  contribution and XOR-folding it into the response riding back — the
  repairing owner ingests ~|missing| stripes of bytes instead of k,
  CRC-verifies every rebuilt stripe against the manifest, and falls back
  to the classic full gather (which CRC-filters corrupt stripes as
  erasures) on any mismatch, old peer, or chain failure.  Repair and
  demote both run on the QoS control lane (utils/qos.py ``background()``)
  so background reconstruction can never shed a foreground tenant.

Every RS encode, decode and partial sum runs where the reduction
config's backend resolves (ops/dispatch.resolve_backend): ``auto``,
``tpu`` and ``cuda`` on the card (csrc/rs.cu), ``cpu`` and ``native`` on
the CPU through the plain version (the native library has no RS code).
The ``dn`` contract is the reference's: ``config.data_dir``,
``containers``, ``index``, ``dn_id``, ``reduction_ctx.config``, ``coded``,
``qos``, ``balance_throttler``, ``_peer_call`` and ``_nns``.

One reference fault is repaired on purpose: the reference's ``demote``
reports ``stripe_complete`` only when the call striped a container
itself, so a block whose containers other blocks' demotions have all
striped already (containers are shared) is never reported demoted and
the NameNode commands it again at every pending timeout.  The port
reports such a block, with no new groups.  A block with a container
still open or unstriped and nothing new striped is left unreported, as
the reference leaves it: its chunks there have no stripes yet.
"""

from __future__ import annotations

import os
import time

import numpy as np

from hdrf_tpu_torch import native
from hdrf_tpu_torch.ops import dispatch, rs
from hdrf_tpu_torch.proto import datatransfer as dt
from hdrf_tpu_torch.proto.rpc import RpcError, send_frame
from hdrf_tpu_torch.reduction import accounting
from hdrf_tpu_torch.server import coded_exchange
from hdrf_tpu_torch.storage import stripe_store
from hdrf_tpu_torch.storage.container_store import _SEAL_HDR, _SEAL_MAGIC
from hdrf_tpu_torch.utils import (fault_injection, log, metrics, profiler,
                                  qos, retry, rollwin)

_M = metrics.registry("ec")
_LOG = log.get_logger("ec_tier")

# budget for one whole demote/repair command (all stripe legs); each peer
# leg retries under it via the ambient-deadline discipline of utils/retry
_CMD_BUDGET_S = 60.0


class EcTier:
    """Owns the DN's stripe store + the three cold-tier roles above."""

    def __init__(self, dn) -> None:
        self._dn = dn
        self.store = stripe_store.StripeStore(
            os.path.join(dn.config.data_dir, "stripes"))
        # degraded-read hooks: a missing sealed file falls through to
        # reconstruction; has_container consults the manifest's payload size
        dn.containers._stripe_fallback = self.reconstruct_sealed
        dn.containers._stripe_probe = self.stripe_usize
        # chain the delete observer: a deleted striped container must drop
        # its local stripes + manifest too (remote stripes are reclaimed by
        # the NN's repair loop noticing the group vanished)
        prev_on_delete = dn.containers._on_delete

        def _on_delete(cid: int) -> None:
            if prev_on_delete is not None:
                prev_on_delete(cid)
            if dn.index.stripe_manifest(cid) is not None:
                self.store.delete_stripes(dn.dn_id, cid)
                dn.index.drop_stripe(cid)

        dn.containers._on_delete = _on_delete
        # rolling per-holder stripe-leg latency (seconds), the hedge
        # trigger's p95 input (the gather-side sibling of the DN's
        # _peer_win slow-peer windows)
        self._leg_win = rollwin.WindowMap(window_s=300.0, maxlen=64)

    @property
    def device(self) -> str:
        """Where RS runs: the card when the backend resolves to it, else
        the plain version on the CPU."""
        b = dispatch.resolve_backend(self._dn.reduction_ctx.config.backend)
        return "cuda" if b == "cuda" else "cpu"

    # ------------------------------------------------------------ hooks

    def stripe_usize(self, cid: int) -> int | None:
        """Uncompressed payload size of a striped container (has_container's
        extent check), or None when the container is not striped."""
        m = self._dn.index.stripe_manifest(cid)
        return int(m["usize"]) if m is not None else None

    def reconstruct_sealed(self, cid: int) -> bytes | None:
        """ContainerStore fallback: reassemble the sealed FILE bytes of a
        demoted container from any k surviving stripes.  None = not striped
        or unrecoverable (the store then raises its original error)."""
        manifest = self._dn.index.stripe_manifest(cid)
        if manifest is None:
            return None
        _M.incr("stripe_gathers")
        got = self._gather(cid, manifest)
        k = int(manifest["k"])
        bad = {i for i, v in got.items()
               if int(native.crc32c(v)) != int(manifest["crcs"][i])}
        if bad:
            # a corrupt survivor is an erasure, not an input: re-gather
            # around it so the decode still sees k intact stripes
            _M.incr("repair_corrupt_survivors", len(bad))
            more = self._gather(cid, manifest, exclude=set(got))
            got = {i: v for i, v in got.items() if i not in bad}
            got.update(more)
        if len(got) < k:
            _M.incr("degraded_read_failures")
            return None
        # (a gather missing a data stripe decodes through parity — the
        # store's reconstruct_container counts that as a degraded read)
        try:
            blob = stripe_store.reconstruct_container(got, manifest,
                                                      device=self.device)
        except (stripe_store.StripeCorrupt, ValueError):
            _M.incr("degraded_read_failures")
            return None
        assert isinstance(blob, bytes)
        return blob

    # ---------------------------------------------------------- serving

    def serve_read(self, sock, fields: dict) -> None:
        """Peer ``stripe_read``: hand one local stripe to a gatherer.
        A gatherer that sent ``accept_enc=1`` may get an LZ4 payload back
        (``enc=1`` + ``usize``) under coded_exchange's smaller-of
        negotiation; callers that never ask — old peers — always get raw
        bytes, so mixed versions stay byte-identical."""
        fault_injection.point("stripe.read", dn_id=self._dn.dn_id)
        owner = fields["owner"]
        cid, idx = int(fields["cid"]), int(fields["idx"])
        try:
            data = self.store.read_stripe(owner, cid, idx)
        except FileNotFoundError:
            send_frame(sock, {"ok": False,
                              "error": f"no stripe {owner}/{cid}/{idx}"})
            return
        usize = len(data)
        enc = 0
        if int(fields.get("accept_enc", 0)) and self._dn.coded.compress_on:
            data, enc = coded_exchange.pack(data, self._dn.coded.backend)
        send_frame(sock, {"ok": True, "data": data, "enc": enc,
                          "usize": usize})

    def serve_write(self, sock, fields: dict) -> None:
        """Peer ``stripe_write``: durably store a stripe pushed by the
        demoting/repairing owner (CRC-checked before the ack).  ``enc=1``
        payloads are LZ4'd by the pusher's coded-exchange negotiation and
        decode to ``usize`` raw bytes BEFORE the CRC check, so the stored
        file and its CRC are identical to the raw path's."""
        try:
            data = fields["data"]
            if int(fields.get("enc", 0)):
                data = coded_exchange.unpack(data, 1, int(fields["usize"]))
            self.store.put_stripe(fields["owner"], int(fields["cid"]),
                                  int(fields["idx"]), data,
                                  crc=fields.get("crc"))
        except (stripe_store.StripeCorrupt, ValueError, KeyError,
                RuntimeError, OSError) as e:
            send_frame(sock, {"ok": False,
                              "error": f"{type(e).__name__}: {e}"})
            return
        send_frame(sock, {"ok": True})

    def serve_coded_read(self, sock, fields: dict) -> None:
        """Peer ``stripe_coded_read``: one hop of a partial-sum repair
        chain.  Compute this DN's GF-combined contribution over its LOCAL
        survivor stripes (ops/rs.py ``partial_sums`` — one Cauchy
        bit-matmul, the coefficients ride in the plan), relay the rest of
        the plan to the next holder, XOR its returned partial sums into
        ours, and answer the fold — so the response traveling back to the
        repairing owner always carries exactly (|missing|, stripe_len)
        bytes no matter how many holders contributed.  Any hop failure
        answers ok=False and the owner falls back to the full gather."""
        dn = self._dn
        fault_injection.point("stripe.coded_read", dn_id=dn.dn_id)
        try:
            owner = fields["owner"]
            cid = int(fields["cid"])
            stripe_len = int(fields["stripe_len"])
            nwant = int(fields["nwant"])
            accept_enc = int(fields.get("accept_enc", 0))
            plan = [list(e) for e in fields["plan"]]
            mine = next((e for e in plan if e[0] == dn.dn_id), None)
            rest = [e for e in plan if e[0] != dn.dn_id]
            with qos.background():
                parts = np.zeros((nwant, stripe_len), dtype=np.uint8)
                if mine is not None:
                    coeff_map = mine[3]
                    idxs = sorted(int(s) for s in coeff_map)
                    stripes = np.stack([np.frombuffer(
                        self.store.read_stripe(owner, cid, s),
                        dtype=np.uint8) for s in idxs])
                    coeffs = np.stack(
                        [np.asarray(coeff_map[str(s)], dtype=np.uint8)
                         for s in idxs], axis=1)
                    parts ^= rs.partial_sums(stripes, coeffs,
                                             device=self.device)
                if rest:
                    nxt = rest[0]
                    br = retry.breaker(f"{dn.dn_id}->{nxt[0]}")
                    try:
                        resp = dn.coded.send(
                            (nxt[1], int(nxt[2])), dt.STRIPE_CODED_READ,
                            nwant * stripe_len, owner=owner, cid=cid,
                            stripe_len=stripe_len, nwant=nwant, plan=rest,
                            accept_enc=accept_enc)
                        if not resp.get("ok"):
                            raise IOError(resp.get("error", "coded relay"))
                    except (OSError, ConnectionError, IOError, KeyError):
                        br.record_failure()
                        raise
                    br.record_success()
                    encs = resp.get("enc") or [0] * len(resp["parts"])
                    _M.incr("coded_relay_bytes",
                            sum(len(p) for p in resp["parts"]))
                    for i, (p, e) in enumerate(zip(resp["parts"], encs)):
                        parts[i] ^= np.frombuffer(
                            coded_exchange.unpack(p, e, stripe_len),
                            dtype=np.uint8)
                blobs = [parts[i].tobytes() for i in range(nwant)]
                if accept_enc and dn.coded.compress_on:
                    packed = coded_exchange.pack_many(blobs,
                                                      dn.coded.backend)
                else:
                    packed = [(b, 0) for b in blobs]
            send_frame(sock, {"ok": True,
                              "parts": [p for p, _ in packed],
                              "enc": [e for _, e in packed]})
        except (OSError, ConnectionError, IOError, KeyError, ValueError,
                RuntimeError, qos.ShedError) as e:
            send_frame(sock, {"ok": False,
                              "error": f"{type(e).__name__}: {e}"})

    # --------------------------------------------------------- demotion

    def demote(self, cmd: dict) -> None:
        """NN ``stripe_demote``: stripe every sealed, not-yet-striped
        container backing ``block_id`` onto ``targets``, then report.
        Ordering per container: stripes durable on holders -> manifest
        WAL'd -> sealed file deleted — a crash at any point leaves the
        container readable (sealed file until the WAL commit, stripes
        after).

        The block is cold by the NameNode's own rule (idle past
        ``ec_demote_after_s``), so an open container holding its chunks
        is sealed first, through the ``flush_open`` path ``stop()`` takes
        (counter ``demote_open_sealed``).  The reference skips it as hot;
        nothing rolls it on an idle DataNode, so a block whose other
        containers other demotions had striped was never reported."""
        dn = self._dn
        bid = cmd["block_id"]
        k, m = int(cmd["k"]), int(cmd["m"])
        targets = [list(t) for t in cmd["targets"]]
        if len(targets) != k + m:
            _M.incr("demote_failures")
            return
        entry = dn.index.get_block(bid)
        if entry is None:
            return
        cids: list[int] = []
        for h in entry.hashes:
            loc = dn.index.chunk_location(h)
            if loc is not None and loc.container_id not in cids:
                cids.append(loc.container_id)
        done: list[dict] = []
        with retry.bind(retry.Deadline(_CMD_BUDGET_S)), qos.background():
            sealed = dn.containers.flush_open(
                on_seal=dn.index.seal_container,
                cids={c for c in cids
                      if dn.index.stripe_manifest(c) is None})
            if sealed:
                _M.incr("demote_open_sealed", sealed)
            for cid in cids:
                if dn.index.stripe_manifest(cid) is not None:
                    continue  # already striped (shared container)
                blob = dn.containers.sealed_file_bytes(cid)
                if blob is None:
                    continue  # a raw file a crash left: never sealed
                magic, usize, _codec = _SEAL_HDR.unpack(
                    blob[:_SEAL_HDR.size])
                if magic != _SEAL_MAGIC:
                    continue
                stripes, manifest = stripe_store.encode_container(
                    blob, k, m, device=self.device)
                manifest.update(owner=dn.dn_id, usize=usize,
                                holders=targets)
                try:
                    for idx, data in enumerate(stripes):
                        self._place(targets[idx], cid, idx, data,
                                    manifest["crcs"][idx])
                except (OSError, ConnectionError, IOError,
                        retry.DeadlineExceeded):
                    _M.incr("demote_failures")
                    continue  # no manifest committed: sealed file stays
                dn.index.record_stripe(cid, manifest)
                freed = dn.containers.drop_sealed_file(cid)
                _M.incr("containers_demoted")
                _M.incr("demote_bytes_freed", freed)
                # the full manifest rides the report so the NN can journal
                # it (editlog/fsimage durable): owner-loss repair needs a
                # copy that survives this DN's WAL dying with this DN
                done.append({"cid": cid, "holders": targets,
                             "logical": manifest["length"],
                             "physical": (k + m) * manifest["stripe_len"],
                             "manifest": manifest})
        if done:
            self._notify_nn(bid, done)
        elif cids and all(dn.index.stripe_manifest(c) is not None
                          for c in cids):
            # every container of the block was striped by other blocks'
            # demotions: the block is demoted, with no new groups
            _M.incr("demotes_already_striped")
            self._notify_nn(bid, [])

    def repair(self, cmd: dict) -> None:
        """NN ``stripe_repair``: re-decode the lost stripe indices from k
        survivors and push them to replacement holders.  The manifest comes
        from this DN's WAL when it is the group's owner; after OWNER loss
        the NN deputizes a surviving holder and hands down its journaled
        manifest copy (``cmd["manifest"]``) — repaired stripes keep the
        original owner's name so every holder's files stay findable."""
        dn = self._dn
        fault_injection.point("stripe.repair", dn_id=dn.dn_id)
        cid = int(cmd["cid"])
        # an NN-supplied manifest (owner-loss deputization) wins over the
        # local WAL: cids are per-DN counters, so the deputy's OWN container
        # of the same cid would shadow the dead owner's group otherwise
        manifest = cmd.get("manifest") or dn.index.stripe_manifest(cid)
        if manifest is None:
            return
        owner = manifest.get("owner", dn.dn_id)
        missing = [int(i) for i in cmd["missing"]]
        targets = [list(t) for t in cmd["targets"]]
        red = dn.reduction_ctx.config
        with retry.bind(retry.Deadline(_CMD_BUDGET_S)), qos.background():
            decoded = None
            if getattr(red, "ec_coded_repair", True):
                decoded = self._gather_coded(cid, manifest, missing)
            if decoded is None:
                # classic full gather: k whole stripes to the owner, CRC-
                # filtered per stripe (corrupt survivors become erasures)
                got = self._gather(cid, manifest, exclude=set(missing))
                bad = {i for i, v in got.items()
                       if int(native.crc32c(v)) != int(manifest["crcs"][i])}
                if bad:
                    # a corrupt survivor is an erasure: re-gather around
                    # it so the decode still sees k intact stripes
                    _M.incr("repair_corrupt_survivors", len(bad))
                    more = self._gather(
                        cid, manifest, exclude=set(missing) | set(got))
                    got = {i: v for i, v in got.items() if i not in bad}
                    got.update(more)
                try:
                    decoded = stripe_store.reconstruct_container(
                        got, manifest, want=missing, device=self.device)
                except (stripe_store.StripeCorrupt, ValueError) as e:
                    _M.incr("repair_failures")
                    _LOG.warning("stripe repair: decode failed",
                                 dn_id=dn.dn_id, cid=cid, missing=missing,
                                 survivors=sorted(got),
                                 error=f"{type(e).__name__}: {e}")
                    return
                coded_exchange.book_repair_wire(
                    sum(len(v) for v in got.values()),
                    sum(len(v) for v in decoded.values()))
            holders = [list(t) for t in manifest["holders"]]
            try:
                for idx, tgt in zip(missing, targets):
                    self._place(tgt, cid, idx, decoded[idx],
                                manifest["crcs"][idx], owner=owner)
                    holders[idx] = list(tgt)
                    _M.incr("repair_bytes", len(decoded[idx]))
            except (OSError, ConnectionError, IOError,
                    retry.DeadlineExceeded) as e:
                _M.incr("repair_failures")
                _LOG.warning("stripe repair: placement failed",
                             dn_id=dn.dn_id, cid=cid, missing=missing,
                             targets=[t[0] for t in targets],
                             error=f"{type(e).__name__}: {e}")
                return
        manifest["holders"] = holders
        if owner == dn.dn_id:
            # agents repairing a dead owner's group must NOT WAL the
            # foreign manifest: cids are per-DN counters, so a local
            # record would shadow this DN's own container of the same id
            # — the NN's editlog copy stays the orphan group's home
            dn.index.record_stripe(cid, manifest)
        _M.incr("stripes_repaired", len(missing))
        self._notify_nn(cmd.get("block_id"),
                        [{"cid": cid, "holders": holders,
                          "logical": manifest["length"],
                          "physical": (int(manifest["k"])
                                       + int(manifest["m"]))
                          * manifest["stripe_len"],
                          "manifest": manifest}],
                        owner=owner)

    # ---------------------------------------------------------- plumbing

    def _place(self, target: list, cid: int, idx: int, data: bytes,
               crc: int, owner: str | None = None) -> None:
        """Durably land one stripe on ``target`` (local fast path; peers
        via stripe_write with capped retries under the ambient deadline and
        the background-transfer throttle).  ``owner`` names the group the
        stripe files belong to — repairs of a dead owner's group pass the
        ORIGINAL owner so surviving holders' (owner, cid, idx) paths stay
        coherent; demotion defaults to this DN."""
        dn = self._dn
        owner = owner or dn.dn_id
        tgt_id, host, port = target[0], target[1], int(target[2])
        if tgt_id == dn.dn_id:
            self.store.put_stripe(owner, cid, idx, data, crc=crc)
            return
        # coded-exchange push: smaller-of LZ4 negotiation (sealed-container
        # stripes are usually incompressible and ship raw; raw-codec and
        # parity-of-raw stripes compress), paced + admitted inside
        # dn.coded.send on the background lane
        wire, enc = data, 0
        if dn.coded.compress_on:
            wire, enc = coded_exchange.pack(data, dn.coded.backend)
        _M.incr("stripe_push_raw_bytes", len(data))
        _M.incr("stripe_push_wire_bytes", len(wire))
        state = {"wire": wire, "enc": enc}

        def _push() -> None:
            resp = dn.coded.send((host, port), dt.STRIPE_WRITE,
                                 len(state["wire"]), owner=owner, cid=cid,
                                 idx=idx, data=state["wire"],
                                 enc=state["enc"], usize=len(data), crc=crc)
            if not resp.get("ok"):
                if state["enc"]:
                    # peer refused the encoded payload (old version or
                    # decode failure): re-negotiate to raw for the retries
                    _M.incr("stripe_push_enc_fallbacks")
                    state["wire"], state["enc"] = data, 0
                raise IOError(f"stripe_write {cid}/{idx} to {tgt_id}: "
                              f"{resp.get('error')}")
        retry.call_with_retries(
            _push, attempts=3,
            retry_on=(ConnectionError, OSError, IOError))

    def _gather(self, cid: int, manifest: dict,
                exclude: set[int] | None = None) -> dict[int, bytes]:
        """k+δ straggler-proof stripe gather (utils/retry.py:194
        ``hedged_quorum``; arXiv 1802.03049's speculative k+δ fetch):
        launch k primary legs — data indices first, so no decode is
        needed when all k land — plus up to ``ec_read_hedge_delta``
        hedged legs once the rolling per-holder p95 leg latency elapses,
        and decode from the FIRST k to land instead of waiting out a
        stalled holder.  Falls back to the serial loop when δ = 0, when
        fewer than k breaker-closed legs can launch, or when the hedged
        fan-out itself misses quorum (mid-gather holder deaths beyond
        what δ covered)."""
        dn = self._dn
        red = dn.reduction_ctx.config
        k, m = int(manifest["k"]), int(manifest["m"])
        owner = manifest.get("owner", dn.dn_id)
        holders = manifest["holders"]
        delta = int(getattr(red, "ec_read_hedge_delta", 0))
        if delta <= 0:
            return self._gather_serial(cid, manifest, exclude)

        # Candidate legs in data-first order, minus excluded stripes and
        # breaker-OPEN edges.  The .state peek is probe-free: half-open
        # edges stay IN the candidate set and spend their single probe
        # inside the leg via br.allow() at call time.
        usable: list[int] = []
        for idx in range(k + m):
            if exclude and idx in exclude:
                continue
            tgt_id = holders[idx][0]
            if (tgt_id != dn.dn_id
                    and retry.breaker(f"{dn.dn_id}->{tgt_id}").state
                    == "open"):
                _M.incr("breaker_skips")
                continue
            usable.append(idx)
        if len(usable) < k:
            # Not enough live legs for a quorum launch; the serial loop
            # still gathers whatever exists (caller handles < k).
            return self._gather_serial(cid, manifest, exclude)
        primaries = usable[:k]
        hedge_idxs = usable[k:k + delta]

        accept_enc = 1 if dn.coded.compress_on else 0

        def leg(idx: int):
            tgt_id, host, port = (holders[idx][0], holders[idx][1],
                                  int(holders[idx][2]))

            def run():
                fault_injection.point("ec.stripe_hedge", dn_id=dn.dn_id,
                                      holder=tgt_id, idx=idx)
                t0 = time.monotonic()
                if tgt_id == dn.dn_id:
                    data = self.store.read_stripe(owner, cid, idx)
                else:
                    br = retry.breaker(f"{dn.dn_id}->{tgt_id}")
                    if not br.allow():
                        raise retry.BreakerOpen(f"{dn.dn_id}->{tgt_id}")
                    try:
                        resp = dn._peer_call((host, port), dt.STRIPE_READ,
                                             owner=owner, cid=cid, idx=idx,
                                             accept_enc=accept_enc)
                        if not resp.get("ok"):
                            raise IOError(
                                resp.get("error", "stripe_read failed"))
                        data = coded_exchange.unpack(
                            resp["data"], int(resp.get("enc", 0)),
                            int(resp.get("usize", 0)))
                    except (OSError, ConnectionError, IOError, KeyError,
                            ValueError):
                        br.record_failure()
                        raise
                    br.record_success()
                self._leg_win.note(tgt_id, time.monotonic() - t0)
                return idx, data

            return run

        sums = self._leg_win.summaries()
        p95s = [sums[holders[i][0]]["p95"] for i in primaries
                if holders[i][0] in sums]
        hedge_after = max((max(p95s) if p95s else 0.0)
                          * red.mirror_hedge_p95_mult,
                          red.mirror_hedge_floor_s)
        try:
            with profiler.phase("ec_gather"):
                wins, _errors, _hedged = retry.hedged_quorum(
                    [leg(i) for i in primaries],
                    [leg(i) for i in hedge_idxs],
                    k=k, hedge_after_s=hedge_after,
                    timeout_s=_CMD_BUDGET_S,
                    on_hedge=lambda: _M.incr("ec_hedges_fired"))
        except retry.QuorumFailed as e:
            _M.incr("ec_hedge_fallbacks")
            # hand the serial fallback the holders that JUST failed so it
            # does not burn its budget re-contacting them (their breakers
            # may need more consecutive failures to open)
            legs_by_pos = primaries + hedge_idxs
            failed = {holders[legs_by_pos[j]][0] for j, _err in e.errors
                      if j < len(legs_by_pos)
                      and holders[legs_by_pos[j]][0] != dn.dn_id}
            return self._gather_serial(cid, manifest, exclude,
                                       failed=failed)
        got: dict[int, bytes] = {}
        for leg_i, (sidx, data) in wins:
            got[sidx] = data
            if leg_i >= len(primaries):
                _M.incr("ec_hedge_wins")
        accounting.record_stripe_gather(sum(len(v) for v in got.values()))
        return got

    def _gather_serial(self, cid: int, manifest: dict,
                       exclude: set[int] | None = None,
                       failed: set[str] | None = None) -> dict[int, bytes]:
        """Serial fallback gather: fetch up to k stripes one holder at a
        time, data indices first, skipping ``exclude``, holders that just
        failed the hedged attempt (``failed``), and breaker-open peers —
        the same probe-free ``.state`` peek the k+δ path uses, so a
        half-open edge's single probe is spent at CALL time (br.allow()),
        never on the skip decision.  Leg latencies feed the same
        ``_leg_win`` windows as the hedged legs, so serial rounds keep the
        hedge-trigger p95s warm instead of letting them age out."""
        dn = self._dn
        k, m = int(manifest["k"]), int(manifest["m"])
        owner = manifest.get("owner", dn.dn_id)
        holders = manifest["holders"]
        accept_enc = 1 if dn.coded.compress_on else 0
        got: dict[int, bytes] = {}
        with profiler.phase("ec_gather"):
            for idx in range(k + m):
                if len(got) >= k:
                    break
                if exclude and idx in exclude:
                    continue
                tgt_id, host, port = (holders[idx][0], holders[idx][1],
                                      int(holders[idx][2]))
                if tgt_id == dn.dn_id:
                    try:
                        got[idx] = self.store.read_stripe(owner, cid, idx)
                    except OSError:
                        continue
                    continue
                if failed and tgt_id in failed:
                    _M.incr("serial_failed_skips")
                    continue
                br = retry.breaker(f"{dn.dn_id}->{tgt_id}")
                if br.state == "open" or not br.allow():
                    _M.incr("breaker_skips")
                    continue
                t0 = time.monotonic()
                try:
                    resp = dn._peer_call((host, port), dt.STRIPE_READ,
                                         owner=owner, cid=cid, idx=idx,
                                         accept_enc=accept_enc)
                    if not resp.get("ok"):
                        raise IOError(resp.get("error", "stripe_read failed"))
                    got[idx] = coded_exchange.unpack(
                        resp["data"], int(resp.get("enc", 0)),
                        int(resp.get("usize", 0)))
                    br.record_success()
                    self._leg_win.note(tgt_id, time.monotonic() - t0)
                except (OSError, ConnectionError, IOError, KeyError,
                        ValueError):
                    br.record_failure()
                    continue
        accounting.record_stripe_gather(sum(len(v) for v in got.values()))
        return got

    def _gather_coded(self, cid: int, manifest: dict,
                      missing: list[int]) -> dict[int, bytes] | None:
        """Partial-sum repair gather (ops/rs.py ``repair_rows`` /
        ``partial_sums``; the repair-pipelining shape of arXiv
        1802.03049): pick k breaker-closed survivors, split the repair
        matrix's columns by holding DN, fold this DN's local
        contribution for free, and chain ONE ``stripe_coded_read``
        through the remote holders — each XORs its contribution into the
        (|missing|, stripe_len) response riding back, so owner ingress is
        ~|missing| stripes instead of k.  Every rebuilt stripe is
        CRC-verified against the manifest: a corrupt contribution
        anywhere in the fold surfaces there (the sum hides WHICH survivor
        was bad), and ``None`` sends the caller to the classic gather,
        which CRC-filters per stripe and treats the corrupt one as an
        erasure.  ``None`` likewise on any chain/peer/old-version
        failure — the fallback is byte-identical."""
        dn = self._dn
        if not missing:
            return {}
        k, m = int(manifest["k"]), int(manifest["m"])
        owner = manifest.get("owner", dn.dn_id)
        holders = manifest["holders"]
        stripe_len = int(manifest["stripe_len"])
        exclude = set(missing)
        usable: list[int] = []
        for idx in range(k + m):
            if idx in exclude:
                continue
            tgt_id = holders[idx][0]
            if (tgt_id != dn.dn_id
                    and retry.breaker(f"{dn.dn_id}->{tgt_id}").state
                    == "open"):
                _M.incr("breaker_skips")
                continue
            usable.append(idx)
        if len(usable) < k:
            return None
        have = usable[:k]
        rows = rs.repair_rows(k, m, tuple(have), tuple(missing))
        col_of = {s: j for j, s in enumerate(have)}
        local: list[int] = []
        groups: dict[str, tuple[tuple, list[int]]] = {}
        for s in have:
            tgt_id, host, port = (holders[s][0], holders[s][1],
                                  int(holders[s][2]))
            if tgt_id == dn.dn_id:
                local.append(s)
            else:
                groups.setdefault(tgt_id, ((host, port), []))[1].append(s)
        parts = np.zeros((len(missing), stripe_len), dtype=np.uint8)
        if local:
            try:
                stripes = np.stack([np.frombuffer(
                    self.store.read_stripe(owner, cid, s), dtype=np.uint8)
                    for s in local])
            except OSError:
                return None
            coeffs = rows[:, [col_of[s] for s in local]]
            parts ^= rs.partial_sums(stripes, coeffs, device=self.device)
        wire = 0
        if groups:
            # one chain through the remote holders; per-survivor coeff
            # columns ride as str-keyed lists (msgpack-stable)
            plan = [[tgt_id, addr[0], addr[1],
                     {str(s): [int(c) for c in rows[:, col_of[s]]]
                      for s in idxs}]
                    for tgt_id, (addr, idxs) in groups.items()]
            head = plan[0]
            br = retry.breaker(f"{dn.dn_id}->{head[0]}")
            try:
                with profiler.phase("ec_gather"):
                    resp = dn.coded.send(
                        (head[1], int(head[2])), dt.STRIPE_CODED_READ,
                        len(missing) * stripe_len, owner=owner, cid=cid,
                        stripe_len=stripe_len, nwant=len(missing),
                        plan=plan, accept_enc=1 if dn.coded.compress_on
                        else 0)
                if not resp.get("ok"):
                    raise IOError(resp.get("error", "coded read failed"))
                encs = resp.get("enc") or [0] * len(resp["parts"])
                wire = sum(len(p) for p in resp["parts"])
                for i, (p, e) in enumerate(zip(resp["parts"], encs)):
                    parts[i] ^= np.frombuffer(
                        coded_exchange.unpack(p, e, stripe_len),
                        dtype=np.uint8)
            except (OSError, ConnectionError, IOError, KeyError,
                    ValueError, RuntimeError):
                # unknown op on an old peer lands here too (no response
                # frame -> recv error): classic gather takes over
                br.record_failure()
                _M.incr("coded_repair_fallbacks")
                return None
            br.record_success()
        decoded: dict[int, bytes] = {}
        for i, w in enumerate(missing):
            blob = parts[i].tobytes()
            if int(native.crc32c(blob)) != int(manifest["crcs"][w]):
                _M.incr("coded_contrib_corrupt")
                _M.incr("coded_repair_fallbacks")
                return None
            decoded[w] = blob
        accounting.record_stripe_gather(wire)
        coded_exchange.book_repair_wire(wire,
                                        len(missing) * stripe_len)
        _M.incr("coded_repairs")
        return decoded

    def _notify_nn(self, block_id, containers: list[dict],
                   owner: str | None = None) -> None:
        """Report new/updated stripe groups (and the demoted block) to the
        NameNodes; first accepting NN wins — the active applies it, a
        standby refuses (same pattern as commit_block_sync).  ``owner``
        keys the groups when a deputized agent reports a dead owner's
        repair (defaults to the reporting DN)."""
        for nn in self._dn._nns:
            try:
                nn.call("stripe_complete", dn_id=self._dn.dn_id,
                        block_id=block_id, containers=containers,
                        owner=owner)
                return
            except (OSError, ConnectionError, RpcError):
                continue
        _M.incr("stripe_complete_failures")

    # ------------------------------------------------------------- stats

    def report(self) -> dict:
        """Heartbeat payload: tier sizes + the holder map the NN's repair
        scheduler rebuilds its soft state from (stripe groups are WAL-
        durable HERE, in the owner DN's chunk index — the NN only caches)."""
        manifests = self._dn.index.stripe_manifests()
        logical = sum(int(m["length"]) for m in manifests.values())
        physical = self.store.physical_bytes()
        accounting.record_stripe_tier(logical, physical)
        return {
            "striped_containers": len(manifests),
            "stripe_logical_bytes": logical,
            "stripe_physical_bytes": physical,
            "manifests": {str(cid): {"holders": m["holders"],
                                     "length": int(m["length"])}
                          for cid, m in manifests.items()},
        }

"""Reduction-effectiveness accounting — the paper's headline metric, kept
(port of hdrf_tpu/reduction/accounting.py: the write, worker and read
observation points, the EC stripe tier's stamps, the geometry gauges, the
DataNode's container-utilization histogram, and the adaptive half: the CDC
select's scan telemetry, the retune counters and
``AdaptiveChunkController``, with the reference's constants, windows, hold
and ``steps()`` ordering).

The reference computes its dedup/compression effectiveness offline from the
Redis tables (SURVEY.md §5); nothing in the running system can answer "how
much reduction am I getting?".  This module is the online answer: every
reduction observation point stamps into one ``reduction_accounting``
registry —

- per-scheme logical vs physical bytes (``logical_bytes__<scheme>`` /
  ``physical_bytes__<scheme>`` counters), fed by the schemes' reduce paths
  (reduction/scheme.py, reduction/dedup.py) and the co-located worker's
  compress ops (server/reduction_worker.py);
- per-block dedup hit/miss chunk counts (counters ``dedup_chunks_hit`` /
  ``dedup_chunks_miss`` + per-block histograms), fed by the same commit
  code dedup_commit / CommitPipeline already run
  (DataDeduplicator.java:338-367's checkChunk is the hit/miss point);
- read-amplification accounting (``read_logical_bytes__<scheme>`` vs
  ``read_physical_bytes__<scheme>`` vs ``read_stripe_bytes__<scheme>``):
  logical bytes served, physical container bytes actually decoded, and
  stripe bytes gathered for EC degraded reads — the serving-path mirror of
  the reduce-side ratio (DataConstructor.java:430-567 re-decompresses whole
  containers per read and never measures it);
- the effective CDC geometry (gauges stamped at the dispatch funnel).

The cluster dedup ratio is ``sum(logical_len) / sum(unique chunk bytes)``
over the chunk index — the standard effectiveness metric of the chunking
literature (arXiv:2505.21194 §V's dedup ratio) and *exactly* recomputable
from the index tables, which is what the acceptance check pins.

Everything here is host-side counter arithmetic on observation points that
already exist: zero device dispatches are added (the ledger event count
for a fixed workload is unchanged — utils/device_ledger.py is never
touched from this module).
"""

from __future__ import annotations

import contextlib
import contextvars

from hdrf_tpu_torch.utils import metrics

_ACC = metrics.registry("reduction_accounting")

# Ambient scheme tag for the READ side: the reconstruct entry point knows
# which scheme is serving, but the physical decode happens layers below in
# storage/container_store.py (which knows nothing about schemes) — the same
# contextvar trick the profiler uses for its ambient timeline.
_read_scheme: contextvars.ContextVar[str | None] = \
    contextvars.ContextVar("hdrf_read_scheme", default=None)


def record_reduce(scheme: str, logical_bytes: int,
                  physical_bytes: int) -> None:
    """Per-scheme logical vs physical byte accounting, stamped where a
    block's reduced form is produced."""
    _ACC.incr(f"logical_bytes__{scheme}", int(logical_bytes))
    _ACC.incr(f"physical_bytes__{scheme}", int(physical_bytes))


def record_dedup_block(chunks: int, new_chunks: int) -> None:
    """Per-block dedup hit/miss chunk accounting (a hit = a chunk whose
    fingerprint was already indexed; a miss appended new container
    bytes)."""
    hits = int(chunks) - int(new_chunks)
    _ACC.incr("dedup_chunks_hit", hits)
    _ACC.incr("dedup_chunks_miss", int(new_chunks))
    _ACC.observe("block_hit_chunks", hits)
    _ACC.observe("block_miss_chunks", int(new_chunks))


def record_worker_bytes(op: str, nbytes: int) -> None:
    """Reduction-worker stamp: bytes processed per worker op family."""
    _ACC.incr(f"worker_{op}_bytes", int(nbytes))


def record_stripe_tier(logical_bytes: int, physical_bytes: int) -> None:
    """EC cold-tier byte accounting (server/ec_tier.py's heartbeat stamp):
    logical = sealed-container bytes demoted to stripes, physical = stripe
    bytes on this DN's disk.  Gauges, not counters — the tier's CURRENT
    footprint, refreshed per heartbeat, so the cluster physical/logical ratio
    stays repr-exact as containers demote and repair."""
    _ACC.gauge("stripe_tier_logical_bytes", int(logical_bytes))
    _ACC.gauge("stripe_tier_physical_bytes", int(physical_bytes))


def stripe_ratio(logical_bytes: int, physical_bytes: int) -> float:
    """Stripe-tier physical/logical expansion: ~(k+m)/k (1.5 for RS(6,3))
    vs the replicated tier's replication factor; 0.0 for an empty tier."""
    return (physical_bytes / logical_bytes) if logical_bytes else 0.0


# ----------------------------------------------------- read amplification


@contextlib.contextmanager
def read_scope(scheme: str):
    """Tag the ambient read with its serving scheme so the container
    store's decode point (storage/container_store.py read_container) can
    attribute physical decoded bytes per scheme without knowing schemes
    exist."""
    tok = _read_scheme.set(scheme)
    try:
        yield
    finally:
        _read_scheme.reset(tok)


def record_read_logical(scheme: str, nbytes: int) -> None:
    """Logical bytes served to a reader, per scheme (the denominator of
    the read-amplification ratio)."""
    _ACC.incr(f"read_logical_bytes__{scheme}", int(nbytes))


def record_container_decode(nbytes: int) -> None:
    """Physical container bytes DECODED to serve reads (cache hits decode
    nothing — that is the compounding win ROADMAP item 1 chases).  Scheme
    attribution comes from the ambient :func:`read_scope`; decodes outside
    any read scope (compaction, EC repair) book under ``raw``."""
    s = _read_scheme.get() or "raw"
    _ACC.incr(f"read_physical_bytes__{s}", int(nbytes))


def record_stripe_gather(nbytes: int) -> None:
    """Stripe bytes gathered over the wire/disk for EC degraded reads —
    the third rung of the amplification ladder (logical < decoded <
    gathered when a read has to reassemble a demoted container)."""
    s = _read_scheme.get() or "raw"
    _ACC.incr(f"read_stripe_bytes__{s}", int(nbytes))


def read_amplification_report() -> dict:
    """Per-scheme read-amplification ratios recomputed from the cumulative
    counters: ``physical / logical`` (and ``stripe / logical``) — 0.0 for
    schemes that served nothing yet.  Refreshes matching gauges so the
    ratios ride /prom next to the raw byte counters."""
    snap = _ACC.snapshot()["counters"]
    out: dict[str, dict] = {}
    for key, v in snap.items():
        if key.startswith("read_logical_bytes__"):
            scheme = key[len("read_logical_bytes__"):]
            logical = int(v)
            physical = int(snap.get(f"read_physical_bytes__{scheme}", 0))
            stripe = int(snap.get(f"read_stripe_bytes__{scheme}", 0))
            amp = physical / logical if logical else 0.0
            out[scheme] = {"logical_bytes": logical,
                           "physical_bytes": physical,
                           "stripe_bytes": stripe,
                           "read_amplification": amp,
                           "stripe_amplification":
                               stripe / logical if logical else 0.0}
            _ACC.gauge(f"read_amplification__{scheme}", amp)
    return out


def snapshot() -> dict:
    """The registry snapshot (rides DN heartbeats; also on /prom and
    /metrics through the process-wide exposition)."""
    read_amplification_report()  # refresh the derived gauges first
    return _ACC.snapshot()


def dedup_ratio(logical_bytes: int, unique_chunk_bytes: int) -> float:
    """logical / unique-chunk bytes, 1.0 for an empty index — the exact
    ground-truth ratio the chunk index defines."""
    return (logical_bytes / unique_chunk_bytes) if unique_chunk_bytes else 1.0


# ----------------------------------------------------- adaptive chunk sizing


def record_scan_summary(slab_survivors: int, candidates: int) -> None:
    """Sequence-select scan telemetry from the cut table's header lanes
    (ops/cdc_cuda.py H_SURV/H_CANDS, written by the select kernel and read
    in ops/resident.py ``start_sha_many`` off the header readback that
    already happens): the 512-position rows holding a candidate and the
    masked candidate population that survived the skip-ahead dead zone."""
    _ACC.incr("cdc_scan_slab_survivors", int(slab_survivors))
    _ACC.incr("cdc_scan_candidates", int(candidates))


def record_retune(key: str, old, new) -> None:
    """One applied controller retune step (a DataNode reconfigure of a
    ``cdc_*`` key, server/datanode.py); the counter is the e2e proof the
    adaptive loop actually moved the geometry."""
    _ACC.incr("cdc_retunes")
    _ACC.incr(f"cdc_retunes__{key}")


def record_retune_rollback() -> None:
    """One guard-triggered geometry revert (tools/slo_report.py guard
    called from the DN tick): the counter is the e2e proof the regression
    guard actually protects the workload, not just flags it."""
    _ACC.incr("retune_rollbacks")


def dedup_counters() -> tuple[int, int]:
    """Cumulative (hit, miss) dedup chunk counters — the controller's
    observation signal, produced by record_dedup_block at the commit
    point."""
    c = _ACC.snapshot()["counters"]
    return int(c.get("dedup_chunks_hit", 0)), int(c.get("dedup_chunks_miss", 0))


class AdaptiveChunkController:
    """Content-adaptive chunk-size controller (the
    adaptive-average-chunk-size observation of arXiv:2505.21194 §V: dedup
    yield is corpus-dependent, and a fixed geometry leaves either ratio or
    index pressure on the table).

    The controller is deliberately host-trivial: it watches the cumulative
    dedup hit/miss counters this module already maintains (the chunk-hit
    ratio vs index pressure), and when a full observation
    window of chunks shows the corpus is dedup-poor it COARSENS the mask
    by one bit (bigger average chunks -> fewer index entries and less
    per-chunk overhead for data that was never going to dedup); when the
    corpus dedups well it walks back toward ``target_mask_bits`` one bit
    at a time.  Every decision is returned as an ORDERED list of
    ``(config_key, value)`` reconfigure steps whose intermediate states
    all keep ``min_chunk <= max_chunk`` — they are applied through the
    DataNode's existing live-reconfig path (server/datanode.py
    reconfigure), never by poking the config directly, so validation,
    metrics, and the audit trail all see them.

    Geometry derivation: for mask bits ``b`` the average chunk is ``2^b``
    (ops/dispatch.py gear_mask), and the emitted window is
    ``min = max(cdc_min_size, 2^(b-2))``, ``max = 2^(b+3)`` — at the
    default target (b=13, min_size=512) this reproduces the shipped
    2048/65536 defaults exactly, so enabling the controller is a no-op
    until evidence accumulates.  Safety: retunes only change where NEW
    cuts land; committed fingerprints are content-addressed and reads
    resolve through the chunk index's offsets, so data written under any
    older geometry stays bit-identical (ARCHITECTURE.md decision 15).
    Every emittable geometry is pinned against the XLA oracle by a
    property test (tests/test_adaptive_cdc.py)."""

    MASK_BITS_MIN = 8      # avg 256 B — floor of the emit range
    MASK_BITS_MAX = 16     # avg 64 KiB — ceiling of the emit range
    LOW_HIT = 0.05         # window hit ratio below which we coarsen
    HIGH_HIT = 0.35        # ratio above which we walk back toward target

    def __init__(self, target_mask_bits: int = 13, min_size: int = 512,
                 window_chunks: int = 512):
        self.target = int(min(max(target_mask_bits, self.MASK_BITS_MIN),
                              self.MASK_BITS_MAX))
        self.min_size = int(min_size)
        self.window_chunks = int(window_chunks)
        self._seen_hit = 0
        self._seen_miss = 0
        self._win_hit = 0
        self._win_miss = 0
        # Windows still held after a guard rollback (slo_report.guard in
        # the DN tick): a retune the guard just reverted must not be
        # re-proposed from the very next window's evidence, or the loop
        # flaps retune/rollback forever.
        self._hold_windows = 0

    def geometry(self, mask_bits: int) -> tuple[int, int]:
        """(min_chunk, max_chunk) for a mask-bits setting."""
        mb = int(mask_bits)
        return max(self.min_size, 1 << (mb - 2)), 1 << (mb + 3)

    def emit_range(self):
        """Every (mask_bits, min_chunk, max_chunk) the controller can ever
        request — the domain of the oracle property test."""
        return [(mb, *self.geometry(mb))
                for mb in range(self.MASK_BITS_MIN, self.MASK_BITS_MAX + 1)]

    def observe(self, hit: int, miss: int,
                current_mask_bits: int) -> list[tuple[str, int]]:
        """Consume the CUMULATIVE dedup counters; once a full window of
        chunk commits has accumulated, return the ordered reconfigure
        steps (possibly none).  Call from the DN heartbeat tick."""
        dh, dm = int(hit) - self._seen_hit, int(miss) - self._seen_miss
        self._seen_hit, self._seen_miss = int(hit), int(miss)
        if dh < 0 or dm < 0:      # counter reset (restart): restart window
            self._win_hit = self._win_miss = 0
            return []
        self._win_hit += dh
        self._win_miss += dm
        total = self._win_hit + self._win_miss
        if total < self.window_chunks:
            return []
        ratio = self._win_hit / total
        self._win_hit = self._win_miss = 0
        if self._hold_windows > 0:
            self._hold_windows -= 1
            return []
        cur = int(current_mask_bits)
        if ratio < self.LOW_HIT:
            new = min(cur + 1, self.MASK_BITS_MAX)
        elif ratio > self.HIGH_HIT and cur != self.target:
            new = cur + (1 if self.target > cur else -1)
        else:
            return []
        if new == cur:
            return []
        return self.steps(cur, new)

    def note_rollback(self, hold_windows: int = 2) -> None:
        """The regression guard reverted the last retune: hold the next
        ``hold_windows`` full observation windows before proposing any
        new geometry, so a workload the guard judged worse under the new
        cuts cannot re-trigger the same retune immediately."""
        self._hold_windows = max(self._hold_windows, int(hold_windows))

    def steps(self, old_mask_bits: int,
              new_mask_bits: int) -> list[tuple[str, int]]:
        """Ordered reconfigure steps old -> new geometry.  Growing applies
        ``max`` before ``min`` (old min <= old max <= new max, then
        new min <= new max); shrinking applies ``min`` first, symmetric —
        so ``min_chunk <= max_chunk`` holds at every intermediate state
        the reconfigure validator checks."""
        mn_new, mx_new = self.geometry(new_mask_bits)
        _, mx_old = self.geometry(old_mask_bits)
        if mx_new >= mx_old:
            steps = [("cdc_max_chunk", mx_new), ("cdc_min_chunk", mn_new)]
        else:
            steps = [("cdc_min_chunk", mn_new), ("cdc_max_chunk", mx_new)]
        steps.append(("cdc_mask_bits", int(new_mask_bits)))
        return steps


def utilization_hist(live_bytes: dict, sizes: dict) -> dict:
    """Container-utilization decile histogram: live referenced bytes over
    bytes on disk, per container.  Sealed (compressed) containers can
    exceed 1.0; dead weight shows up as low deciles.  Buckets: 0..9 =
    [i/10, (i+1)/10), 10 = >= 1.0."""
    out: dict[int, int] = {}
    for cid, sz in sizes.items():
        u = (live_bytes.get(cid, 0) / sz) if sz else 0.0
        b = min(int(u * 10), 10)
        out[b] = out.get(b, 0) + 1
    return out


def note_geometry(cdc) -> None:
    """Effective CDC geometry gauges, stamped at the reduction dispatch
    funnel (ops/dispatch.py chunk_and_fingerprint).  Under the adaptive
    controller the live CdcConfig mutates between blocks, so the gauges —
    not the static config — are what tell an operator (and the bench
    contract) which geometry cuts are being made with right now."""
    _ACC.gauge("cdc_mask_bits_effective", int(cdc.mask_bits))
    _ACC.gauge("cdc_min_chunk_effective", int(cdc.min_chunk))

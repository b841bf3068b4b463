"""Reduction-effectiveness accounting — the paper's headline metric, kept
(port of hdrf_tpu/reduction/accounting.py: the write, worker and read
observation points, the EC stripe tier's stamps, the geometry gauges and
the DataNode's container-utilization histogram; the adaptive chunk
controller comes with its caller, a later slice).

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

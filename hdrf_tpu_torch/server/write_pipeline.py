"""Async multi-block write pipeline: shared device batches for the DN (port
of hdrf_tpu/server/write_pipeline.py, whole).

The reference's receive path is one-block-at-a-time: DataXceiver threads
buffer independently and each block's reduction runs alone (DDRunner,
DataDeduplicator.java:108-217), so concurrent streams never share device
work and the accelerator idles between per-block dispatches.  This module
is the admission/coalescing stage that keeps the device fed:

- ``submit(block_id, data, timeline, tenant)`` hands a fully-buffered
  block to the pipeline and returns a Future of ``(cuts, digests)``.
  Admission is bounded by ``pipeline_max_inflight`` (config.py
  ReductionConfig) and, when an AdmissionController is installed, gated
  per tenant by utils/qos.py (token-bucket + deadline shed BEFORE a
  permit is held); the coalescer queue is a weighted-fair qos.FairQueue
  so queued blocks drain round-robin across tenants.
- On a device backend — ``cuda`` (the card) or ``cpu`` (the kernels'
  plain versions, the counterpart of the reference's ``tpu`` backend on
  the JAX CPU device) — a single coalescer thread drains queued blocks up
  to ``pipeline_depth`` per round, groups them by lane-size bucket, and
  runs each group through ONE ops/resident.ResidentReducer
  ``submit_many`` (the CDC scan and select kernels per block, then one
  header wait, the gathers and one SHA-256 launch per block, and one
  digest readback for the group).  New groups are ENQUEUED before any
  older group's readback is awaited, so device work for block K+1 is in
  flight while block K's host commit (container append, WAL, mirror)
  runs.  The reference starts its coalescer only for the literal backend
  ``tpu``; the port's device backend is ``cuda`` (ops/dispatch.
  resolve_backend maps ``auto`` and ``tpu`` to it), so the test is "not
  ``native``" — a literal copy would route every write inline.
- On the ``native`` backend (and at ``pipeline_depth`` 1) ``submit``
  computes inline on the calling connection thread via
  ops/dispatch.chunk_and_fingerprint — bit-identical results.
- With ``ReductionConfig.mesh_plane`` on and two or more cards, the
  coalescer instead drives parallel/sharded.MeshReducer: futures resolve
  ``(cuts, digests, probe)`` 3-tuples whose probe set lets dedup_commit
  skip the host index walk for probe-negative chunks.  Mixed-size groups
  bucket-pad to the next lane size (``_pad_bucket``); the padding waste
  is exported as ``coalesce_pad_bytes``.

Counters (registry ``write_pipeline``): ``device_batches`` (groups, one
``submit_many`` each), ``device_batch_blocks`` (group sizes),
``inline_reduces``.  Each group's enqueue→finish window is recorded as a
``device_wait`` span into EVERY member block's timeline
(utils/profiler.py BlockTimeline).  The reducer is shared with
ops/dispatch.chunk_and_fingerprint's ``_resident_cache``, keyed by the
CDC geometry and the device: the port has one CDC select that yields
both of the reference's scan variants' cuts, so the reference's
``cdc_pallas_mode``/``cdc_skip_ahead`` key parts have no counterpart.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import Future

import numpy as np

from hdrf_tpu_torch.ops import dispatch
from hdrf_tpu_torch.utils import metrics, profiler, qos

_M = metrics.registry("write_pipeline")


class _Item:
    __slots__ = ("block_id", "arr", "timeline", "future", "tenant")

    def __init__(self, block_id: int, arr: np.ndarray, timeline,
                 future: Future, tenant: str | None = None) -> None:
        self.block_id = block_id
        self.arr = arr
        self.timeline = timeline
        self.future = future
        self.tenant = tenant


class WritePipeline:
    """Admission + device-batch coalescing for concurrent block writes."""

    def __init__(self, cdc, backend: str, depth: int = 4,
                 max_inflight: int = 8, mesh_plane: bool = False,
                 mesh_lanes: int = 2, mesh_bucket_slots: int = 1 << 15,
                 qos_ctrl=None):
        self._cdc = cdc
        self._backend = dispatch.resolve_backend(backend)
        self._depth = max(depth, 1)
        # DN-wide admission gate (utils/qos.py AdmissionController): when
        # installed, submit() sheds over-rate / deadline-doomed tenants
        # BEFORE a pipeline permit is held.
        self._qos = qos_ctrl
        # Mesh-sharded reduction plane (ReductionConfig.mesh_plane): one
        # dispatch per mesh step for the whole coalesced group, dedup probe
        # answered on-mesh.  Futures then resolve (cuts, digests, probe)
        # 3-tuples; None (and 2-tuples) below 2 devices or when disabled.
        self.mesh_reducer = None
        if self._backend == "cuda" and mesh_plane:
            self.mesh_reducer = dispatch.mesh_reducer(
                cdc, lanes_per_device=mesh_lanes,
                bucket_slots=mesh_bucket_slots)
            if self.mesh_reducer is not None:
                # fill the mesh: a step has ndata*lanes lanes, so the
                # coalescer must be allowed to drain at least that many
                self._depth = max(self._depth, self.mesh_reducer.max_group())
        self._sem = threading.BoundedSemaphore(max(max_inflight, 1))
        # Weighted-fair dequeue (qos.FairQueue, queue.Queue-compatible):
        # per-tenant lanes drain round-robin so a flooding tenant's queued
        # blocks cannot starve a light tenant's (FairCallQueue.java:214).
        self._q = qos.FairQueue()
        self._thread: threading.Thread | None = None
        if self._backend != "native" and self._depth > 1:
            self._thread = threading.Thread(target=self._coalesce_loop,
                                            name="write-pipeline",
                                            daemon=True)
            self._thread.start()

    # ------------------------------------------------------------ admission

    def submit(self, block_id: int, data, timeline=None,
               tenant: str | None = None) -> Future:
        """Reduce ``data`` (host bytes / u8 array); Future resolves to
        ``(cuts, digests)``.  Blocks at the ``pipeline_max_inflight``
        admission bound (backpressure on client streams); sheds (raises
        qos.ShedError) before acquiring a permit when the tenant is over
        rate or the ambient deadline cannot cover the service estimate."""
        arr = (data if isinstance(data, np.ndarray)
               else np.frombuffer(data, dtype=np.uint8))
        if tenant is None:
            tenant = qos.current_tenant()
        # unattributed submits (mirror ingest, re-reduction) are internal
        # relays already admitted at the head DN — never shed them
        if self._qos is not None and tenant is not None:
            self._qos.admit(tenant, "write")
        if not self._sem.acquire(timeout=300):
            raise TimeoutError("write pipeline admission timeout")
        # Permit-leak audit: between acquire and a successfully armed
        # done-callback there is no release path — any raise in that
        # window (Future alloc, callback attach) must hand the permit
        # back inline.  Once the callback is armed, failing the future
        # releases through it.
        try:
            fut: Future = Future()
            fut.add_done_callback(lambda _f: self._sem.release())
        except BaseException:
            self._sem.release()
            raise
        if self._thread is None:
            # Serial/native path: compute on the caller's thread — the
            # native choke point records its own reduce_compute phase.
            _M.incr("inline_reduces")
            try:
                fut.set_result(dispatch.chunk_and_fingerprint(
                    arr, self._cdc, self._backend))
            except BaseException as e:  # noqa: BLE001 — caller unwraps
                fut.set_exception(e)
            return fut
        try:
            self._q.put(_Item(block_id, arr, timeline, fut, tenant))
        except BaseException as e:  # noqa: BLE001 — permit rides the future
            fut.set_exception(e)
            raise
        return fut

    def close(self) -> None:
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------ coalescer

    def _reducer(self):
        """The dispatch-cache ResidentReducer for this CDC geometry and
        device (shared with ops/dispatch.chunk_and_fingerprint; an
        adaptive retune mutating ``self._cdc`` resolves to a DIFFERENT
        cached reducer, never mutates a constructed one)."""
        from hdrf_tpu_torch.ops.resident import ResidentReducer

        dev = dispatch._device_for(self._backend)
        key = (self._cdc.mask_bits, self._cdc.min_chunk,
               self._cdc.max_chunk, dev)
        r = dispatch._resident_cache.get(key)
        if r is None:
            r = dispatch._resident_cache[key] = ResidentReducer(
                self._cdc, device=dev)
        return r

    def _drain(self, block: bool) -> tuple[list[_Item], bool]:
        """Up to ``depth`` queued items; ``block`` waits for the first."""
        items: list[_Item] = []
        try:
            first = self._q.get(block=block)
        except queue.Empty:
            return items, False
        if first is None:
            return items, True
        items.append(first)
        while len(items) < self._depth:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                return items, True
            items.append(nxt)
        return items, False

    def _coalesce_loop(self) -> None:
        # The mesh plane supersedes the single-device reducer when present
        # (same submit/start/finish protocol, one dispatch per mesh step)
        # and stays PINNED at its construction geometry — its bucket table
        # holds device state no retune may invalidate.  The single-device
        # reducer is re-resolved per round instead, so an adaptive retune
        # of the shared CdcConfig takes effect at the next group.
        inflight: deque = deque()
        stopping = False
        while True:
            r = self.mesh_reducer or self._reducer()
            if not stopping:
                items, stopping = self._drain(block=not inflight)
                for group in self._group(r, items):
                    try:
                        # ENQUEUE the group's device program now — before
                        # any older group's readback below is awaited.
                        bj = r.submit_many([it.arr for it in group])
                    except BaseException as e:  # noqa: BLE001
                        for it in group:
                            if not it.future.done():
                                it.future.set_exception(e)
                        continue
                    _M.incr("device_batches")
                    _M.observe("device_batch_blocks", len(group))
                    if self.mesh_reducer is not None:
                        _M.incr("mesh_batches")
                        _M.observe("mesh_batch_blocks", len(group))
                    inflight.append((bj, group))
            if not inflight:
                if stopping:
                    return
                continue
            # Finish the OLDEST group only, then loop back to admit newer
            # arrivals: their dispatches enqueue under this group's commit.
            bj, group = inflight.popleft()
            lead = group[0].timeline
            n0 = len(lead.ledger_ids) if lead is not None else 0
            t0 = profiler.mark()
            try:
                # the lead member's timeline is ambient for the readbacks,
                # so the device ledger's hook gives it real device_wait
                # spans + event-id links; they're mirrored to the rest below
                with profiler.bind_timeline(lead):
                    r.start_sha_many(bj)
                    results = r.finish_many(bj)
            except BaseException as e:  # noqa: BLE001
                for it in group:
                    if not it.future.done():
                        it.future.set_exception(e)
                continue
            t1 = profiler.mark()
            new_ids = lead.ledger_ids[n0:] if lead is not None else []
            for idx, (it, res) in enumerate(zip(group, results)):
                tl = it.timeline
                if tl is not None and idx > 0:
                    # shared wait window + ledger links for every member —
                    # the per-block overlap accountant's device_wait input
                    tl.add_span("device_wait", t0, t1, 0)
                    tl.ledger_ids.extend(new_ids)
                it.future.set_result(res)

    @staticmethod
    def _pad_bucket(n: int) -> int:
        """Lane-size bucket for mixed-size coalescing: members of one
        bucket share a device program padded to the longest member, so
        near-sized blocks from different streams batch together instead of
        each drawing its own dispatch (ROADMAP item 1 remainder).
        Geometric 1/8-of-pow2 steps bound worst-case padding at ~12.5%."""
        if n <= 4096:
            return 4096
        top = 1 << (n - 1).bit_length()
        step = max(top // 8, 4096)
        return -(-n // step) * step

    def _group(self, r, items: list[_Item]) -> list[list[_Item]]:
        """Lane-size-bucketed groups bounded by the reducer's max_group;
        padding waste is surfaced as ``coalesce_pad_bytes``."""
        by_bucket: dict[int, list[_Item]] = {}
        for it in items:
            by_bucket.setdefault(self._pad_bucket(it.arr.size),
                                 []).append(it)
        groups: list[list[_Item]] = []
        for bucket, members in by_bucket.items():
            g = max(1, min(self._depth, r.max_group(bucket)))
            for at in range(0, len(members), g):
                grp = members[at:at + g]
                gmax = max(it.arr.size for it in grp)
                pad = sum(gmax - it.arr.size for it in grp)
                if pad:
                    _M.incr("coalesce_pad_bytes", pad)
                groups.append(grp)
        return groups

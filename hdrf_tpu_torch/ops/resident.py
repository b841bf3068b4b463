"""Device-resident block reduction: CDC cuts + SHA-256 chunk fingerprints
(port of hdrf_tpu/ops/resident.py:335-819 ``ResidentReducer``).

A block crosses to the device once; every per-byte pass runs there, and
only the cut table and the digests come back.  Per block, on one stream:

1. ``cdc_cuda.cdc_block`` — the BE word image, the cuts, and the chunks
   binned into a small and a big offset/length lane table (the reference's
   two-bucket rule: small when ``(len + 9 + 63) // 64 <= b_small``,
   ``b_small = max(1, min((2 << mask_bits) // 64, max_nb))``,
   resident.py:371-372).  Its 8-word header goes to pinned host memory;
   its two telemetry lanes (``H_SURV``, ``H_CANDS``) feed
   ``accounting.record_scan_summary`` once the header lands, as the
   reference's ``_start_sha_fused`` does (resident.py:545-552).
2. Once the header has landed: ``gather_cuda.gather_pad_messages`` per
   bucket, then one ``sha256_cuda.sha256_words_grouped`` launch over both
   (the big bucket's long chains first), each sized to exactly the
   header's lane counts; digests and cuts copy back to pinned host memory.

**One path.**  The reference keeps an XLA prep + host-select path beside
its fused kernel, for device-resident input, a kernel overflow and
mixed-size groups (resident.py:399-403, 553-566, 711-746).  Here host
bytes and device tensors of any size go through the same three kernels:
cuts depend only on the bytes, and the CDC tables hold the hard cut bound,
so nothing overflows.  A group is a list of blocks, each run through its
own kernels in order on one stream; offsets are per block ``int32``
(a block must stay under 2 GiB), so a group has no flat-offset bound and
``max_group`` only caps how many blocks' results are in flight.

The batched contract (``submit_many`` / ``start_sha_many`` /
``finish_many`` / ``reduce_many``) and the single-block one (``submit`` /
``start_sha`` / ``finish`` for a block already on the device) mirror the
reference.  Results are ``(cuts uint64[n_chunks], digests u8[n_chunks,
32])``.  On ``device="cpu"`` every stage runs its kernel's plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hdrf_tpu_torch.config import CdcConfig
from hdrf_tpu_torch.ops import cdc_cuda
from hdrf_tpu_torch.ops.dispatch import gear_mask, resolve_device
from hdrf_tpu_torch.ops.gather_cuda import gather_pad_messages
from hdrf_tpu_torch.ops.sha256_cuda import sha256_words_grouped
from hdrf_tpu_torch.reduction import accounting
from hdrf_tpu_torch.utils import device_ledger as _ledger

_HDR = cdc_cuda.TABLE_HDR


def to_host(t: torch.Tensor) -> torch.Tensor:
    """Start a device->host copy of ``t`` (pinned, asynchronous on the
    card; a CPU tensor is its own host copy)."""
    if t.device.type != "cuda":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


def record_event(device: torch.device):
    """A CUDA event after the work enqueued so far on ``device``'s current
    stream (None on the CPU, where everything has already run)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def digest_buckets(words: torch.Tensor, buckets) -> list[torch.Tensor]:
    """Gather kernel per lane table, then ONE SHA launch over all of them
    (``buckets``: one or two ``(lanes int32[2, L] of byte offsets and
    lengths, bucket)``, the first hashed longest lanes first) of a BE word
    image: digests u8[L, 32] per table, on the device."""
    tables = []
    for lanes, bucket in buckets:
        nb = ((lanes[1] + 9 + 63) // 64).to(torch.int32)
        tables.append((gather_pad_messages(words, lanes, bucket), nb))
    return sha256_words_grouped(tables)


def digest_lanes(words: torch.Tensor, lanes: torch.Tensor,
                 bucket: int) -> torch.Tensor:
    """Gather + SHA kernels over one lane table of a BE word image."""
    return digest_buckets(words, [(lanes, bucket)])[0]


@dataclasses.dataclass
class _Block:
    """Per-block state between the three stages."""
    n: int
    words: torch.Tensor | None = None
    table: torch.Tensor | None = None
    ols: torch.Tensor | None = None
    olb: torch.Tensor | None = None
    hdr: torch.Tensor | None = None        # host copy of the table header
    hdr_ready: object = None               # CUDA event after the copy
    cuts_host: torch.Tensor | None = None  # host copy of the cut list
    digs_host: list | None = None          # [small, big] host digests
    done: object = None                    # CUDA event after the copies


@dataclasses.dataclass
class BatchJob:
    """A group of blocks in flight (``submit_many`` .. ``finish_many``)."""
    blocks: list
    _ev: object = None       # ledger token: CDC dispatch -> header readback
    _ev_sha: object = None   # ledger token: SHA dispatch -> digest readback


class ResidentReducer:
    """Async block-reduction front end over the device-resident pipeline.

    Usage (overlapped):
        bj = r.submit_many(blocks)     # upload + CDC kernels
        r.start_sha_many(bj)           # header wait, gather + SHA kernels
        results = r.finish_many(bj)    # [(cuts, digests), ...]
    """

    def __init__(self, cdc: CdcConfig | None = None, device="cuda"):
        self.cdc = cdc or CdcConfig()
        self.mask = gear_mask(self.cdc)
        self.device = resolve_device(device)
        max_nb = (self.cdc.max_chunk + 9 + 63) // 64
        self._b_small = max(1, min((2 << self.cdc.mask_bits) // 64, max_nb))
        self._b_big = max_nb

    # ------------------------------------------------------------ helpers

    def _small(self, lens: np.ndarray) -> np.ndarray:
        """Which chunks go to the small lane table (the two-bucket rule)."""
        return (lens + 9 + 63) // 64 <= self._b_small

    def _assemble(self, cuts: np.ndarray, digs_host: list) -> np.ndarray:
        """Digests in chunk order from the small and big lane results."""
        small = self._small(np.diff(cuts.astype(np.int64), prepend=0))
        digs = np.empty((cuts.size, 32), dtype=np.uint8)
        digs[small] = digs_host[0].numpy()
        digs[~small] = digs_host[1].numpy()
        return digs

    def _device_block(self, data, n: int | None) -> tuple[torch.Tensor, int]:
        """(u8 block zero-padded to the 512-byte grid, true length)."""
        if isinstance(data, torch.Tensor) and data.device == self.device:
            data = data.reshape(-1)
            n = data.numel() if n is None else n
            # a device block already on the grid is used in place; the
            # caller guarantees zeros between n and its end
            if data.numel() % cdc_cuda.PAD_GRID == 0 \
                    and data.numel() - n < cdc_cuda.PAD_GRID:
                return data, n
            data = data[:n]
        return cdc_cuda.padded_block(data, self.device)

    # ----------------------------------------------------- batched pipeline

    def submit_many(self, datas, sizes: list | None = None) -> BatchJob:
        """Upload a group of blocks and enqueue their CDC kernels.

        ``datas``: host byte buffers / u8 ndarrays, u8 tensors (a device
        tensor is used in place), or a (K, n) u8 tensor; sizes may differ.
        ``sizes`` gives true lengths for device blocks carrying zero pad.
        """
        if isinstance(datas, torch.Tensor) and datas.dim() == 2:
            datas = list(datas)
        blocks, h2d = [], 0
        for i, d in enumerate(datas):
            if not isinstance(d, torch.Tensor) or d.device != self.device:
                h2d += d.nbytes if not isinstance(d, (bytes, bytearray)) \
                    else len(d)
            block, n = self._device_block(d, None if sizes is None
                                          else sizes[i])
            b = _Block(n=n)
            if n:
                b.words, b.table, b.ols, b.olb = cdc_cuda.cdc_block(
                    block, n, self.mask, self.cdc.min_chunk,
                    self.cdc.max_chunk, self._b_small)
                b.hdr = to_host(b.table[:_HDR])
                b.hdr_ready = record_event(self.device)
            blocks.append(b)
        ev = _ledger.dispatch("resident.cdc", batch=len(blocks),
                              h2d_bytes=h2d)
        return BatchJob(blocks=blocks, _ev=ev)

    def start_sha_many(self, bj: BatchJob) -> None:
        """Wait for each block's header, then enqueue its two gathers and
        one SHA launch over both lane tables, sized to the header's lane
        counts, and the result copies."""
        nbytes = surv = cands = 0
        for b in bj.blocks:
            if not b.n:
                continue
            if b.hdr_ready is not None:
                b.hdr_ready.synchronize()
            nc, _, ns, nbg, sv, cd = (int(v) for v in b.hdr[:6].tolist())
            surv += sv
            cands += cd
            nbytes += b.hdr.numel() * 4
            big, small = digest_buckets(
                b.words, [(b.olb[:, :nbg], self._b_big),
                          (b.ols[:, :ns], self._b_small)])
            b.digs_host = [to_host(small), to_host(big)]
            b.cuts_host = to_host(b.table[_HDR:_HDR + nc])
            b.done = record_event(self.device)
            b.words = b.table = b.ols = b.olb = None
        _ledger.readback(bj._ev, d2h_bytes=nbytes)
        bj._ev = None
        # the select's telemetry lanes ride the header readback above, as
        # the reference's _start_sha_fused reads them off its table
        accounting.record_scan_summary(surv, cands)
        bj._ev_sha = _ledger.dispatch("resident.sha", batch=len(bj.blocks))

    def finish_many(self, bj: BatchJob) -> list[tuple[np.ndarray, np.ndarray]]:
        """Wait for the digests; return ``(cuts, digests)`` per block."""
        if bj._ev is not None:
            self.start_sha_many(bj)
        out, nbytes = [], 0
        for b in bj.blocks:
            if not b.n:
                out.append((np.empty(0, dtype=np.uint64),
                            np.empty((0, 32), dtype=np.uint8)))
                continue
            if b.done is not None:
                b.done.synchronize()
            cuts = b.cuts_host.numpy().astype(np.uint64)
            digs = self._assemble(cuts, b.digs_host)
            nbytes += digs.nbytes + cuts.size * 4
            out.append((cuts, digs))
        _ledger.readback(bj._ev_sha, d2h_bytes=nbytes)
        bj._ev_sha = None
        return out

    def max_group(self, n: int) -> int:
        """Blocks per ``submit_many`` group.  Offsets are per block, so no
        flat-offset bound applies; 16 (the reference's cap) bounds how many
        blocks' device buffers a group holds at once."""
        return 16

    def reduce_many(self, datas: list) -> list[tuple[np.ndarray, np.ndarray]]:
        """Batched multi-block reduction; results keep input order."""
        out: list = []
        g = self.max_group(0)
        for at in range(0, len(datas), g):
            bj = self.submit_many(datas[at:at + g])
            self.start_sha_many(bj)
            out.extend(self.finish_many(bj))
        return out

    # ------------------------------------------------------- single block

    def submit(self, data, n: int | None = None) -> BatchJob:
        """Start reduction of one block: host bytes, or a u8 tensor already
        on the device (``n`` = true length when it carries zero pad)."""
        return self.submit_many([data], None if n is None else [n])

    def start_sha(self, job: BatchJob) -> None:
        self.start_sha_many(job)

    def finish(self, job: BatchJob) -> tuple[np.ndarray, np.ndarray]:
        return self.finish_many(job)[0]

    def reduce(self, data) -> tuple[np.ndarray, np.ndarray]:
        """Synchronous single-block reduction: (cuts, digests)."""
        job = self.submit(data)
        self.start_sha(job)
        return self.finish(job)

    def fingerprint(self, data, cuts: np.ndarray) -> np.ndarray:
        """SHA-256 digests u8[n_chunks, 32] of the caller's chunks ``[prev
        cut, cut)``: the block's word image from the CDC scan kernel's
        words-only mode, the chunks binned into the small and big lane
        tables by the rule the CDC select applies, then the gathers and
        one SHA launch.  A big lane is as wide as the caller's longest
        chunk needs."""
        cuts = np.asarray(cuts, dtype=np.int64)
        if cuts.size == 0:
            return np.empty((0, 32), dtype=np.uint8)
        block, _ = self._device_block(data, None)
        words = cdc_cuda.be_image(block)
        starts = np.concatenate([[0], cuts[:-1]])
        lens = cuts - starts
        small = self._small(lens)

        def lanes(sel):
            return torch.as_tensor(np.stack([starts[sel], lens[sel]]).astype(
                np.int32), device=self.device)
        big, sm = digest_buckets(
            words, [(lanes(~small), max(self._b_big,
                                        int((lens.max() + 72) // 64))),
                    (lanes(small), self._b_small)])
        digs_host = [to_host(sm), to_host(big)]
        done = record_event(self.device)
        if done is not None:
            done.synchronize()
        return self._assemble(cuts, digs_host)

"""LZ4 container seal on the card: device match discovery + native emit
(port of hdrf_tpu/ops/lz4_tpu.py; the reference's container rollover
compression, DataDeduplicator.java:770-781).

An LZ4 encoder needs, for every position p, the most recent earlier
position with the same 4-byte prefix.  The device finds it for every
position of a 128 KiB supertile at once; the native host half
(``native.lz4_emit``) runs the greedy parse over those records, re-verifies
and extends each one, and serializes standard LZ4 block format.  Round-trip
correctness never depends on the device output — only the ratio does.

The device half of :func:`match_scan`, per block of ``N % _S == 0`` bytes:

1. The big-endian word image (``cdc_cuda.be_image``: the CDC scan
   kernel's words-only mode on the card, ``gear.be_words`` on the CPU)
   and the stride-2 phase words ``(w << 16) | (next >> 16)``, where
   ``next`` is the following word of the whole block (the last entry of
   a supertile reads the next supertile's first word; the block's last
   word reads 0).
2. ``sort_cuda.match_deltas`` — kernel 4: per position, the back-reference
   delta to the previous same-hash position whose 4-gram is equal, in
   position order.
3. Torch ops, as the reference computes them outside any Pallas kernel: a
   run of equal deltas is one match (reverse cummin for its length), a
   cummax frontier keeps only records that advance coverage by >= 4 bytes.
4. Gather-free record extraction through ``sort_cuda.sort_rows`` — kernel
   5: the L1 pack sort moves kept records to the front of 8,192-entry
   rows, a transpose rebalances the rows, the L2 pack sort and the L3 sort
   by position give one position-ascending row of ``p3`` slots.
5. The packed encode (5 B per record with two escape lanes, compacted by
   two more ``sort_rows`` calls) and one D2H copy into pinned memory.

:class:`DeviceLz4` is the front end: ``submit``/``finish`` (one block),
``submit_many``/``finish_many`` (a group), the escape-lane rescan, the
overflow retry with sticky slice hints, the record-flood fallback to the
segmented native encoder, the 16-submit bypass after two floods in a row, and the sampled grey-zone race
against the native encoder — the reference's policy, unchanged, so a
``DeviceLz4`` and a reference ``TpuLz4`` with the same history emit the
same bytes.  On ``device="cpu"`` both kernels run their plain versions.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from hdrf_tpu_torch import native
from hdrf_tpu_torch.ops import cdc_cuda, sort_cuda
from hdrf_tpu_torch.ops.dispatch import resolve_device
from hdrf_tpu_torch.ops.gear import M32, to_i32
from hdrf_tpu_torch.utils import device_ledger as _ledger
from hdrf_tpu_torch.utils import metrics as _metrics

_M_FLOOD = _metrics.registry("lz4_device")

# Segment width for host-parallel native LZ4 (flood fallback / bypass).
# Segments compress independently on a thread pool, then lz4_stitch merges
# them into ONE spec-valid LZ4 block stream (plain concatenation is not
# valid: the block format has no end marker, so each piece's final
# literals-only sequence would derail a decoder mid-stream).  The cost is
# ratio only: offsets never cross a junction, and LZ4's window is 64 KiB.
_SEG = 8 << 20


def _seq_head(lit_len: int, match_nibble: int) -> bytes:
    """Token + extended-length bytes for a sequence with ``lit_len``
    literals and the given low (match-length) nibble."""
    if lit_len < 15:
        return bytes([(lit_len << 4) | match_nibble])
    out = [0xF0 | match_nibble]
    rem = lit_len - 15
    while rem >= 255:
        out.append(255)
        rem -= 255
    out.append(rem)
    return bytes(out)


def lz4_stitch(pieces: list[tuple[bytes, int, int]]) -> bytes:
    """Merge independently compressed LZ4 block streams into one valid
    stream.  ``pieces`` are (stream, tail_token_off, tail_lit) from
    ``native.lz4_compress_tail``.  At each junction the left piece's final
    literals-only sequence is folded into the right piece's first sequence
    (literal runs concatenate; offsets are relative and segment-internal).
    End-of-block restrictions hold because the final piece's tail is kept
    verbatim."""
    out = bytearray()
    pend_lits = b""   # literals awaiting the next sequence-with-a-match
    for stream, tail_off, tail_lit in pieces:
        body, tail = stream[:tail_off], stream[tail_off:]
        tail_literals = tail[-tail_lit:] if tail_lit else b""
        if body:
            if pend_lits:
                # fold pending literals into body's FIRST sequence
                t = body[0]
                lit = t >> 4
                p = 1
                if lit == 15:
                    while True:
                        b = body[p]
                        p += 1
                        lit += b
                        if b != 255:
                            break
                first_lits = body[p:p + lit]
                rest = body[p + lit:]   # offset+matchlen ext of seq 1 onward
                out += _seq_head(len(pend_lits) + lit, t & 0x0F)
                out += pend_lits
                out += first_lits
                out += rest
                pend_lits = b""
            else:
                out += body
            pend_lits = tail_literals
        else:
            # a single literals-only sequence (tiny or incompressible
            # segment): accumulate its literals
            pend_lits += tail_literals
    out += _seq_head(len(pend_lits), 0)
    out += pend_lits
    return bytes(out)


_POOL: ThreadPoolExecutor | None = None
_POOL_LOCK = threading.Lock()


def _pool() -> ThreadPoolExecutor:
    """Process-shared host-compression pool, created on first parallel use
    (a per-instance pool would keep 4 threads per DeviceLz4 for the life
    of the process; instances share one encoder workload anyway)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                min(4, os.cpu_count() or 1), thread_name_prefix="lz4host")
        return _POOL


def _lz4_compress_parallel(a: np.ndarray) -> bytes:
    # On a single-core host the segmented path only adds overhead (the
    # native calls release the GIL but no second core can use it).
    if a.size <= _SEG or (os.cpu_count() or 1) <= 1:
        return native.lz4_compress(a)
    parts = [a[o:o + _SEG] for o in range(0, a.size, _SEG)]
    return lz4_stitch(list(_pool().map(native.lz4_compress_tail, parts)))


_S = 131072         # supertile span in bytes; window <= LZ4's 65535 anyway
_E3 = 8192          # L1 pack-sort row width (entries)
_L2R = 128          # balanced L2 rows
_BIG = 1 << 30
_INVALID = 2**31 - 1


def _esc_slots(p3: int) -> int:
    """Escape-lane capacity of the packed record layout: overflow needs a
    >64 Ki-entry position gap or a >=511-unit length every 64 records;
    it is detected exactly and rescanned in the full layout."""
    return p3 // 64 + 64


def _packed_len(p3: int) -> int:
    """int32 words in a packed record row: [total, nv, esc1, esc2] header
    + A per slot + one dpos low byte per slot (4 per word) + the two
    escape lanes."""
    return 4 + p3 + p3 // 4 + 2 * _esc_slots(p3)


def _shift_right(x: torch.Tensor, fill: int) -> torch.Tensor:
    """out[..., i] = x[..., i - 1] along the last dim, out[..., 0] = fill."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], dim=-1)


def entries(block: torch.Tensor, stride: int) -> tuple[torch.Tensor, int]:
    """The match-delta kernel's input for a u8 block (N % _S == 0): one
    row of int32 4-gram entries per supertile, and ``pos_bits``."""
    t = block.numel() // _S
    s4 = _S // 4
    w = cdc_cuda.be_image(block)
    if stride == 4:
        return w.view(t, s4), 15
    if stride != 2:
        raise ValueError("stride must be 2 or 4")
    wl = w.to(torch.int64) & M32
    nxt = torch.cat([wl[1:], wl.new_zeros(1)])  # next word; 0 at the end
    mid = to_i32(((wl << 16) & M32) | (nxt >> 16))
    return torch.cat([w.view(t, s4), mid.view(t, s4)], dim=1), 16


def match_scan(block: torch.Tensor, stride: int, min_len: int, p1: int,
               p2: int, p3: int, packed: bool = True) -> torch.Tensor:
    """u8[N] (N % _S == 0) -> int32 match-record row, on the block's device.

    ``packed=False`` (the full layout, also the escape-overflow rescan
    shape): int32[1 + 2*p3] of [total_kept, gpos x p3, (delta<<16|len) x
    p3]; unused slots carry gpos == _INVALID (and any record word); used
    slots are position-ascending.

    ``packed=True``: int32[_packed_len(p3)] of [total_kept, n_valid,
    esc1_cnt, esc2_cnt] + A x p3 + B x p3/4 + E1 x esc_slots + E2 x
    esc_slots, where for record i (positions/deltas in entry units, i.e.
    divided by ``stride``):

      A[i] = delta_u (15 bits) | len9 (9 bits) << 15 | dpos_hi8 << 24
      B[i // 4] byte (i % 4)   = dpos_lo8
      dpos16 = pos_u[i] - pos_u[i-1]  (pos_u[-1] == 0); 0xFFFF escapes to
               E1 (absolute pos_u, record order)
      len9   = (mlen - 4) / stride, 32766 when mlen was clipped to 65535;
               >= 511 escapes to E2 (record order), stored as 511

    Every dead field is masked, so the packed row is bit-identical to the
    reference's.  In both layouts total_kept > valid slots means records
    were dropped by the p1/p2/p3 slices (the caller may retry wider).
    """
    dev = block.device
    t = block.numel() // _S
    vals, pos_bits = entries(block, stride)

    # Kernel 4: deltas in position order (entry i of a row is byte
    # position stride * i), so same-delta runs are neighbour relations.
    d = sort_cuda.match_deltas(vals, stride, pos_bits)
    del vals
    okp = d > 0
    cont = okp & (d == _shift_right(d, 0))
    start = okp & ~cont

    # Run length: distance to the next entry that breaks the run, via a
    # reverse cummin over (index where not continuing, +inf elsewhere).
    e = d.shape[1]
    iota = torch.arange(e, dtype=torch.int32, device=dev).expand(t, e)
    pos_b = iota * stride
    brk = torch.where(cont, _BIG, iota)
    nxt_brk = torch.cummin(brk.flip(1), dim=1).values.flip(1)
    nxt1 = torch.cat([nxt_brk[:, 1:],
                      torch.full((t, 1), e, dtype=torch.int32, device=dev)],
                     dim=1)
    run_entries = torch.clamp(nxt1, max=e) - iota       # valid at starts
    mlen = (run_entries - 1) * stride + 4

    # Frontier-advance filter (the order-free core of the greedy parse): a
    # record is useful only if it reaches >= 4 bytes past the furthest end
    # of the records before it.
    keep0 = start & (mlen >= min_len)
    end = pos_b + mlen
    fr = torch.cummax(torch.where(keep0, end, 0), dim=1).values
    keep = keep0 & (end >= _shift_right(fr, 0) + 4)

    gpos = pos_b + (torch.arange(t, dtype=torch.int32, device=dev)
                    * _S)[:, None]
    rec = to_i32((d.to(torch.int64) << 16)
                 | torch.clamp(mlen, max=65535).to(torch.int64))
    total = keep.sum()

    # Kernel 5, L1: kept records to the front of 8,192-entry rows; a
    # transpose deals rows round-robin so the skewed record density
    # balances before the L2 pack and its prefix slice.
    t3 = gpos.numel() // _E3
    kk = keep.reshape(t3, _E3)
    l_iota = torch.arange(_E3, dtype=torch.int32, device=dev).expand(t3, _E3)
    k3 = torch.where(kk, l_iota, _E3)
    g3 = torch.where(kk, gpos.reshape(t3, _E3), _INVALID)
    _, g1, r1 = sort_cuda.sort_rows(k3, g3, rec.reshape(t3, _E3))
    del k3, g3, rec
    g1, r1 = g1[:, :p1], r1[:, :p1]                      # L1 prefix slice
    e2 = p1 * t3 // _L2R
    g2 = g1.t().reshape(_L2R, e2).contiguous()
    r2 = r1.t().reshape(_L2R, e2).contiguous()
    i2 = torch.arange(e2, dtype=torch.int32, device=dev).expand(_L2R, e2)
    k2 = torch.where(g2 != _INVALID, i2, e2)
    _, go, ro = sort_cuda.sort_rows(k2, g2, r2, pad_key=_INVALID,
                                    pad_vals=(_INVALID, 0))
    go, ro = go[:, :p2], ro[:, :p2]                      # L2 prefix slice
    # L3: one row keyed on gpos itself (valid positions are unique,
    # _INVALID sorts last), so records land position-ascending and the
    # readback is sized by p3, not by the per-row worst case.
    gf = go.reshape(1, -1).contiguous()
    rf = ro.reshape(1, -1).contiguous()
    g4, r4 = sort_cuda.sort_rows(gf, rf, pad_key=_INVALID, pad_vals=(0,))
    g4, r4 = g4[0, :p3], r4[0, :p3]                      # L3 prefix slice
    if not packed:
        return torch.cat([total.to(torch.int32).view(1), g4, r4])

    # Packed encode (layout in the docstring), in int64 with u32 wrap.
    valid = g4 != _INVALID
    nv = valid.sum()
    pos_u = torch.where(valid, g4.to(torch.int64), 0) // stride
    dpos = torch.where(valid, pos_u - _shift_right(pos_u, 0), 0)
    esc1 = valid & (dpos >= 0xFFFF)
    dpos16 = torch.where(esc1, 0xFFFF, dpos)
    ru = r4.to(torch.int64) & M32
    delta_u = (ru >> 16) // stride
    ml = ru & 0xFFFF
    # 65535 is the clip value, never a natural length (natural lengths
    # are == 4 mod stride), so the sentinel is unambiguous
    len_u = torch.where(ml == 65535, 32766, ((ml - 4) & M32) // stride)
    esc2 = valid & (len_u >= 511)
    l9 = torch.where(esc2, 511, len_u)
    a_w = torch.where(valid, (delta_u | (l9 << 15) | ((dpos16 >> 8) << 24))
                      & M32, 0)
    blo = torch.where(valid, dpos16 & 0xFF, 0).view(-1, 4)
    b_w = (blo[:, 0] | (blo[:, 1] << 8) | (blo[:, 2] << 16)
           | (blo[:, 3] << 24))
    # Escape lanes: escaped records' absolute values to a static prefix,
    # in record order (the key is the record slot index).
    es = _esc_slots(p3)
    i4 = torch.arange(p3, dtype=torch.int32, device=dev)
    lanes = []
    for esc, v in ((esc1, pos_u), (esc2, len_u)):
        k = torch.where(esc, i4, p3)[None]
        val = torch.where(esc, v, 0).to(torch.int32)[None]
        lanes.append(sort_cuda.sort_rows(k, val, pad_key=_INVALID,
                                         pad_vals=(0,))[1][0, :es])
    hdr = torch.stack([total, nv, esc1.sum(), esc2.sum()]).to(torch.int32)
    return torch.cat([hdr, to_i32(a_w), to_i32(b_w), *lanes])


def _readback(rows: torch.Tensor):
    """Start the D2H copy of ``rows``: (host tensor, CUDA event or None)."""
    if rows.device.type == "cpu":
        return rows, None
    host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    host.copy_(rows, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(rows.device))
    return host, ready


def _landed(host: torch.Tensor, ready) -> np.ndarray:
    if ready is not None:
        ready.synchronize()
    return host.numpy()


@dataclasses.dataclass
class Lz4Job:
    n: int                         # true byte length
    host: np.ndarray               # host copy for emit/fallback
    block: torch.Tensor | None     # padded u8 on the device (overflow retry)
    recs: torch.Tensor | None      # host copy of the packed row, in flight
    p1: int = 0
    p2: int = 0
    p3: int = 0
    ev: object = None              # ledger token: scan dispatch -> readback
    ready: object = None           # CUDA event after the row's D2H copy


class DeviceLz4:
    """Async LZ4 front end over the device match scan.

    Usage (overlapped): ``jobs = [c.submit(b) for b in bufs]`` then
    ``[c.finish(j) for j in jobs]``; ``compress`` is the synchronous
    form.  Inputs smaller than ``min_device`` bytes take the native path
    (device overhead beats the win below a couple of supertiles).
    """

    def __init__(self, stride: int = 2, min_len: int = 4,
                 min_device: int = 2 * _S, device="cuda"):
        if stride not in (2, 4):
            raise ValueError("stride must be 2 or 4")
        self.device = resolve_device(device)
        self.stride = stride
        self.min_len = min_len
        self.min_device = min_device
        # Slice widths learned from overflow retries stick: blocks in one
        # stream compress alike.  The lock covers the hint state, since
        # concurrent seals (a DataNode's container lanes) share an engine.
        self._p1 = 512
        self._p2 = 4096
        self._p3 = 1 << 17  # L3 packed-record slots (the D2H width)
        # Workload-adaptive flood bypass: after BYPASS_AFTER consecutive
        # flood fallbacks, the next BYPASS_RUN submits skip the device scan,
        # then one probing scan re-checks the stream's character.
        self._flood_streak = 0
        self._bypass_left = 0
        self.BYPASS_AFTER = 2
        self.BYPASS_RUN = 16
        self._lock = threading.Lock()

    def _pad(self, a: np.ndarray) -> np.ndarray:
        pad = (-a.size) % _S
        return np.concatenate([a, np.zeros(pad, np.uint8)]) if pad else a

    def _upload(self, a: np.ndarray, device=None) -> torch.Tensor:
        if not a.flags.writeable:  # torch refuses read-only buffers
            a = a.copy()
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device if device is None else device)

    def _shapes(self, n_pad: int) -> tuple[int, int, int]:
        entries = n_pad // self.stride
        t3 = entries // _E3
        p1 = min(self._p1, _E3)
        while p1 * t3 % _L2R and p1 < _E3:
            p1 *= 2
        # _E3 is a multiple of _L2R, so the cap always divides evenly
        p2 = min(self._p2, p1 * t3 // _L2R)
        p3 = min(self._p3, _L2R * p2)
        return p1, p2, p3

    def _scan(self, block: torch.Tensor, p1: int, p2: int, p3: int,
              packed: bool = True) -> np.ndarray:
        """A synchronous scan (the rescans): its row on the host."""
        return _landed(*_readback(match_scan(block, self.stride,
                                             self.min_len, p1, p2, p3,
                                             packed)))

    def submit(self, data, device=None) -> Lz4Job:
        """Start one block's scan on ``device`` (default: the engine's)."""
        a = (np.frombuffer(data, dtype=np.uint8)
             if not isinstance(data, np.ndarray) else data)
        if a.size < self.min_device:
            return Lz4Job(n=a.size, host=a, block=None, recs=None)
        with self._lock:
            if self._bypass_left > 0:
                self._bypass_left -= 1
                _M_FLOOD.incr("bypassed_scans")
                return Lz4Job(n=a.size, host=a, block=None, recs=None)
        return self._submit_scan(a, device)

    def _submit_scan(self, a: np.ndarray, device=None) -> Lz4Job:
        block = self._upload(self._pad(a), device)
        p1, p2, p3 = self._shapes(block.numel())
        ev = _ledger.dispatch("lz4.scan", h2d_bytes=block.numel())
        recs, ready = _readback(match_scan(block, self.stride, self.min_len,
                                           p1, p2, p3))
        return Lz4Job(n=a.size, host=a, block=block, recs=recs, p1=p1, p2=p2,
                      p3=p3, ev=ev, ready=ready)

    def _unpack_full(self, rec_row: np.ndarray, p3: int):
        total = int(rec_row[0])
        g = rec_row[1:1 + p3]
        r = rec_row[1 + p3:]
        m = g != _INVALID
        g, r = g[m], r[m]
        # The L3 sort is by gpos, so records already arrive ascending; the
        # stable argsort stays as a guard on this rare path.
        order = np.argsort(g, kind="stable")
        return total, g[order], r[order].view(np.uint32)

    def _unpack_packed(self, rec_row: np.ndarray, p3: int):
        total, nv = int(rec_row[0]), int(rec_row[1])
        e1, e2 = int(rec_row[2]), int(rec_row[3])
        es = _esc_slots(p3)
        g, r, nrec = native.lz4_unpack_records(
            np.ascontiguousarray(rec_row[4:]).view(np.uint32), p3, nv,
            self.stride, es)
        complete = e1 <= es and e2 <= es and nrec == nv
        return total, g[:nrec], r[:nrec], complete

    def _records(self, job: Lz4Job, rec_row: np.ndarray):
        """Decode one packed record row; escape-lane overflow rescans in the
        full layout for the exact record set."""
        total, g, r, complete = self._unpack_packed(rec_row, job.p3)
        if not complete and job.block is not None:
            _M_FLOOD.incr("escape_rescans")
            ev = _ledger.dispatch("lz4.rescan")
            row = self._scan(job.block, job.p1, job.p2, job.p3,
                             packed=False)
            _ledger.readback(ev, d2h_bytes=row.nbytes)
            return self._unpack_full(row, job.p3)
        return total, g, r

    def _assemble(self, job: Lz4Job, rec_row: np.ndarray) -> bytes:
        total, g, r = self._records(job, rec_row)
        # Slice overflow dropped records: jump every hint straight to the
        # size ``total`` demands (sticky), then rescan once per hint level.
        while total > g.size and job.block is not None:
            with self._lock:
                def pow2(v: int) -> int:
                    return 1 << int(max(v, 1) - 1).bit_length()

                need = pow2(total)
                e_cap = job.block.numel() // self.stride
                if need > max(e_cap // 64, 1 << 16):
                    # Record flood (a sequence every < ~128 B): the serial
                    # hash-table encoder's home turf takes over below.
                    break
                t3 = max(e_cap // _E3, 1)
                self._p3 = max(self._p3, min(need, e_cap))
                if need > _L2R * self._shapes(job.block.numel())[1]:
                    # per-row L2 slots must cover the records too (skew
                    # headroom 2x), or the L3 pack starves
                    self._p2 = max(self._p2,
                                   min(pow2(2 * need // _L2R),
                                       e_cap // _L2R))
                if need > self._shapes(job.block.numel())[0] * t3:
                    # hints stay powers of two: _shapes' divisibility
                    # doubling must terminate at the _E3 cap
                    self._p1 = max(self._p1,
                                   min(_E3, pow2(2 * need // t3)))
                shapes = self._shapes(job.block.numel())
            if shapes == (job.p1, job.p2, job.p3):
                break  # capacity exhausted: dropped records cost only ratio
            p1, p2, p3 = shapes
            ev = _ledger.dispatch("lz4.rescan")
            rec_row = self._scan(job.block, p1, p2, p3)
            _ledger.readback(ev, d2h_bytes=rec_row.nbytes)
            job.p1, job.p2, job.p3 = p1, p2, p3
            total, g, r = self._records(job, rec_row)
        if total > g.size:
            # Record flood the slices cannot represent: fall back to the
            # serial encoder (segmented) instead of emitting from an
            # arbitrary record subset.
            _M_FLOOD.incr("native_fallbacks")
            with self._lock:
                self._flood_streak += 1
                if self._flood_streak >= self.BYPASS_AFTER:
                    self._bypass_left = self.BYPASS_RUN
            return _lz4_compress_parallel(job.host)
        with self._lock:
            self._flood_streak = 0
        m = g < max(job.n - 12, 0)    # spec MFLIMIT; drops pad-region hits
        g, r = g[m], r[m]
        out = native.lz4_emit(job.host, g, r)
        _M_FLOOD.incr("emits")
        if total > (job.n // self.stride) >> 10:
            # Grey zone (non-trivial record density below the flood cap):
            # decide on a mid-container sample whether to race the native
            # encoder, and keep the smaller stream.
            if self._sample_says_emit_wins(job, g, r, len(out)):
                _M_FLOOD.incr("races_skipped")
            else:
                alt = _lz4_compress_parallel(job.host)
                if len(alt) and len(alt) < len(out):
                    _M_FLOOD.incr("native_wins")
                    out = alt
        return out

    _RACE_SAMPLE = 4 << 20

    def _sample_says_emit_wins(self, job: Lz4Job, g: np.ndarray,
                               r: np.ndarray, out_len: int) -> bool:
        """True when the device-records emit beats the serial encoder by
        >= 2% on a mid-container sample span (same bytes, same records,
        rebased)."""
        n = job.n
        if n < 3 * self._RACE_SAMPLE or out_len >= n:
            return False
        lo = (n // 2) & ~65535
        lo0 = max(lo - 65536, 0)   # back-window so sampled offsets verify
        hi = min(lo + self._RACE_SAMPLE, n)
        sl = job.host[lo0:hi]
        m = (g >= lo0) & (g < hi - 12)
        es = native.lz4_emit(sl, g[m] - lo0, r[m])
        ns = native.lz4_compress(sl)
        return len(es) * 100 <= len(ns) * 98

    def finish(self, job: Lz4Job) -> bytes:
        if job.recs is None:
            return _lz4_compress_parallel(job.host) if job.n else b""
        rows = _landed(job.recs, job.ready)
        _ledger.readback(job.ev, d2h_bytes=rows.nbytes)
        job.ev = None
        out = self._assemble(job, rows)
        job.block = None
        job.recs = None
        return out

    def compress(self, data) -> bytes:
        return self.finish(self.submit(data))

    # ------------------------------------------------------------- groups

    def submit_many(self, datas: list, devices=None) -> list[Lz4Job]:
        """Submit a group.  A bypass covers the whole group or none of it,
        and a group of two or more equal-length device-sized blocks is
        scanned whole even while a shorter bypass is pending (the
        reference's batched group); otherwise per-buffer submits.
        ``devices`` places each block's scan (the sharded group of
        parallel/sharded.lz4_submit_many_sharded); the policy and so the
        streams do not depend on it."""
        arrs = [np.frombuffer(d, dtype=np.uint8)
                if not isinstance(d, np.ndarray) else d for d in datas]
        with self._lock:
            if self._bypass_left >= len(arrs):
                self._bypass_left -= len(arrs)
                _M_FLOOD.incr("bypassed_scans", len(arrs))
                return [Lz4Job(n=a.size, host=a, block=None, recs=None)
                        for a in arrs]
        whole = (len(arrs) > 1 and len({a.size for a in arrs}) == 1
                 and arrs[0].size >= self.min_device)
        devs = devices if devices is not None else [None] * len(arrs)
        return [self._submit_scan(a, d) if whole else self.submit(a, d)
                for a, d in zip(arrs, devs)]

    def finish_many(self, jobs: list[Lz4Job]) -> list[bytes]:
        return [self.finish(j) for j in jobs]

    def compress_many(self, datas: list) -> list[bytes]:
        return self.finish_many(self.submit_many(datas))

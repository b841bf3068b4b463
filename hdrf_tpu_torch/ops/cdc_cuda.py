"""Content-defined chunking on the card: kernel 1 and its plain version
(port of hdrf_tpu/ops/cdc_pallas.py; replaces the Pallas ``_select_kernel``
reached through ``_select_call`` at cdc_pallas.py:476).

What it computes, per block: the Gear window-32 hash of every byte, the
candidate cuts ``(h & mask) == 0`` at ``skip_ahead_threshold(min) <= pos1
<= n``, the min/max frontier selection of native/src/cdc.cpp:74-92
(``lo = f + min``, ``hi = min(f + max, n)``, first candidate in [lo, hi]
else ``hi``), the big-endian word image, and the chunks binned into two
offset/length lane tables by padded SHA block count.

Design (csrc/cdc.cu).  The TPU kernel walks the block as a sequential grid
carrying the hash history and the frontier in scratch; on Hopper that
would leave 131 of 132 SMs idle, so the work is a parallel scan and a
parallel select on one stream:

(a) a parallel scan on a persistent grid: each warp walks a contiguous
    span of 1 KiB chunks staged through its own cp.async ring in shared
    memory; each lane hashes one 32-byte piece from zero history and
    takes the hash entering it from its left neighbour by a shuffle (the
    window is 32 bytes and ``h = (h << 1) + G[b]`` is linear, so the hash
    after byte j is ``hp_j + (s << (j + 1))``), which makes one bitmap
    word a lane; the Gear table is one copy in shared memory.
    It writes the BE word image and a candidate bitmap (bit ``i`` =
    ``pos1 == i + 1``), both in coalesced stores, and applies the
    position rule only in the chunks that hold ``thr`` or ``n``.  Its
    words-only mode (``be_image``) writes the image alone.  Bound: bytes
    — it reads the block once and writes it once more as words, plus the
    bitmap (about 0.085 ms per 128 MiB at 3.35 TB/s; the words-only mode
    0.020 ms per 32 MiB).
(b) the select — segmented speculative walks and a stitch, four kernels
    (one wrapper call, one launch count).  The block is cut into segments
    of ``seg_width`` positions (default 128 KiB rounded to a multiple of
    ``max_chunk``, so zeros and candidate-free runs align with the
    segments); one warp per segment walks the frontier from the segment
    start as if a cut stood there; each walker then goes on, at most four
    segments' worth of cuts, until it lands on a point of the next
    segments' chains (where two chains meet they agree); one warp follows
    those merge pointers from segment 0, the only exact start, walking on
    by itself through a shared-memory window of the bitmap past a walker
    that did not merge, and the block scans the segments' counts; then
    every segment on the true chain writes its cuts and lanes in
    parallel.  Where chains never meet (a short period with one
    candidate a period) that one warp walks the whole block: the worst
    case is a serial walk, never a wrong answer.  The header's telemetry
    lanes ride the same launches: ``H_CANDS`` counts the bitmap's set
    bits (the candidates the skip-ahead rule kept) and ``H_SURV`` its
    rows of 512 positions (16 words; row ``r`` covers ``pos1`` in
    ``[512 r + 1, 512 r + 512]``) holding at least one, the reference
    kernel's survivor rows of its (R, 128)-word tiles (cdc_pallas.py:
    334-339, 469-470: each tile's fresh rows counted once).
    ``TALLY_BLOCKS`` more thread blocks of the spec launch count them
    beside the walkers, which are latency-bound, a pair a block, and the
    stitch sums the pairs into the header that the reducer already copies
    back.  Bound: bytes (the
    bitmap read once, a few words per cut written); the walks are
    latency-bound (one dependent L2 load per 4,096 bitmap bits), hence
    spread over ~1,000 warps for a 128 MiB block.

One select covers both reference variants (the skip-ahead sequence select
and the PR 4 walk), which give identical cuts by construction.

**No overflow.**  On the TPU the cut table and lane tables had a
distributional capacity forced by VMEM/SMEM, and a dense block (all
zeros: every position is a candidate) overflowed into an XLA fallback.
Here the tables are sized to the hard bound ``n // min_chunk + 2`` (about
65.5 K entries, 256 KB, for a 128 MiB block at the default 2 KiB
minimum), which no block can exceed, so ``overflowed`` is always False.

Each launch has its own wrapper and launch counter (``cdc_scan``,
``cdc_select``; ``cdc_block`` runs both).  On a CPU tensor a wrapper runs
its plain version (ops/gear.py scan, host select); on a CUDA tensor it
launches its kernel or raises.

**The shard scan** (``shard_scan``, counter ``shard_scan_launches``)
replaces the Pallas ``_scan_kernel`` (pallas_call at cdc_pallas.py:570,
host half ``local_candidate_words_pallas`` at :621-647): the candidate
scan of one ``seq`` shard of a block in the sharded reduction
(parallel/sharded.py).  The same scan body, but the shard's first chunk
takes its history from a 31-byte halo (the previous shard's tail, zeros
for shard 0, read by bytes: it is an unaligned slice), a candidate needs
only ``pos1 >= WINDOW`` of the whole block (no ``<= n`` clamp and no
min-chunk floor: the zero pad's candidates are counted, and the host
drops them), no word image is written, and it returns packed bitmap
words in the reference's ``pack_bitmap_words`` layout, so the TPU
kernel's nibble stage has no counterpart, plus the candidate count.
Bound: bytes — the shard and halo read once, the bitmap written once.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from hdrf_tpu_torch.ops import _build, gear

PAD_GRID = 512          # block bytes are padded to this grid (zeros)
SEG_WIDTH = 1 << 17     # select segment width in positions (default)
MAX_SEGS = 8192         # the select's stitch holds its pointers on chip
WALK_REACH = 4          # select converge walks, in segments' worth of cuts
SEG_ARRAYS = 12         # select scratch arrays of one int a segment
RUN_ARRAYS = 4          # select scratch arrays of one int a serial cut
TALLY_BLOCKS = 256      # select spec blocks counting the telemetry lanes
ROW_WORDS = 16          # bitmap words of a telemetry row (512 positions)
TABLE_HDR = 8
H_COUNT, H_OVERFLOW, H_SMALL, H_BIG = 0, 1, 2, 3
H_SURV, H_CANDS = 4, 5  # telemetry: candidate rows, candidates

# Launches of each kernel, one per wrapper call on a CUDA block
# (``image_launches``: the scan's words-only mode, ``be_image``).
scan_launches = 0
image_launches = 0
select_launches = 0
shard_scan_launches = 0
_launch_lock = threading.Lock()


def cap_for(n: int, min_chunk: int) -> int:
    """Hard bound on the cut count of an n-byte block."""
    return n // max(1, int(min_chunk)) + 2


def padded_block(data, device) -> tuple[torch.Tensor, int]:
    """(u8 block padded with zeros to PAD_GRID, true length) on ``device``
    from host bytes / a u8 ndarray / a u8 tensor."""
    if isinstance(data, torch.Tensor):
        n = data.numel()
        if data.device == torch.device(device) and n % PAD_GRID == 0:
            return data.reshape(-1), n
        src = data.reshape(-1)
    else:
        a = (data if isinstance(data, np.ndarray)
             else np.frombuffer(data, dtype=np.uint8))
        n = a.size
        if not a.flags.writeable:  # torch refuses read-only buffers
            a = a.copy()
        src = torch.from_numpy(np.ascontiguousarray(a))
    n_pad = n + (-n) % PAD_GRID
    block = torch.empty(n_pad, dtype=torch.uint8, device=device)
    block[:n].copy_(src)
    block[n:].zero_()
    return block, n


def _bins(cuts: np.ndarray, b_small: int):
    starts = np.concatenate([[0], cuts[:-1]]).astype(np.int64)
    lens = cuts.astype(np.int64) - starts
    small = (lens + 9 + 63) // 64 <= b_small
    return starts, lens, small


def _check_block(block: torch.Tensor, n: int, what: str) -> None:
    if block.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {block.device}")
    if block.dtype != torch.uint8 or block.dim() != 1 \
            or not block.is_contiguous() or block.data_ptr() % 16:
        raise ValueError(f"{what}: expected a contiguous, 16-byte aligned "
                         "1-D uint8 block")
    n_pad = block.numel()
    if n_pad % PAD_GRID or not 0 < n <= n_pad or n_pad >= (1 << 31):
        raise ValueError(f"{what}: bad lengths n={n} n_pad={n_pad}")


def cdc_scan_plain(block: torch.Tensor, n: int, mask: int, min_chunk: int):
    """Plain version of :func:`cdc_scan`, on the block's own device."""
    cand = gear.candidate_positions(block, n, mask, max(1, int(min_chunk)))
    bits = torch.zeros(block.numel(), dtype=torch.bool, device=block.device)
    bits[cand - 1] = True
    return gear.be_words(block), gear.pack_bits(bits)


def cdc_scan(block: torch.Tensor, n: int, mask: int, min_chunk: int):
    """Gear scan of one block (the first launch of the CDC pair).

    block: u8[n_pad] (n_pad % 512 == 0, zeros past ``n``).  Returns
    ``(words int32[n_pad/4]`` BE image bit patterns, ``bitmap
    int32[n_pad/32]``), bit ``i % 32`` of word ``i // 32`` set when
    ``pos1 = i + 1`` is a selectable candidate (``(h & mask) == 0``,
    ``skip_ahead_threshold(min) <= pos1 <= n``)."""
    if block.device.type == "cpu":
        return cdc_scan_plain(block, n, mask, min_chunk)
    _check_block(block, n, "cdc_scan")
    global scan_launches
    n_pad = block.numel()
    words = torch.empty(n_pad // 4, dtype=torch.int32, device=block.device)
    bitmap = torch.empty(n_pad // 32, dtype=torch.int32, device=block.device)
    _build.launch("hdrf_cdc_scan", block.device, block.data_ptr(), n_pad, n,
                  mask & 0xFFFFFFFF, max(1, int(min_chunk)), words.data_ptr(),
                  bitmap.data_ptr(), what="cdc scan kernel")
    with _launch_lock:  # handler threads of the worker launch too
        scan_launches += 1
    return words, bitmap


def shard_scan_plain(local: torch.Tensor, halo: torch.Tensor, base: int,
                     mask: int):
    """Plain version of :func:`shard_scan`, on the shard's own device: the
    window hashes of ``halo ‖ local``, the position rule, the pack."""
    m = local.numel()
    h = gear.window_hashes(torch.cat([halo, local]))[gear.HALO:]
    pos1 = torch.arange(base + 1, base + m + 1, dtype=torch.int64,
                        device=local.device)
    bits = ((h & (mask & gear.M32)) == 0) & (pos1 >= gear.MIN_CANDIDATE_POS1)
    return gear.pack_bits(bits), bits.sum().to(torch.int32).view(1)


def shard_scan(local: torch.Tensor, halo: torch.Tensor, base: int,
               mask: int):
    """Gear candidate scan of one shard of a block.

    local: u8[m] (m % 256 == 0) — the shard; halo: u8[31] on the same
    device — the previous shard's last 31 bytes, zeros for the first
    shard; base: the shard's offset in the block.  Returns ``(words
    int32[m/32]``, ``count int32[1])``: bit ``k`` of word ``w`` is set when
    the window-32 hash ending at local byte ``32 w + k`` has ``(h & mask)
    == 0`` and ``base + 32 w + k + 1 >= WINDOW``; ``count`` is the number
    of set bits."""
    if local.device.type == "cpu":
        return shard_scan_plain(local, halo, base, mask)
    if local.device.type != "cuda" or halo.device != local.device:
        raise ValueError("shard_scan: local and halo must share a CUDA "
                         "device")
    m = local.numel()
    if local.dtype != torch.uint8 or local.dim() != 1 \
            or not local.is_contiguous() or local.data_ptr() % 16 \
            or m == 0 or m % 256 or m >= (1 << 31):
        raise ValueError("shard_scan: expected a contiguous, 16-byte aligned "
                         f"1-D uint8 shard of a multiple of 256 bytes, got "
                         f"{m}")
    if halo.dtype != torch.uint8 or halo.shape != (gear.HALO,) \
            or not halo.is_contiguous():
        raise ValueError(f"shard_scan: expected a uint8[{gear.HALO}] halo")
    global shard_scan_launches
    words = torch.empty(m // 32, dtype=torch.int32, device=local.device)
    count = torch.empty(1, dtype=torch.int32, device=local.device)
    _build.launch("hdrf_cdc_shard_scan", local.device, local.data_ptr(),
                  halo.data_ptr(), m, int(base), mask & 0xFFFFFFFF,
                  words.data_ptr(), count.data_ptr(),
                  what="cdc shard scan kernel")
    with _launch_lock:
        shard_scan_launches += 1
    return words, count


def cdc_select_plain(bitmap: torch.Tensor, n: int, min_chunk: int,
                     max_chunk: int, b_small: int):
    """Plain version of :func:`cdc_select`, on the bitmap's own device."""
    min_chunk = max(1, int(min_chunk))
    dev = bitmap.device
    shift = torch.arange(32, dtype=torch.int64, device=dev)
    bits = (bitmap.to(torch.int64)[:, None] >> shift) & 1
    cand = (torch.nonzero(bits.reshape(-1)).reshape(-1) + 1).cpu().numpy()
    cuts = gear.cdc_select(cand, n, min_chunk, max_chunk)
    surv, ncand = scan_telemetry_plain(bitmap)
    cap = cap_for(n, min_chunk)
    starts, lens, small = _bins(cuts, b_small)
    table = np.zeros(TABLE_HDR + cap, dtype=np.int32)
    table[TABLE_HDR:TABLE_HDR + cuts.size] = cuts
    ns, nbg = int(small.sum()), int((~small).sum())
    table[:6] = (cuts.size, 0, ns, nbg, surv, ncand)
    ols = np.zeros((2, cap), dtype=np.int32)
    olb = np.zeros((2, cap), dtype=np.int32)
    ols[0, :ns], ols[1, :ns] = starts[small], lens[small]
    olb[0, :nbg], olb[1, :nbg] = starts[~small], lens[~small]
    return (torch.from_numpy(table).to(dev), torch.from_numpy(ols).to(dev),
            torch.from_numpy(olb).to(dev))


def scan_telemetry_plain(bitmap: torch.Tensor) -> tuple[int, int]:
    """(``H_SURV``, ``H_CANDS``) of a candidate bitmap: its rows of
    ``ROW_WORDS`` words holding a set bit, and its set bits."""
    x = bitmap.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    pad = (-x.numel()) % ROW_WORDS
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    x = x - ((x >> 1) & 0x55555555)                  # popcount by halves
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    pop = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    per_row = pop.reshape(-1, ROW_WORDS).sum(dim=1)
    return int((per_row > 0).sum()), int(per_row.sum())


def select_geometry(n: int, min_chunk: int, max_chunk: int,
                    seg_width: int | None = None) -> tuple[int, int]:
    """(segment width, scratch ints) of the select kernel for an n-byte
    block: the width is ``seg_width`` (default ``SEG_WIDTH`` rounded down
    to a multiple of ``max_chunk``), raised until at most ``MAX_SEGS``
    segments cover the block; each segment keeps ``lcap = min(W, n) //
    min + 3`` points and ``WALK_REACH * lcap`` walker cuts, each with a
    running small count, plus ``SEG_ARRAYS`` counters; the serial walk
    keeps up to ``cap_for(n, min)`` cuts, plus their count; each tally
    block of the spec launch its pair of telemetry counts."""
    w = seg_width or max_chunk * max(1, SEG_WIDTH // max_chunk)
    w = max(int(w), -(-n // MAX_SEGS))
    s = -(-n // w)
    lcap = min(w, n) // min_chunk + 3
    return w, ((2 + 2 * WALK_REACH) * s * lcap + SEG_ARRAYS * s
               + RUN_ARRAYS * cap_for(n, min_chunk) + 1 + 2 * TALLY_BLOCKS)


def cdc_select(bitmap: torch.Tensor, n: int, min_chunk: int, max_chunk: int,
               b_small: int, *, seg_width: int | None = None):
    """Min/max cut select over a candidate bitmap (the second launch of
    the CDC pair).  Returns ``(table int32[8+cap]`` = header + cuts,
    ``ols``/``olb int32[2, cap]`` small/big lanes — row 0 byte offsets,
    row 1 lengths); entries past the header counts are unspecified.  A
    chunk is small when its padded SHA block count ``(len + 9 + 63) // 64
    <= b_small``.  ``seg_width`` sets the kernel's segment width (tests
    set it small to stress the stitch); the result does not depend on
    it."""
    if bitmap.device.type == "cpu":
        return cdc_select_plain(bitmap, n, min_chunk, max_chunk, b_small)
    if bitmap.device.type != "cuda" or bitmap.dtype != torch.int32 \
            or not bitmap.is_contiguous() or bitmap.data_ptr() % 16 \
            or not 0 < n <= 32 * bitmap.numel() or n >= (1 << 31):
        raise ValueError("cdc_select: expected a contiguous, 16-byte "
                         f"aligned int32 CUDA bitmap covering n={n}")
    global select_launches
    min_chunk = max(1, int(min_chunk))
    cap = cap_for(n, min_chunk)
    dev = bitmap.device
    table = torch.empty(TABLE_HDR + cap, dtype=torch.int32, device=dev)
    ols = torch.empty((2, cap), dtype=torch.int32, device=dev)
    olb = torch.empty((2, cap), dtype=torch.int32, device=dev)
    w, nscr = select_geometry(n, min_chunk, int(max_chunk), seg_width)
    scratch = torch.empty(nscr, dtype=torch.int32, device=dev)
    _build.launch("hdrf_cdc_select", dev, bitmap.data_ptr(), bitmap.numel(),
                  n, min_chunk, int(max_chunk), int(b_small), table.data_ptr(),
                  ols.data_ptr(), olb.data_ptr(), cap, w, scratch.data_ptr(),
                  what="cdc select kernel")
    with _launch_lock:
        select_launches += 1
    return table, ols, olb


def cdc_block_plain(block: torch.Tensor, n: int, mask: int, min_chunk: int,
                    max_chunk: int, b_small: int):
    """Plain version of :func:`cdc_block`, on the block's own device."""
    words, bitmap = cdc_scan_plain(block, n, mask, min_chunk)
    return (words, *cdc_select_plain(bitmap, n, min_chunk, max_chunk,
                                     b_small))


def cdc_block(block: torch.Tensor, n: int, mask: int, min_chunk: int,
              max_chunk: int, b_small: int):
    """Chunk one block: :func:`cdc_scan` then :func:`cdc_select` on one
    stream.  Returns ``(words, table, ols, olb)``, all on the block's
    device."""
    words, bitmap = cdc_scan(block, n, mask, min_chunk)
    return (words, *cdc_select(bitmap, n, min_chunk, max_chunk, b_small))


def be_image(block: torch.Tensor) -> torch.Tensor:
    """int32 big-endian word image of a padded u8 block (``cdc_scan``'s
    first output) for a caller that brings its own cuts.  On the card it
    is the scan kernel's words-only mode (no hash, no bitmap; counter
    ``image_launches``), so no plain code runs on a CUDA tensor."""
    if block.device.type == "cpu":
        return gear.be_words(block)
    n = block.numel()
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=block.device)
    _check_block(block, n, "be_image")
    global image_launches
    words = torch.empty(n // 4, dtype=torch.int32, device=block.device)
    _build.launch("hdrf_be_image", block.device, block.data_ptr(), n,
                  words.data_ptr(), what="cdc scan kernel (words only)")
    with _launch_lock:
        image_launches += 1
    return words


def table_cuts(table: np.ndarray) -> np.ndarray:
    """uint64 cuts from a host copy of a cut table."""
    nc = int(table[H_COUNT])
    return table[TABLE_HDR:TABLE_HDR + nc].astype(np.uint64)


def chunks_fused(data, mask: int, min_chunk: int, max_chunk: int, *,
                 device="cuda") -> tuple[np.ndarray, bool]:
    """(cuts, overflowed) of one block, cut selection on the device — the
    cut contract of native.cdc_chunk.  ``data``: host bytes / u8 ndarray
    (uploaded to ``device``) or a u8 tensor (used where it lies).
    ``overflowed`` is always False: the tables hold the hard cut bound."""
    if isinstance(data, torch.Tensor):
        device = data.device
    block, n = padded_block(data, device)
    if n == 0:
        return np.empty(0, dtype=np.uint64), False
    _, table, _, _ = cdc_block(block, n, mask, min_chunk, max_chunk,
                               b_small=1 << 30)
    return table_cuts(table.cpu().numpy()), False

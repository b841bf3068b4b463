"""The LZ4 match scan's sort engine: kernels 4 and 5 and their plain
versions (port of hdrf_tpu/ops/sort_pallas.py; replaces the Pallas
``_match_deltas_call`` at sort_pallas.py:273 and ``_sort_rows_call`` at
sort_pallas.py:148).

``match_deltas(vals, stride, pos_bits)`` — (t, e) 4-gram entries of one
row per 128 KiB supertile (stride 2: the even-position words then the
odd-position phase words; stride 4: the words) -> (t, e) back-reference
deltas **in position order**: for position p, q is the latest position
< p in the row with the same ``hash16 = (v * 2654435761) >> 16``;
``delta(p) = (p - q) * stride`` when ``v[q] == v[p]``, ``v[p] !=
rotl8(v[p])`` and the product is <= 65535, else 0.  The plain version is
the reference's sorted formulation (``match_deltas_xla``,
sort_pallas.py:286-306): sort ``hash16 << pos_bits | pos`` keys, compare
each entry with its left neighbour, sort back by position.

``sort_rows(key, *vals, pad_key=, pad_vals=, key_unsigned=)`` — per-row
ascending key/value sort of (t, e) int32 tensors with one or two carried
values; ``key_unsigned`` orders the key's bits as u32.  Rows that are not
a power of two are padded with the caller's sentinel, which must sort at
or past every live key; the result has the input's width.  The sort is
stable — equal keys keep their input order, pad slots after live ones —
so the kernel and the plain version (``torch.sort(stable=True)``) agree
on every slot.

Design (csrc/sort.cu).  Only a previous occurrence at most 65,535 bytes
back gives a delta, so the match kernel answers each row tile by tile:
one block per tile of 8,192 positions sorts the tile by hash16 (a stable
radix sort in shared memory), takes every position's left neighbour of
the same hash as q, and writes the tile's summary (hash bitmap, distinct
hashes before each bitmap word, first and last slot of each hash, the
first slot's gram) to scratch; a second launch lets each tile's first position of a hash look
back through the earlier tiles inside its window, nearest first, and
stop at the first whose bitmap holds the hash.  Gram compare, degenerate
test and cap are done where q is found.

The row sort is a radix tile sort plus merges: one block per tile of up
to 8,192 entries runs a stable LSD radix sort in shared memory over only
the key bits that vary in the tile (the L1/L2 pack keys, row-local
indices up to 8,192: two 7-bit passes), and rows longer than a tile (the
L3 and escape rows, up to 2^19 entries) then take log2(E / 8,192)
merge-path merge passes, one launch each over all rows, every block
making a 2,048-entry slice of output.  Bound: bytes for both (each
row read once and written once at 3.35 TB/s).

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.  Each wrapper counts one launch per call
on a CUDA tensor (``match_deltas_launches``, ``sort_rows_launches``).
"""

from __future__ import annotations

import threading

import torch

from hdrf_tpu_torch.ops import _build
from hdrf_tpu_torch.ops.gear import M32

HASH_MUL = 2654435761   # golden-ratio multiplier (lz4.cpp hash4)
_BIAS = -(1 << 31)      # int32 bits of 0x80000000
_TILE = 8192            # row entries a block of the sort kernels sorts
_HASH_WORDS = 2048      # u32 words of a tile's 65,536-bit hash bitmap

# Launches of each kernel, one per wrapper call on a CUDA tensor.
match_deltas_launches = 0
sort_rows_launches = 0
_launch_lock = threading.Lock()


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & M32


def positions(e: int, stride: int, device) -> torch.Tensor:
    """int64 entry -> position map of a row (position in stride units):
    stride 2 interleaves ``[0, 2, 4, ..., 1, 3, 5, ...]``."""
    idx = torch.arange(e, dtype=torch.int64, device=device)
    if stride == 2:
        half = e // 2
        return torch.where(idx < half, 2 * idx, 2 * (idx - half) + 1)
    return idx


def _check_match(vals: torch.Tensor, stride: int, pos_bits: int) -> None:
    if stride not in (2, 4):
        raise ValueError("stride must be 2 or 4")
    if vals.dtype != torch.int32 or vals.dim() != 2:
        raise ValueError("match_deltas: vals must be 2-D int32")
    e = vals.shape[1]
    if not 0 < e <= min(1 << 16, 1 << pos_bits) or pos_bits > 16 \
            or (stride == 2 and e % 2):
        raise ValueError(f"match_deltas: bad row width {e} for stride "
                         f"{stride}, pos_bits {pos_bits}")


def match_deltas_plain(vals: torch.Tensor, stride: int,
                       pos_bits: int) -> torch.Tensor:
    """Plain version of :func:`match_deltas`: the hash-group sort,
    neighbour compare and un-permute sort of ``match_deltas_xla``, in
    int64 with u32 wrap emulated."""
    _check_match(vals, stride, pos_bits)
    t, e = vals.shape
    v = _u32(vals)
    posn = positions(e, stride, vals.device)[None].expand(t, e)
    h = ((v * HASH_MUL) & M32) >> 16
    key = (h << pos_bits) | posn
    sk, order = torch.sort(key, dim=1, stable=True)
    sv = torch.gather(v, 1, order)
    pk = torch.cat([torch.full((t, 1), M32, dtype=torch.int64,
                               device=v.device), sk[:, :-1]], dim=1)
    pv = torch.cat([torch.zeros((t, 1), dtype=torch.int64, device=v.device),
                    sv[:, :-1]], dim=1)
    same = (sk >> pos_bits) == (pk >> pos_bits)
    nondegen = sv != (((sv << 8) & M32) | (sv >> 24))
    okm = same & (sv == pv) & nondegen
    pmask = (1 << pos_bits) - 1
    delta = torch.where(okm, (((sk & pmask) - (pk & pmask)) * stride) & M32,
                        torch.zeros_like(sk))
    delta = torch.where(delta <= 65535, delta, torch.zeros_like(delta))
    _, back = torch.sort(sk & pmask, dim=1, stable=True)
    return torch.gather(delta, 1, back).to(torch.int32)


def match_scratch_words(t: int, e: int) -> int:
    """int32 words of the match kernel's per-tile summaries: per tile of a
    row, 2,048 (bitmap word, distinct hashes before it) pairs, and per
    distinct hash the gram at its first slot and a u16 first and last
    slot."""
    return t * -(-e // _TILE) * (2 * _HASH_WORDS + 2 * _TILE)


def match_deltas(vals: torch.Tensor, stride: int,
                 pos_bits: int) -> torch.Tensor:
    """(t, e) int32 4-gram entries (u32 bits, entry order) -> (t, e) int32
    deltas in position order.  ``e <= 2^pos_bits <= 65536``."""
    if vals.device.type == "cpu":
        return match_deltas_plain(vals, stride, pos_bits)
    _check_match(vals, stride, pos_bits)
    if vals.device.type != "cuda" or not vals.is_contiguous():
        raise ValueError("match_deltas: expected a contiguous CUDA tensor")
    global match_deltas_launches
    t, e = vals.shape
    out = torch.empty_like(vals)
    if t == 0:
        return out
    scratch = torch.empty(match_scratch_words(t, e), dtype=torch.int32,
                          device=vals.device)
    _build.launch("hdrf_match_deltas", vals.device, vals.data_ptr(), t, e,
                  stride, out.data_ptr(), scratch.data_ptr(),
                  what="match deltas kernel")
    with _launch_lock:  # handler threads of the worker launch too
        match_deltas_launches += 1
    return out


def _check_sort(key: torch.Tensor, vals, pad_key, pad_vals) -> None:
    if key.dtype != torch.int32 or key.dim() != 2:
        raise ValueError("sort_rows: key must be 2-D int32")
    if not 1 <= len(vals) <= 2 or any(
            v.dtype != torch.int32 or v.shape != key.shape
            or v.device != key.device for v in vals):
        raise ValueError("sort_rows: one or two int32 values shaped like "
                         "the key, on its device")
    e = key.shape[1]
    if e & (e - 1) and (pad_key is None or pad_vals is None
                        or len(pad_vals) != len(vals)):
        raise ValueError("sort_rows: rows that are not a power of two need "
                         "pad_key and one pad value per carried value")


def sort_rows_plain(key: torch.Tensor, *vals: torch.Tensor, pad_key=None,
                    pad_vals=None, key_unsigned: bool = False):
    """Plain version of :func:`sort_rows` (a stable ``torch.sort`` and a
    gather per value; no padding is needed)."""
    _check_sort(key, vals, pad_key, pad_vals)
    if key_unsigned:
        sk, order = torch.sort(key ^ _BIAS, dim=1, stable=True)
        sk = sk ^ _BIAS
    else:
        sk, order = torch.sort(key, dim=1, stable=True)
    return (sk, *[torch.gather(v, 1, order) for v in vals])


def sort_rows(key: torch.Tensor, *vals: torch.Tensor, pad_key=None,
              pad_vals=None, key_unsigned: bool = False):
    """Per-row ascending sort of (t, e) int32 ``key`` carrying one or two
    int32 ``vals``; returns ``(key, *vals)`` sorted, each (t, e)."""
    if key.device.type == "cpu":
        return sort_rows_plain(key, *vals, pad_key=pad_key,
                               pad_vals=pad_vals, key_unsigned=key_unsigned)
    _check_sort(key, vals, pad_key, pad_vals)
    if key.device.type != "cuda" or not key.is_contiguous() \
            or not all(v.is_contiguous() for v in vals):
        raise ValueError("sort_rows: expected contiguous CUDA tensors")
    global sort_rows_launches
    t, e = key.shape
    if t == 0 or e == 0:
        return (key.clone(), *[v.clone() for v in vals])
    width = 1 << (e - 1).bit_length()
    dev = key.device
    outs = [torch.empty((t, width), dtype=torch.int32, device=dev)
            for _ in range(1 + len(vals))]
    # rows wider than one tile merge through scratch shaped like the outputs
    scr = [torch.empty_like(o) for o in outs] if width > _TILE else []
    pv = [int(p) & M32 for p in (pad_vals or ())] + [0, 0]

    def ptrs(ts, k):
        return [x.data_ptr() for x in ts] + [None] * (k - len(ts))
    _build.launch("hdrf_sort_rows", dev, key.data_ptr(), *ptrs(vals, 2),
                  len(vals), t, e, width, int(key_unsigned),
                  int(pad_key or 0) & M32, pv[0], pv[1], *ptrs(outs, 3),
                  *ptrs(scr, 3), what="sort rows kernel")
    with _launch_lock:
        sort_rows_launches += 1
    return tuple(o[:, :e] for o in outs)

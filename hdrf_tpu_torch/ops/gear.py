"""Gear rolling-hash CDC: constants, the Gear table and the plain candidate
scan (port of hdrf_tpu/ops/gear.py:36-104, 171-182) plus the plain host
cut select (a copy of hdrf_tpu/native/src/cdc.cpp:74-92
``hdrf_cdc_select``).

The hash at byte ``i`` is the window-32 sum

    h[i] = sum_{k=0}^{31} G[b[i-k]] << k   (mod 2^32)

of the sequential recurrence ``h = (h << 1) + G[b]``; ``G[b] =
fmix32(b * 0x9E3779B1)``.  Position ``pos1 = i + 1`` is a candidate cut
when ``(h[i] & mask) == 0`` and ``pos1 >= MIN_CANDIDATE_POS1``.

The plain scan here is the yardstick the CUDA kernel (ops/cdc_cuda.py) is
held against: it computes every hash at once by log-doubling
(``A_{2m}[i] = A_m[i] + (A_m[i-m] << m)``) in ``int64`` tensors with
``& 0xFFFFFFFF`` after every add and shift — u32 arithmetic emulated, not
left to ``torch.uint32`` operator coverage.  It runs on whatever device
its input lies on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WINDOW = 32  # bytes contributing to the hash: h[i] covers b[i-31..i]
HALO = WINDOW - 1  # bytes of history a shard needs from the one before it

# Window-warmup convention shared by every candidate producer: the first
# WINDOW-1 positions hold partial-window hashes and can never be cuts.
MIN_CANDIDATE_POS1 = WINDOW

M32 = 0xFFFFFFFF


def skip_ahead_threshold(min_chunk: int) -> int:
    """Smallest pos1 a candidate must reach to ever be selectable under a
    ``min_chunk`` floor: every selection window opens at
    ``prev_cut + min_chunk >= min_chunk``, so masking candidates below
    ``max(MIN_CANDIDATE_POS1, min_chunk)`` is cut-identical."""
    return max(MIN_CANDIDATE_POS1, int(min_chunk))


def _fmix32_np(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint32)
    z ^= z >> np.uint32(16)
    z = (z * np.uint32(0x85EBCA6B)) & np.uint32(M32)
    z ^= z >> np.uint32(13)
    z = (z * np.uint32(0xC2B2AE35)) & np.uint32(M32)
    z ^= z >> np.uint32(16)
    return z


@functools.cache
def gear_table_np() -> np.ndarray:
    """256-entry uint32 Gear table ``fmix32(b * 0x9E3779B1)``."""
    with np.errstate(over="ignore"):
        return _fmix32_np(np.arange(256, dtype=np.uint32)
                          * np.uint32(0x9E3779B1))


def be_words(block: torch.Tensor) -> torch.Tensor:
    """u8[N] (N % 4 == 0) -> big-endian word image as int32 bit patterns."""
    b = block.view(-1, 4).to(torch.int64)
    w = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]
    return to_i32(w)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[N] (N % 32 == 0) -> int32[N/32] bitmap words, bit ``k`` of word
    ``w`` = ``bits[32 w + k]`` (the layout of the reference's
    ``gear.pack_bitmap_words``)."""
    shift = torch.arange(32, dtype=torch.int64, device=bits.device)
    return to_i32((bits.view(-1, 32).to(torch.int64) << shift).sum(dim=1))


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def window_hashes(block: torch.Tensor) -> torch.Tensor:
    """All-position window-32 Gear hashes of u8[N] as int64 in [0, 2^32)."""
    a = torch.as_tensor(gear_table_np().astype(np.int64),
                        device=block.device)[block.to(torch.int64)]
    n = a.numel()
    m = 1
    while m < WINDOW:
        shifted = torch.cat([a.new_zeros(min(m, n)), a[:max(n - m, 0)]])
        a = (a + ((shifted << m) & M32)) & M32
        m *= 2
    return a


def candidate_positions(block: torch.Tensor, n: int, mask: int,
                        min_chunk: int) -> torch.Tensor:
    """Sorted int64 pos1 of every selectable candidate in ``block[:n]``
    (the skip-ahead dead zone below ``skip_ahead_threshold`` dropped)."""
    h = window_hashes(block[:n])
    pos1 = torch.arange(1, n + 1, device=block.device, dtype=torch.int64)
    hit = ((h & (mask & M32)) == 0) & (pos1 >= skip_ahead_threshold(min_chunk))
    return pos1[hit]


def words_to_positions(idx: np.ndarray, vals: np.ndarray,
                       n: int) -> np.ndarray:
    """Sorted uint64 pos1 of the set bits of sparse bitmap words (word
    ``idx[i]`` holds ``vals[i]``; bit ``k`` of word ``w`` is ``pos1 = 32 w
    + k + 1``), those ``<= n`` (a copy of the reference's
    ``gear._words_to_positions``)."""
    if idx.size == 0:
        return np.empty(0, dtype=np.uint64)
    bits = np.unpackbits(vals[:, None].astype(">u4").view(np.uint8)
                         .reshape(-1, 4)[:, ::-1], axis=1, bitorder="little")
    wi, bi = np.nonzero(bits)
    pos = idx[wi].astype(np.uint64) * 32 + bi + 1
    pos.sort()
    return pos[pos <= n]


def cdc_select(cand: np.ndarray, length: int, min_chunk: int,
               max_chunk: int) -> np.ndarray:
    """Min/max frontier cut selection over sorted candidates (the rule of
    native/src/cdc.cpp:74-92): ``lo = start + min``, ``hi = min(start +
    max, len)``, cut = first candidate in [lo, hi], else ``hi``.  Returns
    uint64 exclusive chunk ends; the last is always ``length``."""
    cand = np.asarray(cand, dtype=np.int64)
    min_chunk = max(int(min_chunk), 1)
    cuts: list[int] = []
    start = 0
    while start < length:
        lo = start + min_chunk
        hi = min(start + max_chunk, length)
        ci = int(np.searchsorted(cand, lo, side="left"))
        cut = int(cand[ci]) if ci < cand.size and cand[ci] <= hi else hi
        cuts.append(cut)
        start = cut
    return np.asarray(cuts, dtype=np.uint64)

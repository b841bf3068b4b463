"""The match-delta kernel's tiled decomposition, modelled in numpy on the CPU.

``csrc/sort.cu`` answers a row of the LZ4 match scan tile by tile: phase 1
sorts each tile by hash16 (stable), takes a same-hash left neighbour as q
and writes the tile's summary (hash bitmap, distinct hashes before each
bitmap word, first and last slot of each hash); phase 2 lets each tile's
first position of a hash look back through the earlier tiles inside its
window (q >= p - 65535 // stride), nearest first, stopping at the first
tile whose bitmap holds the hash.  ``_match_model`` follows those phases
at any tile width; it must give, on every slot, the reference's sorted
formulation (``sort_pallas.match_deltas_xla``) and the port's plain
version (``sort_cuda.match_deltas_plain``).  Tolerance zero.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrf_tpu.ops import sort_pallas
from hdrf_tpu_torch.ops import sort_cuda

M32 = 0xFFFFFFFF
MUL = sort_cuda.HASH_MUL
INV = pow(MUL, -1, 1 << 32)   # grams with a chosen hash16
KERNEL_TILE = 8192            # csrc/sort.cu kTile


def _hash(v: np.ndarray) -> np.ndarray:
    return (v.astype(np.int64) * MUL & M32) >> 16


def _degenerate(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return v == (((v << 8) & M32) | (v >> 24))


def _match_model(v: np.ndarray, stride: int, tile: int) -> np.ndarray:
    """(t, e) grams in POSITION order -> deltas, by the kernel's phases."""
    t, e = v.shape
    win = 65535 // stride
    lb = -(-win // tile)
    d = np.zeros((t, e), np.int64)
    for r in range(t):
        vr, h = v[r].astype(np.int64), _hash(v[r])
        summ = []
        for k in range(-(-e // tile)):
            t0 = k * tile
            order = np.argsort(h[t0:t0 + tile], kind="stable")
            sh = h[t0 + order]
            new = np.r_[True, sh[1:] != sh[:-1]]
            end = np.r_[sh[1:] != sh[:-1], True]
            # phase 1: a same-hash left neighbour in the tile is q
            i = np.nonzero(~new)[0]
            p, q = t0 + order[i], t0 + order[i - 1]
            ok = (vr[p] == vr[q]) & ~_degenerate(vr[p]) \
                & ((p - q) * stride <= 65535)
            d[r, p[ok]] = ((p - q) * stride)[ok]
            # the summary: bitmap, distinct hashes before each word, last slots
            bits = np.zeros(2048, np.int64)
            np.bitwise_or.at(bits, sh[new] >> 5, 1 << (sh[new] & 31))
            pre = np.cumsum(np.bitwise_count(bits), dtype=np.int64) \
                - np.bitwise_count(bits)
            summ.append((bits, pre, order[end]))
            # phase 2: first positions look back, nearest tile first
            p = t0 + order[new]
            hp = h[p]
            pend = ~_degenerate(vr[p])
            for jj in range(min(k, lb)):
                j = k - 1 - jj
                pend &= (j + 1) * tile - 1 >= p - win   # tile in the window
                bits_j, pre_j, last_j = summ[j]
                w = bits_j[hp >> 5]
                hit = pend & ((w >> (hp & 31)) & 1 == 1)
                rank = pre_j[hp >> 5] + np.bitwise_count(
                    w & ((1 << (hp & 31)) - 1)).astype(np.int64)
                ph, q = p[hit], j * tile + last_j[rank[hit]]
                ok = (ph - q <= win) & (vr[q] == vr[ph])
                d[r, ph[ok]] = ((ph - q) * stride)[ok]
                pend &= ~hit
    return d


def _to_entries(v: np.ndarray, stride: int) -> np.ndarray:
    """Position order -> the kernel's entry order (stride 2: evens, odds)."""
    return v if stride == 4 else np.concatenate([v[:, ::2], v[:, 1::2]], 1)


def _with_hash(h, low) -> np.ndarray:
    """Grams whose hash16 is ``h`` (``low`` < 0xFFFF picks among them)."""
    return ((((np.asarray(h, np.int64) << 16) | low) * INV) & M32).astype(
        np.uint32)


def _unique_hash_row(rng, e: int) -> np.ndarray:
    """A row of non-degenerate grams, no two with the same hash16."""
    h = rng.permutation(1 << 16)[:e]
    v = _with_hash(h, rng.integers(0, 0xFFFF, e))
    while (bad := _degenerate(v)).any():
        v[bad] = _with_hash(h[bad], rng.integers(0, 0xFFFF, int(bad.sum())))
    return v


def _bytes_row(rng, kind: str, e: int, stride: int) -> np.ndarray:
    """Grams at every ``stride``-th byte of a byte row (position order)."""
    n = e * stride + 4
    if kind == "text":
        b = rng.integers(97, 123, n, dtype=np.uint8)
        b[::3] = 32
    elif kind == "few":
        b = rng.integers(0, 3, n, dtype=np.uint8)
    elif kind == "zeros":
        b = np.zeros(n, np.uint8)
    else:
        b = rng.integers(0, 256, n, dtype=np.uint8)
    w = ((b[:-3].astype(np.uint32) << 24) | (b[1:-2].astype(np.uint32) << 16)
         | (b[2:-1].astype(np.uint32) << 8) | b[3:].astype(np.uint32))
    return w[:e * stride:stride]


def _edge_pairs(e: int, stride: int) -> list:
    """(q, p) pairs exactly at and one past the window, some ending on the
    first position of a kernel tile."""
    win = 65535 // stride
    t = KERNEL_TILE
    if stride == 2:
        return [(100, 100 + win), (5000, 5001 + win),
                (5 * t - win, 5 * t), (6 * t - win - 1, 6 * t)]
    return [(100, 100 + win), (5000, 5001 + win), (3 * t - win, 3 * t),
            (2 * t - win - 1, 2 * t)]


GROUPS = ((10, 10), (500, 300), (1000, 8000), (3000, 2500), (20000, 4000))


def _special_row(rng, kind: str, e: int, stride: int) -> np.ndarray:
    if kind in ("zeros", "random", "text", "few"):
        return _bytes_row(rng, kind, e, stride)
    v = _unique_hash_row(rng, e)
    if kind == "window-edge":
        for q, p in _edge_pairs(e, stride):
            v[p] = v[q]
    elif kind == "unequal-grams":
        # A, then B (same hash16, other gram), then A twice: the second A's
        # latest same-hash position holds B, so only the third A matches
        for a1, gap in GROUPS:
            if a1 + 3 * gap >= e:
                continue
            a = v[a1]
            b = np.uint32((int(a) + INV) & M32)
            assert _hash(np.array([b]))[0] == _hash(np.array([a]))[0]
            for i, g in enumerate((a, b, a, a)):
                v[a1 + i * gap] = g
    elif kind == "degenerate":
        for at in range(0, e - 600, 5000):
            v[at:at + 300] = 0x41414141
            v[at + 300:at + 600] = 0
    return v


def _reference(v: np.ndarray, stride: int, pos_bits: int) -> np.ndarray:
    ent = _to_entries(v, stride)
    posn = sort_cuda.positions(ent.shape[1], stride, "cpu").numpy().astype(
        np.uint32)
    return np.asarray(sort_pallas.match_deltas_xla(
        jnp.asarray(ent), jnp.asarray(np.broadcast_to(posn, ent.shape)),
        stride, pos_bits)).astype(np.int64)


KINDS = ["zeros", "random", "text", "few", "window-edge", "unequal-grams",
         "degenerate"]


@pytest.mark.parametrize("tile", [1024, KERNEL_TILE])
@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_tiled_match_model_equals_reference_on_full_rows(kind, stride, tile):
    """Full rows (65,536 entries at stride 2, 32,768 at stride 4), the
    kernel's tile width and a narrower one."""
    e, pos_bits = (65536, 16) if stride == 2 else (32768, 15)
    v = _special_row(np.random.default_rng(len(kind) + stride), kind, e,
                     stride)[None]
    want = _reference(v, stride, pos_bits)
    got = _match_model(v, stride, tile)
    np.testing.assert_array_equal(got, want)
    plain = sort_cuda.match_deltas_plain(
        torch.from_numpy(_to_entries(v, stride).view(np.int32)), stride,
        pos_bits).numpy().view(np.uint32)
    np.testing.assert_array_equal(plain, want)
    win = 65535 // stride
    if kind == "window-edge":
        # each pair's only same-hash predecessor sits win or win + 1 back
        for q, p in _edge_pairs(e, stride):
            assert want[0, p] == ((p - q) * stride if p - q <= win else 0)
        assert np.count_nonzero(want) == 2
    elif kind == "unequal-grams":
        assert np.count_nonzero(want) == len(GROUPS)
    elif kind in ("zeros", "degenerate"):
        assert not want.any()
    elif kind in ("text", "few"):
        assert want.any() and want.max() <= 65535


@pytest.mark.parametrize("tile", [16, 64, 100])
@pytest.mark.parametrize("stride,e", [(2, 2048), (4, 1500)])
@pytest.mark.parametrize("kind", ["random", "text", "few", "unequal-grams"])
def test_tiled_match_model_is_independent_of_the_tile(kind, stride, e, tile):
    """Narrow rows cut into many tiny tiles (a ragged last tile at 100 and
    at e = 1,500): every first position looks back through many tiles."""
    rng = np.random.default_rng(e + tile)
    v = np.stack([_special_row(rng, kind, e, stride) for _ in range(3)])
    pos_bits = int(e - 1).bit_length()
    np.testing.assert_array_equal(_match_model(v, stride, tile),
                                  _reference(v, stride, pos_bits))


def test_look_back_reaches_four_tiles_at_stride_2_and_two_at_stride_4():
    """The window bounds phase 2's work: tile k looks back through at most
    ceil((65535 // stride) / 8192) tiles."""
    assert [-(-(65535 // s) // KERNEL_TILE) for s in (2, 4)] == [4, 2]

"""The port's CUDA kernels on the card against their plain versions.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips without a GPU.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q

This file imports only the port (no JAX, no reference package), so it runs
where JAX is not installed.  Outputs are integers: exact equality.
"""

import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from hdrf_tpu_torch import native
from hdrf_tpu_torch.config import CdcConfig
from hdrf_tpu_torch.ops import (cdc_cuda, dispatch, gather_cuda, rs, rs_cuda,
                                sha256_cuda, sort_cuda)
from hdrf_tpu_torch.ops.dispatch import gear_mask
from hdrf_tpu_torch.ops.gear import words_to_positions
from hdrf_tpu_torch.ops.lz4_device import _INVALID, _S, DeviceLz4
from hdrf_tpu_torch.ops.resident import ResidentReducer
from hdrf_tpu_torch.ops.sha256 import sha256_words
from hdrf_tpu_torch.parallel import sharded

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


CASES = [  # (seed, size, fill, mask, min, max)
    (1, 150_000, "random", 0x1FFF, 2048, 65536),
    (2, 200_000, "text", 0x1FFF, 2048, 65536),
    (3, 120_000, "random", 0xFFFFFF, 512, 4096),
    (4, 30_000, "random", 0x7, 8, 64),
    (5, 300_000, "zeros", 0x1FFF, 2048, 65536),
    (6, 300, "random", 0x3F, 16, 128),
]


def _data(seed, n, fill):
    rng = np.random.default_rng(seed)
    if fill == "zeros":
        return np.zeros(n, np.uint8)
    lo, hi = (97, 123) if fill == "text" else (0, 256)
    return rng.integers(lo, hi, n, dtype=np.uint8)


def _periodic(seed, n, period, mask):
    """n bytes of one random pattern of ``period`` bytes repeated, drawn
    so that the repetition holds exactly one candidate per period: with a
    period under min_chunk, chains a period apart never meet."""
    rng = np.random.default_rng(seed)
    reps = -(-64 // period) + 2      # two whole periods past the window
    while True:
        pat = rng.integers(0, 256, period, dtype=np.uint8)
        c = native.gear_candidates(np.tile(pat, reps), mask)
        if np.count_nonzero(c > (reps - 2) * period) == 2:
            return np.resize(pat, n)


SELECT_CASES = [  # adversarial inputs of the segmented select
    (7, 600_000, "periodic", 0x1FFF, 2048, 65536),
    (9, 600_000, "period3", 0x1FFF, 2048, 65536),
    (8, 200_000, "starts", 0x1FFF, 2048, 8192),
]


@pytest.mark.parametrize("seg_width", [None, 9217])
@pytest.mark.parametrize("seed,n,fill,mask,mn,mx", CASES + SELECT_CASES)
def test_kernels_equal_plain(dev, seed, n, fill, mask, mn, mx, seg_width):
    if fill in ("periodic", "period3"):   # chains meet late, or never
        a = _periodic(seed, n, 1531 if fill == "periodic" else 3, mask)
    elif fill == "starts":   # zeros at every segment start, random between
        a = _data(seed, n, "random")
        for s in range(0, n, seg_width or 131072):
            a[max(s - 64, 0):s] = 0
    else:
        a = _data(seed, n, fill)
    block, n = cdc_cuda.padded_block(a, dev)
    kw, kb = cdc_cuda.cdc_scan(block, n, mask, mn)
    pw, pb = cdc_cuda.cdc_scan_plain(block, n, mask, mn)
    assert torch.equal(kw, pw) and torch.equal(kb, pb)
    k = (kw, *cdc_cuda.cdc_select(kb, n, mn, mx, 4, seg_width=seg_width))
    p = cdc_cuda.cdc_block_plain(block, n, mask, mn, mx, 4)
    nc, _, ns, nbg = k[1][:4].tolist()
    assert k[1][:4].tolist() == p[1][:4].tolist()
    assert torch.equal(k[0], p[0])
    assert torch.equal(k[1][:8 + nc], p[1][:8 + nc])
    assert torch.equal(k[2][:, :ns], p[2][:, :ns])
    assert torch.equal(k[3][:, :nbg], p[3][:, :nbg])
    for ol, bucket, cnt in ((k[2], 4, ns), (k[3], (mx + 72) // 64, nbg)):
        lanes = ol[:, :cnt]
        mk = gather_cuda.gather_pad_messages(k[0], lanes, bucket)
        assert torch.equal(mk, gather_cuda.gather_pad_messages_plain(
            k[0], lanes, bucket))
        nb = ((lanes[1] + 72) // 64).to(torch.int32)
        assert torch.equal(sha256_cuda.sha256_words_cuda(mk, nb),
                           sha256_words(mk, nb))


SCAN_EDGES = [  # (n, fill, mask, min): the scan's tiles are 1 KiB chunks
    (300, "random", 0, 16),             # n inside a piece, mask 0
    (512, "random", 0, 32),             # pos1 == thr == 32 and == n
    (512, "zeros", 0x1FFF, 2048),       # thr past n: no candidate
    (1536, "random", 0, 1000),          # ragged last chunk, thr mid-piece
    (5000, "text", 0, 2100),            # thr in the third chunk
    (64 * 1024 + 300, "random", 0xFF, 4097),
    ((3 << 20) + 512, "random", 0x1FFF, 2048),   # spans of many chunks
    ((3 << 20) + 77, "zeros", 0x1FFF, 2048),
]


@pytest.mark.parametrize("n,fill,mask,mn", SCAN_EDGES)
def test_scan_edges_equal_plain(dev, n, fill, mask, mn):
    """The scan at its position-rule and tiling edges: words and bitmap
    equal the plain version, the bitmap's positions equal the native
    candidates in [thr, n], one launch."""
    a = _data(n + mn, n, fill)
    block, n = cdc_cuda.padded_block(a, dev)
    n0 = cdc_cuda.scan_launches
    kw, kb = cdc_cuda.cdc_scan(block, n, mask, mn)
    torch.cuda.synchronize()
    assert cdc_cuda.scan_launches == n0 + 1
    pw, pb = cdc_cuda.cdc_scan_plain(block, n, mask, mn)
    assert torch.equal(kw, pw) and torch.equal(kb, pb)
    wv = kb.cpu().numpy().view(np.uint32)
    (idx,) = np.nonzero(wv)
    pos = words_to_positions(idx.astype(np.uint32), wv[idx], n)
    nat = native.gear_candidates(a, mask)
    np.testing.assert_array_equal(pos, nat[nat >= max(mn, 32)])


@pytest.mark.parametrize("n", [512, 1536, (1 << 20) + 512, 32 << 20,
                               128 << 20])
def test_be_image_words_only_launch(dev, n):
    """``be_image`` is one launch of the scan's words-only mode (its own
    counter; ``scan_launches`` does not move) and equals gear.be_words."""
    from hdrf_tpu_torch.ops import gear
    g = torch.Generator(device=dev).manual_seed(n % 1000)
    block = torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                          generator=g)
    s0, i0 = cdc_cuda.scan_launches, cdc_cuda.image_launches
    got = cdc_cuda.be_image(block)
    torch.cuda.synchronize()
    assert (cdc_cuda.scan_launches, cdc_cuda.image_launches) == (s0, i0 + 1)
    assert torch.equal(got, gear.be_words(block))


SHARD_EDGES = [  # (m, base): shards of 256 B, one chunk +- 256 B, many
    (256, 0), (256, 4096), (768, 0), (768, 1024), (1280, 0), (1280, 1280),
    ((2 << 20) + 256, 0), ((2 << 20) + 256, (2 << 20) + 256),
]


@pytest.mark.parametrize("mask", [0, 0x7, 0x1FFF])
@pytest.mark.parametrize("m,base", SHARD_EDGES)
def test_shard_scan_edges_equal_plain(dev, m, base, mask):
    """A shard at the scan's tiling edges with a random, unaligned halo
    (a slice of the bytes before it): words and count equal the plain
    version."""
    rng = np.random.default_rng(m + base + mask)
    buf = torch.from_numpy(rng.integers(0, 256, m + 64, dtype=np.uint8))
    buf = buf.to(dev)
    local = buf[64:]
    halo = buf[64 - 31:64] if base else torch.zeros(31, dtype=torch.uint8,
                                                    device=dev)
    kw, kc = cdc_cuda.shard_scan(local, halo, base, mask)
    pw, pc = cdc_cuda.shard_scan_plain(local, halo, base, mask)
    assert torch.equal(kw, pw) and torch.equal(kc, pc)


def test_select_counts_one_launch(dev):
    """The select's four kernels are one wrapper call, one launch."""
    a = _data(1, 150_000, "random")
    block, n = cdc_cuda.padded_block(a, dev)
    _, bitmap = cdc_cuda.cdc_scan(block, n, 0x1FFF, 2048)
    n0 = cdc_cuda.select_launches
    cdc_cuda.cdc_select(bitmap, n, 2048, 65536, 4, seg_width=4096)
    torch.cuda.synchronize()
    assert cdc_cuda.select_launches == n0 + 1


EMIT_RANGE = [(mb, max(512, 1 << (mb - 2)), 1 << (mb + 3))
              for mb in range(8, 17)]   # AdaptiveChunkController's range


@pytest.mark.parametrize("mb,mn,mx", EMIT_RANGE,
                         ids=[f"mb{g[0]}" for g in EMIT_RANGE])
def test_header_lanes_and_emit_range_equal_plain(dev, mb, mn, mx):
    """At every geometry the adaptive controller can emit: the select
    kernel's table (cuts, counts and the H_SURV / H_CANDS lanes) equals
    the plain version's, the lanes equal a count over the bitmap, and
    the reducer's cuts and digests equal the native oracle's."""
    cdc = CdcConfig(mask_bits=mb, min_chunk=mn, max_chunk=mx)
    mask = gear_mask(cdc)
    rng = np.random.default_rng(mb)
    for a in (rng.integers(0, 256, (2 << 20) + 333, dtype=np.uint8),
              rng.integers(97, 101, 1 << 20, dtype=np.uint8)):
        block, n = cdc_cuda.padded_block(a, dev)
        words, bitmap = cdc_cuda.cdc_scan(block, n, mask, mn)
        k = cdc_cuda.cdc_select(bitmap, n, mn, mx, 4)
        p = cdc_cuda.cdc_select_plain(bitmap.cpu(), n, mn, mx, 4)
        nc = int(k[0][0])
        assert torch.equal(k[0][:8 + nc].cpu(), p[0][:8 + nc])
        surv, cands = cdc_cuda.scan_telemetry_plain(bitmap.cpu())
        assert k[0][cdc_cuda.H_SURV].item() == surv
        assert k[0][cdc_cuda.H_CANDS].item() == cands > 0
        cuts, digs = ResidentReducer(cdc, device=dev).reduce(a)
        want = native.cdc_select(native.gear_candidates(a, mask), a.size,
                                 mn, mx)
        np.testing.assert_array_equal(cuts, want)
        starts = np.concatenate([[0], want[:-1]]).astype(np.uint64)
        np.testing.assert_array_equal(
            digs, native.sha256_batch(a, starts, want - starts))


@pytest.mark.parametrize("nbm", [1, 15, 17, 4096 + 5])
def test_header_lanes_of_ragged_bitmaps(dev, nbm):
    """A bitmap whose length is not a whole number of 16-word rows: the
    kernel's lanes count its partial last row as the plain version
    does."""
    rng = np.random.default_rng(nbm)
    bm = rng.integers(0, 2 ** 32, nbm, dtype=np.uint64).astype(np.uint32)
    bm &= rng.integers(0, 2 ** 32, nbm, dtype=np.uint64).astype(np.uint32)
    bm[rng.random(nbm) < 0.5] = 0
    bitmap = torch.from_numpy(bm.view(np.int32)).to(dev)
    n = 32 * nbm
    table, _, _ = cdc_cuda.cdc_select(bitmap, n, 64, 4096, 4)
    assert (table[cdc_cuda.H_SURV].item(), table[cdc_cuda.H_CANDS].item()) \
        == cdc_cuda.scan_telemetry_plain(bitmap.cpu())


def test_sha_partial_last_thread_block(dev):
    """133 lanes: the last 128-thread block is partial and still hashed."""
    rng = np.random.default_rng(7)
    L = 133
    raw = rng.integers(0, 256, (L, 64), dtype=np.uint8)
    lens = rng.integers(0, 56, L)
    words = torch.from_numpy(raw.view(">u4").astype(np.uint32).view(
        np.int32).reshape(-1)).to(dev)
    ol = torch.from_numpy(np.stack([np.arange(L) * 64, lens]).astype(
        np.int32)).to(dev)
    msgs = gather_cuda.gather_pad_messages(words, ol, 1)
    got = sha256_cuda.sha256_words_cuda(
        msgs, torch.ones(L, dtype=torch.int32, device=dev)).cpu().numpy()
    for i in range(L):
        assert bytes(got[i]) == hashlib.sha256(
            raw[i, :lens[i]].tobytes()).digest()


def test_sha_lone_long_lane_beside_short_lanes(dev):
    """One 1,025-block lane (a 64 KiB chunk) in the big table beside
    10,000 short lanes in the small one, one grouped launch: the long lane
    against the plain version (run on the CPU: one lane, 1,025 steps) and
    hashlib, the short lanes against the plain version on the card."""
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, 1 << 20, dtype=np.uint8)
    words = torch.from_numpy(raw.view(">u4").astype(np.uint32).view(
        np.int32)).to(dev)
    big_ol = torch.tensor([[4096], [65536]], dtype=torch.int32, device=dev)
    lens = rng.integers(0, 4 * 64 - 9 + 1, 10_000)
    offs = rng.integers(0, raw.size - 256, 10_000)
    small_ol = torch.from_numpy(np.stack([offs, lens]).astype(
        np.int32)).to(dev)
    big = gather_cuda.gather_pad_messages(words, big_ol, 1025)
    small = gather_cuda.gather_pad_messages(words, small_ol, 4)
    nb_big = torch.tensor([1025], dtype=torch.int32, device=dev)
    nb_small = ((small_ol[1] + 9 + 63) // 64).to(torch.int32)
    n0 = sha256_cuda.launches
    got_big, got_small = sha256_cuda.sha256_words_grouped(
        [(big, nb_big), (small, nb_small)])
    torch.cuda.synchronize()
    assert sha256_cuda.launches == n0 + 1
    assert torch.equal(got_big.cpu(), sha256_words(big.cpu(), nb_big.cpu()))
    assert bytes(got_big[0].cpu().numpy()) == hashlib.sha256(
        raw[4096:4096 + 65536].tobytes()).digest()
    assert torch.equal(got_small, sha256_words(small, nb_small))
    for i in (0, 1, 4999, 9999):
        o, n = int(offs[i]), int(lens[i])
        assert bytes(got_small[i].cpu().numpy()) == hashlib.sha256(
            raw[o:o + n].tobytes()).digest()


def test_sha_grouped_partial_last_thread_blocks(dev):
    """133 lanes in each table, mixed lengths: both tables end in a
    partial 32-lane thread block and every lane is still hashed, each
    digest in its own row after the big table's longest-first order."""
    rng = np.random.default_rng(13)
    raw = rng.integers(0, 256, 1 << 18, dtype=np.uint8)
    words = torch.from_numpy(raw.view(">u4").astype(np.uint32).view(
        np.int32)).to(dev)
    tables, spans = [], []
    for bucket, hi in ((9, 9 * 64 - 9), (2, 2 * 64 - 9)):
        lens = rng.integers(0, hi + 1, 133)
        offs = rng.integers(0, raw.size - 1024, 133)
        ol = torch.from_numpy(np.stack([offs, lens]).astype(np.int32)).to(dev)
        tables.append((gather_cuda.gather_pad_messages(words, ol, bucket),
                       ((ol[1] + 9 + 63) // 64).to(torch.int32)))
        spans.append(list(zip(offs, lens)))
    got = sha256_cuda.sha256_words_grouped(tables)
    for (msgs, nb), g, sp in zip(tables, got, spans):
        assert torch.equal(g, sha256_words(msgs, nb))
        for (o, n), d in zip(sp, g.cpu().numpy()):
            assert bytes(d) == hashlib.sha256(raw[o:o + n].tobytes()).digest()


def test_reducer_grouped_sha_once_per_block(dev):
    """ResidentReducer.reduce on blocks with both lane tables filled, one
    with the big table empty: equal to the native oracle, one SHA launch
    (both tables) and two gather launches a block."""
    rng = np.random.default_rng(17)
    cdc = CdcConfig(mask_bits=10, min_chunk=256, max_chunk=4096)
    r = ResidentReducer(cdc, device=dev)
    for a in (rng.integers(0, 256, 1 << 20, dtype=np.uint8),
              rng.integers(97, 123, 300_000, dtype=np.uint8),
              np.zeros(100_000, np.uint8)):
        n0, g0 = sha256_cuda.launches, gather_cuda.launches
        cuts, digs = r.reduce(a)
        torch.cuda.synchronize()
        assert sha256_cuda.launches == n0 + 1
        lens = np.diff(cuts.astype(np.int64), prepend=0)
        n_big = int(((lens + 72) // 64 > r._b_small).sum())
        assert gather_cuda.launches == g0 + 1 + (n_big > 0)
        wc, wd = _oracle(a, cdc)
        np.testing.assert_array_equal(cuts, wc)
        np.testing.assert_array_equal(digs, wd)


def test_fingerprints_on_card_equal_hashlib(dev):
    """dispatch.fingerprints with the caller's cuts (one chunk longer than
    max_chunk): the BE image comes from the CDC scan kernel's words-only
    mode alone (no hashing scan, no select), then the gather and SHA
    kernels."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, 140_001, dtype=np.uint8)
    cuts = np.array([1, 64, 119, 5000, 5001, 21_000, 140_001], np.uint64)
    scans, selects = cdc_cuda.scan_launches, cdc_cuda.select_launches
    images = cdc_cuda.image_launches
    got = dispatch.fingerprints(a, cuts, "cuda")
    assert cdc_cuda.image_launches == images + 1
    assert cdc_cuda.scan_launches == scans
    assert cdc_cuda.select_launches == selects
    start = 0
    for c, d in zip(cuts, got):
        assert bytes(d) == hashlib.sha256(a[start:int(c)].tobytes()).digest()
        start = int(c)


def test_reducer_on_card_equals_cpu(dev):
    rng = np.random.default_rng(8)
    datas = [rng.integers(0, 256, 1 << 20, dtype=np.uint8),
             np.zeros(100_000, np.uint8), np.empty(0, np.uint8)]
    cdc = CdcConfig(mask_bits=10, min_chunk=256, max_chunk=4096)
    got = ResidentReducer(cdc, device=dev).reduce_many(datas)
    want = ResidentReducer(cdc, device="cpu").reduce_many(datas)
    for (gc, gd), (wc, wd) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gd, wd)
    assert gear_mask(cdc) == ResidentReducer(cdc, device=dev).mask


# ------------------------------------------------------ the LZ4 seal kernels

def _grams(rng, kind, t, e, stride):
    """(t, e) int32 4-gram entries in the match scan's row layout."""
    n = e * stride
    if kind == "text":
        b = rng.integers(97, 123, size=(t, n + 4), dtype=np.uint8)
        b[:, ::3] = 32
    elif kind == "few":
        b = rng.integers(0, 3, size=(t, n + 4), dtype=np.uint8)
    elif kind == "zeros":
        b = np.zeros((t, n + 4), np.uint8)
    else:
        b = rng.integers(0, 256, size=(t, n + 4), dtype=np.uint8)
    w = ((b[:, :-3].astype(np.uint32) << 24)
         | (b[:, 1:-2].astype(np.uint32) << 16)
         | (b[:, 2:-1].astype(np.uint32) << 8) | b[:, 3:].astype(np.uint32))
    if stride == 4:
        w = w[:, :n:4]
    else:
        w = np.concatenate([w[:, :n:4], w[:, 2:n:4]], axis=1)
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32))


@pytest.mark.parametrize("stride,t", [(2, 133), (4, 40)])
@pytest.mark.parametrize("kind", ["text", "few", "zeros", "random"])
def test_match_deltas_kernel_equals_plain(dev, stride, t, kind):
    """Full rows (stride 2: 65,536 entries, stride 4: 32,768), a ragged row
    count; integer outputs, exact."""
    e, pos_bits = (65536, 16) if stride == 2 else (32768, 15)
    vals = _grams(np.random.default_rng(t + stride), kind, t, e, stride)
    n0 = sort_cuda.match_deltas_launches
    got = sort_cuda.match_deltas(vals.to(dev), stride, pos_bits)
    torch.cuda.synchronize()
    assert sort_cuda.match_deltas_launches == n0 + 1
    want = sort_cuda.match_deltas_plain(vals.to(dev), stride, pos_bits)
    assert torch.equal(got, want)
    if kind in ("text", "few"):
        assert bool((got > 0).any())


_INV = pow(sort_cuda.HASH_MUL, -1, 1 << 32)   # grams with a chosen hash16


def _special_rows(rng, stride):
    """Full rows of non-degenerate grams with unique hash16 except: row 0,
    gram pairs exactly 65535 // stride and one more apart (the window's
    edge), some ending on a tile's first position; row 1, a gram A, then
    B of A's hash but another gram, then A twice (only the last A
    matches); row 2, runs of degenerate grams.  Position order in, the
    kernel's entry order out."""
    e = 65536 if stride == 2 else 32768
    win, tile = 65535 // stride, 8192
    rows = []
    for r in range(3):
        h = rng.permutation(1 << 16)[:e].astype(np.int64)
        v = (((h << 16) | rng.integers(1, 0xFF00, e)) * _INV) & 0xFFFFFFFF
        v = v.astype(np.uint32)
        if r == 0:
            last = 6 if stride == 2 else 3   # tiles of a row after the pairs
            for q, p in ((100, 100 + win), (5000, 5001 + win),
                         ((last - 1) * tile - win, (last - 1) * tile),
                         (last * tile - win - 1, last * tile)):
                v[p] = v[q]
        elif r == 1:
            for a1, gap in ((10, 10), (500, 300), (1000, 8000), (3000, 2500)):
                a = v[a1]
                for i, g in enumerate((a, (int(a) + _INV) & 0xFFFFFFFF, a, a)):
                    v[a1 + i * gap] = g
        else:
            for at in range(0, e - 600, 5000):
                v[at:at + 300] = 0x41414141
                v[at + 300:at + 600] = 0
        rows.append(v)
    v = np.stack(rows)
    if stride == 2:
        v = np.concatenate([v[:, ::2], v[:, 1::2]], axis=1)
    return torch.from_numpy(np.ascontiguousarray(v).view(np.int32))


@pytest.mark.parametrize("stride", [2, 4])
def test_match_deltas_kernel_window_edge_and_gram_rows(dev, stride):
    """The window's edge, same-hash grams that differ, degenerate runs:
    every slot equal to the plain version."""
    pos_bits = 16 if stride == 2 else 15
    vals = _special_rows(np.random.default_rng(stride), stride).to(dev)
    got = sort_cuda.match_deltas(vals, stride, pos_bits)
    want = sort_cuda.match_deltas_plain(vals, stride, pos_bits)
    assert torch.equal(got, want)
    nz = (want != 0).sum(dim=1).tolist()
    assert nz == [2, 4, 0]


@pytest.mark.parametrize("stride,e", [(2, 700), (2, 10_000), (4, 8193),
                                      (2, 65534)])
@pytest.mark.parametrize("kind", ["text", "few"])
def test_match_deltas_kernel_ragged_rows(dev, stride, e, kind):
    """Rows that are no multiple of the 8,192-position tile: one tile, a
    ragged last tile."""
    vals = _grams(np.random.default_rng(e), kind, 5, e, stride).to(dev)
    pos_bits = int(e - 1).bit_length()
    got = sort_cuda.match_deltas(vals, stride, pos_bits)
    assert torch.equal(got, sort_cuda.match_deltas_plain(vals, stride,
                                                         pos_bits))


def _keys(rng, t, e, unsigned, tied):
    """Unique keys (a permutation) or, ``tied``, keys from e // 4 values,
    centred on 0 (i32) or across the sign bit of the u32 order."""
    key = np.stack([rng.permutation(e).astype(np.int64) for _ in range(t)])
    if tied:
        key //= 4
    if unsigned:
        key = key + 0x80000000 - e // 2
    else:
        key = key - e // 2
    return torch.from_numpy((key & 0xFFFFFFFF).astype(np.uint32)
                            .view(np.int32))


SORT_CASES = [  # (t, e, n_val, unsigned)
    (133, 8192, 2, False),      # L1 rows, ragged row count
    (128, 8192, 2, True),       # L2 rows, u32 keys across the sign bit
    (1, 524288, 1, False),      # the L3 row
    (2, 131072, 1, True),       # escape rows
    (3, 100_000, 2, False),     # padded non-pow2 rows
    (5, 700, 1, True),          # narrower than a tile, padded
]


@pytest.mark.parametrize("tied", [False, True], ids=["unique", "tied"])
@pytest.mark.parametrize("t,e,n_val,unsigned", SORT_CASES)
def test_sort_rows_kernel_equals_plain(dev, t, e, n_val, unsigned, tied):
    """Every slot equals the stable plain sort, ties included."""
    rng = np.random.default_rng(e + t)
    key = _keys(rng, t, e, unsigned, tied).to(dev)
    vals = [torch.from_numpy(rng.integers(-2**31, 2**31, size=(t, e))
                             .astype(np.int32)).to(dev)
            for _ in range(n_val)]
    pad = dict(pad_key=-1 if unsigned else 2**31 - 1,
               pad_vals=(0,) * n_val, key_unsigned=unsigned)
    n0 = sort_cuda.sort_rows_launches
    got = sort_cuda.sort_rows(key, *vals, **pad)
    torch.cuda.synchronize()
    assert sort_cuda.sort_rows_launches == n0 + 1
    want = sort_cuda.sort_rows_plain(key, *vals, **pad)
    for g, w in zip(got, want):
        assert g.shape == (t, e)
        assert torch.equal(g, w)


def test_sort_rows_tied_dead_slots(dev):
    """Pack-sort keys: live slots carry their unique index, dead slots tie
    on the row width (gpos _INVALID).  The sort is stable, so every slot,
    dead ones included, equals the plain version."""
    rng = np.random.default_rng(12)
    t, e = 64, 8192
    live = rng.random((t, e)) < 0.1
    idx = np.broadcast_to(np.arange(e, dtype=np.int32), (t, e))
    key = torch.from_numpy(np.where(live, idx, e).astype(np.int32)).to(dev)
    g = torch.from_numpy(np.where(live, rng.integers(0, 2**30, (t, e)),
                                  _INVALID).astype(np.int32)).to(dev)
    r = torch.from_numpy(rng.integers(-2**31, 2**31, (t, e))
                         .astype(np.int32)).to(dev)
    got = sort_cuda.sort_rows(key, g, r)
    want = sort_cuda.sort_rows_plain(key, g, r)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("t,e", [(1, 300_000), (2, 131_072)])
def test_sort_rows_long_rows_stable_across_tiles(dev, t, e):
    """Long rows whose keys tie across tiles (16 values, some equal to the
    pad sentinel, the L3 case): the merge passes keep the input order of
    equal keys, and pad slots stay after the live slots that tie with the
    sentinel."""
    rng = np.random.default_rng(e)
    vals = rng.integers(0, 16, (t, e))
    key = np.where(vals == 15, _INVALID, vals).astype(np.int32)
    order = np.broadcast_to(np.arange(e, dtype=np.int32), (t, e))
    k, v = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (key, order))
    gk, gv = sort_cuda.sort_rows(k, v, pad_key=_INVALID, pad_vals=(-1,))
    wk, wv = sort_cuda.sort_rows_plain(k, v, pad_key=_INVALID,
                                       pad_vals=(-1,))
    assert torch.equal(gk, wk) and torch.equal(gv, wv)
    assert bool((gv >= 0).all())           # no pad slot among the first e
    gk, gv = gk.cpu().numpy(), gv.cpu().numpy()
    for row in range(t):
        for kv in np.unique(gk[row]):
            assert np.all(np.diff(gv[row][gk[row] == kv]) > 0)


def _seal_corpora():
    rng = np.random.default_rng(21)
    vocab = [rng.integers(97, 123, size=rng.integers(2, 9),
                          dtype=np.uint8).tobytes() for _ in range(500)]
    text = b" ".join(vocab[i] for i in rng.integers(0, 500, size=600_000))
    return {"text": np.frombuffer(text[:3 << 20], np.uint8),
            "repeat997": np.tile(rng.integers(0, 256, 997, dtype=np.uint8),
                                 3 << 10)[:3 << 20],
            "zeros": np.zeros(2 << 20, np.uint8),
            "random": rng.integers(0, 256, 2 << 20, dtype=np.uint8),
            "odd_tail": rng.integers(97, 100, 5 * _S + 3, dtype=np.uint8)}


@pytest.mark.parametrize("stride", [2, 4])
def test_device_lz4_on_card_equals_cpu(dev, stride):
    """The seal on the card emits the CPU engine's bytes, submit for submit
    (same history), through both kernels; compress_many too."""
    corp = _seal_corpora()
    card = DeviceLz4(stride=stride, device=dev)
    cpu = DeviceLz4(stride=stride, device="cpu")
    m0, s0 = sort_cuda.match_deltas_launches, sort_cuda.sort_rows_launches
    for name, a in corp.items():
        out = card.compress(a)
        assert out == cpu.compress(a), name
        assert native.lz4_decompress(out, a.size) == a.tobytes()
    group = [corp["text"], corp["repeat997"][:3 << 20], corp["text"]]
    assert card.compress_many(group) == cpu.compress_many(group)
    assert sort_cuda.match_deltas_launches > m0
    assert sort_cuda.sort_rows_launches > s0


# ----------------------------------------------- the shard scan and the mesh

@pytest.mark.parametrize("n_seq", [1, 4, 8])
@pytest.mark.parametrize("seed,n,fill,mask,mn,mx", CASES)
def test_shard_scan_kernel_equals_plain(dev, n_seq, seed, n, fill, mask, mn,
                                        mx):
    """Each shard with the previous shard's tail as its halo (zeros for
    the first): words and count exact, and the shards' words together,
    cut at n, give native.gear_candidates of the whole block."""
    a = _data(seed, n, fill)
    chunk = 256 * n_seq
    buf = np.zeros(n + (-n) % chunk, np.uint8)
    buf[:n] = a
    block = torch.from_numpy(buf).to(dev)
    m = buf.size // n_seq
    words = []
    for s in range(n_seq):
        local = block[s * m:(s + 1) * m]
        halo = (block[s * m - 31:s * m] if s
                else torch.zeros(31, dtype=torch.uint8, device=dev))
        n0 = cdc_cuda.shard_scan_launches
        kw, kc = cdc_cuda.shard_scan(local, halo, s * m, mask)
        torch.cuda.synchronize()
        assert cdc_cuda.shard_scan_launches == n0 + 1
        pw, pc = cdc_cuda.shard_scan_plain(local, halo, s * m, mask)
        assert torch.equal(kw, pw) and torch.equal(kc, pc)
        words.append(kw.cpu().numpy().view(np.uint32))
    wv = np.concatenate(words)
    (idx,) = np.nonzero(wv)
    pos = words_to_positions(idx.astype(np.uint32), wv[idx], n)
    np.testing.assert_array_equal(pos, native.gear_candidates(a, mask))


def _oracle(a, cdc):
    cuts = native.cdc_select(native.gear_candidates(a, gear_mask(cdc)),
                             a.size, cdc.min_chunk, cdc.max_chunk)
    starts = np.concatenate([[0], cuts[:-1]]).astype(np.uint64)
    return cuts, native.sha256_batch(a, starts, cuts - starts)


@pytest.mark.parametrize("n_data,n_seq,n", [(1, 4, 3 << 20), (2, 2, 3 << 20),
                                            (1, 4, 40_000)])
def test_reduce_sharded_on_card(dev, n_data, n_seq, n):
    """The halo route (3 MiB) and the all-gather route (40 KB) on a mesh
    of one card repeated: equal to the native oracle, through the shard
    scan kernel."""
    a = np.random.default_rng(n + n_seq).integers(0, 256, n, dtype=np.uint8)
    cdc = CdcConfig()
    mesh = sharded.make_mesh(n_data, n_seq, [dev] * (n_data * n_seq))
    n0 = cdc_cuda.shard_scan_launches
    cuts, digs = sharded.reduce_sharded(a, cdc, mesh)
    assert cdc_cuda.shard_scan_launches == n0 + n_seq
    wc, wd = _oracle(a, cdc)
    np.testing.assert_array_equal(cuts, wc)
    np.testing.assert_array_equal(digs, wd)


def test_mesh_reducer_on_card_equals_serial(dev):
    rng = np.random.default_rng(31)
    group = [rng.integers(0, 256, k, np.uint8)
             for k in (1 << 20, 300_000, 777, 1 << 19, 5000)]
    cdc = CdcConfig(mask_bits=10, min_chunk=256, max_chunk=4096)
    r = sharded.MeshReducer(cdc, sharded.make_mesh(2, 1, [dev, dev]))
    got = r.reduce_many(group)
    want = ResidentReducer(cdc, device=dev).reduce_many(group)
    for (gc, gd, probe), (wc, wd) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gd, wd)
        assert probe == frozenset()
    r.table.note_new([d.tobytes() for d in want[0][1]])
    again = r.reduce_many(group[:1])[0]
    hm = r.table.host_probe(again[1])
    assert again[2] == frozenset(again[1][i].tobytes()
                                 for i in np.nonzero(hm)[0])
    # slot collisions overwrite a few entries, so not every chunk hits
    assert len(again[2]) > len(again[1]) // 2


def test_lz4_sharded_on_card_equals_compress_many(dev):
    corp = _seal_corpora()
    group = [corp["text"], corp["random"][:3 << 20], corp["zeros"][:3 << 20],
             corp["text"]]
    mesh = sharded.make_mesh(2, 1, [dev, dev])
    got = sharded.lz4_compress_many_sharded(DeviceLz4(device=dev), group,
                                            mesh)
    assert got == DeviceLz4(device=dev).compress_many(group)


# ------------------------------------------------------- the read path


@pytest.mark.parametrize("bucket", [16, 32, 64, 128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("fill", ["random", "zeros"])
def test_gather_raw_kernel_equals_plain(dev, bucket, fill):
    """The raw lane gather on the card equals its plain version on every
    lane: all four byte alignments, random offsets and a lane whose
    window ends at the image's edge."""
    W = bucket * 16
    rng = np.random.default_rng(bucket)
    nw = W + 4096
    img = (np.zeros(nw, np.int32) if fill == "zeros" else
           rng.integers(-(1 << 31), 1 << 31, nw, dtype=np.int64)
           .astype(np.int32))
    offs = rng.integers(0, (nw - W - 1) * 4, 253)
    offs = np.concatenate([offs, [0, 1, 2, 3, (nw - W - 1) * 4 + 3]])
    ol = np.stack([offs, rng.integers(1, bucket * 64 - 4, offs.size)]) \
        .astype(np.int32)
    words = torch.from_numpy(img).to(dev)
    ol_d = torch.from_numpy(ol).to(dev)
    n0 = gather_cuda.raw_launches
    got = gather_cuda.gather_lanes_raw(words, ol_d, bucket)
    assert gather_cuda.raw_launches == n0 + 1
    want = gather_cuda.gather_lanes_raw_plain(words, ol_d, bucket)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), gather_cuda.gather_lanes_raw_plain(
        torch.from_numpy(img), torch.from_numpy(ol), bucket))


@pytest.mark.parametrize("bucket", [16, 32, 64, 128, 256, 512, 1024, 2048])
def test_gather_raw_both_orders_equal_plain(dev, bucket):
    """Both orders of the raw gather on the card equal their plain
    versions, bit for bit: groups of 1, 127, 128 and 1,029 lanes, all
    four byte alignments, windows ending at the image's edge and past it,
    and images whose first word lies 0-3 words past a 16-byte boundary."""
    W = bucket * 16
    rng = np.random.default_rng(bucket + 1)
    nw = W + 3 * 4096 + 7
    full = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, nw + 4,
                                         dtype=np.int64).astype(np.int32)
                            ).to(dev)
    for lanes in (1, 127, 128, 1029):
        edge = (nw - W - 1) * 4
        offs = rng.integers(0, edge, lanes)
        offs[:min(lanes, 8)] = [edge, edge + 3, edge + 4, 0, 1, 2, 3,
                                nw * 4 - 5][:min(lanes, 8)]
        ol = torch.from_numpy(np.stack([offs, np.ones(lanes)]).astype(
            np.int32)).to(dev)
        for p in range(4):
            words = full[p:p + nw]
            for order in ("words", "bytes"):
                n0 = gather_cuda.raw_launches
                got = gather_cuda.gather_lanes_raw(words, ol, bucket, order)
                assert gather_cuda.raw_launches == n0 + 1
                want = gather_cuda.gather_lanes_raw_plain(words, ol, bucket,
                                                          order)
                assert got.dtype == want.dtype and torch.equal(got, want), \
                    (lanes, p, order)
            assert torch.equal(got.view(lanes, -1, 4), gather_cuda
                               .gather_lanes_raw(words, ol, bucket)
                               .view(torch.uint8).view(lanes, -1, 4)
                               .flip(-1))


def test_device_reconstructor_on_card_equals_cpu(dev):
    """Card and CPU reconstructors write the same bytes and leave the same
    counts over a sequence that evicts and hits."""
    from hdrf_tpu_torch.ops.reconstruct import DeviceReconstructor

    rng = np.random.default_rng(71)
    pay = {c: rng.integers(0, 256, int(rng.integers(50_000, 200_000)),
                           dtype=np.uint8).tobytes() for c in range(6)}
    wanted, spans, pos = [], [], 0
    for _ in range(400):
        c = int(rng.integers(0, 6))
        ln = int(rng.integers(1, 8000))
        off = int(rng.integers(0, len(pay[c]) - ln))
        lo = int(rng.integers(0, ln))
        wanted.append((c, off, ln))
        spans.append((pos, lo, ln - lo))
        pos += ln - lo
    outs = []
    for d in (dev, "cpu"):
        r = DeviceReconstructor(budget=600_000, headroom=70_000, device=d)
        out = bytearray(pos)
        r.gather(wanted, lambda c: pay[c], spans, out)
        r.gather(wanted[:50], lambda c: pay[c], spans[:50], out)
        outs.append((bytes(out), r._used, list(r._images),
                     dict(r._sizes)))
    assert outs[0] == outs[1]
    want = b"".join(pay[c][o + lo:o + lo + n]
                    for (c, o, _), (_, lo, n) in zip(wanted, spans))
    assert outs[0][0] == want


def test_dedup_scheme_on_card(dev, tmp_path):
    """dedup_lz4 through the scheme on the card (CDC + SHA-256 kernels on
    the write, the device seal on roll, the raw gather on reads >= 1
    MiB) reads back every block, whole and ranged, and keeps the native
    backend's chunk hashes."""
    from hdrf_tpu_torch.config import ReductionConfig
    from hdrf_tpu_torch.index.chunk_index import ChunkIndex
    from hdrf_tpu_torch.ops.reconstruct import DeviceReconstructor
    from hdrf_tpu_torch.reduction import scheme
    from hdrf_tpu_torch.reduction.dedup import DEVICE_RECON_MIN
    from hdrf_tpu_torch.reduction.scheme import ReductionContext
    from hdrf_tpu_torch.server.read_plane import ReadPlane
    from hdrf_tpu_torch.storage.container_store import ContainerStore
    from hdrf_tpu_torch.utils import qos

    cfg = ReductionConfig()
    cs = ContainerStore(
        str(tmp_path / "c"), container_size=1 << 20, codec="lz4",
        compress_fn=lambda d: dispatch.block_compress("lz4", d, "cuda"),
        compress_batch_fn=lambda ds: dispatch.block_compress_batch(
            "lz4", ds, "cuda"))
    recon = DeviceReconstructor(budget=4 << 20, device=dev)
    cs._on_delete = recon.invalidate
    rp = ReadPlane(cs, backend="cuda", qos_ctrl=qos.AdmissionController())
    rp.attach_store(cs)
    ctx = ReductionContext(cfg, cs, ChunkIndex(str(tmp_path / "i")),
                           backend="cuda", recon=recon, read_plane=rp)
    s = scheme.get("dedup_lz4")
    rng = np.random.default_rng(72)
    a = rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes()
    blocks = {1: a, 2: a[1 << 20:] + rng.integers(97, 123, 1 << 20,
                                                   dtype=np.uint8).tobytes()}
    n0 = gather_cuda.raw_launches
    try:
        for bid, d in blocks.items():
            assert s.reduce(bid, d, ctx) == b""
            want = dispatch.chunk_and_fingerprint(d, cfg.cdc, "native")[1]
            assert ctx.index.get_block(bid).hashes == [
                bytes(h) for h in want]
        for bid, d in blocks.items():
            assert s.reconstruct(bid, b"", len(d), ctx) == d
            for off, ln in [(12_345, DEVICE_RECON_MIN + 7), (99, 4_097)]:
                assert s.reconstruct(bid, b"", len(d), ctx, off, ln) \
                    == d[off:off + ln]
        assert gather_cuda.raw_launches > n0
    finally:
        rp.close()
        ctx.index.close()



def test_datanode_on_card_concurrent_writes(dev, tmp_path):
    """A port DataNode on ``cuda`` takes four concurrent 8 MiB writes:
    every block's chunks are the native backend's cuts with hashlib
    digests, the coalescer ran (groups counted), no seal fell back to the
    host, and a read through the device reconstructor (``device_recon``,
    after a restart on the same directory) equals the bytes written."""
    import threading

    from _dn_standin import StandInNN, port_dn, read_block, write_block, \
        write_ok
    from hdrf_tpu_torch.utils import metrics

    rng = np.random.default_rng(73)
    base = rng.integers(0, 256, 8 << 20, dtype=np.uint8).tobytes()
    blocks = [base] + [rng.integers(0, 256, 3 << 20, dtype=np.uint8)
                       .tobytes() + base[3 << 20:] for _ in range(3)]
    wp = metrics.registry("write_pipeline")
    fallbacks = (metrics.registry("datanode").counter("worker_fallbacks")
                 + metrics.registry("block_receiver")
                 .counter("worker_fallbacks"))
    g0 = wp.counter("device_batches")
    red = {"container_size": 4 << 20}
    root = str(tmp_path / "dn")
    nn = StandInNN()
    try:
        dn = port_dn(root, nn.addr, "dn-card", backend="cuda", red=red)
        try:
            acks = [None] * 4

            def go(i):
                acks[i] = write_block(dn.addr, 10 + i, blocks[i])
            ts = [threading.Thread(target=go, args=(i,)) for i in range(4)]
            for th in ts:
                th.start()
            for th in ts:
                th.join(timeout=300)
            assert all(write_ok(a, b) for a, b in zip(acks, blocks))
            cdc = dn.reduction_ctx.config.cdc
            for i, b in enumerate(blocks):
                cuts, digs = dispatch.chunk_and_fingerprint(b, cdc, "native")
                hashes = dn.index.get_block(10 + i).hashes
                assert hashes == [bytes(d) for d in digs]
                starts = np.concatenate([[0], cuts[:-1]]).astype(np.int64)
                assert hashes == [hashlib.sha256(b[s:e]).digest()
                                  for s, e in zip(starts, cuts.astype(
                                      np.int64))]
                assert read_block(dn.addr, 10 + i)[1] == b
        finally:
            dn.stop()
        assert wp.counter("device_batches") > g0
        assert (metrics.registry("datanode").counter("worker_fallbacks")
                + metrics.registry("block_receiver")
                .counter("worker_fallbacks")) == fallbacks
        n0 = gather_cuda.raw_launches
        dn = port_dn(root, nn.addr, "dn-card", backend="cuda",
                     red={**red, "device_recon": True})
        try:
            assert dn.reduction_ctx.recon is not None
            for i, b in enumerate(blocks):
                assert read_block(dn.addr, 10 + i)[1] == b
            assert gather_cuda.raw_launches > n0
        finally:
            dn.stop()
    finally:
        nn.stop()


# ------------------------------------------------- meshes over several cards

@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_sharded_across_cards(cards):
    """Halos, ring walks and all-gathers as copies between cards; the
    dispatch funnel takes the sharded path by itself."""
    n = len(cards)
    a = np.random.default_rng(77).integers(0, 256, 8 << 20, dtype=np.uint8)
    cdc = CdcConfig()
    want = _oracle(a, cdc)
    shapes = [(1, n)] + ([(2, n // 2)] if n % 2 == 0 else [])
    for n_data, n_seq in shapes:
        mesh = sharded.make_mesh(n_data, n_seq, cards)
        cuts, digs = sharded.reduce_sharded(a, cdc, mesh)
        np.testing.assert_array_equal(cuts, want[0])
        np.testing.assert_array_equal(digs, want[1])
    n0 = cdc_cuda.shard_scan_launches
    cuts, digs = dispatch.chunk_and_fingerprint(a, cdc, backend="cuda")
    assert cdc_cuda.shard_scan_launches == n0 + n
    np.testing.assert_array_equal(cuts, want[0])
    np.testing.assert_array_equal(digs, want[1])
    small = CdcConfig(mask_bits=10, min_chunk=256, max_chunk=4096)
    group = [a[i << 20:(i + 1) << 20] for i in range(2 * n)]
    r = sharded.MeshReducer(small, sharded.make_mesh(n, 1, cards))
    serial = ResidentReducer(small, device=cards[0]).reduce_many(group)
    for (gc, gd, _p), (wc, wd) in zip(r.reduce_many(group), serial):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gd, wd)
    corp = _seal_corpora()
    seal = [corp["text"], corp["random"], corp["zeros"], corp["text"]]
    got = sharded.lz4_compress_many_sharded(
        DeviceLz4(device=cards[0]), seal, sharded.make_mesh(n, 1, cards))
    assert got == DeviceLz4(device=cards[0]).compress_many(seal)


def test_launch_selftest_nccl(cards):
    """One process per card over nccl: every rank's reduce_sharded on the
    global mesh equals the native oracle."""
    n = len(cards)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hdrf_tpu_torch.parallel.launch",
         "--coordinator", f"127.0.0.1:{port}", "--nprocs", str(n),
         "--rank", str(r), "--selftest", "8"], cwd=repo,
        env=dict(os.environ, PYTHONPATH=repo, CUDA_VISIBLE_DEVICES=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for rc, out, err in outs:
        assert rc == 0 and "oracle_match=True" in out, out + err[-3000:]


# ------------------------------------------------------ GF(2^8) RS kernel

RS_LENGTHS = [1, 3, 15, 16, 17, 4097, 65_536 + 5]
RS_SHAPES = [(6, 3), (10, 4), (1, 1), (24, 8), (2, 3), (5, 12)]


def _edge_coeffs(rng, nrows, k):
    c = rng.integers(0, 256, (nrows, k), dtype=np.uint8)
    c.flat[::3] = 0
    c.flat[1::4] = 1
    c.flat[2::5] = 0xFF
    return c


@pytest.mark.parametrize("L", RS_LENGTHS)
def test_rs_kernel_matches_plain(dev, L):
    """Aligned rows, rows at every byte offset of a flat buffer (odd L puts
    each row at another alignment), coefficients with zeros, ones, 0xFF,
    and more than 8 rows (two launches)."""
    rng = np.random.default_rng(L)
    for k, nrows in RS_SHAPES:
        c = _edge_coeffs(rng, nrows, k)
        flat = torch.from_numpy(rng.integers(0, 256, k * L + 19,
                                             dtype=np.uint8)).to(dev)
        for off in (0, 1, 2, 3, 5, 16):
            d = flat[off:off + k * L].view(k, L)
            n0 = rs_cuda.launches
            got = rs_cuda.gf_apply(c, d)
            torch.cuda.synchronize()
            assert rs_cuda.launches - n0 == -(-nrows // rs_cuda.MAX_ROWS)
            assert torch.equal(got, rs_cuda.gf_apply_plain(c, d)), (k, off)


@pytest.mark.parametrize("k", range(1, rs_cuda.MAX_K + 1))
def test_rs_kernel_every_k_and_rows(dev, k):
    """Every instantiation of the kernel (shard count k) at every row
    count 1-8 equals the plain version: rows aligned (L 16, offset 0)
    and at byte offsets 1-3, 5 and 16, ragged lengths, coefficients with
    zeros, ones and 0xFF."""
    rng = np.random.default_rng(100 + k)
    for L in (1, 15, 16, 17, 4097, 65_536 + 5):
        flat = torch.from_numpy(rng.integers(0, 256, k * L + 19,
                                             dtype=np.uint8)).to(dev)
        for nrows in range(1, rs_cuda.MAX_ROWS + 1):
            c = _edge_coeffs(rng, nrows, k)
            for off in (0, 1, 2, 3, 5, 16):
                d = flat[off:off + k * L].view(k, L)
                n0 = rs_cuda.launches
                got = rs_cuda.gf_apply(c, d)
                assert rs_cuda.launches == n0 + 1
                assert torch.equal(got, rs_cuda.gf_apply_plain(c, d)), \
                    (L, nrows, off)


def test_rs_entry_points_on_the_card(dev):
    """rs_encode / rs_decode / partial_sums on the card equal the host
    oracles: every RS(6,3) erasure pattern at an odd stripe length."""
    import itertools

    rng = np.random.default_rng(8)
    L = 4097
    d = rng.integers(0, 256, (6, L), dtype=np.uint8)
    par = rs.rs_encode(d, 6, 3, device=dev)
    assert np.array_equal(par, rs.encode_ref(d, 3))
    allsh = np.concatenate([d, par])
    for r in (1, 2, 3):
        for lost in itertools.combinations(range(9), r):
            have = {i: allsh[i] for i in range(9) if i not in lost}
            got = rs.rs_decode(have, 6, 3, want=list(lost), device=dev)
            assert all(np.array_equal(got[i], allsh[i]) for i in lost)
    c = _edge_coeffs(rng, 3, 2)
    assert np.array_equal(rs.partial_sums(allsh[:2], c, device=dev),
                          rs.partial_sums_ref(allsh[:2], c))
    bm = rs._bit_matrix(rs.rs_matrix(6, 3)[6:])
    assert np.array_equal(rs._bit_matmul(bm, d, 3, device=dev), par)
    with pytest.raises(ValueError, match="not the expansion"):
        rs._bit_matmul(np.eye(24, 48, dtype=np.float32)[::-1].copy(), d, 3,
                       device=dev)



def test_namenode_writes_and_demotes_on_card(dev, tmp_path):
    """Steps (a) and (d) of chip_smoke's NAMENODE phase at a small size: a
    port NameNode, three port DataNodes on ``cuda``, one 8 MiB block
    written down the pipeline add_block chose, read back from every
    replica; then ``ec_demote_after_s`` set, the NameNode's
    ``stripe_demote`` runs the RS kernel on the owner, the other replicas
    are invalidated and the block reads back equal from the owner."""
    import time

    from _dn_standin import port_dn, read_block, write_block, write_ok
    from hdrf_tpu_torch.config import NameNodeConfig
    from hdrf_tpu_torch.proto.rpc import RpcClient
    from hdrf_tpu_torch.server.namenode import NameNode

    def wait(pred, what, timeout=120.0):
        t_end = time.monotonic() + timeout
        while not pred():
            assert time.monotonic() < t_end, what
            time.sleep(0.05)

    nn = NameNode(NameNodeConfig(meta_dir=str(tmp_path / "name"),
                                 ec_data_shards=3, ec_parity_shards=2)
                  ).start()
    dns = {}
    try:
        for i in range(3):
            d = port_dn(str(tmp_path / f"dn{i}"), nn.addr, f"dn-{i}",
                        backend="cuda", red={"container_size": 1 << 20})
            dns[d.dn_id] = d
        wait(lambda: len(nn._datanodes) == 3, "registration")
        rng = np.random.default_rng(5)
        data = rng.integers(0, 256, 8 << 20, dtype=np.uint8).tobytes()
        n0 = (cdc_cuda.scan_launches, sha256_cuda.launches)
        with RpcClient(nn.addr) as c:
            c.call("create", path="/card/f", client="t", scheme="dedup_lz4")
            a = c.call("add_block", path="/card/f", client="t")
            tg = [{"dn_id": t["dn_id"], "addr": t["addr"]}
                  for t in a["targets"]]
            acks = write_block(tg[0]["addr"], a["block_id"], data,
                               targets=tg[1:], gen_stamp=a["gen_stamp"])
            assert write_ok(acks, data)
            wait(lambda: c.call("complete", path="/card/f", client="t",
                                block_lengths={a["block_id"]: len(data)}),
                 "complete")
            assert cdc_cuda.scan_launches > n0[0]
            assert sha256_cuda.launches > n0[1]
            assert c.call("stat", path="/card/f")["length"] == len(data)
            locs = c.call("get_block_locations", path="/card/f")["blocks"]
            holders = [loc["dn_id"] for loc in locs[0]["locations"]]
            assert len(holders) == 3
            for d in holders:
                assert read_block(dns[d].addr, a["block_id"])[1] == data
            for d in dns.values():
                d.containers.drain_seals()
            r0 = rs_cuda.launches
            nn.config.ec_demote_after_s = 0.5
            wait(lambda: c.call("ec_status")["demoted_blocks"] == 1,
                 "demotion")
            assert rs_cuda.launches > r0
            wait(lambda: len(c.call("get_block_locations", path="/card/f")
                             ["blocks"][0]["locations"]) == 1,
                 "replicas invalidated down to the owner")
            owner = c.call("get_block_locations", path="/card/f")[
                "blocks"][0]["locations"][0]["dn_id"]
            assert dns[owner].index.stripe_manifests()
            assert read_block(dns[owner].addr, a["block_id"])[1] == data
    finally:
        for d in dns.values():
            d.stop()
        nn.stop()


def test_client_ec_write_and_degraded_read_on_card(dev):
    """The port client's striped path on the card: an RS(6,3) EC file
    written by ``HdrfClient(device="cuda")`` launches the RS kernel and
    stores shards byte-identical to a ``device="cpu"`` client's; with a
    data-shard holder stopped, the card client decodes on the card and
    both read the bytes back."""
    from hdrf_tpu_torch.client.filesystem import HdrfClient
    from hdrf_tpu_torch.proto import datatransfer as dt
    from hdrf_tpu_torch.testing.minicluster import MiniCluster

    data = np.random.default_rng(9).integers(
        0, 256, 3_000_001, dtype=np.uint8).tobytes()
    with MiniCluster(n_datanodes=9, replication=1, block_size=1 << 20,
                     container_size=1 << 20) as mc:
        addr = mc.nn_addrs()[0]
        with HdrfClient(addr, name="card") as gc, \
                HdrfClient(addr, name="host", device="cpu") as hc:
            assert gc.device == "cuda"
            r0 = rs_cuda.launches
            gc.write("/ec/g", data, ec="rs-6-3-64k")
            assert rs_cuda.launches > r0
            hc.write("/ec/h", data, ec="rs-6-3-64k")
            stored = {}
            for p in ("/ec/g", "/ec/h"):
                loc = hc._call("get_block_locations", path=p)
                stored[p] = [dt.fetch_block(tuple(b["locations"][0]["addr"]),
                                            b["block_id"])
                             for g in loc["groups"] for b in g["blocks"]]
            assert stored["/ec/g"] == stored["/ec/h"]
            assert gc.read("/ec/g") == hc.read("/ec/g") == data
            victim = tuple(loc["groups"][0]["blocks"][0]["locations"][0]
                           ["addr"])
            mc.stop_datanode(next(i for i, d in enumerate(mc.datanodes)
                                  if tuple(d.addr) == victim))
            r1 = rs_cuda.launches
            assert gc.read("/ec/h") == data
            assert rs_cuda.launches > r1
            assert hc.read("/ec/h", offset=65_537, length=1_000_000) == \
                data[65_537:1_065_537]


def _bench(argv: list) -> list:
    import contextlib
    import io
    import json

    from hdrf_tpu_torch import benchmarks

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert benchmarks.main(argv) == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


def test_benchmarks_cdc_and_ec_on_card(dev):
    """``benchmarks cdc --mb 1`` and ``ec --mb 2`` on the card: their
    oracle flags hold, and the kernels they time launched."""
    cdc_cuda.scan_launches = cdc_cuda.select_launches = 0
    cdc_cuda.image_launches = gather_cuda.launches = rs_cuda.launches = 0
    (o,) = _bench(["cdc", "--mb", "1", "--inner", "2", "--repeats", "1"])
    assert o["backend"] == "cuda" and o["interpret"] is False
    assert o["cuts_verified"] is True
    n = 1 << 20
    rng = np.random.default_rng(17)
    a = rng.integers(0, 256, n, dtype=np.uint8)
    a[: n // 4] = rng.integers(97, 123, size=n // 4, dtype=np.uint8)
    block, _ = cdc_cuda.padded_block(a, dev)
    _, bitmap = cdc_cuda.cdc_scan_plain(
        block, n, gear_mask(CdcConfig(mask_bits=13, min_chunk=2048)), 2048)
    assert (o["scan_slab_survivors"], o["scan_candidates"]) \
        == cdc_cuda.scan_telemetry_plain(bitmap)
    for c in (cdc_cuda.scan_launches, cdc_cuda.select_launches,
              cdc_cuda.image_launches, gather_cuda.launches):
        assert c > 0
    (e,) = _bench(["ec", "--mb", "2", "--inner", "2"])
    assert e["backend"] == "cuda" and e["parity_oracle_ok"] is True
    assert (e["k"], e["m"], e["storage_ratio"]) == (6, 3, 1.5)
    assert rs_cuda.launches > 0

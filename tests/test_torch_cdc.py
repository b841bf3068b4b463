"""Port CDC (hdrf_tpu_torch.ops.gear / cdc_cuda) against the JAX reference.

The port runs its plain versions on the CPU (``device="cpu"``); the
reference runs as its own tests run it — the fused Pallas kernel through
the interpreter (both scan variants), the XLA/native overflow fallback of
``ResidentReducer(fused_mode="interpret")``, and the native C++ oracle.
Cuts are integers: every comparison is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrf_tpu import native
from hdrf_tpu.config import CdcConfig as RefCdc
from hdrf_tpu.ops import cdc_pallas
from hdrf_tpu.ops import gear as ref_gear
from hdrf_tpu.ops import sha256 as ref_sha
from hdrf_tpu.ops.dispatch import gear_mask as ref_gear_mask
from hdrf_tpu.ops.resident import ResidentReducer as RefReducer
from hdrf_tpu.utils import device_ledger as ref_ledger
from hdrf_tpu_torch.config import CdcConfig
from hdrf_tpu_torch.ops import cdc_cuda, dispatch, gear
from hdrf_tpu_torch.ops import sha256 as port_sha
from hdrf_tpu_torch.ops.resident import ResidentReducer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are per-op bound on small tensors; one intra-op
    thread keeps them off the cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpora():
    """The seven corpora of tests/test_cdc_pallas.py (same seed, same
    draw order)."""
    rng = np.random.default_rng(7)
    text = rng.integers(97, 123, size=200_000, dtype=np.uint8)
    yield "random", rng.integers(0, 256, 150_000, dtype=np.uint8), \
        0x1FFF, 2048, 65536
    yield "text-low-entropy", text, 0x1FFF, 2048, 65536
    yield "forced-max-runs", rng.integers(0, 256, 120_000, dtype=np.uint8), \
        0xFFFFFF, 512, 4096
    yield "dense", rng.integers(0, 256, 30_000, dtype=np.uint8), 0x7, 8, 64
    yield "tail-short-chunk", rng.integers(0, 256, 65536 + 37,
                                           dtype=np.uint8), \
        0x1FFF, 2048, 65536
    yield "single-tile", rng.integers(0, 256, 65536, dtype=np.uint8), \
        0x3FF, 256, 8192
    yield "sub-tile", rng.integers(0, 256, 300, dtype=np.uint8), 0x3F, 16, 128


@pytest.mark.parametrize("skip_ahead", [True, False],
                         ids=["skip-ahead", "pr4-walk"])
@pytest.mark.parametrize("name,a,mask,mn,mx", list(_corpora()),
                         ids=[c[0] for c in _corpora()])
def test_cuts_equal_reference_kernel_and_native(name, a, mask, mn, mx,
                                                skip_ahead):
    """Port chunks_fused == the reference fused kernel (interpreter, both
    scan variants) == native.cdc_chunk, on every standard corpus."""
    want, of = cdc_pallas.chunks_fused(
        a, mask, mn, mx, mask_bits=max(bin(mask).count("1"), 1),
        interpret=True, skip_ahead=skip_ahead)
    assert not of
    got, overflowed = cdc_cuda.chunks_fused(a, mask, mn, mx, device="cpu")
    assert not overflowed
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, native.cdc_chunk(a, mask, mn, mx))


def test_zeros_match_reference_overflow_fallback():
    """All zeros makes every position a candidate: the reference's fused
    kernel overflows its distributional cut cap and reruns through its
    XLA + host-select fallback; the port, sized to the hard bound, gives
    the same cuts (one every min_chunk) and digests without overflowing."""
    ref_cdc = RefCdc(mask_bits=20, min_chunk=64, max_chunk=4096)
    a = np.zeros(1 << 18, dtype=np.uint8)
    evs = ref_ledger.events_snapshot()
    t0 = evs[-1]["id"] if evs else 0
    want_cuts, want_digs = RefReducer(ref_cdc,
                                      fused_mode="interpret").reduce(a)
    ops = {e["op"] for e in ref_ledger.events_snapshot() if e["id"] > t0}
    assert {"resident.cdc_fused", "resident.prep_batch"} <= ops
    cdc = dispatch.from_reference_cdc(dataclasses.asdict(ref_cdc))
    cuts, overflowed = cdc_cuda.chunks_fused(
        a, dispatch.gear_mask(cdc), cdc.min_chunk, cdc.max_chunk,
        device="cpu")
    assert not overflowed
    np.testing.assert_array_equal(cuts, want_cuts)
    assert np.all(np.diff(cuts.astype(np.int64), prepend=0) == 64)
    got_cuts, got_digs = ResidentReducer(cdc, device="cpu").reduce(a)
    np.testing.assert_array_equal(got_cuts, want_cuts)
    np.testing.assert_array_equal(got_digs, want_digs)


def test_warmup_vector():
    """pos1 = 1 can never be a cut; the first admissible candidate is
    MIN_CANDIDATE_POS1 (mask 0 makes every position hash-eligible)."""
    z = np.zeros(256, dtype=np.uint8)
    cuts, _ = cdc_cuda.chunks_fused(z, 0, 1, 4096, device="cpu")
    want = native.cdc_chunk(z, 0, 1, 4096)
    assert cuts[0] == want[0] == gear.MIN_CANDIDATE_POS1 \
        == ref_gear.MIN_CANDIDATE_POS1
    np.testing.assert_array_equal(cuts, want)


def test_gear_table_and_sha_constants_equal_reference():
    """The state carried across: Gear table and SHA-256 constants, element
    for element, against the JAX package and the native library."""
    np.testing.assert_array_equal(gear.gear_table_np(),
                                  ref_gear.gear_table_np())
    np.testing.assert_array_equal(gear.gear_table_np(), native.gear_table())
    np.testing.assert_array_equal(port_sha._K, ref_sha._K)
    np.testing.assert_array_equal(port_sha._H0, ref_sha._H0)
    assert gear.WINDOW == ref_gear.WINDOW
    for m in (0, 1, 31, 64, 2048, 1 << 20):
        assert gear.skip_ahead_threshold(m) == ref_gear.skip_ahead_threshold(m)


@pytest.mark.parametrize("mask_bits", [1, 3, 8, 13, 16, 20, 24, 31])
def test_gear_mask_and_config_equal_reference(mask_bits):
    ref = RefCdc(mask_bits=mask_bits, min_chunk=512, max_chunk=8192)
    cdc = dispatch.from_reference_cdc(dataclasses.asdict(ref))
    assert dataclasses.asdict(cdc) == dataclasses.asdict(ref)
    assert dispatch.gear_mask(cdc) == ref_gear_mask(ref)


def test_defaults_equal_reference():
    assert dataclasses.asdict(CdcConfig()) == dataclasses.asdict(RefCdc())


def test_plain_scan_and_select_equal_native():
    """The plain candidate scan and host select, piece by piece, against
    native.gear_candidates / native.cdc_select."""
    rng = np.random.default_rng(12)
    a = rng.integers(0, 256, 50_000, dtype=np.uint8)
    a[20_000:23_000] = 0                       # a dense run
    for mask, mn, mx in ((0x1FFF, 2048, 65536), (0x3F, 16, 128),
                         (0xFF, 40, 700)):
        cand = gear.candidate_positions(torch.from_numpy(a), a.size, mask,
                                        mn).numpy()
        nat = native.gear_candidates(a, mask).astype(np.int64)
        np.testing.assert_array_equal(
            cand, nat[nat >= gear.skip_ahead_threshold(mn)])
        np.testing.assert_array_equal(
            gear.cdc_select(cand, a.size, mn, mx),
            native.cdc_select(nat, a.size, mn, mx))


def test_empty_and_unaligned_blocks():
    cuts, of = cdc_cuda.chunks_fused(b"", 0x1FFF, 2048, 65536, device="cpu")
    assert cuts.size == 0 and not of
    rng = np.random.default_rng(13)
    for n in (1, 31, 32, 513, 4097):
        a = rng.integers(0, 256, n, dtype=np.uint8)
        cuts, _ = cdc_cuda.chunks_fused(a, 0xFF, 16, 256, device="cpu")
        np.testing.assert_array_equal(cuts, native.cdc_chunk(a, 0xFF, 16,
                                                             256))


# ----------------------------------------- the select kernel's algorithm

def _next_cut(cand, n, mn, mx, f):
    lo, hi = f + mn, min(f + mx, n)
    if lo <= hi:
        i = int(np.searchsorted(cand, lo))
        if i < cand.size and cand[i] <= hi:
            return int(cand[i])
    return hi


def _select_model(cand, n, mn, mx, b_small, w):
    """numpy model of csrc/cdc.cu's select at segment width ``w``: (a)
    speculative walks from every segment start, (b) each walker on from
    its exit, at most 4 lcap cuts, until it lands on a point of the chain
    of the segment it is in, (c) the stitch along the merge pointers from
    segment 0, walking on serially past a walker that did not merge until
    the chain lands on a segment's point, (d) the emit at offsets scanned
    from the segments' counts; the header's telemetry lanes are the spec
    grid's tally (rows of 512 positions holding a candidate, and the
    candidates).  Returns the kernel's (table, ols, olb) up
    to the header counts, the number of segments on the true chain and
    the number of cuts the stitch walked serially."""
    nseg = -(-n // w)
    lcap = min(w, n) // mn + 3
    small = lambda ln: (ln + 9 + 63) // 64 <= b_small   # noqa: E731
    pts = []                                            # (a)
    for i in range(nseg):
        p = [i * w]
        while p[-1] < (i + 1) * w and p[-1] < n or len(p) == 1:
            p.append(_next_cut(cand, n, mn, mx, p[-1]))
        assert len(p) <= lcap
        pts.append(p)
    merge, ys = [], []                                  # (b)
    for i in range(nseg):
        f, y, m = pts[i][-1], [], "end"
        while f < n:
            k = f // w
            if f in pts[k]:
                m = (k, pts[k].index(f))
                break
            if len(y) == cdc_cuda.WALK_REACH * lcap:
                m = "open"
                break
            f = _next_cut(cand, n, mn, mx, f)
            y.append(f)
        merge.append(m)
        ys.append(y)
    ent, runs, k, e = [-1] * nseg, [[] for _ in range(nseg)], 0, 0  # (c)
    while True:
        ent[k] = e
        if merge[k] == "end":
            break
        if merge[k] == "open":
            f = ys[k][-1]
            while f < n:
                f = _next_cut(cand, n, mn, mx, f)
                runs[k].append(f)
                if f < n and f in pts[f // w]:
                    break
            if f >= n:
                break
            merge[k] = (f // w, pts[f // w].index(f))
        k, e = merge[k]
    pieces = [[] if ent[k] < 0 else pts[k][ent[k]:] + ys[k] + runs[k]
              for k in range(nseg)]
    nc = [max(len(p) - 1, 0) for p in pieces]
    ns = [sum(small(b - a) for a, b in zip(p, p[1:])) for p in pieces]
    oc, os_ = np.cumsum([0] + nc), np.cumsum([0] + ns)  # scan
    ob = oc - os_
    table = np.zeros(8 + oc[-1], np.int32)              # (d)
    ols = np.zeros((2, os_[-1]), np.int32)
    olb = np.zeros((2, ob[-1]), np.int32)
    for k, p in enumerate(pieces):
        c, s, b = oc[k], os_[k], ob[k]
        for a, cut in zip(p, p[1:]):
            table[8 + c] = cut
            c += 1
            if small(cut - a):
                ols[:, s] = (a, cut - a)
                s += 1
            else:
                olb[:, b] = (a, cut - a)
                b += 1
    rows = np.unique((np.asarray(cand, dtype=np.int64) - 1) // 512).size
    table[:6] = (oc[-1], 0, os_[-1], ob[-1], rows, len(cand))  # + tally
    return (table, ols, olb, sum(e >= 0 for e in ent),
            sum(len(r) for r in runs))


SHORT_PERIODS = (3, 5, 7)


def _select_cases():
    """(name, candidates or bytes, n, mask, min, max): adversarial inputs
    of the segmented select; byte corpora go through the native scan."""
    rng = np.random.default_rng(41)
    yield "zeros", np.zeros(300_000, np.uint8), None, 0x1FFF, 2048, 65536
    yield "no-candidates", np.empty(0, np.int64), 100_000, 0, 512, 4096
    # one candidate per 1,531 positions, under min: chains a period apart
    # never meet, and no segment width is a multiple of the period
    yield "period-never-aligns", np.arange(700, 250_000, 1531), 250_000, \
        0, 2048, 8192
    # short periods (a solid 24-bit colour is a 3-byte one): every chain
    # steps by the same stride, so chains a non-multiple apart never meet
    # and the stitch walks serially
    for p in SHORT_PERIODS:
        yield f"period-{p}", np.arange(1000 + p // 2, 250_000, p), 250_000, \
            0, 2048, 8192
    yield "segment-starts", "starts", 200_000, 0, 2048, 8192
    yield "dense", rng.integers(0, 256, 30_000, dtype=np.uint8), None, \
        0x7, 8, 64
    yield "forced-max-runs", rng.integers(0, 256, 120_000, dtype=np.uint8), \
        None, 0xFFFFFF, 512, 4096
    yield "tail-short", rng.integers(0, 256, 3 * 8192 + 37, dtype=np.uint8), \
        None, 0x3FF, 256, 2048


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["w-multiple-of-max", "w-odd"])
@pytest.mark.parametrize("name,src,n,mask,mn,mx", list(_select_cases()),
                         ids=[c[0] for c in _select_cases()])
def test_segmented_select_model_equals_serial(name, src, n, mask, mn, mx,
                                              aligned):
    """The select kernel's four phases, modelled at tiny segment widths,
    give the serial walk's cuts (port gear.cdc_select and the reference's
    native.cdc_select) and the plain version's table and lane tables."""
    w = mx if aligned else mx + mn // 2 + 1
    if isinstance(src, str):               # candidates at segment starts
        cand = np.arange(w, n, w)
    elif src.dtype == np.uint8:
        n = src.size
        cand = native.gear_candidates(src, mask).astype(np.int64)
    else:
        cand = src
    b_small = 2
    got = _select_model(cand[cand >= gear.skip_ahead_threshold(mn)], n,
                        mn, mx, b_small, w)
    want = native.cdc_select(cand.astype(np.uint64), n, mn, mx)
    np.testing.assert_array_equal(got[0][8:], want.astype(np.int64))
    np.testing.assert_array_equal(got[0][8:],
                                  gear.cdc_select(cand, n, mn, mx))
    assert got[3] <= -(-n // w) and -(-n // w) >= 3
    if name.startswith("period-") and name != "period-never-aligns":
        assert got[4] > 0                  # the stitch walked serially
    bits = torch.zeros(n + (-n) % 512, dtype=torch.bool)
    bits[torch.from_numpy(cand[cand >= gear.skip_ahead_threshold(mn)]
                          - 1)] = True
    table, ols, olb = cdc_cuda.cdc_select_plain(gear.pack_bits(bits), n, mn,
                                                mx, b_small)
    nc, _, ns, nbg = got[0][:4]
    np.testing.assert_array_equal(got[0], table[:8 + nc].numpy())
    np.testing.assert_array_equal(got[1], ols[:, :ns].numpy())
    np.testing.assert_array_equal(got[2], olb[:, :nbg].numpy())


# ------------------------------------------- the scan kernel's algorithm

def _bit_range(lo: int, hi: int) -> int:
    """csrc/cdc.cu ``bit_range``: bits lo..hi of a word, none if lo > hi."""
    if lo > 31 or hi < 0 or lo > hi:
        return 0
    m = gear.M32
    if lo > 0:
        m = (m << lo) & gear.M32
    if hi < 31:
        m &= (2 << hi) - 1
    return m


def _scan_model(buf: np.ndarray, hist: np.ndarray, lo: int, hi: int,
                mask: int, lanes: int = 32, span: int = 1):
    """numpy model of csrc/cdc.cu's ``gear_scan`` over ``buf`` (u8, a
    multiple of 32 bytes) with ``hist`` the 32 bytes before it, at
    ``lanes`` 32-byte pieces a chunk and ``span`` chunks a warp.  Each
    piece is hashed once from zero history (prefix hashes hp_j); the hash
    entering it is its left neighbour's last hp (the previous chunk's
    last lane for lane 0), or, for the first piece of a span, a warp sum
    of ``G[b_k] << (31 - k)`` over the 32 bytes before it; the hash after
    byte j is ``hp_j + (s << (j + 1))``.  The position rule (selectable
    pos1 within ``buf``: [lo, hi]) is applied as a bit mask a piece, only
    in chunks that hold a bound.  Returns (bitmap u32[len / 32], the
    hashes u64[len], the number of clamped chunks)."""
    g = gear.gear_table_np().astype(np.uint64)
    n = buf.size
    pieces = g[buf.reshape(-1, 32)]
    hp = np.zeros_like(pieces)
    h = np.zeros(len(pieces), np.uint64)
    for j in range(32):
        h = ((h << np.uint64(1)) + pieces[:, j]) & gear.M32
        hp[:, j] = h
    chunk = 32 * lanes
    p = np.arange(len(pieces))
    s = np.concatenate([[np.uint64(0)], hp[:-1, 31]])   # the left lane's
    ext = np.concatenate([hist, buf])
    for q in np.nonzero(p * 32 % (chunk * span) == 0)[0]:  # span starts
        pre = ext[32 * q:32 * q + 32].astype(np.uint64)    # 32 bytes before
        s[q] = np.uint64(sum(int(g[b]) << (31 - k)
                             for k, b in enumerate(pre)) & gear.M32)
    shift = np.arange(1, 33, dtype=np.uint64)
    t = (hp + ((s[:, None] << shift) & gear.M32)) & gear.M32
    bits = (((t & np.uint64(mask)) == 0).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(axis=1)
    off = p * 32 // chunk * chunk
    rem = np.minimum(chunk, n - off)
    clamped = (off + 1 < lo) | (off + rem > hi)
    for q in np.nonzero(clamped)[0]:
        bits[q] &= np.uint64(_bit_range(lo - (32 * q + 1), hi - (32 * q + 1)))
    return (bits.astype(np.uint32), t.reshape(-1),
            len(set((off[clamped] // chunk).tolist())))


SCAN_MODEL_CASES = [  # (name, n, fill, mask, min, lanes, span)
    ("n-in-a-piece-300", 300, "random", 0, 16, 32, 1),
    ("pos1-is-thr-512", 512, "random", 0, 32, 32, 1),
    ("ragged-last-tile", 1536, "random", 0, 1000, 32, 1),
    ("thr-in-third-tile", 5000, "text", 0x7, 2100, 32, 3),
    ("zeros", 4096, "zeros", 0x1FFF, 64, 32, 2),
    ("narrow-lanes", 3000, "random", 0xF, 100, 4, 3),
    ("two-lanes-text", 20_000, "text", 0xFF, 300, 2, 5),
    ("random-spans", 200_000, "random", 0x1FFF, 2048, 32, 7),
]


def _scan_data(n: int, fill: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if fill == "zeros":
        return np.zeros(n, np.uint8)
    return rng.integers(*((97, 123) if fill == "text" else (0, 256)), n,
                        dtype=np.uint8)


@pytest.mark.parametrize("name,n,fill,mask,mn,lanes,span", SCAN_MODEL_CASES,
                         ids=[c[0] for c in SCAN_MODEL_CASES])
def test_scan_model_equals_window_hashes_and_reference(name, n, fill, mask,
                                                       mn, lanes, span):
    """The scan kernel's decomposition (pieces hashed from zero, entering
    hashes by neighbour and warp sum, the hoisted position rule), modelled
    at the kernel's widths and at narrow ones, gives every window hash of
    ``gear.window_hashes`` and the bitmap of the plain scan, of the
    reference's ``candidate_bitmap_words`` and ``gear_candidates_jax``
    and of ``native.gear_candidates``, tolerance zero."""
    a = _scan_data(n, fill, n + mn)
    block, n = cdc_cuda.padded_block(a, "cpu")
    thr = gear.skip_ahead_threshold(mn)
    got, hashes, clamped = _scan_model(block.numpy(), np.zeros(32, np.uint8),
                                       thr, n, mask, lanes, span)
    assert clamped >= 1
    np.testing.assert_array_equal(hashes,
                                  gear.window_hashes(block).numpy())
    _, plain = cdc_cuda.cdc_scan_plain(block, n, mask, mn)
    np.testing.assert_array_equal(got, plain.numpy().view(np.uint32))
    ref = np.asarray(ref_gear.candidate_bitmap_words(
        jnp.asarray(block.numpy()), jnp.uint32(mask)))
    pos = np.arange(1, block.numel() + 1)
    rule = ((pos >= thr) & (pos <= n)).reshape(-1, 32)
    ref_bits = np.unpackbits(ref.view(np.uint8), bitorder="little") \
        .reshape(-1, 32).astype(bool) & rule
    np.testing.assert_array_equal(
        np.unpackbits(got.view(np.uint8), bitorder="little")
        .reshape(-1, 32).astype(bool), ref_bits)
    (idx,) = np.nonzero(got)
    cand = gear.words_to_positions(idx, got[idx], n)
    for oracle in (native.gear_candidates(a, mask),
                   ref_gear.gear_candidates_jax(a, mask)):
        oracle = oracle.astype(np.uint64)
        np.testing.assert_array_equal(cand, oracle[oracle >= thr])


def test_scan_model_hoisted_rule_equals_per_position_rule():
    """Clamping only the chunks that hold ``thr`` or ``n`` gives the same
    bitmap as testing every position, at the kernel's widths: mask 0 makes
    every position a candidate, so the bitmap is exactly the rule."""
    for n, mn in ((300, 16), (512, 32), (1536, 1000), (4000, 2100),
                  (70_000, 4097)):
        block, n = cdc_cuda.padded_block(_scan_data(n, "random", n), "cpu")
        thr = gear.skip_ahead_threshold(mn)
        got, _, _ = _scan_model(block.numpy(), np.zeros(32, np.uint8), thr,
                                n, 0)
        pos = np.arange(1, block.numel() + 1)
        want = np.packbits((pos >= thr) & (pos <= n), bitorder="little")
        np.testing.assert_array_equal(got.view(np.uint8), want)


@pytest.mark.parametrize("n", [512, 1536, 4096 + 512, 65_536])
def test_be_image_plain_equals_reference_word_image(n):
    """``be_image``'s plain version (``gear.be_words``; the words-only
    scan on the card) equals the reference's ``be_word_image`` on the
    CPU."""
    from hdrf_tpu.ops.resident import be_word_image
    a = _scan_data(n, "random", n)
    got = cdc_cuda.be_image(torch.from_numpy(a)).numpy().view(np.uint32)
    want = np.asarray(be_word_image(jnp.asarray(a)))
    np.testing.assert_array_equal(got, want)

"""The port's LZ4 seal (hdrf_tpu_torch.ops.lz4_device, ops/sort_cuda,
native) against the JAX package on the CPU.

The plain versions of the two kernels are held to the XLA forms the
reference's Pallas kernels are held to (``jax.lax.sort`` and
``sort_pallas.match_deltas_xla``, tests/test_sort_pallas.py); the match
scan, its packed record row and the LZ4 streams of ``compress`` and
``compress_many`` to the reference ``TpuLz4`` with the same history, on the
corpora of tests/test_lz4_tpu.py (rebuilt from their seed), at stride 2
and 4, through the overflow retry, the escape rescan, the record flood
and the bypass.  Outputs are integers and bytes: tolerance zero.
"""

from __future__ import annotations

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hdrf_tpu import native as ref_native
from hdrf_tpu.ops import lz4_tpu, sort_pallas
from hdrf_tpu.ops.lz4_tpu import TpuLz4
from hdrf_tpu.utils import codec as ref_codec
from hdrf_tpu.utils import metrics as ref_metrics
from hdrf_tpu_torch import native
from hdrf_tpu_torch.ops import dispatch, lz4_device, sort_cuda
from hdrf_tpu_torch.ops.lz4_device import _S, DeviceLz4
from hdrf_tpu_torch.utils import codec
from hdrf_tpu_torch.utils import metrics

RNG = np.random.default_rng(11)   # tests/test_lz4_tpu.py's seed and order


def _text(n: int, rng=RNG) -> np.ndarray:
    vocab = [rng.integers(97, 123, size=rng.integers(2, 9),
                          dtype=np.uint8).tobytes() for _ in range(500)]
    out = b" ".join(vocab[i] for i in rng.integers(0, 500, size=n // 5))
    return np.frombuffer(out[:n], np.uint8)


CORPORA = {
    "text": _text(400_000),
    "zeros": np.zeros(300_000, np.uint8),
    "random": RNG.integers(0, 256, size=300_000, dtype=np.uint8),
    "rand_ascii": RNG.integers(97, 123, size=300_000, dtype=np.uint8),
    "repeat997": np.tile(RNG.integers(0, 256, size=997, dtype=np.uint8),
                         300),
    "one_tile": _text(_S),
}


def _twin(**state) -> tuple[TpuLz4, DeviceLz4]:
    """A reference TpuLz4 and a port DeviceLz4 (CPU) in the same state."""
    ref = TpuLz4(stride=state.pop("stride", 2))
    for k, v in state.items():
        setattr(ref, k, v)
    d = {f: getattr(ref, f) for f in dispatch._LZ4_FIELDS}
    return ref, dispatch.from_reference_lz4(d, device="cpu")


def _counters(reg) -> dict:
    return dict(reg.snapshot()["counters"])


# --------------------------------------------------------------- sort_rows

def _keys(rng, t, e, unsigned):
    key = np.stack([rng.permutation(e).astype(np.int64) for _ in range(t)])
    if unsigned:   # across the sign bit
        return (key + 0xFFFF0000 - e // 2).astype(np.uint32)
    return (key - e // 2).astype(np.int32)


@pytest.mark.parametrize("t,e,n_val", [(3, 1024, 2), (2, 8192, 1),
                                       (4, 2048, 1), (1, 1500, 2)])
@pytest.mark.parametrize("unsigned", [False, True])
def test_sort_rows_plain_matches_lax_sort(t, e, n_val, unsigned):
    rng = np.random.default_rng(e + n_val)
    key = _keys(rng, t, e, unsigned)
    vals = [rng.integers(-2**31, 2**31, size=(t, e)).astype(np.int32)
            for _ in range(n_val)]
    want = jax.lax.sort((jnp.asarray(key), *map(jnp.asarray, vals)),
                        dimension=1, num_keys=1)
    got = sort_cuda.sort_rows(
        torch.from_numpy(key.view(np.int32)),
        *map(torch.from_numpy, vals), key_unsigned=unsigned,
        pad_key=np.int32(-1) if unsigned else 2**31 - 1,
        pad_vals=(0,) * n_val)
    np.testing.assert_array_equal(got[0].numpy().view(key.dtype),
                                  np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sort_rows_ties_and_pad_contract():
    """Tied keys: sorted keys, KV pairs a permutation of the input.  A row
    that is not a power of two needs its sentinel."""
    rng = np.random.default_rng(3)
    key = rng.integers(0, 16, size=(2, 1024)).astype(np.int32)
    val = np.arange(2048, dtype=np.int32).reshape(2, 1024)
    sk, sv = sort_cuda.sort_rows(torch.from_numpy(key),
                                 torch.from_numpy(val))
    sk, sv = sk.numpy(), sv.numpy()
    assert (np.diff(sk, axis=1) >= 0).all()
    for r in range(2):
        assert sorted(zip(sk[r], sv[r])) == sorted(zip(key[r], val[r]))
    with pytest.raises(ValueError):
        sort_cuda.sort_rows(torch.zeros((1, 1500), dtype=torch.int32),
                            torch.zeros((1, 1500), dtype=torch.int32))


# ------------------------------------------------------------ match_deltas

def _grams(rng, kind, t, e, stride):
    """(t, e) u32 entries of the match scan's layout from random bytes."""
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
    w = ((b[:, :-3].astype(np.uint32) << 24) | (b[:, 1:-2].astype(np.uint32)
         << 16) | (b[:, 2:-1].astype(np.uint32) << 8)
         | b[:, 3:].astype(np.uint32))
    if stride == 4:
        return w[:, :n:4]
    return np.concatenate([w[:, :n:4], w[:, 2:n:4]], axis=1)


@pytest.mark.parametrize("stride,e", [(2, 1024), (2, 8192), (4, 1024),
                                      (4, 4096)])
@pytest.mark.parametrize("kind", ["text", "few", "zeros", "random"])
def test_match_deltas_plain_matches_xla(stride, e, kind):
    rng = np.random.default_rng(e * stride)
    t = 4 if e <= 2048 else 2
    vals = _grams(rng, kind, t, e, stride)
    pos_bits = int(e - 1).bit_length()
    posn = sort_cuda.positions(e, stride, "cpu").numpy().astype(np.uint32)
    want = sort_pallas.match_deltas_xla(
        jnp.asarray(vals), jnp.asarray(np.broadcast_to(posn, vals.shape)),
        stride, pos_bits)
    got = sort_cuda.match_deltas(torch.from_numpy(vals.view(np.int32)),
                                 stride, pos_bits)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    if kind in ("text", "few"):
        assert (got.numpy() > 0).any()


def test_match_deltas_offset_cap_on_a_full_row():
    """A stride-2 row of 65,536 entries over a 3-letter alphabet: previous
    occurrences farther than 65,535 bytes are dropped by the cap."""
    rng = np.random.default_rng(4)
    vals = _grams(rng, "few", 1, 65536, 2)
    posn = sort_cuda.positions(65536, 2, "cpu").numpy().astype(np.uint32)
    want = np.asarray(sort_pallas.match_deltas_xla(
        jnp.asarray(vals), jnp.asarray(posn[None]), 2, 16))
    got = sort_cuda.match_deltas(torch.from_numpy(vals.view(np.int32)), 2,
                                 16).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert want.max() <= 65535


# -------------------------------------------------------------- match scan

def _scan_both(a, stride, p=None, packed=True):
    ref = TpuLz4(stride=stride)
    blk = ref._pad(a)
    p1, p2, p3 = p or ref._shapes(blk.size)
    want = np.asarray(lz4_tpu._match_scan(jax.device_put(blk), stride, 4, p1,
                                          p2, p3, packed=packed))
    got = lz4_device.match_scan(torch.from_numpy(blk.copy()), stride, 4, p1,
                                p2, p3, packed=packed).numpy()
    return ref, (p1, p2, p3), want, got


@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_match_scan_matches_reference(name, stride):
    """The packed record row is bit-identical; the full layout decodes to
    the same record set (its dead slots carry arbitrary record words)."""
    a = CORPORA[name]
    ref, p, want, got = _scan_both(a, stride)
    assert got.shape == want.shape == (lz4_device._packed_len(p[2]),)
    assert lz4_device._packed_len(p[2]) == lz4_tpu._packed_len(p[2])
    np.testing.assert_array_equal(got, want)
    _, _, wf, gf = _scan_both(a, stride, p, packed=False)
    tw, gw, rw = ref._unpack_full(wf, p[2])
    tg, gg, rg = ref._unpack_full(gf, p[2])
    assert tw == tg and tw == int(want[0])
    np.testing.assert_array_equal(gg, gw)
    np.testing.assert_array_equal(rg, rw)


def test_match_scan_small_hints_and_escape_lanes():
    """Slices far below the record density (records dropped: total >
    slots) and a p3 whose escape lanes overflow still give the reference's
    rows."""
    a = CORPORA["text"]
    _, _, want, got = _scan_both(a, 2, (128, 128, 4096))
    np.testing.assert_array_equal(got, want)
    assert int(want[0]) > int(want[1])          # records were dropped
    long_matches = _long_match_block()
    _, p, want, got = _scan_both(long_matches, 2, (512, 64, 256))
    np.testing.assert_array_equal(got, want)
    assert int(want[3]) > lz4_tpu._esc_slots(p[2])   # E2 overflowed


def _hash16(g: int) -> int:
    return ((g * 2654435761) & 0xFFFFFFFF) >> 16


def _collision_free_segment(rng, n: int) -> bytes:
    """n random bytes whose 4-grams at even offsets, read cyclically, have
    pairwise distinct hash16: in ``s + s`` no other gram with a colliding
    hash interrupts the copy's back-references, so the whole copy is one
    run of equal deltas."""
    while True:
        s = bytearray(rng.integers(0, 256, 2, dtype=np.uint8).tobytes())
        seen: set[int] = set()
        for p in range(0, n - 2, 2):
            for _ in range(64):
                nxt = rng.integers(0, 256, 2, dtype=np.uint8).tobytes()
                grams = [int.from_bytes(bytes(s[p:p + 2]) + nxt, "big")]
                if p + 2 == n - 2:   # the last pair closes the cycle
                    grams.append(int.from_bytes(nxt + bytes(s[:2]), "big"))
                hs = {_hash16(g) for g in grams}
                if len(hs) == len(grams) and not hs & seen:
                    break
            else:
                break
            seen |= hs
            s += nxt
        if len(s) == n:
            return bytes(s)


def _long_match_block() -> np.ndarray:
    """Random 1,100-byte segments each followed by its copy (three
    supertiles): every copy is one match of >= 511 entry units, an E2
    escape, ~59 per supertile."""
    rng = np.random.default_rng(23)
    per_tile = _S // 2200
    out = bytearray()
    for _ in range(3):
        for _ in range(per_tile):
            s = _collision_free_segment(rng, 1100)
            out += s + s
        out += bytes(_S - per_tile * 2200)
    return np.frombuffer(bytes(out), np.uint8)


# ---------------------------------------------------------------- DeviceLz4

@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_compress_matches_reference(name, stride):
    a = CORPORA[name]
    ref, port = _twin(stride=stride)
    out = port.compress(a)
    assert out == ref.compress(a)
    assert native.lz4_decompress(out, a.size) == a.tobytes()


def test_overflow_retry_and_sticky_hints_match_reference():
    a = CORPORA["text"]
    ref, port = _twin(_p1=128, _p2=128)
    assert port.compress(a) == ref.compress(a)
    assert (port._p1, port._p2, port._p3) == (ref._p1, ref._p2, ref._p3)
    assert port._p2 > 128
    b = _text(3 * _S - 1, np.random.default_rng(8))
    assert port.compress(b) == ref.compress(b)


def test_escape_rescan_matches_reference():
    a = _long_match_block()
    ref, port = _twin(_p3=256)
    r0 = ref_metrics.registry("lz4_tpu").counter("escape_rescans")
    p0 = _counters(metrics.registry("lz4_device")).get("escape_rescans", 0)
    out = port.compress(a)
    assert out == ref.compress(a)
    assert ref_metrics.registry("lz4_tpu").counter("escape_rescans") > r0
    assert _counters(metrics.registry("lz4_device"))["escape_rescans"] > p0
    assert native.lz4_decompress(out, a.size) == a.tobytes()


def test_flood_fallback_bypass_and_probe_match_reference():
    """Short-match-dense text floods the slices: the native encoder takes
    over, two floods in a row turn on the bypass, and the state the two
    engines keep stays equal submit for submit."""
    rng = np.random.default_rng(31)
    flood = [_text(640 * 1024, rng) for _ in range(3)]
    ref, port = _twin(BYPASS_RUN=2)
    reg = metrics.registry("lz4_device")
    c0 = _counters(reg)
    for a in [*flood, flood[0], CORPORA["repeat997"]]:
        assert port.compress(a) == ref.compress(a)
        assert (port._flood_streak, port._bypass_left) == \
            (ref._flood_streak, ref._bypass_left)
    c1 = _counters(reg)
    assert c1.get("native_fallbacks", 0) - c0.get("native_fallbacks", 0) >= 2
    assert c1.get("bypassed_scans", 0) - c0.get("bypassed_scans", 0) == 2


def test_compress_many_matches_reference():
    rng = np.random.default_rng(41)
    blocks = [_text(2 * _S, rng) for _ in range(3)]
    ref, port = _twin()
    assert port.compress_many(blocks) == ref.compress_many(blocks)
    mixed = [_text(2 * _S, rng), _text(3 * _S, rng), np.zeros(10, np.uint8)]
    assert port.compress_many(mixed) == ref.compress_many(mixed)
    ref2, port2 = _twin(_bypass_left=3)
    assert port2.compress_many(blocks) == ref2.compress_many(blocks)
    assert port2._bypass_left == ref2._bypass_left == 0
    # a shorter bypass leaves an equal-length group whole and is kept, but
    # bypasses the first buffers of a mixed group
    for group, left in ((blocks, 1), (mixed, 0)):
        ref3, port3 = _twin(_bypass_left=1)
        assert port3.compress_many(group) == ref3.compress_many(group)
        assert port3._bypass_left == ref3._bypass_left == left


def test_small_and_empty_inputs_take_the_native_path():
    port = DeviceLz4(device="cpu")
    a = RNG.integers(0, 256, size=1000, dtype=np.uint8)
    job = port.submit(a)
    assert job.recs is None
    assert port.finish(job) == ref_native.lz4_compress(a)
    assert port.compress(b"") == b""


def test_seal_entry_points_default_to_the_card():
    """DeviceLz4, from_reference_lz4 and block_compress run on the card
    unless the caller asks for the CPU: without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceLz4()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.from_reference_lz4(
            {f: 1 for f in dispatch._LZ4_FIELDS} | {"stride": 2})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dispatch.block_compress("lz4", CORPORA["text"].tobytes())


def test_from_reference_lz4_carries_every_field():
    ref = TpuLz4(stride=4, min_len=8, min_device=3 * _S)
    ref._p1, ref._p2, ref._p3 = 1024, 2048, 1 << 15
    ref._flood_streak, ref._bypass_left = 1, 5
    ref.BYPASS_AFTER, ref.BYPASS_RUN = 3, 7
    port = dispatch.from_reference_lz4(
        {f: getattr(ref, f) for f in dispatch._LZ4_FIELDS}, device="cpu")
    assert {f: getattr(port, f) for f in dispatch._LZ4_FIELDS} == \
        {f: getattr(ref, f) for f in dispatch._LZ4_FIELDS}
    assert port.device == torch.device("cpu")


# ------------------------------------------------- host half and dispatch

def test_stitch_and_native_functions_match_reference():
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(12)
    seg = lz4_device._SEG // 64
    a = _text(3 * seg + 777, rng)
    parts = [a[o:o + seg] for o in range(0, a.size, seg)]
    with ThreadPoolExecutor(2) as pool:
        pieces = list(pool.map(native.lz4_compress_tail, parts))
    assert pieces == [ref_native.lz4_compress_tail(p) for p in parts]
    out = lz4_device.lz4_stitch(pieces)
    assert out == lz4_tpu.lz4_stitch(pieces)
    assert native.lz4_decompress(out, a.size) == a.tobytes()
    assert native.lz4_compress(a) == ref_native.lz4_compress(a)
    g = np.array([4, 100, 2000], np.int32)
    r = np.array([(4 << 16) | 8, (96 << 16) | 12, (1000 << 16) | 40],
                 np.uint32)
    assert native.lz4_emit(a, g, r) == ref_native.lz4_emit(a, g, r)
    # a packed row with both escape lanes and the clipped-length sentinel
    p3, es = 256, lz4_tpu._esc_slots(256)
    recs = [(10, 3, 0), (12, 5, 600), (80_000, 7, 2), (80_001, 9, 32766)]
    A, B = np.zeros(p3, np.uint32), np.zeros(p3 // 4, np.uint32)
    E1, E2 = np.zeros(es, np.uint32), np.zeros(es, np.uint32)
    prev = e1 = e2 = 0
    for i, (pos, dlt, ln) in enumerate(recs):
        dp = pos - prev
        if dp >= 0xFFFF:
            dp, E1[e1], e1 = 0xFFFF, pos, e1 + 1
        if ln >= 511:
            E2[e2], e2 = ln, e2 + 1
        A[i] = dlt | (min(ln, 511) << 15) | ((dp >> 8) << 24)
        B[i // 4] |= (dp & 0xFF) << ((i % 4) * 8)
        prev = pos
    row = np.concatenate([A, B, E1, E2])
    got = native.lz4_unpack_records(row, p3, len(recs), 2, es)
    want = ref_native.lz4_unpack_records(row, p3, len(recs), 2, es)
    assert got[2] == want[2] == len(recs)
    for x, y in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        native.lz4_unpack_records(row[:16], p3, 4, 2, es)


def test_dispatch_codecs_match_reference():
    a = CORPORA["rand_ascii"].tobytes()
    assert codec.compress("gzip", a) == ref_codec.compress("gzip", a)
    assert codec.compress("none", a) == a
    assert codec.decompress("lz4", ref_codec.compress("lz4", a),
                            len(a)) == a
    assert dispatch.block_compress("gzip", a, "cpu") == zlib.compress(a, 1)
    with pytest.raises(KeyError):
        codec.compress("nope", a)
    comp = dispatch.block_compress("lz4", a, "cpu")
    outs = dispatch.block_decompress_batch(["lz4", "gzip", "none"],
                                           [comp, zlib.compress(a), a],
                                           [len(a)] * 3, "cpu")
    assert outs == [a, a, a]
    assert dispatch.lz4_engine("cpu") is dispatch.lz4_engine("cpu")
    assert dataclasses.is_dataclass(lz4_device.Lz4Job)

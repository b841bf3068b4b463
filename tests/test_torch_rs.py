"""The port's Reed-Solomon arithmetic (hdrf_tpu_torch/ops/rs.py) against
the reference's (hdrf_tpu/ops/rs.py, its jitted ``_bit_matmul`` on the
JAX CPU backend) and its host oracles ``encode_ref`` /
``partial_sums_ref``.

Inputs are numpy arrays from a seed; outputs are bytes: tolerance zero.
The port runs ``device="cpu"``: the plain version of the GF(2^8) kernel
(the reference's bit-plane product in PyTorch).  The kernel itself is
held against the plain version on the card in tests/test_torch_cuda.py.

    python -m pytest tests/test_torch_rs.py -q
"""

import itertools

import numpy as np
import pytest
import torch

from hdrf_tpu.ops import rs as ref
from hdrf_tpu_torch.ops import rs, rs_cuda

GEOMETRIES = [(6, 3), (1, 1), (10, 4), (24, 8)]
LENGTHS = [1, 3, 15, 16, 17, 4097]
K, M = 6, 3
# every non-empty erasure pattern of RS(6,3): 9 + 36 + 84 = 129
PATTERNS = [p for r in range(1, M + 1)
            for p in itertools.combinations(range(K + M), r)]


def _data(seed, k, n):
    return np.random.default_rng(seed).integers(0, 256, (k, n),
                                                dtype=np.uint8)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_encode_and_bit_matmul_equal_reference(k, m, L):
    d = _data(k * 1000 + L, k, L)
    want = ref.encode_ref(d, m)
    bm = ref._bit_matrix(ref.rs_matrix(k, m)[k:])
    assert np.array_equal(np.asarray(ref._bit_matmul(bm, d, m)), want)
    assert np.array_equal(rs._bit_matmul(bm, d, m, device="cpu"), want)
    assert np.array_equal(rs.rs_encode(d, k, m, device="cpu"), want)
    assert np.array_equal(rs.rs_encode(d.tobytes(), k, m, device="cpu"), want)
    assert np.array_equal(np.asarray(ref.rs_encode(d, k, m)), want)


def test_pattern_count():
    assert len(PATTERNS) == 129


@pytest.fixture(scope="module")
def rs63():
    d = _data(63, K, 33)
    return d, np.concatenate([d, ref.encode_ref(d, M)])


@pytest.mark.parametrize("lost", PATTERNS, ids=lambda p: "-".join(map(str, p)))
def test_decode_every_erasure_pattern(rs63, lost):
    d, allsh = rs63
    shards = {i: allsh[i] for i in range(K + M) if i not in lost}
    got = rs.rs_decode(shards, K, M, device="cpu")
    want = ref.rs_decode(shards, K, M)
    assert sorted(got) == sorted(want) == [i for i in lost if i < K]
    for i in got:
        assert np.array_equal(got[i], np.asarray(want[i]))
        assert np.array_equal(got[i], d[i])
    # data and parity rebuilt together (the repair path's ``want``)
    every = rs.rs_decode(shards, K, M, want=list(lost), device="cpu")
    for i in lost:
        assert np.array_equal(every[i], allsh[i])


# (nwant, n, seed): a holder's column slice, coefficients with zeros,
# ones and 0xFF spliced in
PARTIAL = [(1, 1, 0), (3, 2, 1), (2, 6, 2), (3, 3, 3), (8, 24, 4),
           (3, 1, 5)]


@pytest.mark.parametrize("nwant,n,seed", PARTIAL)
def test_partial_sums_equal_reference(nwant, n, seed):
    rng = np.random.default_rng(seed)
    for L in (1, 17, 4097):
        stripes = rng.integers(0, 256, (n, L), dtype=np.uint8)
        coeffs = rng.integers(0, 256, (nwant, n), dtype=np.uint8)
        coeffs.flat[::3] = 0
        coeffs.flat[1::5] = 1
        coeffs.flat[2::7] = 0xFF
        want = ref.partial_sums_ref(stripes, coeffs)
        assert np.array_equal(rs.partial_sums_ref(stripes, coeffs), want)
        assert np.array_equal(rs.partial_sums(stripes, coeffs,
                                              device="cpu"), want)
        assert np.array_equal(np.asarray(ref.partial_sums(stripes, coeffs)),
                              want)


@pytest.mark.parametrize("lost", PATTERNS[::7],
                         ids=lambda p: "-".join(map(str, p)))
def test_xor_fold_of_holder_splits_equals_decode(rs63, lost):
    """Each of three holders (slot i on holder i % 3) applies its columns
    of ``repair_rows`` to its survivors; the XOR fold is the decode."""
    _, allsh = rs63
    have = [i for i in range(K + M) if i not in lost][:K]
    want = list(lost)
    rows = rs.repair_rows(K, M, tuple(have), tuple(want))
    assert np.array_equal(rows, ref.repair_rows(K, M, tuple(have),
                                                tuple(want)))
    parts = []
    for h in range(3):
        mine = [j for j, s in enumerate(have) if s % 3 == h]
        if mine:
            parts.append(rs.partial_sums(
                np.stack([allsh[have[j]] for j in mine]), rows[:, mine],
                device="cpu"))
    fold = rs.xor_fold(parts)
    assert np.array_equal(fold, ref.xor_fold(parts))
    dec = rs.rs_decode({i: allsh[i] for i in have}, K, M, want=want,
                       device="cpu")
    for r, i in enumerate(want):
        assert np.array_equal(fold[r], dec[i])
        assert np.array_equal(fold[r], allsh[i])


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_host_half_equals_reference(k, m):
    assert all(np.array_equal(a, b) for a, b in zip(rs._tables(),
                                                    ref._tables()))
    g = rs.rs_matrix(k, m)
    assert np.array_equal(g, ref.rs_matrix(k, m))
    assert np.array_equal(rs._bit_matrix(g), ref._bit_matrix(g))
    assert np.array_equal(rs.gf_mat_inv(g[m:m + k]),
                          ref.gf_mat_inv(g[m:m + k]))
    rng = np.random.default_rng(k * 31 + m)
    have = tuple(sorted(rng.choice(k + m, k, replace=False).tolist()))
    want = tuple(i for i in range(k + m) if i not in have)
    assert np.array_equal(rs.repair_rows(k, m, have, want),
                          ref.repair_rows(k, m, have, want))
    for a in (0, 1, 2, 0x53, 0xFF):
        for b in (0, 1, 0xCA, 0xFF):
            assert rs.gf_mul(a, b) == ref.gf_mul(a, b)


@pytest.mark.parametrize("policy", ["rs-6-3-64k", "RS-10-4-1024k",
                                    "rs-24-8-4k", "rs-1-1-1k", "rs-25-3-64k",
                                    "rs-6-9-64k", "rs-6-3", "xor-2-1-64k",
                                    "rs-6-3-0k"])
def test_parse_policy_equals_reference(policy):
    try:
        want = ref.parse_policy(policy)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" (")[0]):
            rs.parse_policy(policy)
    else:
        assert rs.parse_policy(policy) == want


def test_gf_apply_on_cpu_is_the_plain_version():
    d = _data(5, 4, 100)
    c = np.array([[1, 0, 0xFF, 7], [0, 0, 0, 0]], np.uint8)
    out = rs_cuda.gf_apply(c, torch.from_numpy(d))
    assert out.dtype == torch.uint8 and tuple(out.shape) == (2, 100)
    assert np.array_equal(out.numpy(), ref.partial_sums_ref(d, c))
    assert np.array_equal(rs_cuda.gf_apply_plain(c, torch.from_numpy(d)),
                          out)
    with pytest.raises(ValueError):
        rs_cuda.gf_apply(c[:, :3], torch.from_numpy(d))


@pytest.mark.parametrize("nrows", [1, 3, 8])
@pytest.mark.parametrize("k", range(1, rs_cuda.MAX_K + 1))
def test_gf_apply_plain_equals_partial_sums_ref(k, nrows):
    """The kernel's plain version at every shard count the kernel is
    instantiated for and at 1, 3 and 8 rows, against the reference's
    table oracle: coefficients holding zeros, ones and 0xFF, ragged
    lengths."""
    rng = np.random.default_rng(k * 10 + nrows)
    c = rng.integers(0, 256, (nrows, k), dtype=np.uint8)
    c.flat[::3] = 0
    c.flat[1::4] = 1
    c.flat[2::5] = 0xFF
    for L in (1, 15, 16, 17, 4097):
        d = rng.integers(0, 256, (k, L), dtype=np.uint8)
        got = rs_cuda.gf_apply_plain(c, torch.from_numpy(d))
        assert np.array_equal(got.numpy(), ref.partial_sums_ref(d, c)), L


def test_coefficients_recovered_from_bit_matrix():
    rng = np.random.default_rng(9)
    c = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    assert np.array_equal(rs._coeffs_of(rs._bit_matrix(c), 3, 5), c)
    bogus = rng.integers(0, 2, (24, 40)).astype(np.float32)
    with pytest.raises(ValueError, match="not the expansion"):
        rs._coeffs_of(bogus, 3, 5)


def test_card_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device path launches instead")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.rs_encode(_data(1, K, 8), K, M)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.partial_sums(_data(1, 2, 8), np.ones((1, 2), np.uint8))

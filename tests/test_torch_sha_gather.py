"""Port gather + SHA-256 (hdrf_tpu_torch.ops.gather_cuda / sha256 /
sha256_cuda) against the JAX reference, on the CPU (plain versions).

The gather is held against ``hdrf_tpu.ops.resident.sha_pad_messages``, the
XLA counterpart of the Pallas gather kernel; SHA against
``hdrf_tpu.ops.sha256.sha256_words`` and hashlib, including a lane count
that is not a multiple of the kernel's 128-thread block.  Exact equality.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

from hdrf_tpu import native
from hdrf_tpu.ops.resident import sha_pad_messages
from hdrf_tpu.ops.sha256 import sha256_words as ref_sha256_words
from hdrf_tpu_torch.ops import gather_cuda, sha256_cuda
from hdrf_tpu_torch.ops.gear import be_words
from hdrf_tpu_torch.ops.sha256 import fingerprint_chunks, sha256_words


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are per-op bound on small tensors; one intra-op
    thread keeps them off the cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(rng, nbytes: int, L: int, bucket: int):
    """L random chunk lanes that fit a bucket, inside an nbytes image."""
    lens = rng.integers(0, bucket * 64 - 9 + 1, L)
    offs = rng.integers(0, nbytes - lens.max(), L)
    return np.stack([offs, lens]).astype(np.int32)


@pytest.mark.parametrize("bucket", [1, 2, 5, 16])
def test_gather_equals_reference_pad_messages(bucket):
    rng = np.random.default_rng(bucket)
    nbytes = 8192
    W = bucket * 16
    raw = rng.integers(0, 256, nbytes, dtype=np.uint8)
    # the reference slices windows of W + 1 words: pad so none clamps
    words = np.concatenate([raw.view(">u4").astype(np.uint32),
                            np.zeros(W + 1, np.uint32)])
    ol = _lanes(rng, nbytes, 130, bucket)
    want, nb = sha_pad_messages(jax.device_put(words), jax.device_put(ol),
                                bucket)
    got = gather_cuda.gather_pad_messages(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(ol), bucket)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    np.testing.assert_array_equal((ol[1] + 9 + 63) // 64, np.asarray(nb))
    # the unpadded image gives the same messages (reads past its end are 0)
    got2 = gather_cuda.gather_pad_messages(
        torch.from_numpy(words[:nbytes // 4].view(np.int32)),
        torch.from_numpy(ol), bucket)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


@pytest.mark.parametrize("L", [256, 133])
def test_sha_equals_reference_and_hashlib(L):
    """256 lanes against the reference XLA SHA (it needs a multiple of
    128) and hashlib; 133 lanes — a partial last thread block — against
    hashlib."""
    rng = np.random.default_rng(L)
    B = 3
    raw = rng.integers(0, 256, L * B * 64, dtype=np.uint8)
    lens = rng.integers(0, B * 64 - 9 + 1, L)
    offs = np.arange(L) * (B * 64)
    words = be_words(torch.from_numpy(raw))
    ol = torch.from_numpy(np.stack([offs, lens]).astype(np.int32))
    msgs = gather_cuda.gather_pad_messages(words, ol, B)
    nb = torch.from_numpy(((lens + 9 + 63) // 64).astype(np.int32))
    got = sha256_cuda.sha256_words_cuda(msgs, nb).numpy()
    for i in range(L):
        o = int(offs[i])
        assert bytes(got[i]) == hashlib.sha256(
            raw[o:o + int(lens[i])].tobytes()).digest(), i
    if L % 128 == 0:
        want = ref_sha256_words(jax.device_put(msgs.numpy().view(np.uint32)),
                                jax.device_put(nb.numpy()))
        np.testing.assert_array_equal(got, np.asarray(want))


def test_sha_lane_holds_state_past_its_count():
    """A lane with nblocks smaller than the message width stops there."""
    raw = np.arange(200, dtype=np.uint8)
    words = be_words(torch.from_numpy(np.concatenate(
        [raw, np.zeros(56, np.uint8)])))
    ol = torch.tensor([[0, 0, 0], [0, 50, 200]], dtype=torch.int32)
    msgs = gather_cuda.gather_pad_messages(words, ol, 4)
    nb = ((ol[1] + 9 + 63) // 64).to(torch.int32)
    got = sha256_words(msgs, nb).numpy()
    for i, n in enumerate((0, 50, 200)):
        assert bytes(got[i]) == hashlib.sha256(raw[:n].tobytes()).digest()


def test_fingerprint_chunks_equals_native():
    rng = np.random.default_rng(21)
    a = rng.integers(0, 256, 40_000, dtype=np.uint8)
    cuts = np.array([1, 64, 55 + 64, 5000, 5001, 21_000, 40_000],
                    dtype=np.uint64)
    starts = np.concatenate([[0], cuts[:-1]]).astype(np.uint64)
    got = fingerprint_chunks(a, cuts, device="cpu")
    np.testing.assert_array_equal(
        got, native.sha256_batch(a, starts, cuts - starts))


def _table(rng, image: np.ndarray, lens: np.ndarray, bucket: int):
    """Gathered messages of chunks of ``lens`` at random offsets of a BE
    word image, their block counts and the chunks' bytes."""
    offs = rng.integers(0, image.size - 65536, lens.size)
    ol = torch.from_numpy(np.stack([offs, lens]).astype(np.int32))
    words = be_words(torch.from_numpy(image))
    msgs = gather_cuda.gather_pad_messages(words, ol, bucket)
    nb = ((ol[1] + 9 + 63) // 64).to(torch.int32)
    return msgs, nb, [image[o:o + n].tobytes() for o, n in zip(offs, lens)]


def test_grouped_sha_at_bucket_edges_equals_reference_and_hashlib():
    """One grouped call over a big table (257..1,025 blocks, both edges)
    and a small one (1..256 blocks), at CdcConfig()'s bucket edges (b_small
    = 256 blocks, a 64 KiB max_chunk = 1,025; a chunk of len bytes takes
    (len + 9 + 63) // 64 blocks): each table against the reference
    XLA SHA (the Pallas kernel's CPU path, as its own tests run it) and
    every digest against hashlib."""
    rng = np.random.default_rng(1025)
    image = rng.integers(0, 256, 1 << 18, dtype=np.uint8)
    big_lens = rng.integers(16376, 65537, 128)
    big_lens[:3] = (16376, 65536, 65527)
    small_lens = rng.integers(0, 16376, 128)
    small_lens[:4] = (0, 55, 56, 16375)
    big, small = _table(rng, image, big_lens, 1025), \
        _table(rng, image, small_lens, 256)
    assert [int(x) for x in big[1][:3]] == [257, 1025, 1024]
    assert [int(x) for x in small[1][:4]] == [1, 1, 2, 256]
    got = sha256_cuda.sha256_words_grouped([big[:2], small[:2]])
    for (msgs, nb, chunks), g in zip((big, small), got):
        want = ref_sha256_words(jax.device_put(msgs.numpy().view(np.uint32)),
                                jax.device_put(nb.numpy()))
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
        for c, d in zip(chunks, g.numpy()):
            assert bytes(d) == hashlib.sha256(c).digest()


def test_grouped_sha_with_an_empty_big_table():
    """A block whose chunks all fit the small bucket: the big table is
    empty and the small one is still hashed."""
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, 1 << 17, dtype=np.uint8)
    msgs, nb, chunks = _table(rng, image, np.array([0, 55, 56, 16375]), 256)
    empty = (torch.zeros((0, 1025 * 16), dtype=torch.int32),
             torch.zeros(0, dtype=torch.int32))
    big, small = sha256_cuda.sha256_words_grouped([empty, (msgs, nb)])
    assert big.shape == (0, 32)
    assert [int(x) for x in nb] == [1, 1, 2, 256]
    for c, d in zip(chunks, small.numpy()):
        assert bytes(d) == hashlib.sha256(c).digest()


def test_lane_order_is_undone_on_store():
    """The kernel hashes the first table's lanes longest first and stores
    each digest in its own row: hashing the rows in ``lane_order`` and
    putting row i's digest at ``order[i]`` gives the unpermuted result."""
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, 1 << 17, dtype=np.uint8)
    lens = rng.integers(0, 3 * 64 - 9 + 1, 40)
    lens[7] = lens[3]          # a tie keeps lane order
    msgs, nb, chunks = _table(rng, image, lens, 3)
    order = sha256_cuda.lane_order(nb)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(40))
    o = order.numpy()
    assert (np.diff(nb.numpy()[o]) <= 0).all()
    ties = [i for i in o if nb[i] == nb[3]]
    assert ties == sorted(ties)
    walked = sha256_words(msgs[order.long()], nb[order.long()])
    stored = torch.empty_like(walked)
    stored[order.long()] = walked
    np.testing.assert_array_equal(stored.numpy(),
                                  sha256_words(msgs, nb).numpy())
    for c, d in zip(chunks, stored.numpy()):
        assert bytes(d) == hashlib.sha256(c).digest()

"""The port's device reconstructor and raw lane gather against the
reference's, on the CPU.

``gather_lanes_raw_plain`` (the raw gather kernel's plain version) must
equal the JAX ``reconstruct.gather_lanes_raw`` exactly, at every bucket
from 16 to 256, all four byte alignments and random offsets inside the
headroom contract (the reference's ``dynamic_slice`` clamps a window
past the image, the port's loads read zero: they agree inside it); in
byte order it must equal the reference's lanes byte-swapped, as the
reference's ``gather`` swaps them on the host, at every bucket from 16
to 2048.
``DeviceReconstructor(device="cpu").gather`` must write the same ``out``
bytes as the reference's, and leave the same ``image_hits`` /
``images_staged`` / ``chunks_gathered`` counts and the same resident set
and budget over a sequence that evicts.  Card cases are in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from hdrf_tpu.ops import reconstruct as ref
from hdrf_tpu.utils import metrics as ref_metrics
from hdrf_tpu_torch.ops import gather_cuda
from hdrf_tpu_torch.ops.reconstruct import DeviceReconstructor
from hdrf_tpu_torch.storage.container_store import ContainerStore
from hdrf_tpu_torch.utils import metrics

COUNTS = ("image_hits", "images_staged", "chunks_gathered",
          "reconstructions")


def _counts(reg) -> dict:
    c = reg.registry("device_recon").snapshot()["counters"]
    return {k: c.get(k, 0) for k in COUNTS}


@pytest.mark.parametrize("bucket", [16, 32, 64, 128, 256])
def test_gather_lanes_raw_plain_equals_jax(bucket):
    W = bucket * 16
    rng = np.random.default_rng(bucket)
    nw = W + 3000
    words = rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(np.uint32)
    q = rng.integers(0, nw - W - 1, 64)
    offs = np.concatenate([q * 4 + (np.arange(64) % 4),       # 4 alignments
                           [0, 1, 2, 3, (nw - W - 1) * 4,     # window at
                            (nw - W - 1) * 4 + 3]])           # the edge
    ol = np.stack([offs, rng.integers(1, bucket * 64 - 4, offs.size)]) \
        .astype(np.int32)
    want = np.asarray(ref.gather_lanes_raw(jnp.asarray(words),
                                           jnp.asarray(ol), bucket))
    got = gather_cuda.gather_lanes_raw_plain(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(ol), bucket)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # the wrapper runs the plain version on a CPU tensor
    assert torch.equal(gather_cuda.gather_lanes_raw(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(ol),
        bucket), got)


@pytest.mark.parametrize("bucket", [16, 32, 64, 128, 256, 512, 1024, 2048])
def test_gather_lanes_raw_bytes_plain_equals_jax_byteswap(bucket):
    """The byte-order plain version is the reference's lanes with each
    word's bytes swapped (hdrf_tpu/ops/reconstruct.py:159,
    ``lanes.byteswap()``): all four byte alignments and windows ending at
    the image's edge; the wrapper runs it on a CPU tensor."""
    W = bucket * 16
    rng = np.random.default_rng(bucket + 7)
    nw = W + 600
    words = rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(np.uint32)
    edge = (nw - W - 1) * 4
    offs = np.concatenate([rng.integers(0, edge, 12) // 4 * 4
                           + np.arange(12) % 4,
                           [0, 1, 2, 3, edge, edge + 1, edge + 2, edge + 3]])
    ol = np.stack([offs, np.ones(offs.size)]).astype(np.int32)
    want = np.asarray(ref.gather_lanes_raw(jnp.asarray(words),
                                           jnp.asarray(ol), bucket)) \
        .byteswap().view(np.uint8).reshape(offs.size, W * 4)
    w_t, ol_t = torch.from_numpy(words.view(np.int32)), torch.from_numpy(ol)
    got = gather_cuda.gather_lanes_raw_plain(w_t, ol_t, bucket, "bytes")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(gather_cuda.gather_lanes_raw(w_t, ol_t, bucket,
                                                    order="bytes"), got)
    with pytest.raises(ValueError, match="order"):
        gather_cuda.gather_lanes_raw(w_t, ol_t, bucket, order="le")


def _workload(seed: int, ncid: int = 6, nchunks: int = 400):
    rng = np.random.default_rng(seed)
    pay = {c: rng.integers(0, 256, int(rng.integers(50_000, 200_000)),
                           dtype=np.uint8).tobytes() for c in range(ncid)}
    wanted, spans, pos = [], [], 0
    for _ in range(nchunks):
        c = int(rng.integers(0, ncid))
        ln = int(rng.integers(1, 8000))
        off = int(rng.integers(0, len(pay[c]) - ln))
        lo = int(rng.integers(0, ln))
        wanted.append((c, off, ln))
        spans.append((pos, lo, ln - lo))
        pos += ln - lo
    return pay, wanted, spans, pos


def _run(rec, pay, wanted, spans, pos) -> tuple:
    outs = []
    for sl in (slice(None), slice(0, 50), slice(200, 400)):
        w, s = wanted[sl], spans[sl]
        base = s[0][0]
        out = bytearray(s[-1][0] + s[-1][2] - base)
        rec.gather(w, lambda c: pay[c],
                   [(a - base, lo, n) for a, lo, n in s], out)
        outs.append(bytes(out))
    return outs, rec._used, list(rec._images), dict(rec._sizes)


@pytest.mark.parametrize("budget", [600_000, 64 << 20])
def test_reconstructor_equals_reference(budget):
    """Same bytes, same counts, same resident set and budget use over a
    sequence that evicts (600 KB: FIFO, hits do not reorder) and one
    that does not."""
    pay, wanted, spans, pos = _workload(budget % 97)
    r0, p0 = _counts(ref_metrics), _counts(metrics)
    want = _run(ref.DeviceReconstructor(budget=budget, headroom=70_000),
                pay, wanted, spans, pos)
    got = _run(DeviceReconstructor(budget=budget, headroom=70_000,
                                   device="cpu"), pay, wanted, spans, pos)
    assert got == want
    assert want[0][0] == b"".join(pay[c][o + lo:o + lo + n] for (c, o, _),
                                  (_, lo, n) in zip(wanted, spans))
    r1, p1 = _counts(ref_metrics), _counts(metrics)
    assert {k: p1[k] - p0[k] for k in COUNTS} \
        == {k: r1[k] - r0[k] for k in COUNTS}
    assert p1["images_staged"] - p0["images_staged"] >= 6


def test_resident_image_equals_reference_words():
    """The staged image is the reference's word for word: the payload,
    zero-padded by the headroom, rounded up to 512 bytes, big-endian."""
    data = np.random.default_rng(5).integers(0, 256, 12_345,
                                             dtype=np.uint8).tobytes()
    r = ref.DeviceReconstructor(headroom=5000)
    p = DeviceReconstructor(headroom=5000, device="cpu")
    want = np.asarray(r._image(1, lambda: data))
    got = p._image(1, lambda: data).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert p._used == r._used == (12_345 + 5000 + 511) // 512 * 512


def test_staging_race_accounts_once():
    """A second stager of the same container (its loader runs while the
    first one's does) keeps the first image and accounts it once."""
    data = bytes(range(256)) * 40

    def race(rec):
        def outer():
            rec._image(3, lambda: data)   # the racing stager wins first
            return data
        rec._image(3, outer)
        return rec._used, list(rec._images)
    r0, p0 = _counts(ref_metrics), _counts(metrics)
    want = race(ref.DeviceReconstructor(headroom=1024))
    got = race(DeviceReconstructor(headroom=1024, device="cpu"))
    assert got == want
    assert want[0] == (len(data) + 1024 + 511) // 512 * 512
    r1, p1 = _counts(ref_metrics), _counts(metrics)
    assert p1["image_hits"] - p0["image_hits"] \
        == r1["image_hits"] - r0["image_hits"] == 1


def test_headroom_contract_is_asserted():
    pay = {0: bytes(100_000)}
    for rec in (ref.DeviceReconstructor(headroom=8192),
                DeviceReconstructor(headroom=8192, device="cpu")):
        with pytest.raises(AssertionError):
            rec.gather([(0, 0, 9000)], lambda c: pay[c], [(0, 0, 9000)],
                       bytearray(9000))


def test_invalidate_on_container_delete(tmp_path):
    """ContainerStore.delete_container fires ``_on_delete``: the stale
    image drops and its budget is returned."""
    cs = ContainerStore(str(tmp_path / "c"), container_size=1 << 16,
                        lanes=1)
    rng = np.random.default_rng(6)
    chunks = [rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
              for _ in range(8)]
    locs = cs.append_chunks(chunks)
    rec = DeviceReconstructor(headroom=70_000, device="cpu")
    cs._on_delete = rec.invalidate
    out = bytearray(sum(len(c) for c in chunks))
    spans, at = [], 0
    for c in chunks:
        spans.append((at, 0, len(c)))
        at += len(c)
    rec.gather(locs, cs.read_container, spans, out)
    assert bytes(out) == b"".join(chunks)
    staged = set(rec._images)
    assert len(staged) > 1
    for cid in staged:
        cs.delete_container(cid)
    assert not rec._images and rec._used == 0

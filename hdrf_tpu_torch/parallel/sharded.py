"""Multi-device sharded reduction over a ('data', 'seq') mesh of torch
devices (port of hdrf_tpu/parallel/sharded.py: ``make_mesh`` sharded.py:98,
``reduce_sharded`` :335, ``ShardedBucketTable`` :719, ``MeshReducer``
:817, ``lz4_compress_many_sharded`` :1025).

The reference expresses the multi-chip form of the write path with two
mesh axes under ``shard_map``:

- ``seq`` — sequence parallelism over one block's bytes: each shard runs
  the Gear candidate scan over its range (ops/cdc_cuda.shard_scan, the
  port of the Pallas ``_scan_kernel``) with the previous shard's last
  ``WINDOW - 1`` bytes as its halo.  ``G[0] == 0``, so the first shard's
  zero halo reproduces the whole-block scan bit for bit.
- ``data`` — data parallelism over independent blocks and SHA-256 lanes.

JAX runs that mesh single-controller: one process drives every device,
and a collective is a copy between devices.  So does the port.  A
:class:`Mesh` is a grid of ``torch.device`` values, a sharded array is a
dict from mesh coordinate ``(d, s)`` to that shard's tensor on its device,
and one process runs each shard's step in turn:

- ``ppermute`` is a ``.to(device, non_blocking=True)`` of the sender's
  tensor (zeros where no shard sends);
- ``all_gather`` a concatenation on each consumer's device;
- ``psum`` a sum on the first device.

Shards on one device still get their own tensors, so a mesh may repeat a
device (``cuda:0`` four times on one card, ``cpu`` eight times in the CPU
tests: the counterpart of the reference tests' virtual devices), and no
path special-cases it.  On a machine with several cards the same code
spans ``cuda:0..N-1``.

Across processes (parallel/launch.py) a mesh records each shard's rank.
A process holds tensors only for its own shards; where a step needs
another rank's part, every rank writes its own parts into a zero buffer
and a ``torch.distributed`` all-reduce sums them (``nccl`` on the card,
``gloo`` on the CPU), so every rank ends with all of them.

Arrays are cut by a spec, one entry per dimension, as the reference's
``PartitionSpec``: ``None`` (whole), an axis name, or ``("data",
"seq")`` (the flattened mesh).  ``_put_global`` and ``_fetch_global``
cross the host boundary and keep the ledger's transfer and readback
accounting.

Every stage runs the port's kernels on a CUDA shard and their plain
versions on a CPU shard; a CUDA mesh without a card raises.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from hdrf_tpu_torch import native
from hdrf_tpu_torch.config import CdcConfig
from hdrf_tpu_torch.ops import cdc_cuda, gear
from hdrf_tpu_torch.ops.dispatch import gear_mask, resolve_device
from hdrf_tpu_torch.ops.resident import digest_lanes, record_event, to_host
from hdrf_tpu_torch.ops.sha256_cuda import sha256_words_cuda
from hdrf_tpu_torch.utils import device_ledger as _ledger
from hdrf_tpu_torch.utils import fault_injection
from hdrf_tpu_torch.utils import metrics as _metrics

WINDOW = gear.WINDOW
_HALO = gear.HALO
AXES = ("data", "seq")

_MP = _metrics.registry("mesh_plane")


def _process_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


class Mesh:
    """A 2-D ('data', 'seq') grid of torch devices.

    ``devices``: rows of ``torch.device`` (or names), one row per ``data``
    index, one column per ``seq`` index; ``shape[axis]`` gives the sizes.
    ``ranks`` (the same grid) names each shard's process; by default every
    shard belongs to this process."""

    def __init__(self, devices, ranks=None):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        nd = len(self.devices)
        ns = len(self.devices[0]) if nd else 0
        if not ns or any(len(r) != ns for r in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid")
        self.rank = _process_rank()
        self.ranks = ([[self.rank] * ns for _ in range(nd)] if ranks is None
                      else [list(r) for r in ranks])
        self.shape = {"data": nd, "seq": ns}

    def keys(self) -> list[tuple[int, int]]:
        """Every mesh coordinate ``(d, s)``, row-major."""
        return [(d, s) for d in range(self.shape["data"])
                for s in range(self.shape["seq"])]

    def local_keys(self) -> list[tuple[int, int]]:
        """The coordinates whose shard this process holds."""
        return [k for k in self.keys() if self.ranks[k[0]][k[1]] == self.rank]

    def device(self, key) -> torch.device:
        return self.devices[key[0]][key[1]]

    @property
    def multiprocess(self) -> bool:
        return any(r != self.rank for row in self.ranks for r in row)


def make_mesh(n_data: int = 1, n_seq: int | None = None,
              devices=None) -> Mesh:
    """A ('data', 'seq') mesh over ``devices`` (default: every CUDA device;
    raises without one).  ``devices`` may repeat a device — each shard
    keeps its own tensors, so ``["cpu"] * 8`` or ``["cuda:0"] * 4`` is an
    8- or 4-shard mesh, the counterpart of the reference tests' virtual
    CPU devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh; pass "
                               "devices=['cpu'] * n to run the plain "
                               "versions")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n_seq is None:
        n_seq = len(devices) // n_data
    if n_data * n_seq != len(devices) or not n_data * n_seq:
        raise ValueError(f"mesh {n_data}x{n_seq} != {len(devices)} devices")
    return Mesh([devices[d * n_seq:(d + 1) * n_seq] for d in range(n_data)])


# --------------------------------------------------------------------------
# Sharded arrays and the collectives between their shards
# --------------------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _part(mesh: Mesh, key, spec: tuple, shape: tuple) -> tuple:
    """The index of shard ``key``'s part of an array of ``shape``."""
    idx = []
    for dim, entry in enumerate(spec):
        n, i = 1, 0
        for ax in _axes(entry):
            n *= mesh.shape[ax]
            i = i * mesh.shape[ax] + key[AXES.index(ax)]
        step = shape[dim] // n
        idx.append(slice(i * step, (i + 1) * step))
    return tuple(idx)


def _canonical(mesh: Mesh, key, spec: tuple) -> bool:
    """True for the one replica of each part: index 0 on every axis the
    spec does not cut."""
    used = {ax for e in spec for ax in _axes(e)}
    return all(key[i] == 0 for i, ax in enumerate(AXES) if ax not in used)


def _comm_device() -> torch.device:
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over every process (on the communication device)."""
    import torch.distributed as dist

    x = t.to(_comm_device())
    dist.all_reduce(x)
    return x


def _put_global(arr: np.ndarray, mesh: Mesh, spec: tuple) -> dict:
    """Host array -> this process's shards of it (every local coordinate
    gets its part on its device; replicated axes get copies).  The single
    H2D chokepoint of the sharded pipeline: the ledger counts the bytes
    sent here, so callers never double-count."""
    parts, nbytes = {}, 0
    for key in mesh.local_keys():
        part = np.ascontiguousarray(arr[_part(mesh, key, spec, arr.shape)])
        if not part.flags.writeable:  # torch refuses read-only buffers
            part = part.copy()
        parts[key] = torch.from_numpy(part).to(mesh.device(key),
                                               non_blocking=True)
        nbytes += part.nbytes
    _ledger.transfer("h2d", "sharded.put", nbytes)
    return parts


def _fetch_global(parts: dict, mesh: Mesh, spec: tuple, shape: tuple,
                  dtype: torch.dtype) -> np.ndarray:
    """Sharded array -> the full numpy array on every process.  Each part
    comes from its canonical shard; across processes every rank writes its
    own parts into zeros and an all-reduce completes the array (the
    reference's ``process_allgather``)."""
    out = torch.zeros(shape, dtype=dtype)
    for key, t in parts.items():
        if _canonical(mesh, key, spec):
            out[_part(mesh, key, spec, shape)] = t.to("cpu")
    if mesh.multiprocess:
        out = _all_reduce(out).cpu()
    return out.numpy()


def _exchange(mesh: Mesh, parts: dict, shape: tuple,
              dtype: torch.dtype) -> dict:
    """Every coordinate's tensor of ``parts`` (one per coordinate, all of
    ``shape``; a coordinate without one counts as zeros).  In one process
    that is ``parts`` itself; across processes an all-reduce of a zero
    stack into which each rank wrote its own."""
    if not mesh.multiprocess:
        return parts
    keys = mesh.keys()
    stack = torch.zeros((len(keys), *shape), dtype=dtype,
                        device=_comm_device())
    for i, k in enumerate(keys):
        if k in parts:
            stack[i] = parts[k]
    stack = _all_reduce(stack)
    return {k: stack[i] for i, k in enumerate(keys)}


def _ppermute(mesh: Mesh, parts: dict, src, dst_keys, shape: tuple,
              dtype: torch.dtype) -> dict:
    """For each coordinate ``k`` of ``dst_keys``: the tensor of coordinate
    ``src(k)`` on k's device (``.to``, a copy between devices), zeros
    where ``src(k)`` is None."""
    full = _exchange(mesh, parts, shape, dtype)
    out = {}
    for k in dst_keys:
        s = src(k)
        dev = mesh.device(k)
        out[k] = (torch.zeros(shape, dtype=dtype, device=dev) if s is None
                  else full[s].to(dev, non_blocking=True))
    return out


def _psum(mesh: Mesh, parts: dict, shape: tuple,
          dtype: torch.dtype) -> torch.Tensor:
    """The sum of every coordinate's part, on this process's first
    device."""
    full = _exchange(mesh, parts, shape, dtype)
    dev = mesh.device(mesh.local_keys()[0])
    total = torch.zeros(shape, dtype=dtype, device=dev)
    for t in full.values():
        total += t.to(dev)
    return total


def _be_rows(msgs: torch.Tensor) -> torch.Tensor:
    """u8[L, B*64] messages -> their big-endian words, int32[L, B*16]."""
    L = msgs.shape[0]
    return msgs.reshape(L, -1, 4).flip(-1).contiguous().view(
        torch.int32).reshape(L, -1)


# --------------------------------------------------------------------------
# The sharded scan, SHA lanes and the fixed-segment reduction step
# --------------------------------------------------------------------------

def candidate_words_sharded(mesh: Mesh):
    """The all-position Gear candidate scan with a block's bytes sharded
    over 'seq'.

    Returns ``fn(block, mask) -> (words, count)``: ``block`` a sharded u8
    array (spec ``("seq",)``, each shard a multiple of 256 bytes),
    ``words`` the packed bitmap words of each shard (spec ``("seq",)``,
    computed on the shards of data row 0), bit-identical to the
    whole-block scan; ``count`` the candidate total (the psum over
    'seq'), int32[1] on the first device."""
    def scan(block: dict, mask: int):
        keys = [k for k in mesh.local_keys() if k[0] == 0]
        m = next(iter(block.values())).numel()
        halos = _ppermute(
            mesh, {k: block[k][-_HALO:] for k in keys},
            lambda k: (0, k[1] - 1) if k[1] else None, keys, (_HALO,),
            torch.uint8)
        words, counts = {}, {}
        for k in keys:
            words[k], counts[k] = cdc_cuda.shard_scan(block[k], halos[k],
                                                      k[1] * m, mask)
        return words, _psum(mesh, counts, (1,), torch.int32)
    return scan


def gear_candidates_sharded(data, mask: int, mesh: Mesh) -> np.ndarray:
    """Host-facing sharded candidate scan; the contract of
    ``native.gear_candidates`` (every pos1 in [32, n] with ``(h & mask)
    == 0``), bytes spread over ``mesh['seq']``."""
    a = np.frombuffer(data, dtype=np.uint8) \
        if not isinstance(data, np.ndarray) else data
    n = a.size
    chunk = 256 * mesh.shape["seq"]
    buf = np.zeros(n + (-n) % chunk, dtype=np.uint8)
    buf[:n] = a
    words, _ = candidate_words_sharded(mesh)(
        _put_global(buf, mesh, ("seq",)), mask)
    wv = _fetch_global(words, mesh, ("seq",), (buf.size // 32,),
                       torch.int32).view(np.uint32)
    (idx,) = np.nonzero(wv)
    return gear.words_to_positions(idx.astype(np.uint32), wv[idx], n)


def sha256_lanes_sharded(mesh: Mesh):
    """SHA-256 lane hashing with lanes sharded over 'data' (pure data
    parallelism): ``fn(blocks, nblocks) -> digests`` for sharded arrays of
    pre-padded messages u8[L, B*64] (spec ``("data", None)``), block
    counts int32[L] (spec ``("data",)``) and digests u8[L, 32] (spec
    ``("data", None)``, computed on seq column 0)."""
    def hash_local(blocks: dict, nblocks: dict) -> dict:
        return {k: sha256_words_cuda(_be_rows(blocks[k]),
                                     nblocks[k].to(torch.int32))
                for k in mesh.local_keys() if k[1] == 0}
    return hash_local


def _segment_sha_pad(seg: int) -> np.ndarray:
    """The constant SHA-256 terminal block for a fixed ``seg``-byte message
    (seg % 64 == 0): 0x80 marker + big-endian bit length."""
    pad = np.zeros(64, dtype=np.uint8)
    pad[0] = 0x80
    pad[56:64] = np.frombuffer(np.uint64(seg * 8).byteswap().tobytes(),
                               dtype=np.uint8)
    return pad


def reduction_step(mesh: Mesh, seg: int = 512):
    """The fixed-segment reduction forward, sharded over ('data', 'seq').

    ``fn(blocks, mask)`` for a sharded u8[B, N] array (spec ``("data",
    "seq")``): B blocks data-parallel, each block's N bytes
    sequence-parallel.  Per block it runs (1) the candidate scan with the
    halo ``ppermute``, (2) SHA-256 of the block's fixed ``seg``-byte
    segments, (3) the candidate total by ``psum`` over both axes.  Returns
    ``{"words": ..., "digests": ..., "candidates": int32[1]}``, words
    u32[B, N/32] and digests u8[B, N/seg, 32] sharded ``("data", "seq")``
    and left on the devices."""
    pad_const = torch.from_numpy(_segment_sha_pad(seg))

    def step(blocks: dict, mask: int):
        keys = mesh.local_keys()
        b_local, m = next(iter(blocks.values())).shape
        halos = _ppermute(
            mesh, {k: blocks[k][:, -_HALO:] for k in keys},
            lambda k: (k[0], k[1] - 1) if k[1] else None, keys,
            (b_local, _HALO), torch.uint8)
        words, digests, counts = {}, {}, {}
        for k in keys:
            blk, dev = blocks[k], mesh.device(k)
            scans = [cdc_cuda.shard_scan(blk[i], halos[k][i], k[1] * m, mask)
                     for i in range(b_local)]
            words[k] = torch.stack([w for w, _ in scans])
            counts[k] = sum(c for _, c in scans)
            lanes = blk.reshape(-1, seg)
            msgs = torch.cat([lanes, pad_const.to(dev).expand(
                lanes.shape[0], 64)], dim=1)
            nb = torch.full((lanes.shape[0],), seg // 64 + 1,
                            dtype=torch.int32, device=dev)
            digests[k] = sha256_words_cuda(_be_rows(msgs), nb).reshape(
                b_local, m // seg, 32)
        return {"words": words, "digests": digests,
                "candidates": _psum(mesh, counts, (1,), torch.int32)}
    return step


# --------------------------------------------------------------------------
# The variable-chunk pipeline, sharded: seq-parallel candidate scan -> host
# cut select -> chunk-parallel SHA over the CDC chunks on every shard
# --------------------------------------------------------------------------

def _bucket_of(nb: int) -> int:
    """Padded SHA blocks per lane: the next power of two of ``nb`` (the
    reference's one bucket sized for max_chunk)."""
    return 1 << int(nb - 1).bit_length()


def _sha_chunks_sharded(mesh: Mesh, bucket: int):
    """Variable-chunk SHA with lanes sharded over the flattened mesh.  The
    block arrives seq-sharded (the resident shards the scan used); each
    shard all-gathers its data row's full byte image, word-images it, and
    gathers + hashes its own lane subset (``ol`` spec ``(None, ("data",
    "seq"))``; digests spec ``(("data", "seq"), None)``)."""
    n_seq = mesh.shape["seq"]

    def run(block_sh: dict, ol: dict) -> dict:
        keys = mesh.local_keys()
        m = next(iter(block_sh.values())).numel()
        full = _exchange(mesh, block_sh, (m,), torch.uint8)
        out = {}
        for k in keys:
            dev = mesh.device(k)
            img = torch.cat([full[(k[0], s)].to(dev, non_blocking=True)
                             for s in range(n_seq)])
            out[k] = digest_lanes(cdc_cuda.be_image(img), ol[k], bucket)
        return out
    return run


def _sha_chunks_halo(mesh: Mesh, bucket: int, halo_shards: int):
    """Data-local sharded SHA: each chunk is hashed on the shard where it
    starts (round-robin over 'data'), whose image is its own shard plus
    ``halo_shards`` following shards fetched by a ``ppermute`` ring walk —
    ``halo_shards`` shard copies per device instead of the all-gather's
    ``n_seq - 1``.  Over-read bytes past a chunk (the next chunks, or
    ring-wrapped bytes on the last shard) are cut by the gather's SHA
    padding, so the digests stay bit-identical.  ``ol`` has spec
    ``("data", "seq")`` (int32[1, 1, 2, lmax] per shard); digests spec
    ``(("data", "seq"), None)``; the host unpermutes them by its own owner
    assignment."""
    n_seq = mesh.shape["seq"]

    def run(block_sh: dict, ol: dict) -> dict:
        keys = mesh.local_keys()
        cur = {k: cdc_cuda.be_image(block_sh[k]) for k in keys}
        parts = [cur]
        nw = next(iter(cur.values())).numel()
        for _ in range(halo_shards):   # fetch the NEXT shard's words
            cur = _ppermute(mesh, cur, lambda k: (k[0], (k[1] + 1) % n_seq),
                            keys, (nw,), torch.int32)
            parts.append(cur)
        return {k: digest_lanes(torch.cat([p[k] for p in parts]),
                                 ol[k][0, 0], bucket) for k in keys}
    return run


def reduce_sharded(data, cdc: CdcConfig, mesh: Mesh):
    """(cuts, digests) for ONE block with every stage on the mesh — the
    multi-device form of ops.dispatch.chunk_and_fingerprint, bit-identical
    to ``native.cdc_select`` over ``native.gear_candidates`` and
    ``native.sha256_batch``:

    1. the all-position candidate scan, bytes sharded over 'seq' with the
       halo ``ppermute``;
    2. the host cut select over the sparse candidates (``native.cdc_select``,
       the reference's host step), after the skip-ahead filter;
    3. SHA-256 of the variable chunks, lanes spread over every shard, from
       the same seq-sharded bytes step 1 used: the block crosses to the
       devices once.  Data-local (``_sha_chunks_halo``) when a chunk's
       gather window spans fewer than ``n_seq - 1`` following shards, else
       the all-gather (``_sha_chunks_sharded``).
    """
    a = (np.frombuffer(data, dtype=np.uint8)
         if not isinstance(data, np.ndarray) else data)
    n = a.size
    if n == 0:  # same contract as ResidentReducer's n == 0 case
        return np.empty(0, dtype=np.uint64), np.empty((0, 32), np.uint8)
    if n >= (1 << 31):
        raise ValueError("i32 lane offsets: shard blocks beyond 2 GiB")
    mask = gear_mask(cdc)
    n_data, n_seq = mesh.shape["data"], mesh.shape["seq"]
    # one padded image serves both stages: shard-size granularity for the
    # scan (each seq shard % 256) and the word-image grid (% 512)
    grid = 512 * n_seq
    buf = np.zeros(n + (-n) % grid, dtype=np.uint8)
    buf[:n] = a
    block_sh = _put_global(buf, mesh, ("seq",))
    ev = _ledger.dispatch("sharded.scan")
    words, _ = candidate_words_sharded(mesh)(block_sh, mask)
    wv = _fetch_global(words, mesh, ("seq",), (buf.size // 32,),
                       torch.int32).view(np.uint32)
    _ledger.readback(ev, d2h_bytes=wv.nbytes)
    (idx,) = np.nonzero(wv)
    vals = wv[idx]
    # Skip-ahead dead-zone filter (gear.skip_ahead_threshold): candidates
    # below max(WINDOW, min_chunk) can never be selected — every window
    # opens at prev + min — so dropping them before the unpack + select is
    # cut-identical and shrinks the host walk.  Applied to the sparse
    # (idx, vals) pairs; the packed-bitmap readback stays as it is.
    thr = gear.skip_ahead_threshold(cdc.min_chunk)
    if thr > gear.MIN_CANDIDATE_POS1 and idx.size:
        w_t, rem = divmod(thr - 1, 32)
        keep = idx >= w_t
        if rem:
            at = np.nonzero(idx == w_t)[0]
            if at.size:
                vals[at] &= np.uint32((0xFFFFFFFF << rem) & 0xFFFFFFFF)
                keep[at] = vals[at] != 0
        idx, vals = idx[keep], vals[keep]
    pos = gear.words_to_positions(idx.astype(np.uint32), vals, n)
    cuts = native.cdc_select(pos, n, cdc.min_chunk, cdc.max_chunk)
    starts = np.concatenate([[0], cuts[:-1]]).astype(np.int64)
    lens = (cuts - starts).astype(np.int64)
    nchunks = len(cuts)
    ndev = n_data * n_seq
    bucket = _bucket_of((cdc.max_chunk + 9 + 63) // 64)
    shard_bytes = buf.size // n_seq
    # shards covering one full gather window past a shard boundary
    halo = -(-(bucket * 64 + 64) // shard_bytes)
    if halo < n_seq - 1:
        # Data-local SHA: each chunk hashed at its owning seq position,
        # round-robin over 'data' (rank chunks within their seq shard,
        # lane index = rank // n_data), vectorized.
        owner_seq = np.minimum(starts // shard_bytes,
                               n_seq - 1).astype(np.int64)
        counts = np.bincount(owner_seq, minlength=n_seq)
        order = np.argsort(owner_seq, kind="stable")
        group_base = np.cumsum(counts) - counts
        rank = np.empty(nchunks, dtype=np.int64)
        rank[order] = np.arange(nchunks) - np.repeat(group_base, counts)
        d_arr = rank % n_data
        j_arr = rank // n_data
        # per-shard lane count in power-of-two 128-lane steps (the
        # reference's stable jit key; zero-length lanes hash the empty
        # message and are never read)
        max_cell = max(int(j_arr.max()) + 1 if nchunks else 1, 1)
        lmax = 128 << max(0, (max_cell - 1).bit_length() - 7) \
            if max_cell > 128 else 128
        ol_all = np.zeros((n_data, n_seq, 2, lmax), dtype=np.int32)
        ol_all[d_arr, owner_seq, 0, j_arr] = starts - owner_seq * shard_bytes
        ol_all[d_arr, owner_seq, 1, j_arr] = lens
        fn = _sha_chunks_halo(mesh, bucket, halo)
        ol_dev = _put_global(ol_all, mesh, ("data", "seq"))
        ev = _ledger.dispatch("sharded.sha", batch=nchunks)
        out = _fetch_global(fn(block_sh, ol_dev), mesh, (("data", "seq"),),
                            (ndev * lmax, 32), torch.uint8)
        _ledger.readback(ev, d2h_bytes=out.nbytes)
        return cuts, out[(d_arr * n_seq + owner_seq) * lmax + j_arr]
    # tiny blocks / shards smaller than the gather window: the halo walk
    # would rebuild the full image anyway — the all-gather is the tool
    lane_grid = 128 * ndev
    L = max(-(-nchunks // lane_grid) * lane_grid, lane_grid)
    ol = np.zeros((2, L), dtype=np.int32)
    ol[0, :nchunks] = starts
    ol[1, :nchunks] = lens
    fn = _sha_chunks_sharded(mesh, bucket)
    ol_dev = _put_global(ol, mesh, (None, ("data", "seq")))
    ev = _ledger.dispatch("sharded.sha", batch=nchunks)
    digests = _fetch_global(fn(block_sh, ol_dev), mesh, (("data", "seq"),),
                            (L, 32), torch.uint8)
    _ledger.readback(ev, d2h_bytes=digests.nbytes)
    return cuts, digests[:nchunks]


# --------------------------------------------------------------------------
# Mesh-sharded reduction plane: a coalesced write-pipeline group becomes one
# mesh step.  Blocks are data-parallel over 'data'; each shard runs CDC,
# SHA-256 of both lane buckets and its partition of the dedup bucket probe;
# an all_gather of the probe keys + a psum of the votes replicate every
# verdict.  The serial ResidentReducer is the bit-identity oracle.
# --------------------------------------------------------------------------

_PROBE_MULT = 2654435761  # Knuth multiplicative hash, u32 wraparound
_M32 = 0xFFFFFFFF


def _fp_hi_lo(fp_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """First 8 digest bytes as two big-endian u32 keys — the numpy mirror
    of the on-mesh probe's key math (must stay bit-identical to the step
    and the ShardedBucketTable refresh)."""
    u = fp_u8.astype(np.uint32)
    hi = (u[:, 0] << 24) | (u[:, 1] << 16) | (u[:, 2] << 8) | u[:, 3]
    lo = (u[:, 4] << 24) | (u[:, 5] << 16) | (u[:, 6] << 8) | u[:, 7]
    return hi, lo


def _probe_slot(hi: torch.Tensor, lo: torch.Tensor, slots: int):
    """``((lo * _PROBE_MULT mod 2^32) ^ hi) % slots`` over int64 u32
    values, the product taken in 16-bit halves so nothing overflows."""
    prod = ((lo & 0xFFFF) * _PROBE_MULT
            + ((((lo >> 16) * _PROBE_MULT) & 0xFFFF) << 16)) & _M32
    return (prod ^ hi) % slots


class ShardedBucketTable:
    """Device-resident dedup fingerprint buckets, fingerprint space
    partitioned over the 'data' axis (owner = hi % ndata, slot = Knuth
    multiplicative hash of the 64-bit digest prefix).

    A probe accelerator, not an authority: the ChunkIndex commit listener
    feeds new fingerprints through :meth:`note_new`, and a pending batch
    flushes to the devices right before each mesh step.  A stale or
    collided entry can only give a false positive (resolved by the host's
    authoritative index re-check) or a false negative (the chunk is
    appended again) — never corruption.  A failed refresh (fault point
    ``sharded.bucket_refresh``) re-queues the pending rows and the step
    probes the stale table."""

    def __init__(self, mesh: Mesh, slots: int = 1 << 15):
        self.mesh = mesh
        self.ndata = mesh.shape["data"]
        self.slots = int(slots)
        self._np = np.full((self.ndata, self.slots, 2), 0xFFFFFFFF,
                           np.uint32)
        self._dev: dict | None = None    # (d, 0) -> int64[1, slots, 2]
        self._pending: list[bytes] = []
        self._lock = threading.Lock()

    def note_new(self, fingerprints) -> None:
        """Buffer newly committed chunk fingerprints (>= 8 bytes each) for
        the next refresh.  Called from the ChunkIndex commit listener."""
        with self._lock:
            self._pending.extend(bytes(f) for f in fingerprints)

    def _keys(self, fp_rows: np.ndarray):
        hi, lo = _fp_hi_lo(fp_rows)
        owner = hi % np.uint32(self.ndata)
        slot = ((lo * np.uint32(_PROBE_MULT)) ^ hi) % np.uint32(self.slots)
        return owner, slot, hi, lo

    def host_probe(self, digests: np.ndarray) -> np.ndarray:
        """Numpy mirror of the on-mesh probe (tests pin the two agree)."""
        owner, slot, hi, lo = self._keys(digests)
        ent = self._np[owner, slot]
        return (ent[:, 0] == hi) & (ent[:, 1] == lo)

    def flush(self) -> None:
        with self._lock:
            pend, self._pending = self._pending, []
        if not pend:
            return
        try:
            fault_injection.point("sharded.bucket_refresh", rows=len(pend))
        except Exception:
            with self._lock:
                self._pending = pend + self._pending
            _MP.incr("bucket_refresh_failures")
            return
        fps = np.frombuffer(b"".join(p[:8] for p in pend),
                            np.uint8).reshape(-1, 8)
        owner, slot, hi, lo = self._keys(fps)
        self._np[owner, slot, 0] = hi
        self._np[owner, slot, 1] = lo
        _MP.incr("bucket_refresh_rows", len(pend))
        if self._dev is None:
            return
        # the last write of each (owner, slot) wins, as in the numpy mirror;
        # deduplicated here because a device scatter with repeated indices
        # keeps an unspecified one
        flat = owner.astype(np.int64) * self.slots + slot
        _, first_rev = np.unique(flat[::-1], return_index=True)
        last = flat.size - 1 - first_rev
        rows = np.stack([owner[last], slot[last], hi[last],
                         lo[last]]).astype(np.int64)
        _ledger.dispatch("sharded.bucket_refresh", batch=len(pend),
                         h2d_bytes=rows.nbytes)
        for k, tbl in self._dev.items():
            sel = rows[:, rows[0] == k[0]]
            if sel.shape[1]:
                r = torch.from_numpy(sel).to(tbl.device)
                tbl[0, r[1], 0] = r[2]
                tbl[0, r[1], 1] = r[3]

    def device_table(self) -> dict:
        """The table's shards on the mesh, pending rows flushed first."""
        self.flush()
        if self._dev is None:
            self._dev = _put_global(self._np.astype(np.int64), self.mesh,
                                    ("data", None, None))
        return self._dev


def from_reference_bucket_table(mesh: Mesh, np_table: np.ndarray,
                                slots: int,
                                pending: list) -> ShardedBucketTable:
    """A port ``ShardedBucketTable`` in the state of a reference one whose
    ``_np`` (u32[ndata, slots, 2]), ``slots`` and ``_pending`` are given:
    the two then probe alike."""
    t = ShardedBucketTable(mesh, slots=slots)
    if np_table.shape != t._np.shape:
        raise ValueError(f"table {np_table.shape} != {t._np.shape} for a "
                         f"{t.ndata}-shard mesh")
    t._np[...] = np_table
    t._pending = [bytes(p) for p in pending]
    return t


@dataclasses.dataclass
class _Shard:
    """One data shard's part of a mesh step."""
    key: tuple
    cdc: list                # per local block: (words, table, ols, olb) | None
    hdrs: list               # per local block: host header copy | None
    ready: object = None     # CUDA event after the header copies
    digs: torch.Tensor | None = None    # u8[Kl*(Ls+Lb), 32] on the device
    keys: torch.Tensor | None = None    # int64[Kl*(Ls+Lb), 2] probe keys
    cuts: list | None = None            # per local block: int32 cut tensor


@dataclasses.dataclass
class MeshJob:
    """One in-flight mesh step (K blocks, one dispatch)."""
    k0: int                    # real blocks (the rest pad the mesh width)
    cap: int
    Ls: int
    Lb: int
    b_small: int
    true_ns: list[int]
    Kl: int = 0
    n_pad: int = 0
    shards: list | None = None
    table: dict | None = None  # the bucket table the step probes
    hits: torch.Tensor | None = None
    _ev: object = None


class MeshReducer:
    """Mesh-sharded group-reduction front end: the multi-device counterpart
    of ops.resident.ResidentReducer's batched pipeline (the same submit /
    start / finish shape).

    ``finish_many`` returns per block ``(cuts u64, digests u8[nc, 32],
    probe frozenset)`` — the third element is the set of chunk
    fingerprints whose on-mesh bucket probe voted HIT.

    Per data shard one step runs: ``cdc_cuda.cdc_block`` per block (the
    scan's skip-ahead floor is the reference's static word mask, the
    select its device cut walk with the hard cap), the two-bucket lane
    tables of the shard's blocks joined over one flat word image, the
    gather + SHA-256 kernels per bucket, then the probe: every shard's
    keys (digest bytes 0-7) all-gathered, each shard answering for its
    partition of fingerprint space (hi % ndata), and a psum of the votes.
    Digest rows keep the reference's layout: per shard ``Kl * Ls`` small
    rows then ``Kl * Lb`` big rows, block ``kl``'s lanes at ``kl * Ls``
    and ``Kl * Ls + kl * Lb``.  One process drives the whole mesh."""

    def __init__(self, cdc: CdcConfig | None = None, mesh: Mesh | None = None,
                 lanes_per_device: int = 2, bucket_slots: int = 1 << 15,
                 mask: int | None = None):
        self.cdc = cdc or CdcConfig()
        self.mesh = mesh if mesh is not None else \
            make_mesh(n_data=max(torch.cuda.device_count(), 1), n_seq=1)
        if self.mesh.shape["seq"] != 1:
            raise ValueError("the mesh plane shards blocks over 'data' only")
        if self.mesh.multiprocess:
            raise ValueError("the mesh plane runs in one process")
        self.ndata = self.mesh.shape["data"]
        self.mask = gear_mask(self.cdc) if mask is None else mask
        self.lanes_per_device = max(1, int(lanes_per_device))
        self.table = ShardedBucketTable(self.mesh, slots=bucket_slots)
        self._b_big = (self.cdc.max_chunk + 9 + 63) // 64
        self._b_small = max(1, min((2 << self.cdc.mask_bits) // 64,
                                   self._b_big))

    def max_group(self, n: int = 0) -> int:
        """Mesh width x per-device lane capacity — the coalescer's group
        target."""
        return self.ndata * self.lanes_per_device

    def submit_many(self, datas) -> MeshJob:
        """Upload a group, one block per lane, and enqueue every shard's CDC
        kernels."""
        arrs = [np.frombuffer(d, dtype=np.uint8)
                if not isinstance(d, np.ndarray) else d for d in datas]
        true_ns = [int(a.size) for a in arrs]
        k0 = len(arrs)
        if not k0 or not max(true_ns):
            raise ValueError("a mesh step needs at least one non-empty block")
        n_pad = max(true_ns) + (-max(true_ns)) % 512
        k = k0 + (-k0) % self.ndata   # dummy zero blocks (true_n 0) pad
        Kl = k // self.ndata
        if Kl * n_pad >= (1 << 31):
            raise ValueError("i32 lane offsets: a shard's blocks beyond 2 GiB")
        buf = np.zeros((k, n_pad), dtype=np.uint8)
        for i, a in enumerate(arrs):
            buf[i, :a.size] = a
        mn, mx = self.cdc.min_chunk, self.cdc.max_chunk
        # Provable capacities: cuts advance >= min_chunk (+1 final short
        # chunk), big chunks are > b_small*64-9 bytes by the binning rule.
        # Lb == 0 when the rule proves every chunk small.
        cap = n_pad // max(mn, 1) + 2
        Ls = cap
        Lb = (0 if self._b_small >= self._b_big
              else n_pad // max(self._b_small * 64 - 8, mn, 1) + 2)
        table = self.table.device_table()   # flushes pending commits
        blocks = _put_global(buf, self.mesh, ("data", None))
        tns = true_ns + [0] * (k - k0)
        shards = []
        for key in self.mesh.local_keys():
            dev, blk = self.mesh.device(key), blocks[key]
            cdc, hdrs = [], []
            for kl in range(Kl):
                n = tns[key[0] * Kl + kl]
                if not n:
                    cdc.append(None)
                    hdrs.append(None)
                    continue
                out = cdc_cuda.cdc_block(blk[kl], n, self.mask, mn, mx,
                                         self._b_small)
                cdc.append(out)
                hdrs.append(to_host(out[1][:cdc_cuda.TABLE_HDR]))
            shards.append(_Shard(key=key, cdc=cdc, hdrs=hdrs,
                                 ready=record_event(dev)))
        ev = _ledger.dispatch("sharded.step", batch=k0,  # H2D: the put
                              key=(Kl, n_pad, cap, self.ndata))
        _MP.incr("steps")
        _MP.observe("step_blocks", k0)
        _MP.incr("step_bytes", int(sum(true_ns)))
        return MeshJob(k0=k0, cap=cap, Ls=Ls, Lb=Lb, b_small=self._b_small,
                       true_ns=true_ns, Kl=Kl, n_pad=n_pad, shards=shards,
                       table=table, _ev=ev)

    def start_sha_many(self, job: MeshJob) -> None:
        """Wait for each shard's CDC headers, then enqueue its gather + SHA
        kernels (sized to the headers' lane counts), the probe and the
        result copies."""
        Kl, Ls, Lb = job.Kl, job.Ls, job.Lb
        for sh in job.shards:
            dev = self.mesh.device(sh.key)
            if sh.ready is not None:
                sh.ready.synchronize()
            words, lanes, rows, sh.cuts = [], ([], []), ([], []), []
            for kl, (out, hdr) in enumerate(zip(sh.cdc, sh.hdrs)):
                if out is None:
                    words.append(torch.zeros(job.n_pad // 4,
                                             dtype=torch.int32, device=dev))
                    sh.cuts.append(None)
                    continue
                w, tbl, ols, olb = out
                nc, _, ns, nbg = (int(v) for v in hdr[:4].tolist())
                words.append(w)
                sh.cuts.append(tbl[cdc_cuda.TABLE_HDR:cdc_cuda.TABLE_HDR + nc])
                base = kl * job.n_pad
                for b, (ol, cnt, row0) in enumerate(
                        ((ols, ns, kl * Ls), (olb, nbg, Kl * Ls + kl * Lb))):
                    if cnt:
                        lanes[b].append(torch.stack([ol[0, :cnt] + base,
                                                     ol[1, :cnt]]))
                        rows[b].append(torch.arange(row0, row0 + cnt,
                                                    device=dev))
            flat = torch.cat(words)
            sh.digs = torch.zeros((Kl * (Ls + Lb), 32), dtype=torch.uint8,
                                  device=dev)
            for b, bucket in ((0, job.b_small), (1, self._b_big)):
                if lanes[b]:
                    sh.digs[torch.cat(rows[b])] = digest_lanes(
                        flat, torch.cat(lanes[b], dim=1), bucket)
            d8 = sh.digs[:, :8].to(torch.int64)
            sh.keys = torch.stack(
                [(d8[:, 0] << 24) | (d8[:, 1] << 16) | (d8[:, 2] << 8)
                 | d8[:, 3],
                 (d8[:, 4] << 24) | (d8[:, 5] << 16) | (d8[:, 6] << 8)
                 | d8[:, 7]], dim=1)
            sh.cdc = sh.hdrs = None
        # On-mesh dedup probe: every shard sees every fingerprint (the
        # all_gather), answers only for its own partition of fingerprint
        # space (hi % ndata), and the psum replicates the verdicts.
        votes = {}
        for sh in job.shards:
            dev = self.mesh.device(sh.key)
            gath = torch.cat([o.keys.to(dev, non_blocking=True)
                              for o in job.shards])
            hi, lo = gath[:, 0], gath[:, 1]
            ent = job.table[sh.key][0, _probe_slot(hi, lo,
                                                   self.table.slots)]
            votes[sh.key] = ((hi % self.ndata == sh.key[0])
                             & (ent[:, 0] == hi) & (ent[:, 1] == lo)
                             ).to(torch.int32)
        n_rows = job.shards[0].keys.shape[0] * len(job.shards)
        job.hits = to_host(_psum(self.mesh, votes, (n_rows,),
                                       torch.int32))
        for sh in job.shards:
            sh.keys = None
            sh.digs = to_host(sh.digs)
            sh.cuts = [None if c is None else to_host(c)
                       for c in sh.cuts]
            sh.ready = record_event(self.mesh.device(sh.key))

    def finish_many(self, job: MeshJob) -> list[tuple]:
        """Wait for the results; ``(cuts, digests, probe)`` per block."""
        if job.hits is None:
            self.start_sha_many(job)
        for sh in job.shards:
            if sh.ready is not None:
                sh.ready.synchronize()
        Kl = job.Kl
        counts = np.zeros(Kl * self.ndata, dtype=np.int64)
        cuts = np.zeros((Kl * self.ndata, job.cap), dtype=np.int32)
        for sh in job.shards:
            for kl, c in enumerate(sh.cuts):
                if c is not None:
                    b = sh.key[0] * Kl + kl
                    counts[b] = c.numel()
                    cuts[b, :c.numel()] = c.numpy()
        digs = np.concatenate([sh.digs.numpy() for sh in job.shards])
        hits = job.hits.numpy()
        _ledger.readback(job._ev,
                         d2h_bytes=int(counts.sum()) * 4 + digs.nbytes
                         + hits.nbytes)
        job._ev = None
        job.shards = job.table = job.hits = None
        out = []
        hit_lanes = 0
        for b in range(job.k0):
            if job.true_ns[b] == 0:
                out.append((np.empty(0, np.uint64),
                            np.empty((0, 32), np.uint8), frozenset()))
                continue
            nc = int(counts[b])
            assert nc <= job.cap, "cut capacity proof violated"
            c = cuts[b, :nc].astype(np.int64)
            assert nc > 0 and c[-1] == job.true_ns[b], \
                "device cut select lost the final cut"
            starts = np.concatenate([[0], c[:-1]])
            lens = c - starts
            small = (lens + 9 + 63) // 64 <= job.b_small
            rank = np.where(small, np.cumsum(small) - 1,
                            np.cumsum(~small) - 1)
            d, kl = b // Kl, b % Kl
            base = d * Kl * (job.Ls + job.Lb)
            rows = np.where(small, base + kl * job.Ls + rank,
                            base + Kl * job.Ls + kl * job.Lb + rank)
            dg = digs[rows]
            hit = hits[rows] > 0
            hit_lanes += int(hit.sum())
            probe = frozenset(dg[i].tobytes()
                              for i in np.nonzero(hit)[0])
            out.append((c.astype(np.uint64), dg, probe))
        if hit_lanes:
            _MP.incr("probe_hit_lanes", hit_lanes)
        return out

    def reduce_many(self, datas: list) -> list[tuple]:
        """Every block of ``datas`` in groups of up to ``max_group``, one
        mesh step each, in order (the tests' and the smoke's entry)."""
        out = []
        g = self.max_group()
        for at in range(0, len(datas), g):
            out.extend(self.finish_many(self.submit_many(datas[at:at + g])))
        return out


# --------------------------------------------------------------------------
# Sharded LZ4 match scan: the compress leg of the mesh plane.  Per-block
# match scans are independent, so a group spreads over 'data': block i of a
# group padded to the mesh width scans on data shard i // Kl, through
# DeviceLz4's own group policy, so the streams equal compress_many's.
# --------------------------------------------------------------------------

def lz4_submit_many_sharded(lz, datas: list, mesh: Mesh):
    """Submit a container group's LZ4 match scans over the mesh's data
    shards.  Returns ``lz.submit_many``'s jobs for ``lz.finish_many``, or
    None where the reference declines the mesh (a 'seq' axis, fewer than
    two payloads, or one under ``lz.min_device``)."""
    if mesh.shape["seq"] != 1:
        return None
    arrs = [np.frombuffer(d, dtype=np.uint8)
            if not isinstance(d, np.ndarray) else d for d in datas]
    if len(arrs) < 2 or min(a.size for a in arrs) < lz.min_device:
        return None
    if mesh.multiprocess:
        raise ValueError("the sharded LZ4 scan runs in one process")
    k0, ndata = len(arrs), mesh.shape["data"]
    Kl = (k0 + (-k0) % ndata) // ndata
    _MP.incr("lz4_steps")
    return lz.submit_many(arrs, devices=[mesh.device((i // Kl, 0))
                                         for i in range(k0)])


def lz4_compress_many_sharded(lz, datas: list, mesh: Mesh) -> list[bytes]:
    jobs = lz4_submit_many_sharded(lz, datas, mesh)
    if jobs is None:
        return lz.compress_many(datas)
    return lz.finish_many(jobs)

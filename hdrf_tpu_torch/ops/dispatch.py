"""Backend dispatch for the reduction hot ops (port of
hdrf_tpu/ops/dispatch.py:31-281).

Three backends with identical outputs:

- ``cuda``: the card — ops/resident.ResidentReducer over the CDC, gather
  and SHA-256 kernels, ops/lz4_device.DeviceLz4 over the match-delta and
  row-sort kernels.  The reference's ``auto`` and ``tpu`` (its
  accelerator) resolve here; without a card they raise, nothing falls
  back to a host backend;
- ``native``: the host C++ library, as the reference's ``native``
  backend — ``native.gear_candidates`` + ``cdc_select`` +
  ``sha256_batch`` for the funnel, the host codec for the seal;
- ``cpu``: the card's pipelines with each kernel's plain PyTorch
  version, for tests on a machine without a card.

``chunk_and_fingerprint`` is the write path's one funnel,
``block_compress`` / ``block_compress_batch`` the container seal's.  With
two or more cards the funnel runs the sharded pipeline
(parallel/sharded.reduce_sharded) over a ('data'=1, 'seq'=n) mesh, and
with the mesh plane on (``set_mesh_plane`` or ``HDRF_MESH_PLANE=1``) an
LZ4 group spreads over a ('data'=n, 'seq'=1) mesh, as in the reference.
A CUDA backend without a card raises; nothing falls back to the CPU
behind the caller.  ``from_reference_cdc`` and ``from_reference_lz4``
carry state across from the reference package.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from hdrf_tpu_torch.config import CdcConfig
from hdrf_tpu_torch.utils import metrics as _metrics

_M = _metrics.registry("ops_dispatch")

BACKENDS = ("cuda", "native", "cpu")
# The reference's names for the accelerator (hdrf_tpu/config.py:70-72).
_CARD_ALIASES = ("auto", "tpu")


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def resolve_backend(backend: str) -> str:
    """``auto`` and ``tpu`` -> ``cuda``; otherwise the name, checked."""
    if backend in _CARD_ALIASES:
        return "cuda"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS + _CARD_ALIASES}")
    return backend


def gear_mask(cdc: CdcConfig) -> int:
    """Boundary mask with ``mask_bits`` effective bits -> avg chunk
    2^mask_bits.  Bits are spread across the 32-bit hash (FastCDC: spread
    masks judge more of the window than low-contiguous ones) — NOT
    ``(1 << mask_bits) - 1``."""
    bits, mask, step = cdc.mask_bits, 0, 32 // max(cdc.mask_bits, 1)
    pos = 31
    for _ in range(bits):
        mask |= 1 << pos
        pos -= step
        if pos < 0:
            pos = 30
    return mask & 0xFFFFFFFF


def from_reference_cdc(d: dict) -> CdcConfig:
    """The port's CdcConfig from the reference's
    ``dataclasses.asdict(hdrf_tpu.config.CdcConfig)`` dict (same fields)."""
    return CdcConfig(mask_bits=int(d["mask_bits"]),
                     min_chunk=int(d["min_chunk"]),
                     max_chunk=int(d["max_chunk"]),
                     normalized=bool(d.get("normalized", True)))


def _device_for(backend: str) -> torch.device:
    return resolve_device("cuda" if resolve_backend(backend) == "cuda"
                          else "cpu")


def _host_u8(data) -> np.ndarray:
    return (data if isinstance(data, np.ndarray)
            else np.frombuffer(data, dtype=np.uint8))


def chunk_cuts(data, cdc: CdcConfig, backend: str = "auto") -> np.ndarray:
    """Exclusive chunk end offsets covering [0, len(data)] (uint64)."""
    if resolve_backend(backend) == "native":
        from hdrf_tpu_torch import native

        a = _host_u8(data)
        return native.cdc_select(native.gear_candidates(a, gear_mask(cdc)),
                                 a.size, cdc.min_chunk, cdc.max_chunk)
    from hdrf_tpu_torch.ops import cdc_cuda

    cuts, _ = cdc_cuda.chunks_fused(data, gear_mask(cdc), cdc.min_chunk,
                                    cdc.max_chunk,
                                    device=_device_for(backend))
    return cuts


def fingerprints(data, cuts: np.ndarray, backend: str = "auto") -> np.ndarray:
    """(n_chunks, 32) SHA-256 digests of the chunks delimited by ``cuts``."""
    if resolve_backend(backend) == "native":
        from hdrf_tpu_torch import native

        starts = np.concatenate([[0], cuts[:-1]]).astype(np.uint64)
        lens = (np.asarray(cuts, np.uint64) - starts).astype(np.uint64)
        return native.sha256_batch(_host_u8(data), starts, lens)
    from hdrf_tpu_torch.ops.sha256 import fingerprint_chunks

    return fingerprint_chunks(data, cuts, device=_device_for(backend))


_resident_cache: dict = {}
_mesh_cache: list = []
_mesh_plane: list = []
_mesh_plane_mesh_cache: list = []
_mesh_reducer_cache: dict = {}


def set_mesh_plane(flag: bool) -> None:
    """Process-wide switch for the mesh-sharded reduction plane
    (parallel/sharded.MeshReducer); unset, ``HDRF_MESH_PLANE=1`` turns it
    on."""
    _mesh_plane[:] = [bool(flag)]


def mesh_plane_enabled() -> bool:
    if _mesh_plane:
        return _mesh_plane[0]
    import os

    return os.environ.get("HDRF_MESH_PLANE", "") == "1"


def _cards() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _mesh_plane_mesh():
    """('data'=n, 'seq'=1) mesh over every card — the block-data-parallel
    layout of the mesh plane — or None below two cards, where the serial
    ResidentReducer is strictly better."""
    if not _mesh_plane_mesh_cache:
        from hdrf_tpu_torch.parallel.sharded import make_mesh

        devs = _cards()
        _mesh_plane_mesh_cache.append(
            make_mesh(n_data=len(devs), n_seq=1, devices=devs)
            if len(devs) > 1 else None)
    return _mesh_plane_mesh_cache[0]


def mesh_reducer(cdc: CdcConfig, lanes_per_device: int = 2,
                 bucket_slots: int = 1 << 15):
    """The shared parallel/sharded.MeshReducer for this CDC geometry, or
    None below two cards.  Shared, so the device bucket table sees every
    ChunkIndex commit exactly once."""
    mesh = _mesh_plane_mesh()
    if mesh is None:
        return None
    key = (cdc.mask_bits, cdc.min_chunk, cdc.max_chunk,
           int(lanes_per_device), int(bucket_slots))
    r = _mesh_reducer_cache.get(key)
    if r is None:
        from hdrf_tpu_torch.parallel.sharded import MeshReducer

        r = _mesh_reducer_cache[key] = MeshReducer(
            cdc, mesh=mesh, lanes_per_device=lanes_per_device,
            bucket_slots=bucket_slots)
    return r


def _multichip_mesh():
    """The ('data'=1, 'seq'=n) mesh over every card, built once, or None
    below two: the serving path's multi-device form engages by itself when
    more than one card is present."""
    if not _mesh_cache:
        from hdrf_tpu_torch.parallel.sharded import make_mesh

        devs = _cards()
        _mesh_cache.append(make_mesh(n_data=1, n_seq=len(devs), devices=devs)
                           if len(devs) > 1 else None)
    return _mesh_cache[0]


def chunk_and_fingerprint(data, cdc: CdcConfig, backend: str = "auto"):
    """(cuts, digests) in one call — THE entry point for the write path.
    On a device the block crosses once: the sharded pipeline with two or
    more cards, else ops/resident.ResidentReducer (one per geometry and
    device, kept).  ``native`` is the host library's pair of calls."""
    from hdrf_tpu_torch.ops.resident import ResidentReducer
    from hdrf_tpu_torch.reduction import accounting
    from hdrf_tpu_torch.utils import profiler

    backend = resolve_backend(backend)
    nbytes = (len(data) if isinstance(data, (bytes, bytearray))
              else data.nbytes)
    _M.incr(f"reduce_{backend}_total")
    _M.incr(f"reduce_{backend}_bytes", nbytes)
    accounting.note_geometry(cdc)
    if backend == "native":
        # synchronous host work: a host phase (device paths are not
        # wrapped, their waits are the device's)
        with profiler.phase("reduce_compute"):
            cuts = chunk_cuts(data, cdc, backend)
            return cuts, fingerprints(data, cuts, backend)
    if backend == "cuda":
        mesh = _multichip_mesh()
        if mesh is not None:
            from hdrf_tpu_torch.parallel.sharded import reduce_sharded

            return reduce_sharded(data, cdc, mesh)
    dev = _device_for(backend)
    key = (cdc.mask_bits, cdc.min_chunk, cdc.max_chunk, dev)
    r = _resident_cache.get(key)
    if r is None:
        r = _resident_cache[key] = ResidentReducer(cdc, device=dev)
    return r.reduce(data)


# ----------------------------------------------------------- entropy stage
# (port of hdrf_tpu/ops/dispatch.py:212-281)

_LZ4_FIELDS = ("stride", "min_len", "min_device", "_p1", "_p2", "_p3",
               "_flood_streak", "_bypass_left", "BYPASS_AFTER", "BYPASS_RUN")
_lz4_engines: dict = {}
_lz4_lock = threading.Lock()


def from_reference_lz4(d: dict, device="cuda"):
    """A ``DeviceLz4`` in the state of a reference ``TpuLz4`` whose fields
    ``stride``, ``min_len``, ``min_device``, ``_p1``, ``_p2``, ``_p3``,
    ``_flood_streak``, ``_bypass_left``, ``BYPASS_AFTER`` and
    ``BYPASS_RUN`` are given as plain ints: the two then emit the same
    bytes for the same payloads in the same order."""
    from hdrf_tpu_torch.ops.lz4_device import DeviceLz4

    c = DeviceLz4(stride=int(d["stride"]), min_len=int(d["min_len"]),
                  min_device=int(d["min_device"]), device=device)
    for f in _LZ4_FIELDS[3:]:
        setattr(c, f, int(d[f]))
    return c


def lz4_engine(backend: str = "auto"):
    """The process's ``DeviceLz4`` for a backend (created at first use; its
    learned slice hints and flood state persist across seals)."""
    from hdrf_tpu_torch.ops.lz4_device import DeviceLz4

    dev = _device_for(backend)
    with _lz4_lock:
        eng = _lz4_engines.get(dev)
        if eng is None:
            eng = _lz4_engines[dev] = DeviceLz4(device=dev)
    return eng


def block_compress(codec: str, data: bytes, backend: str = "auto") -> bytes:
    """Codec dispatch for the entropy stage (container seal).  ``lz4``
    finds its matches on the backend's device (ops/lz4_device.py); every
    other codec, and every codec on ``native``, is the host codec.  The
    output is a standard LZ4 block either way."""
    from hdrf_tpu_torch.utils import codec as codecs

    backend = resolve_backend(backend)
    _M.incr(f"compress_{backend}_total")
    _M.incr(f"compress_{backend}_bytes", len(data))
    if codec == "lz4" and backend != "native":
        return lz4_engine(backend).compress(data)
    return codecs.compress(codec, data)


def block_compress_batch(codec: str, datas: list,
                         backend: str = "auto") -> list:
    """Batched codec dispatch: ``lz4`` payloads go to
    ``DeviceLz4.compress_many`` (a flood bypass covers the whole group or
    none of it), spread over the cards when the mesh plane is on;
    everything else per item."""
    backend = resolve_backend(backend)
    if codec == "lz4" and backend != "native":
        _M.incr(f"compress_{backend}_total", len(datas))
        _M.incr(f"compress_{backend}_bytes", sum(len(d) for d in datas))
        if backend == "cuda" and mesh_plane_enabled():
            mesh = _mesh_plane_mesh()
            if mesh is not None:
                from hdrf_tpu_torch.parallel.sharded import (
                    lz4_compress_many_sharded,
                )

                return lz4_compress_many_sharded(lz4_engine(backend), datas,
                                                 mesh)
        return lz4_engine(backend).compress_many(datas)
    return [block_compress(codec, d, backend) for d in datas]


def block_decompress_batch(codec_names: list, blobs: list, usizes: list,
                           backend: str = "auto") -> list:
    """Batched decode dispatch for a read window.  LZ4 decode is byte-serial
    in its output dependence, so it runs the host decoder on every
    backend, as in the reference.  The worker has no decode op: this is
    the read plane's seam, kept so the dispatch surface matches the
    reference's."""
    from hdrf_tpu_torch.utils import codec as codecs

    backend = resolve_backend(backend)
    _M.incr(f"decompress_{backend}_total", len(blobs))
    _M.incr(f"decompress_{backend}_bytes", sum(usizes))
    return [codecs.decompress(c, b, u)
            for c, b, u in zip(codec_names, blobs, usizes)]

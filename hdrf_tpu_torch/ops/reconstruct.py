"""Device-side block reconstruction: the read path's device half (port of
hdrf_tpu/ops/reconstruct.py: ``DeviceReconstructor`` with its image cache,
:63-115, and ``gather``, :117-166; the raw lane gather, :46-60, is
ops/gather_cuda.gather_lanes_raw).

The reference's read engine (DataConstructor.java:360-567: metadata,
group-by-container, decompress, the scatter loop ``bBuffer ->
data[chunk.bbStart]`` :527-531) splits here:

- **Container images stay device-resident.**  A container is decompressed
  once on the host (LZ4's byte-serial output dependence; the reference
  decompresses serially too) and its big-endian word image is cached on
  the device — the padded payload uploaded once, the words made there by
  ``cdc_cuda.be_image`` (the scan's words-only mode).  The image equals
  the reference's word for word: the payload, zero-padded by
  ``headroom`` bytes and rounded up to 512.  The budget counts that
  padded byte size, evicts in insertion (FIFO) order — a hit does not
  reorder — and a staging race on one container keeps the first image and
  accounts it once, all as the reference does.
- **The chunk gather runs on the device.**  Chunks become lanes gathered
  from the resident image by the raw gather kernel (funnel shift, no SHA
  pad), grouped by (container, power-of-two bucket) and padded to a
  multiple of 128 lanes.  The kernel stores the lanes as raw bytes (its
  byte-order mode), which are copied to the host once a group; the host
  lays each chunk's span into the output in one ordered pass.

On a TPU the reference uses the padded Pallas gather where its DMA window
fits the headroom (``gather_pad_messages``, reconstruct.py:148-157) and
the raw gather elsewhere; the bytes ``gather`` writes into ``out`` are the
same either way, because spans read only below each chunk's length.  The
port launches the raw kernel for every group: that is the function this
module defines, and it needs no ``+640`` headroom exception.  The
headroom contract stays asserted (``bucket * 64 + 4 <= headroom``): the
reference's ``dynamic_slice`` clamps a window past the image, the
kernel's loads read zero there, and the two agree only inside it.

``device="cpu"`` runs the plain versions (tests); a CUDA device launches
the kernels or raises.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from hdrf_tpu_torch.ops import cdc_cuda, gather_cuda
from hdrf_tpu_torch.ops.dispatch import resolve_device
from hdrf_tpu_torch.utils import metrics

_M = metrics.registry("device_recon")

_PAD = 512  # image pad grid (bytes; the be_image block grid)


def _bucket_of(nw: int) -> int:
    return max(1 << int(max(nw, 1) - 1).bit_length(), 16)


class DeviceReconstructor:
    """Device-resident container image cache + device chunk gather."""

    def __init__(self, budget: int = 256 << 20,
                 headroom: int = (1 << 20) + 4096, device="cuda"):
        """``headroom``: zero pad past each image's end so a lane window
        (up to the largest chunk, rounded to its pow2 bucket) never runs
        past the image.  Must exceed 2x the largest chunk in use."""
        self._budget = budget
        self._headroom = headroom
        self._device = resolve_device(device)
        self._lock = threading.Lock()
        self._images: dict[int, torch.Tensor] = {}  # cid -> i32 BE words
        self._sizes: dict[int, int] = {}
        self._used = 0

    def _stage(self, data) -> tuple[torch.Tensor, int]:
        """(BE word image on the device, padded byte size) of a payload."""
        a = np.frombuffer(data, np.uint8)
        padded = -(-(a.size + self._headroom) // _PAD) * _PAD
        block = torch.empty(padded, dtype=torch.uint8, device=self._device)
        if a.size:
            block[:a.size].copy_(torch.from_numpy(a.copy()))
        block[a.size:].zero_()
        return cdc_cuda.be_image(block), padded

    def _image(self, cid: int, payload_loader) -> torch.Tensor:
        with self._lock:
            img = self._images.get(cid)
            if img is not None:
                _M.incr("image_hits")
                return img
        data = payload_loader()  # host decompress happens at most once
        img, padded = self._stage(data)
        with self._lock:
            # two threads can race the staging above for the same cid; the
            # loser must not double-account the image size (a permanently
            # inflated _used silently shrinks the budget -> early evictions)
            if cid in self._images:
                _M.incr("image_hits")
                return self._images[cid]
            self._used += padded
            while self._used > self._budget and self._images:
                old_cid = next(iter(self._images))
                self._images.pop(old_cid)
                self._used -= self._sizes.pop(old_cid)
            self._images[cid] = img
            self._sizes[cid] = padded
            _M.incr("images_staged")
        return img

    def invalidate(self, cid: int) -> None:
        """Container rewritten/compacted: drop the stale image."""
        with self._lock:
            if self._images.pop(cid, None) is not None:
                self._used -= self._sizes.pop(cid, 0)

    def gather(self, wanted: list[tuple[int, int, int]], payload_loader,
               spans: list[tuple[int, int, int]], out: bytearray) -> None:
        """Fill ``out`` per ``spans`` from device-gathered chunk lanes.

        wanted[i] = (container_id, offset, length) of needed chunk i;
        spans[i] = (out_at, lo, n): write chunk i's bytes [lo, lo+n) at
        out[out_at:].  ``payload_loader(cid)`` supplies a container's
        uncompressed payload when its image isn't resident yet."""
        # group by (container, pow2 length bucket): a single max-length
        # bucket would pad every lane to the largest chunk
        groups: dict[tuple[int, int], list[int]] = {}
        for i, (cid, _, ln) in enumerate(wanted):
            b = _bucket_of(-(-ln // 64) + 1)
            groups.setdefault((cid, b), []).append(i)
        dst = memoryview(out)
        for (cid, bucket), idxs in groups.items():
            img = self._image(cid, lambda c=cid: payload_loader(c))
            assert bucket * 64 + 4 <= self._headroom, \
                "chunk larger than the gather headroom"
            L = -(-len(idxs) // 128) * 128
            ol = np.zeros((2, L), np.int32)
            for j, i in enumerate(idxs):
                ol[0, j] = wanted[i][1]
                ol[1, j] = wanted[i][2]
            ol_dev = torch.from_numpy(ol).to(self._device)
            # the lanes as raw bytes (byte order at the kernel's store),
            # then one copy back
            lane_bytes = gather_cuda.gather_lanes_raw(
                img, ol_dev, bucket, order="bytes").reshape(-1).cpu().numpy()
            src = memoryview(lane_bytes)
            row = bucket * 64
            for j, i in enumerate(idxs):
                out_at, lo, nb = spans[i]
                base = j * row
                dst[out_at:out_at + nb] = src[base + lo:base + lo + nb]
            _M.incr("chunks_gathered", len(idxs))
        _M.incr("reconstructions")

"""Chunk gather with SHA-256 padding: kernel 2 and its plain version (port
of hdrf_tpu/ops/gather_pallas.py; replaces the Pallas ``_kernel`` reached
through ``_gather_chunk`` at gather_pallas.py:122).

``gather_pad_messages(words, ol, bucket)`` turns each chunk lane — a byte
offset and a length into the big-endian word image — into a ready-to-hash
message of ``bucket`` 64-byte blocks: the chunk's bytes from any byte
offset, the 0x80 marker, zero fill, and the 64-bit big-endian bit length
in the last word of its last real block; words past that are zero.
Output ``int32[L, bucket*16]`` (u32 bit patterns), the standalone contract
the read path reuses later.

Design (csrc/gather.cu): one thread block per lane, its threads striding
over the lane's output words.  The card loads words at any index, so the
TPU's DMA of whole 512-byte rows plus the roll pair that realigned them
is gone: output word ``j`` is a funnel shift of image words ``q + j`` and
``q + j + 1`` (``q = off // 4``), read coalesced by neighbouring threads.
Words past the last real block are written as zeros without a load.
Bound: bytes — the chunk bytes read once and the padded messages written
once (about 0.4 GB per 128 MiB block at the default geometry, ~0.12 ms at
3.35 TB/s).  Reads past the end of the image return zero, so the image
needs no pad words.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import threading

import torch

from hdrf_tpu_torch.ops import _build
from hdrf_tpu_torch.ops.gear import M32, to_i32

# Kernel launches, one per wrapper call on CUDA tensors with L > 0.
launches = 0
_launch_lock = threading.Lock()


def gather_pad_messages_plain(words: torch.Tensor, ol: torch.Tensor,
                              bucket: int) -> torch.Tensor:
    """Plain version of :func:`gather_pad_messages` (the arithmetic of
    hdrf_tpu/ops/resident.py:158-193 ``sha_pad_messages``)."""
    W = bucket * 16
    dev = words.device
    offs = ol[0].to(torch.int64)[:, None]
    lens = ol[1].to(torch.int64)[:, None]
    w64 = torch.cat([words.to(torch.int64) & M32,
                     torch.zeros(W + 1, dtype=torch.int64, device=dev)])
    q = offs // 4
    s8 = (offs % 4) * 8
    idx = (q + torch.arange(W + 1, device=dev)[None, :]).clamp_(
        max=w64.numel() - 1)
    lanes = w64[idx]
    a, b = lanes[:, :W], lanes[:, 1:]
    c = torch.where(s8 == 0, a, ((a << s8) & M32) | (b >> (32 - s8)))
    wl = lens // 4
    r8 = (lens % 4) * 8
    j = torch.arange(W, device=dev)[None, :]
    keep = torch.where(r8 == 0, torch.zeros_like(r8), (M32 << (32 - r8)) & M32)
    marker = 0x80 << (24 - r8)
    boundary = (c & keep) | marker
    out = torch.where(j < wl, c,
                      torch.where(j == wl, boundary, torch.zeros_like(c)))
    last = (lens + 9 + 63) // 64 * 16 - 1
    out = torch.where(j == last, (lens * 8) & M32, out)
    return to_i32(out)


def gather_pad_messages(words: torch.Tensor, ol: torch.Tensor,
                        bucket: int) -> torch.Tensor:
    """(L, bucket*16) int32 SHA-ready big-endian messages for one bucket.

    words: int32[NW] BE word image; ol: int32[2, L] — row 0 chunk byte
    offsets into the image, row 1 byte lengths, each row contiguous, with
    ``len + 9 <= bucket * 64``.
    """
    if words.device.type == "cpu":
        return gather_pad_messages_plain(words, ol, bucket)
    if words.device.type != "cuda" or ol.device != words.device:
        raise ValueError("gather_pad_messages: words and ol must share a "
                         "CUDA device")
    if words.dtype != torch.int32 or words.dim() != 1 \
            or not words.is_contiguous():
        raise ValueError("gather_pad_messages: words must be contiguous "
                         "1-D int32")
    if ol.dtype != torch.int32 or ol.dim() != 2 or ol.shape[0] != 2 \
            or ol.stride(1) != 1:
        raise ValueError("gather_pad_messages: ol must be int32[2, L] with "
                         "contiguous rows")
    L, W = ol.shape[1], bucket * 16
    out = torch.empty((L, W), dtype=torch.int32, device=words.device)
    if L == 0:
        return out
    global launches
    _build.launch("hdrf_gather_pad", words.device, words.data_ptr(),
                  words.numel(), ol[0].data_ptr(), ol[1].data_ptr(), L, W,
                  out.data_ptr(), what="gather kernel")
    with _launch_lock:  # handler threads of the worker launch too
        launches += 1
    return out

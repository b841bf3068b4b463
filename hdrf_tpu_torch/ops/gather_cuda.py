"""Chunk-lane gathers: with SHA-256 padding (kernel 2, port of
hdrf_tpu/ops/gather_pallas.py; replaces the Pallas ``_kernel`` reached
through ``_gather_chunk`` at gather_pallas.py:122) and raw, for the read
path (port of hdrf_tpu/ops/reconstruct.py:46-60 ``gather_lanes_raw``, a
jitted XLA program), each beside its plain version.

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

``gather_lanes_raw(words, ol, bucket)`` is the same funnel shift without
the pad: output word ``j`` of a lane is image words ``q + j`` and
``q + j + 1`` shifted together, for all ``bucket * 16`` words (past the
chunk's length they are the image's next bytes, not zeros; ``ol[1]`` is
not read).  With ``order="bytes"`` it returns the lanes as bytes,
u8[L, bucket*64]: each word byte-reversed, so a lane is the image's raw
bytes from its offset (the reference swaps them on the host,
hdrf_tpu/ops/reconstruct.py:159, ``lanes.byteswap()``).  Its kernel is
``gather_raw_kernel`` in the same source: a flat grid over (lane, 4-word
quad), one 16-byte load and one 16-byte store a thread, the neighbouring
quad taken by shuffle, the byte order applied at the store.  The
reference's ``dynamic_slice`` clamps a window that would run past the
image; here loads past the image read zero.  The two agree inside the
reconstructor's headroom contract (``bucket * 64 + 4 <= headroom``), which
ops/reconstruct.py asserts.  Bound: bytes — the image bytes under the
union of the lanes' ``W + 1`` word windows read once and the ``W`` words a
lane written once.

On a CPU tensor a wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import threading

import torch

from hdrf_tpu_torch.ops import _build
from hdrf_tpu_torch.ops.gear import M32, to_i32

# Kernel launches, one per wrapper call on CUDA tensors with L > 0
# (``launches``: the padded gather; ``raw_launches``: the raw gather).
launches = 0
raw_launches = 0
_launch_lock = threading.Lock()


def _check_args(what: str, words: torch.Tensor, ol: torch.Tensor) -> None:
    if words.device.type != "cuda" or ol.device != words.device:
        raise ValueError(f"{what}: words and ol must share a CUDA device")
    if words.dtype != torch.int32 or words.dim() != 1 \
            or not words.is_contiguous():
        raise ValueError(f"{what}: words must be contiguous 1-D int32")
    if ol.dtype != torch.int32 or ol.dim() != 2 or ol.shape[0] != 2 \
            or ol.stride(1) != 1:
        raise ValueError(f"{what}: ol must be int32[2, L] with contiguous "
                         "rows")


def _shifted_lanes(words: torch.Tensor, offs: torch.Tensor,
                   W: int) -> torch.Tensor:
    """int64[L, W] (u32 values): lane i's words j = funnel shift of image
    words ``q + j``, ``q + j + 1`` at byte offset ``offs[i]``; loads past
    the image read zero."""
    dev = words.device
    offs = offs.to(torch.int64)[:, None]
    w64 = torch.cat([words.to(torch.int64) & M32,
                     torch.zeros(W + 1, dtype=torch.int64, device=dev)])
    q = offs // 4
    s8 = (offs % 4) * 8
    idx = (q + torch.arange(W + 1, device=dev)[None, :]).clamp_(
        max=w64.numel() - 1)
    lanes = w64[idx]
    a, b = lanes[:, :W], lanes[:, 1:]
    return torch.where(s8 == 0, a, ((a << s8) & M32) | (b >> (32 - s8)))


def gather_pad_messages_plain(words: torch.Tensor, ol: torch.Tensor,
                              bucket: int) -> torch.Tensor:
    """Plain version of :func:`gather_pad_messages` (the arithmetic of
    hdrf_tpu/ops/resident.py:158-193 ``sha_pad_messages``)."""
    W = bucket * 16
    dev = words.device
    lens = ol[1].to(torch.int64)[:, None]
    c = _shifted_lanes(words, ol[0], W)
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
    _check_args("gather_pad_messages", words, ol)
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


def gather_lanes_raw_plain(words: torch.Tensor, ol: torch.Tensor,
                           bucket: int, order: str = "words") -> torch.Tensor:
    """Plain version of :func:`gather_lanes_raw` (the arithmetic of
    hdrf_tpu/ops/reconstruct.py:46-60; in byte order, each word's bytes
    flipped)."""
    lanes = to_i32(_shifted_lanes(words, ol[0], bucket * 16))
    if order == "words":
        return lanes
    L = lanes.shape[0]
    return lanes.view(torch.uint8).view(L, -1, 4).flip(-1).reshape(L, -1)


def gather_lanes_raw(words: torch.Tensor, ol: torch.Tensor, bucket: int,
                     order: str = "words") -> torch.Tensor:
    """Raw chunk lanes for one bucket: (L, bucket*16) int32 big-endian
    words, or with ``order="bytes"`` (L, bucket*64) uint8, the chunks'
    bytes in order.

    words: int32[NW] BE word image; ol: int32[2, L] — row 0 chunk byte
    offsets into the image (row 1, the lengths, is not read), each row
    contiguous; bucket a power of two >= 16.
    """
    if order not in ("words", "bytes"):
        raise ValueError(f"gather_lanes_raw: order {order!r} is not "
                         "'words' or 'bytes'")
    if words.device.type == "cpu":
        return gather_lanes_raw_plain(words, ol, bucket, order)
    _check_args("gather_lanes_raw", words, ol)
    if bucket < 16 or bucket & (bucket - 1):
        raise ValueError(f"gather_lanes_raw: bucket {bucket} is not a power "
                         "of two >= 16")
    L, W = ol.shape[1], bucket * 16
    out = torch.empty((L, W), dtype=torch.int32, device=words.device)
    if L:
        global raw_launches
        _build.launch("hdrf_gather_raw", words.device, words.data_ptr(),
                      words.numel(), ol[0].data_ptr(), L, W,
                      int(order == "bytes"), out.data_ptr(),
                      what="raw gather kernel")
        with _launch_lock:
            raw_launches += 1
    return out if order == "words" else out.view(torch.uint8)

"""SHA-256 compression on the card: kernel 3 (port of
hdrf_tpu/ops/sha256_pallas.py; replaces the Pallas ``_kernel`` of
``sha256_words_pallas`` at sha256_pallas.py:99).  Its plain version is
``ops/sha256.py:sha256_words``.

Same contract as the reference: pre-padded big-endian messages
``int32[L, B*16]`` (u32 bit patterns) and per-lane block counts ``[L]``
give digests ``u8[L, 32]``; a lane past its count holds its state.

Design (csrc/sha256.cu): one thread per lane, the eight state words and
the sixteen-word schedule window in registers, ``_K`` in constant memory,
the 64 rounds fully unrolled (rotates are single funnel shifts).  A lane
stops at its own block count.  The grid rounds the lane count UP to whole
thread blocks and each thread checks its lane against L, so every lane is
hashed — the tail fault of sha256_pallas.py:82-86 (a floored tile count
left the last lanes unprocessed) cannot recur.  Bound: integer operations
(1384 per 64-byte block as sm_90 issues them: a rotate is one SHF, a
three-input logic op one LOP3, a three-operand add one IADD3), a few
times the byte bound; with one thread per chunk the card also runs short
of lanes (~13 K for a 128 MiB block), so the longest chunk sets the time.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import threading

import torch

from hdrf_tpu_torch.ops import _build
from hdrf_tpu_torch.ops.sha256 import sha256_words

# Kernel launches, one per wrapper call on CUDA tensors with L > 0.
launches = 0
_launch_lock = threading.Lock()


def sha256_words_cuda(words: torch.Tensor,
                      nblocks: torch.Tensor) -> torch.Tensor:
    """u8[L, 32] SHA-256 digests of pre-padded message lanes."""
    if words.device.type == "cpu":
        return sha256_words(words, nblocks)
    if words.device.type != "cuda" or nblocks.device != words.device:
        raise ValueError("sha256_words_cuda: words and nblocks must share a "
                         "CUDA device")
    if words.dtype != torch.int32 or words.dim() != 2 \
            or not words.is_contiguous() or words.shape[1] % 16:
        raise ValueError("sha256_words_cuda: words must be contiguous "
                         "int32[L, B*16]")
    L = words.shape[0]
    if nblocks.dtype != torch.int32 or nblocks.shape != (L,) \
            or not nblocks.is_contiguous():
        raise ValueError("sha256_words_cuda: nblocks must be int32[L]")
    out = torch.empty((L, 32), dtype=torch.uint8, device=words.device)
    if L == 0:
        return out
    global launches
    _build.launch("hdrf_sha256", words.device, words.data_ptr(), L,
                  words.shape[1], nblocks.data_ptr(), out.data_ptr(),
                  what="sha256 kernel")
    with _launch_lock:  # handler threads of the worker launch too
        launches += 1
    return out

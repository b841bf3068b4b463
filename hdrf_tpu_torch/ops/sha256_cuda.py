"""SHA-256 compression on the card: kernel 3 (port of
hdrf_tpu/ops/sha256_pallas.py; replaces the Pallas ``_kernel`` of
``sha256_words_pallas`` at sha256_pallas.py:99).  Its plain version is
``ops/sha256.py:sha256_words``.

Same contract as the reference: pre-padded big-endian messages
``int32[L, B*16]`` (u32 bit patterns) and per-lane block counts ``[L]``
give digests ``u8[L, 32]``; a lane past its count holds its state.
``sha256_words_grouped`` hashes several such lane tables (a block's big
and small bucket) in ONE launch; ``sha256_words_cuda`` is the one-table
call.

Design (csrc/sha256.cu).  A lane is serial, so a launch lasts as long as
its longest lane's chain of compressions (1,025 for a 64 KiB chunk): the
kernel keeps everything but the rounds off that chain.  A pair of warps
takes a unit of 32 lanes: a consumer warp runs the 64 rounds, one lane a
thread, and a producer warp keeps four message blocks per lane in flight
in shared memory (``cp.async``, four threads to a lane's 64-byte block)
and computes the next block's ``W[t] + K[t]`` while the consumer runs the
current one; the consumer folds h into that sum one round early.  The
first table's units run first and its lanes longest first
(``lane_order``; each digest goes back to its own row).  When the first
table's lanes can pass 256 compressions (the big bucket), one two-pair
block stays resident on each SM, its four warps one to a sub-partition,
and the pairs take the units in order from a counter, so the longest
chains start at once, each warp alone in its sub-partition, while the
other pairs work through the rest; with short lanes only, one pair a
unit, as many blocks as fit, and the rounds put every add on the FMA pipe
beside the ALU pipe that runs the rotates and logic ops (more throughput
when warps share a sub-partition; a lone long chain keeps the compiler's
adds).  Every lane is hashed: each
unit checks its lanes against L, so the tail fault of
sha256_pallas.py:82-86 cannot recur.  Bound: the larger of the integer
operations (1,384 a 64-byte block as sm_90 executes them: a rotate is one
SHF, a three-input logic op one LOP3, a three-operand add one IADD3) and
the longest lane's chain (64 dependent SHF -> LOP3 -> IADD3 a
compression; ``chain_probe`` measures that latency on the card).

On CPU tensors the wrappers run the plain version; on CUDA tensors they
launch the kernel or raise.  ``launches`` counts one per wrapper call that
launches (a grouped call is one launch).
"""

from __future__ import annotations

import threading

import torch

from hdrf_tpu_torch.ops import _build
from hdrf_tpu_torch.ops.sha256 import sha256_words

# Kernel launches, one per wrapper call on CUDA tensors with lanes to hash.
launches = 0
_launch_lock = threading.Lock()


def lane_order(nblocks: torch.Tensor) -> torch.Tensor:
    """int32 lane indices, the longest lanes (most blocks) first; ties
    keep lane order."""
    return torch.sort(nblocks, descending=True, stable=True).indices.to(
        torch.int32)


def _check(words: torch.Tensor, nblocks: torch.Tensor, dev) -> None:
    if words.device != dev or nblocks.device != dev:
        raise ValueError("sha256: every table must lie on one CUDA device")
    if words.dtype != torch.int32 or words.dim() != 2 \
            or not words.is_contiguous() or words.shape[1] % 16:
        raise ValueError("sha256: words must be contiguous int32[L, B*16]")
    if nblocks.dtype != torch.int32 or nblocks.shape != (words.shape[0],) \
            or not nblocks.is_contiguous():
        raise ValueError("sha256: nblocks must be int32[L]")


def sha256_words_grouped(tables) -> list[torch.Tensor]:
    """u8[L, 32] digests of each ``(words, nblocks)`` lane table (one or
    two: the big bucket first), hashed in one launch, the first table's
    lanes longest first."""
    tables = list(tables)
    if not 1 <= len(tables) <= 2:
        raise ValueError("sha256_words_grouped: one or two lane tables")
    dev = tables[0][0].device
    if dev.type == "cpu":
        return [sha256_words(w, nb) for w, nb in tables]
    if dev.type != "cuda":
        raise ValueError("sha256_words_grouped: expected CUDA tensors")
    for w, nb in tables:
        _check(w, nb, dev)
    outs = [torch.empty((w.shape[0], 32), dtype=torch.uint8, device=dev)
            for w, _ in tables]
    if not any(w.shape[0] for w, _ in tables):
        return outs
    # held until the launch: a freed order's memory could be reused, and
    # overwritten, before the kernel reads it
    order = lane_order(tables[0][1]) if tables[0][0].shape[0] > 1 else None
    args = []
    for i, ((w, nb), out) in enumerate(zip(tables, outs)):
        args += [w.data_ptr(), w.shape[0], w.shape[1], nb.data_ptr(),
                 None if i or order is None else order.data_ptr(),
                 out.data_ptr()]
    args += [None, 0, 0, None, None, None] * (2 - len(tables))
    unit_counter = torch.zeros(1, dtype=torch.int32, device=dev)
    global launches
    _build.launch("hdrf_sha256", dev, *args, unit_counter.data_ptr(),
                  what="sha256 kernel")
    with _launch_lock:  # handler threads of the worker launch too
        launches += 1
    return outs


def sha256_words_cuda(words: torch.Tensor,
                      nblocks: torch.Tensor) -> torch.Tensor:
    """u8[L, 32] SHA-256 digests of pre-padded message lanes."""
    return sha256_words_grouped([(words, nblocks)])[0]


def chain_probe(device, iters: int = 1 << 19) -> dict:
    """Latency of one dependent SHF -> LOP3 -> IADD3 link (a SHA-256
    round's critical path) on the card: one thread walks ``iters`` x 16
    links.  Returns ns a link (CUDA events around the launch) and SM
    clocks a link (``clock64`` inside the kernel)."""
    out = torch.empty(1, dtype=torch.int32, device=device)
    cycles = torch.empty(1, dtype=torch.int64, device=device)
    links = 16 * iters
    args = (0x6A09E667, 0x510E527F, 0x9B05688C, iters, out.data_ptr(),
            cycles.data_ptr())
    _build.launch("hdrf_sha_chain_probe", device, *args, what="chain probe")
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        t0.record()
        _build.launch("hdrf_sha_chain_probe", device, *args,
                      what="chain probe")
        t1.record()
        t1.synchronize()
    return {"links": links, "ns_per_link": t0.elapsed_time(t1) * 1e6 / links,
            "cycles_per_link": int(cycles.item()) / links}

"""GF(2^8) Reed-Solomon coefficient apply: the kernel (csrc/rs.cu
``rs_apply_kernel``) beside its plain version.  Replaces the jitted XLA
program hdrf_tpu/ops/rs.py:167 ``_bit_matmul`` (the JAX package files it
under "TPU kernels"; it is no ``pallas_call``).

``gf_apply(coeffs, shards)`` computes ``out[r, x] = XOR_j gf_mul(C[r, j],
shards[j, x])`` for a host coefficient matrix ``C`` u8[nrows, k] and a
tensor ``shards`` u8[k, L] whose rows are contiguous (any row stride, any
byte alignment).  Every RS encode, decode and partial-sum repair of
ops/rs.py is one call.

The plain version, ``bit_matmul_plain``, is the reference's own
formulation: bit planes of the shards, an f32 matrix product with the
expanded bit matrix f32[nrows*8, k*8], mod 2, repacked to bytes.  It is
exact in f32 (at most k*8 = 192 summands of 0/1).  On the card the f32
product stays in full f32 (``torch.backends.cuda.matmul.allow_tf32`` is
False by default and nothing here sets it; with 0/1 inputs and sums under
2^11 TF32 would be exact too).

On a CPU tensor ``gf_apply`` runs the plain version; on a CUDA tensor it
launches the kernel (a call of more than 8 rows launches once per 8) or
raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from hdrf_tpu_torch.ops import _build

MAX_K = 24      # parse_policy's bound on data shards (rs.py:49)
MAX_ROWS = 8    # rows of one launch (parse_policy's bound on parity)

launches = 0
_launch_lock = threading.Lock()


def bit_matmul_plain(bitmat: torch.Tensor, shards: torch.Tensor,
                     nrows: int) -> torch.Tensor:
    """(bitmat @ bits(shards)) mod 2 repacked to bytes, in PyTorch
    (hdrf_tpu/ops/rs.py:167-186).  bitmat f32[nrows*8, k*8], shards
    u8[k, L] -> u8[nrows, L] on the shards' device."""
    k, L = shards.shape
    dev = shards.device
    s = shards.to(torch.int32)
    planes = torch.stack([(s >> b) & 1 for b in range(8)], dim=1)
    x = planes.reshape(k * 8, L).to(torch.float32)
    acc = bitmat.to(device=dev, dtype=torch.float32) @ x
    bits = torch.remainder(acc, 2.0)
    w = torch.tensor([float(1 << b) for b in range(8)], device=dev)
    by = (bits.reshape(nrows, 8, L) * w[None, :, None]).sum(dim=1)
    return by.to(torch.uint8)


def gf_apply_plain(coeffs, shards: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gf_apply`: the bit-matrix expansion of the
    coefficients through :func:`bit_matmul_plain`."""
    from hdrf_tpu_torch.ops import rs

    c = np.asarray(coeffs, dtype=np.uint8)
    return bit_matmul_plain(torch.from_numpy(rs._bit_matrix(c)), shards,
                            c.shape[0])


def gf_apply(coeffs, shards: torch.Tensor) -> torch.Tensor:
    """u8[nrows, L]: the GF(2^8) coefficient matrix ``coeffs`` (host
    u8[nrows, k]) applied to ``shards`` u8[k, L].  On the card the result
    is a view whose rows start 16-byte aligned (row stride L rounded up to
    16)."""
    c = np.ascontiguousarray(coeffs, dtype=np.uint8)
    if c.ndim != 2 or shards.dim() != 2 or c.shape[1] != shards.shape[0]:
        raise ValueError(f"gf_apply: coefficients {c.shape} do not match "
                         f"shards {tuple(shards.shape)}")
    if shards.device.type == "cpu":
        return gf_apply_plain(c, shards)
    if shards.device.type != "cuda" or shards.dtype != torch.uint8 \
            or (shards.shape[1] > 1 and shards.stride(1) != 1):
        raise ValueError("gf_apply: shards must be uint8 rows on a CUDA "
                         "device, each row contiguous")
    nrows, k = c.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"gf_apply: {k} shards (the kernel takes 1..{MAX_K})")
    L = shards.shape[1]
    lp = max(-(-L // 16) * 16, 16)
    out = torch.empty((nrows, lp), dtype=torch.uint8,
                      device=shards.device)[:, :L]
    if L == 0:
        return out
    global launches
    for r0 in range(0, nrows, MAX_ROWS):
        part = c[r0:r0 + MAX_ROWS].tobytes()
        coef = (ctypes.c_uint8 * len(part)).from_buffer_copy(part)
        # shards, out and coef stay referenced until the launch returns
        _build.launch("hdrf_rs_apply", shards.device, shards.data_ptr(),
                      shards.stride(0), k, out[r0].data_ptr(), out.stride(0),
                      len(part) // k, L, ctypes.addressof(coef),
                      what="rs kernel")
        with _launch_lock:   # serve threads of several holders launch too
            launches += 1
    return out

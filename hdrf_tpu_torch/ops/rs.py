"""Reed-Solomon erasure coding over GF(2^8) (port of hdrf_tpu/ops/rs.py).

The host half is the reference's, copied bit for bit: ``parse_policy``
(in ops/ec_policy.py, which loads no torch; re-exported here), the
log/antilog field (``_tables``, ``gf_mul``, ``gf_inv``,
``gf_mat_inv``), the Cauchy generator ``rs_matrix``, the bit-matrix
expansion ``_bit_matrix``, the host oracles ``encode_ref`` and
``partial_sums_ref``, ``repair_rows`` (the decode seam shared by the full
gather and the partial-sum repair) and ``xor_fold``.

The device half -- ``rs_encode``, ``rs_decode``, ``partial_sums`` and
``_bit_matmul`` -- keeps the reference's signatures (host numpy or bytes
in, numpy out) with a ``device`` argument that defaults to the card.  On
``cuda`` each call is one launch of the GF(2^8) kernel of csrc/rs.cu
(ops/rs_cuda.py ``gf_apply``) on the coefficient matrix itself; the
reference expands it to a bit matrix for the MXU (rs.py:167
``_bit_matmul``), which on this card would move 32x the bytes.
``device="cpu"`` runs the plain version, the reference's bit-plane
product in PyTorch.  ``_bit_matmul`` keeps the reference's inputs (a bit
matrix) so a test can hold it against the JAX program; on the card it
recovers the coefficient matrix from the bit matrix (the image of the
basis element 1) and refuses one that is no expansion of a GF matrix.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hdrf_tpu_torch.ops import rs_cuda
from hdrf_tpu_torch.ops.dispatch import resolve_device
from hdrf_tpu_torch.ops.ec_policy import parse_policy  # noqa: F401


# --------------------------------------------------------------- GF(2^8) host

_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1 (the usual RS-255 field)


@functools.cache
def _tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[:255]
    return exp, log


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    exp, log = _tables()
    return int(exp[log[a] + log[b]])


def gf_inv(a: int) -> int:
    exp, log = _tables()
    return int(exp[255 - log[a]])


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square GF(2^8) matrix (Gauss-Jordan, host side, tiny)."""
    n = m.shape[0]
    a = m.astype(np.int64).copy()
    inv = np.eye(n, dtype=np.int64)
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r, col]), None)
        if piv is None:
            raise ValueError("singular GF matrix (too many erasures)")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        pi = gf_inv(int(a[col, col]))
        a[col] = [gf_mul(int(v), pi) for v in a[col]]
        inv[col] = [gf_mul(int(v), pi) for v in inv[col]]
        for r in range(n):
            if r != col and a[r, col]:
                f = int(a[r, col])
                a[r] ^= np.array([gf_mul(f, int(v)) for v in a[col]])
                inv[r] ^= np.array([gf_mul(f, int(v)) for v in inv[col]])
    return inv.astype(np.uint8)


@functools.cache
def rs_matrix(k: int, m: int) -> np.ndarray:
    """(k+m, k) GF(256) generator: identity over data rows + Cauchy parity
    rows 1/(x_i + y_j) — any k rows are invertible (Cauchy property)."""
    g = np.zeros((k + m, k), dtype=np.uint8)
    g[:k] = np.eye(k, dtype=np.uint8)
    xs = list(range(m))           # parity points
    ys = list(range(m, m + k))    # data points; disjoint from xs
    for i in range(m):
        for j in range(k):
            g[k + i, j] = gf_inv(xs[i] ^ ys[j])
    return g


def _bit_matrix(gf_rows: np.ndarray) -> np.ndarray:
    """GF(256) matrix (r, c) -> GF(2) bit matrix (r*8, c*8).

    Row-bit b' of output byte = XOR over input bits b where the bit-matrix
    entry M[b', b] = bit b' of (coeff * x^b) — multiplication by the basis
    monomials.
    """
    r, c = gf_rows.shape
    out = np.zeros((r * 8, c * 8), dtype=np.float32)
    for i in range(r):
        for j in range(c):
            coeff = int(gf_rows[i, j])
            if not coeff:
                continue
            for b in range(8):
                prod = gf_mul(coeff, 1 << b)
                for bp in range(8):
                    if prod >> bp & 1:
                        out[i * 8 + bp, j * 8 + b] = 1.0
    return out


def encode_ref(data: np.ndarray, m: int) -> np.ndarray:
    """Host oracle: parity shards via GF log/antilog table arithmetic.
    data: u8[k, L] -> u8[m, L]."""
    k, L = data.shape
    exp, log = _tables()
    g = rs_matrix(k, m)[k:]
    out = np.zeros((m, L), dtype=np.uint8)
    for i in range(m):
        acc = np.zeros(L, dtype=np.uint8)
        for j in range(k):
            coeff = int(g[i, j])
            if coeff:
                nz = data[j] != 0
                prod = np.zeros(L, dtype=np.uint8)
                prod[nz] = exp[log[coeff] + log[data[j][nz]]]
                acc ^= prod
        out[i] = acc
    return out



    return np.asarray(out)


@functools.cache
def repair_rows(k: int, m: int, have: tuple[int, ...],
                want: tuple[int, ...]) -> np.ndarray:
    """GF(256) repair matrix R, u8[len(want), k]:
    ``missing[w] = XOR_j gf_mul(R[w, j], survivor[have[j]])``.

    ``have`` names the k survivor indices in use (sorted), ``want`` the
    indices to rebuild (data or parity).  The decode seam shared by
    rs_decode (full gather) and the partial-sum repair plane: each
    holder's contribution applies the COLUMNS of R matching its local
    survivors, so the per-holder split is just column selection."""
    if len(have) != k:
        raise ValueError(f"need {k} survivor indices, got {len(have)}")
    g = rs_matrix(k, m)
    sub = g[list(have)]                 # (k, k) rows that produced survivors
    inv = gf_mat_inv(sub)               # data = inv @ survivors
    rows = np.zeros((len(want), k), dtype=np.uint8)
    for r, idx in enumerate(want):
        if idx < k:
            rows[r] = inv[idx]
        else:  # parity shard: re-encode from decoded data = g[idx] @ inv
            for j in range(k):
                acc = 0
                for t in range(k):
                    acc ^= gf_mul(int(g[idx, t]), int(inv[t, j]))
                rows[r, j] = acc
    return rows

# ------------------------------------------------------------- device half

def _host_rows(a) -> torch.Tensor:
    """A host tensor over the u8 rows ``a`` (copied only when read-only:
    torch refuses read-only buffers)."""
    a = np.ascontiguousarray(a, dtype=np.uint8)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def _apply(coeffs: np.ndarray, shards, device) -> np.ndarray:
    """u8[nrows, L] = GF matrix ``coeffs`` applied to host rows ``shards``
    u8[k, L] on ``device``: the plain version on the CPU; on the card the
    rows are staged at a 16-byte aligned row stride, one kernel launch,
    and the result copied back."""
    dev = resolve_device(device)
    src = _host_rows(shards)
    if dev.type == "cpu":
        return rs_cuda.gf_apply(coeffs, src).numpy()
    k, L = src.shape
    buf = torch.empty((k, max(-(-L // 16) * 16, 16)), dtype=torch.uint8,
                      device=dev)
    buf[:, :L].copy_(src)
    out = rs_cuda.gf_apply(coeffs, buf[:, :L])
    host = np.empty((len(coeffs), L), dtype=np.uint8)
    torch.from_numpy(host).copy_(out)
    return host


def _coeffs_of(bitmat: np.ndarray, nrows: int, k: int) -> np.ndarray:
    """The GF matrix whose ``_bit_matrix`` is ``bitmat``: column b = 0 of
    each 8x8 block is the coefficient times 1, its bits the coefficient."""
    blocks = bitmat.reshape(nrows, 8, k, 8)[:, :, :, 0]
    c = (blocks.astype(np.uint8) << np.arange(8, dtype=np.uint8)[None, :, None]
         ).sum(axis=1, dtype=np.uint32).astype(np.uint8)
    if not np.array_equal(_bit_matrix(c), bitmat):
        raise ValueError("bit matrix is not the expansion of a GF(2^8) "
                         "matrix: the kernel takes GF coefficients")
    return c


def _bit_matmul(bitmat, shards, nrows: int, device="cuda") -> np.ndarray:
    """(A @ bits(shards)) mod 2, repacked to bytes (rs.py:167-186).

    bitmat: f32[nrows*8, k*8]; shards: u8[k, L] -> u8[nrows, L]."""
    bitmat = np.asarray(bitmat, dtype=np.float32)
    if resolve_device(device).type == "cpu":
        return rs_cuda.bit_matmul_plain(torch.from_numpy(bitmat.copy()),
                                        _host_rows(shards), nrows).numpy()
    k = np.asarray(shards).shape[0]
    return _apply(_coeffs_of(bitmat, nrows, k), shards, device)


def rs_encode(data: bytes | np.ndarray, k: int, m: int,
              device="cuda") -> np.ndarray:
    """Encode k data shards -> m parity shards on ``device``.
    data: u8[k, L] (or flat bytes of length k*L)."""
    a = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    shards = a.reshape(k, -1)
    return _apply(rs_matrix(k, m)[k:], shards, device)


def rs_decode(shards: dict[int, np.ndarray], k: int, m: int,
              want: list[int] | None = None,
              device="cuda") -> dict[int, np.ndarray]:
    """Recover missing shards from any k survivors.

    shards: {shard_index: u8[L]} with >= k entries (indices 0..k-1 = data,
    k..k+m-1 = parity).  Returns {index: u8[L]} for ``want`` (default: the
    missing data shards).
    """
    have = sorted(shards)[:k]
    if len(have) < k:
        raise ValueError(f"need {k} shards, have {len(have)}")
    if want is None:
        want = [i for i in range(k) if i not in shards]
    if not want:
        return {}
    rows = repair_rows(k, m, tuple(have), tuple(want))
    surv = np.stack([shards[i] for i in have])
    out = _apply(rows, surv, device)
    return {idx: out[i] for i, idx in enumerate(want)}


def partial_sums(stripes: np.ndarray, coeffs: np.ndarray,
                 device="cuda") -> np.ndarray:
    """One holder's repair contribution: u8[nwant, L] from its LOCAL
    survivor stripes u8[n, L] and its repair_rows column slice
    u8[nwant, n] -- one launch of the kernel encode uses.  XOR-folding
    every holder's output equals ``rs_decode`` of the full gather
    bit-for-bit."""
    coeffs = np.asarray(coeffs, dtype=np.uint8)
    return _apply(coeffs, np.asarray(stripes), device)


def partial_sums_ref(stripes: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Host oracle for ``partial_sums``: GF log/antilog table arithmetic
    (the same tables encode_ref pins against)."""
    stripes = np.asarray(stripes, dtype=np.uint8)
    coeffs = np.asarray(coeffs, dtype=np.uint8)
    nwant, n = coeffs.shape
    L = stripes.shape[1]
    exp, log = _tables()
    out = np.zeros((nwant, L), dtype=np.uint8)
    for w in range(nwant):
        acc = np.zeros(L, dtype=np.uint8)
        for j in range(n):
            c = int(coeffs[w, j])
            if c:
                nz = stripes[j] != 0
                prod = np.zeros(L, dtype=np.uint8)
                prod[nz] = exp[log[c] + log[stripes[j][nz]]]
                acc ^= prod
        out[w] = acc
    return out


def xor_fold(parts: list[np.ndarray]) -> np.ndarray:
    """Accumulate per-holder contributions: GF(2^8) addition is XOR, so
    the fold is associative/commutative — chain order never matters."""
    acc = np.array(parts[0], dtype=np.uint8, copy=True)
    for p in parts[1:]:
        acc ^= np.asarray(p, dtype=np.uint8)
    return acc

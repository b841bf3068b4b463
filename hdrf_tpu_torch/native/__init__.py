"""Host native helpers: CRC32C (whole and per checksum chunk), the LZ4
codec, the Gear candidate scan, the min/max cut select, SHA-256 of byte
ranges, the byte-range gather and ChaCha20 / ChaCha20-Poly1305 (port of
hdrf_tpu/native/__init__.py:123-166, 180-320 over its ``crc32c.cpp``,
``lz4.cpp``, ``cdc.cpp``, ``sha256.cpp``, ``ranges.cpp`` and
``chacha20.cpp``).

The port keeps its own copies of those sources in ``native/src`` and
builds every ``src/*.cpp`` with ``g++`` into one library,
``build/hdrf_tpu_torch/libhdrf_torch_native.so`` at the repository root,
at first use and again whenever any source is newer than the library;
then binds it with ctypes.  What crosses: the packet checksum and the
host half of the LZ4 seal (the serial encoder, its tail-reporting form
for segmented compression, the emit over device match records, the
packed-record unpack and the decoder), the sharded reduction's host cut
select, the host candidate scan and SHA-256 (the ``native`` backend, and
what ``chip_smoke.py`` holds the kernels to), the container store's
chunk-byte gather, the DataNode's per-chunk replica checksums and the
encrypted data-transfer channel's cipher (security.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hdrf_tpu_torch"
_SO = BUILD_DIR / "libhdrf_torch_native.so"

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()

_P, _U64, _U32 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32
_U64P = ctypes.POINTER(ctypes.c_uint64)
# C entry points: name -> (argtypes, restype).
_SIGNATURES = {
    "hdrf_crc32c": ([_U32, _P, _U64], _U32),
    # data, len, chunk_size, out
    "hdrf_crc32c_chunks": ([_P, _U64, _U64, _P], None),
    # key, nonce, counter, src, n, dst
    "hdrf_chacha20_xor": ([_P, _P, _U32, _P, _U64, _P], None),
    # key, nonce, aad, aad_len, src, n, dst
    "hdrf_aead_seal": ([_P, _P, _P, _U64, _P, _U64, _P], None),
    "hdrf_aead_open": ([_P, _P, _P, _U64, _P, _U64, _P], ctypes.c_int),
    "hdrf_lz4_compress_bound": ([_U64], _U64),
    "hdrf_lz4_compress": ([_P, _U64, _P, _U64], _U64),
    "hdrf_lz4_compress_tail": ([_P, _U64, _P, _U64, _U64P, _U64P], _U64),
    "hdrf_lz4_decompress": ([_P, _U64, _P, _U64], _U64),
    # row, p3, nv, stride, esc_slots, pos_out, dl_out
    "hdrf_lz4_unpack_records": ([_P, _U64, _U64, _U64, _U64, _P, _P], _U64),
    # src, n, pos, dl, nrec, dst, cap
    "hdrf_lz4_emit": ([_P, _U64, _P, _P, _U64, _P, _U64], _U64),
    # data, len, mask, out_pos, cap
    "hdrf_gear_candidates": ([_P, _U64, _U32, _P, _U64], _U64),
    # cand, ncand, len, min, max, out_cuts, cap
    "hdrf_cdc_select": ([_P, _U64, _U64, _U64, _U64, _P, _U64], _U64),
    # data, offsets, lengths, n, out
    "hdrf_sha256_batch": ([_P, _P, _P, _U64, _P], None),
    # src, n, starts, lens, dst
    "hdrf_gather_ranges": ([_P, _U64, _P, _P, _P], _U64),
}


def _sources() -> list[Path]:
    return sorted(_SRC_DIR.glob("*.cpp"))


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    "-o", str(tmp), *map(str, _sources())],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, _SO)  # atomic: concurrent builders never see half a file


def _stale() -> bool:
    if not _SO.exists():
        return True
    built = _SO.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _sources())


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if _stale():
                _build()
            lib = ctypes.CDLL(str(_SO))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def _as_u8(data) -> np.ndarray:
    a = (data if isinstance(data, np.ndarray)
         else np.frombuffer(data, dtype=np.uint8))
    if a.dtype != np.uint8 or not a.flags.c_contiguous:
        raise ValueError("expected C-contiguous uint8 data")
    return a


def crc32c(data: bytes | bytearray | memoryview | np.ndarray,
           crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, chained from ``crc``."""
    a = _as_u8(data)
    return _load().hdrf_crc32c(crc & 0xFFFFFFFF, a.ctypes.data, a.size)


def crc32c_chunks(data, chunk_size: int) -> np.ndarray:
    """CRC32C of every ``chunk_size`` slice of ``data`` (the last may be
    short), u32[ceil(len / chunk_size)]."""
    a = _as_u8(data)
    n = (a.size + chunk_size - 1) // chunk_size
    out = np.empty(max(n, 1), dtype=np.uint32)
    _load().hdrf_crc32c_chunks(a.ctypes.data, a.size, chunk_size,
                               out.ctypes.data)
    return out[:n]


def _key_nonce(key: bytes, nonce: bytes) -> tuple[np.ndarray, np.ndarray]:
    if len(key) != 32 or len(nonce) != 12:
        raise ValueError("ChaCha20 needs a 32-byte key and a 12-byte nonce")
    return np.frombuffer(key, np.uint8), np.frombuffer(nonce, np.uint8)


def chacha20_xor(key: bytes, nonce: bytes, data, counter: int = 1) -> bytes:
    """Raw ChaCha20 keystream XOR (RFC 8439)."""
    k, n = _key_nonce(key, nonce)
    a = _as_u8(data)
    out = np.empty(a.size, dtype=np.uint8)
    _load().hdrf_chacha20_xor(k.ctypes.data, n.ctypes.data, counter,
                              a.ctypes.data, a.size, out.ctypes.data)
    return out.tobytes()


def aead_seal(key: bytes, nonce: bytes, aad: bytes, plaintext) -> bytes:
    """ChaCha20-Poly1305 seal: ciphertext || 16-byte tag."""
    k, n = _key_nonce(key, nonce)
    a = _as_u8(plaintext)
    ad = np.frombuffer(aad, np.uint8) if aad else np.empty(0, np.uint8)
    out = np.empty(a.size + 16, dtype=np.uint8)
    _load().hdrf_aead_seal(k.ctypes.data, n.ctypes.data, ad.ctypes.data,
                           ad.size, a.ctypes.data, a.size, out.ctypes.data)
    return out.tobytes()


def aead_open(key: bytes, nonce: bytes, aad: bytes, sealed) -> bytes | None:
    """ChaCha20-Poly1305 open; None if authentication fails."""
    k, n = _key_nonce(key, nonce)
    a = _as_u8(sealed)
    if a.size < 16:
        return None
    ad = np.frombuffer(aad, np.uint8) if aad else np.empty(0, np.uint8)
    out = np.empty(a.size - 16, dtype=np.uint8)
    ok = _load().hdrf_aead_open(k.ctypes.data, n.ctypes.data, ad.ctypes.data,
                                ad.size, a.ctypes.data, a.size - 16,
                                out.ctypes.data)
    return out.tobytes() if ok else None


def lz4_compress(data) -> bytes:
    """The serial hash-table LZ4 block encoder."""
    a = _as_u8(data)
    if a.size == 0:
        return b""
    lib = _load()
    cap = lib.hdrf_lz4_compress_bound(a.size)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.hdrf_lz4_compress(a.ctypes.data, a.size, out.ctypes.data, cap)
    if n == 0:
        raise RuntimeError("lz4 compression failed")
    return out[:n].tobytes()


def lz4_compress_tail(data) -> tuple[bytes, int, int]:
    """lz4_compress plus (tail_token_offset, tail_literal_count) of the
    stream's final literals-only sequence — what the segmented
    compressor's stitcher needs (ops/lz4_device.lz4_stitch)."""
    a = _as_u8(data)
    if a.size == 0:
        return b"", 0, 0
    lib = _load()
    cap = lib.hdrf_lz4_compress_bound(a.size)
    out = np.empty(cap, dtype=np.uint8)
    toff, tlit = ctypes.c_uint64(), ctypes.c_uint64()
    n = lib.hdrf_lz4_compress_tail(a.ctypes.data, a.size, out.ctypes.data,
                                   cap, ctypes.byref(toff),
                                   ctypes.byref(tlit))
    if n == 0:
        raise RuntimeError("lz4 compression failed")
    return out[:n].tobytes(), toff.value, tlit.value


def lz4_emit(data, positions: np.ndarray, delta_len: np.ndarray) -> bytes:
    """Greedy parse + serialize an LZ4 block from externally discovered
    match records (the host half of the device seal).  Records are
    (position, (offset << 16) | est_len), sorted by position."""
    a = _as_u8(data)
    if a.size == 0:
        return b""
    ps = np.ascontiguousarray(positions, dtype=np.int32)
    dl = np.ascontiguousarray(delta_len, dtype=np.uint32)
    if ps.shape != dl.shape:
        raise ValueError("positions/delta_len shape mismatch")
    lib = _load()
    cap = lib.hdrf_lz4_compress_bound(a.size)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.hdrf_lz4_emit(a.ctypes.data, a.size, ps.ctypes.data,
                          dl.ctypes.data, ps.size, out.ctypes.data, cap)
    if n == 0:
        raise RuntimeError("lz4 emit failed")
    return out[:n].tobytes()


def lz4_unpack_records(row: np.ndarray, p3: int, nv: int, stride: int,
                       esc_slots: int):
    """Decode the packed device record row (the u32 body after its 4-word
    header; layout in ops/lz4_device.match_scan) into the (positions,
    (offset << 16) | len) arrays lz4_emit consumes.  Returns (pos
    int32[nrec], dl uint32[nrec], nrec); nrec < nv means an escape lane
    overflowed on the device and the tail was not decodable."""
    r = np.ascontiguousarray(row, dtype=np.uint32)
    if r.size < p3 + p3 // 4 + 2 * esc_slots:
        raise ValueError("packed record row too short")
    if not 0 <= nv <= p3:
        raise ValueError("invalid record count")
    pos = np.empty(nv, dtype=np.int32)
    dl = np.empty(nv, dtype=np.uint32)
    nrec = _load().hdrf_lz4_unpack_records(
        r.ctypes.data, p3, nv, stride, esc_slots, pos.ctypes.data,
        dl.ctypes.data)
    return pos[:nrec], dl[:nrec], int(nrec)


def lz4_decompress(data, decompressed_size: int) -> bytes:
    """Decode one LZ4 block of exactly ``decompressed_size`` bytes."""
    a = _as_u8(data)
    if decompressed_size == 0:
        return b""
    out = np.empty(decompressed_size, dtype=np.uint8)
    n = _load().hdrf_lz4_decompress(a.ctypes.data, a.size, out.ctypes.data,
                                    decompressed_size)
    if n != decompressed_size:
        raise RuntimeError(f"lz4 decompression failed: got {n}, want "
                           f"{decompressed_size}")
    return out.tobytes()


def gear_candidates(data, mask: int) -> np.ndarray:
    """Every pos1 in [32, len] whose window-32 Gear hash has ``(h & mask)
    == 0`` (uint64, ascending): the serial host scan."""
    a = _as_u8(data)
    lib = _load()
    cap = max(a.size // 8, 1024)
    out = np.empty(cap, dtype=np.uint64)
    n = lib.hdrf_gear_candidates(a.ctypes.data, a.size, mask & 0xFFFFFFFF,
                                 out.ctypes.data, cap)
    if n > cap:  # a dense mask: retry at the exact size
        out = np.empty(n, dtype=np.uint64)
        n = lib.hdrf_gear_candidates(a.ctypes.data, a.size,
                                     mask & 0xFFFFFFFF, out.ctypes.data, n)
    return out[:n].copy()


def cdc_select(candidates: np.ndarray, length: int, min_chunk: int,
               max_chunk: int) -> np.ndarray:
    """Min/max frontier cut select over sorted candidates: uint64
    exclusive chunk ends, the last always ``length``."""
    cand = np.ascontiguousarray(candidates, dtype=np.uint64)
    cap = length // max(min_chunk, 1) + 2
    out = np.empty(cap, dtype=np.uint64)
    n = _load().hdrf_cdc_select(cand.ctypes.data, cand.size, length,
                                min_chunk, max_chunk, out.ctypes.data, cap)
    return out[:n].copy()


def sha256_batch(data, offsets: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """SHA-256 of the byte ranges ``[offsets[i], offsets[i] + lengths[i])``
    of ``data``: u8[n, 32]."""
    a = _as_u8(data)
    offs = np.ascontiguousarray(offsets, dtype=np.uint64)
    lens = np.ascontiguousarray(lengths, dtype=np.uint64)
    if offs.shape != lens.shape:
        raise ValueError("offsets/lengths shape mismatch")
    if offs.size and int((offs + lens).max()) > a.size:
        raise ValueError("chunk range exceeds data buffer")
    out = np.empty((offs.size, 32), dtype=np.uint8)
    _load().hdrf_sha256_batch(a.ctypes.data, offs.ctypes.data,
                              lens.ctypes.data, offs.size, out.ctypes.data)
    return out


def gather_ranges(data, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate the ``[starts[i], starts[i] + lens[i])`` ranges of
    ``data`` into one u8 buffer in one native pass (the dedup commit's
    chunk-byte shuffle, ContainerStore.append_ranges)."""
    a = _as_u8(data)
    ss = np.ascontiguousarray(starts, dtype=np.uint64)
    ls = np.ascontiguousarray(lens, dtype=np.uint64)
    if ss.shape != ls.shape:
        raise ValueError("starts/lens shape mismatch")
    if ss.size and int((ss + ls).max()) > a.size:
        raise ValueError("range exceeds data buffer")
    out = np.empty(int(ls.sum()), dtype=np.uint8)
    _load().hdrf_gather_ranges(a.ctypes.data, ss.size, ss.ctypes.data,
                               ls.ctypes.data, out.ctypes.data)
    return out

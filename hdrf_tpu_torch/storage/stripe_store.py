"""Erasure-coded stripe store: the EC(6,3) cold tier's storage half (port
of hdrf_tpu/storage/stripe_store.py).

Re-expresses the reference's striped-block layout and reconstruction
plumbing (DFSStripedOutputStream.java:81 client striping;
StripedBlockUtil.java:77 logical<->stripe index math;
StripedBlockReconstructor.java:41 decode-and-writeback;
ErasureCodingWorker.java:55 DN-side reconstruction executor) device-first:
instead of striping the *raw* byte stream cell-by-cell at write time, we
RS-encode whole **sealed container files** — the already-reduced
(dedup'd + compressed) representation — so the EC savings multiply with
the reduction ratio (the compressed-coded-computing frame, arXiv
1805.01993).  Parity comes from ops/rs.py's GF(2^8) kernel on the card
(csrc/rs.cu; ``device`` picks it, ``"cpu"`` runs the plain version),
bit-identical to the GF log/antilog host oracle ``rs.encode_ref``.

Layout: a sealed file of ``length`` bytes is zero-padded to
``k * stripe_len`` and split row-major into k data stripes; m parity
stripes are appended (indices k..k+m-1).  Each stripe carries a CRC32C
(the port's native ``crc32c``) and the manifest records
``(k, m, length, stripe_len, crcs, holders)`` — enough to reassemble the
exact sealed bytes from ANY k surviving stripes.  Local stripe files are
keyed ``(owner_dn_id, cid, idx)`` because container ids are only unique
per owning DN.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Iterator

import numpy as np

from hdrf_tpu_torch import native
from hdrf_tpu_torch.ops import rs
from hdrf_tpu_torch.utils import metrics

_M = metrics.registry("ec")


class StripeCorrupt(IOError):
    """A stripe's bytes fail its manifest CRC (treated as an erasure)."""


def encode_container(sealed: bytes, k: int, m: int,
                     device="cuda") -> tuple[list[bytes], dict]:
    """RS-encode sealed container file bytes into k+m stripes.

    Returns ``(stripes, manifest)`` where ``stripes[i]`` is stripe index i
    (0..k-1 data, k..k+m-1 parity) and the manifest holds the geometry +
    per-stripe CRCs needed to reconstruct the exact input from any k
    survivors.  The input is zero-padded to a multiple of k (rs_encode
    reshapes to (k, -1)); ``length`` in the manifest is the TRUE sealed
    size, so reassembly truncates the pad away.
    """
    if k < 1 or m < 1:
        raise ValueError(f"bad EC geometry k={k} m={m}")
    length = len(sealed)
    stripe_len = max(1, -(-length // k))  # ceil; >=1 so empty still stripes
    padded = sealed + b"\x00" * (k * stripe_len - length)
    with _M.time("encode_us"):
        data = np.frombuffer(padded, dtype=np.uint8).reshape(k, stripe_len)
        parity = rs.rs_encode(data, k, m, device=device)
    stripes = [data[i].tobytes() for i in range(k)]
    stripes += [parity[i].tobytes() for i in range(m)]
    crcs = [native.crc32c(s) for s in stripes]
    _M.incr("stripes_encoded", k + m)
    _M.incr("containers_encoded")
    _M.incr("encode_logical_bytes", length)
    _M.incr("encode_physical_bytes", (k + m) * stripe_len)
    manifest = {"k": k, "m": m, "length": length,
                "stripe_len": stripe_len, "crcs": crcs}
    return stripes, manifest


def reconstruct_container(stripes: dict[int, bytes], manifest: dict,
                          want: list[int] | None = None,
                          device="cuda") -> bytes | dict[int, bytes]:
    """Reassemble the sealed container bytes from >= k surviving stripes.

    CRC-verifies every offered stripe against the manifest (a corrupt
    stripe is an erasure, not an input — StripedBlockReconstructor
    treats checksum failures the same way), decodes any missing data
    indices through ops/rs.py (``device``), and truncates the
    zero pad back to ``length``.  With ``want`` set, returns the decoded
    stripes ``{idx: bytes}`` instead (the repair path: re-encode exactly
    the lost indices).
    """
    k, m = int(manifest["k"]), int(manifest["m"])
    length = int(manifest["length"])
    stripe_len = int(manifest["stripe_len"])
    crcs = list(manifest["crcs"])
    good: dict[int, np.ndarray] = {}
    for idx, raw in stripes.items():
        idx = int(idx)
        if len(raw) != stripe_len or native.crc32c(raw) != crcs[idx]:
            _M.incr("stripe_crc_errors")
            continue
        good[idx] = np.frombuffer(raw, dtype=np.uint8)
    if len(good) < k:
        raise StripeCorrupt(
            f"need {k} intact stripes, have {len(good)} of {len(stripes)}")
    if want is not None:
        with _M.time("decode_us"):
            out = rs.rs_decode(good, k, m, want=want, device=device)
        _M.incr("stripes_decoded", len(want))
        return {i: out[i].tobytes() for i in want}
    missing = [i for i in range(k) if i not in good]
    if missing:
        # a data stripe was lost: this read decodes through parity — the
        # cold tier's degraded-read counter lives HERE so every caller
        # (DN fallback, bench, tests) stamps the same registry
        _M.incr("degraded_reads")
        with _M.time("decode_us"):
            good.update(rs.rs_decode(good, k, m, want=missing,
                                      device=device))
        _M.incr("stripes_decoded", len(missing))
    blob = b"".join(good[i].tobytes() for i in range(k))
    return blob[:length]


class StripeStore:
    """Flat-file stripe storage for one DataNode (all volumes share it).

    Mirrors ContainerStore's on-disk discipline (container_store.py raw/
    sealed files): tmp-write + ``os.replace`` so a crash never leaves a
    half stripe, and ``physical_bytes()`` feeds the DN's capacity report.
    Stripes for containers owned by OTHER DNs land here too — that is the
    point of striping — hence the (owner, cid, idx) key.
    """

    def __init__(self, root: str) -> None:
        self._dir = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, owner: str, cid: int, idx: int) -> str:
        # owner ids are socket-safe tokens (host_port); keep them verbatim
        return os.path.join(self._dir, f"{owner}.{cid}.{idx}.stripe")

    def put_stripe(self, owner: str, cid: int, idx: int, payload: bytes,
                   crc: int | None = None) -> None:
        if crc is not None and native.crc32c(payload) != crc:
            _M.incr("stripe_crc_errors")
            raise StripeCorrupt(f"stripe {owner}/{cid}/{idx}: bad CRC on write")
        path = self._path(owner, cid, idx)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        _M.incr("stripe_writes")
        _M.incr("stripe_bytes_written", len(payload))

    def read_stripe(self, owner: str, cid: int, idx: int) -> bytes:
        with open(self._path(owner, cid, idx), "rb") as f:
            data = f.read()
        _M.incr("stripe_reads")
        return data

    def has_stripe(self, owner: str, cid: int, idx: int) -> bool:
        return os.path.exists(self._path(owner, cid, idx))

    def local_indices(self, owner: str, cid: int) -> list[int]:
        """Stripe indices of (owner, cid) present on this DN's disk."""
        pfx = f"{owner}.{cid}."
        out = []
        for name in os.listdir(self._dir):
            if name.startswith(pfx) and name.endswith(".stripe"):
                out.append(int(name[len(pfx):-len(".stripe")]))
        return sorted(out)

    def delete_stripes(self, owner: str, cid: int) -> int:
        """Drop every local stripe of (owner, cid); returns bytes freed."""
        freed = 0
        with self._lock:
            for idx in self.local_indices(owner, cid):
                p = self._path(owner, cid, idx)
                try:
                    freed += os.path.getsize(p)
                    os.unlink(p)
                except FileNotFoundError:
                    pass
        _M.incr("stripe_bytes_deleted", freed)
        return freed

    def quarantine(self, owner: str, cid: int, idx: int) -> int:
        """Rename one scrub-confirmed corrupt stripe aside (``.quar``) so
        no gather/decode can pick it up again — reconstruct_container
        already CRC-filters corrupt stripes as erasures, but a renamed
        file also survives restarts and stops counting as a holder.
        Returns bytes quarantined."""
        p = self._path(owner, cid, idx)
        with self._lock:
            try:
                size = os.path.getsize(p)
                os.rename(p, p + ".quar")
            except OSError:
                return 0
        _M.incr("stripe_quarantined")
        return size

    def iter_stripes(self) -> Iterator[tuple[str, int, int, int]]:
        """Yield (owner, cid, idx, nbytes) for every local stripe file."""
        for name in sorted(os.listdir(self._dir)):
            if not name.endswith(".stripe"):
                continue
            stem = name[:-len(".stripe")]
            owner, cid_s, idx_s = stem.rsplit(".", 2)
            try:
                size = os.path.getsize(os.path.join(self._dir, name))
            except FileNotFoundError:
                continue
            yield owner, int(cid_s), int(idx_s), size

    def physical_bytes(self) -> int:
        return sum(size for *_ignored, size in self.iter_stripes())

    def stats(self) -> dict[str, Any]:
        n, total = 0, 0
        for *_ignored, size in self.iter_stripes():
            n += 1
            total += size
        return {"stripe_files": n, "stripe_physical_bytes": total}

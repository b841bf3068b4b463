"""Client-side EC striping (port of hdrf_tpu/client/striped.py:
``layout_shards``, ``assemble``, ``StripedWriter``, ``StripedReader``): the
DFSStripedOutputStream.java:81 / DFSStripedInputStream + StripedBlockUtil
analog.

Layout (HDFS-compatible cell striping): the file is cut into ``cell``-byte
cells laid round-robin over k data shards — cell c lives in shard ``c % k``
at row ``c // k``.  One *block group* covers ``k * block_size`` logical bytes
and produces k data + m parity internal blocks on k+m distinct DataNodes.
Parity is computed by the GF(2^8) RS kernel (ops/rs.py -> ops/rs_cuda.py,
``rs_apply_kernel`` in csrc/rs.cu) on the client's device
(``HdrfClient.device``: the card unless the caller asked for the CPU, where
the kernel's plain version runs); data shards are stored zero-padded to
whole stripes (the pad never leaves the group: reads slice to the group's
logical length).  The shards stored equal the reference client's byte for
byte.

Reads fetch the k data shards; any missing/failed shard triggers a parity
fetch + RS decode on the spot, on the same device (the degraded-read path,
StripedBlockUtil.decodeAndFillBuffer analog).
"""

from __future__ import annotations

import socket

import numpy as np

from hdrf_tpu_torch.ops import rs
from hdrf_tpu_torch.proto import datatransfer as dt
from hdrf_tpu_torch.utils import metrics

_M = metrics.registry("client_ec")


def layout_shards(data: bytes, k: int, cell: int) -> np.ndarray:
    """Round-robin cell layout -> u8[k, L] zero-padded data shards."""
    n = len(data)
    ncells = max((n + cell - 1) // cell, 1)
    rows = (ncells + k - 1) // k
    L = rows * cell
    shards = np.zeros((k, L), dtype=np.uint8)
    a = np.frombuffer(data, dtype=np.uint8)
    for c in range(ncells):
        piece = a[c * cell:(c + 1) * cell]
        r = c // k
        shards[c % k, r * cell:r * cell + piece.size] = piece
    return shards


def assemble(shards: dict[int, np.ndarray], k: int, cell: int,
             length: int) -> bytes:
    """Inverse of layout_shards over the k data shards."""
    L = next(iter(shards.values())).size
    out = np.empty(length, dtype=np.uint8)
    pos = 0
    c = 0
    while pos < length:
        r = c // k
        piece = shards[c % k][r * cell:(r + 1) * cell]
        take = min(cell, length - pos)
        out[pos:pos + take] = piece[:take]
        pos += take
        c += 1
    return out.tobytes()


class StripedWriter:
    def __init__(self, client):
        self._c = client

    def write(self, path: str, data: bytes, policy: str) -> None:
        c = self._c
        k, m, cell = rs.parse_policy(policy)
        info = c._call("create", path=path, client=c.name, ec=policy)
        group_capacity = k * info["block_size"]
        lengths: dict[int, int] = {}
        off = 0
        while True:
            chunk = data[off:off + group_capacity]
            gid = self._write_group(path, chunk, k, m, cell)
            lengths[gid] = len(chunk)
            off += group_capacity
            if off >= len(data):
                break
        c._complete(path, lengths)
        _M.incr("ec_files_written")
        _M.incr("ec_bytes_written", len(data))

    def _write_group(self, path: str, chunk: bytes, k: int, m: int,
                     cell: int) -> int:
        c = self._c
        alloc = c._call("add_block_group", path=path, client=c.name)
        assert alloc["k"] == k and alloc["m"] == m
        shards = layout_shards(chunk, k, cell)
        parity = rs.rs_encode(shards, k, m, device=c.device)
        allsh = np.concatenate([shards, parity])
        for blk, shard in zip(alloc["blocks"], allsh):
            self._send_shard(blk, alloc["gen_stamp"], shard.tobytes())
        return alloc["group_id"]

    def _send_shard(self, blk: dict, gen_stamp: int, shard: bytes) -> None:
        c = self._c
        sock = socket.create_connection(tuple(blk["target"]["addr"]),
                                        timeout=120)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock = dt.secure_socket(sock, blk.get("token"),
                                    c.config.encrypt_data_transfer)
            dt.send_op(sock, dt.WRITE_BLOCK, block_id=blk["block_id"],
                       gen_stamp=gen_stamp, scheme="direct",
                       token=blk.get("token"), targets=[])
            psz = c.config.packet_size
            _, status = dt.stream_acked(sock, shard, psz)[-1]
            if status != dt.ACK_SUCCESS:
                raise IOError(f"shard write returned {status}")
        finally:
            sock.close()


class StripedReader:
    def __init__(self, client):
        self._c = client

    def read(self, loc: dict, offset: int, end: int) -> bytes:
        """Read [offset, end) of an EC file given its location response."""
        k, m, cell = rs.parse_policy(loc["ec"])
        out = bytearray()
        pos = 0
        for grp in loc["groups"]:
            glen = grp["length"]
            gstart, gend = pos, pos + glen
            pos = gend
            if gend <= offset or gstart >= end:
                continue
            lo = max(offset, gstart) - gstart
            hi = min(end, gend) - gstart
            out += self._read_group(grp, k, m, cell, glen, lo, hi)
        return bytes(out)

    def _read_group(self, grp: dict, k: int, m: int, cell: int, glen: int,
                    lo: int, hi: int) -> bytes:
        """Bytes [lo, hi) of one group, reading only the stripe rows that
        overlap the range (O(length) network cost, not O(group)); the
        degraded path fetches the SAME row range from parity shards — RS is
        per-byte-position, so decode works row-wise."""
        stripe = k * cell
        row_lo, row_hi = lo // stripe, (hi + stripe - 1) // stripe
        soff, slen = row_lo * cell, (row_hi - row_lo) * cell
        shards: dict[int, np.ndarray] = {}
        failed: list[int] = []
        for i in range(k):
            data = self._try_read_shard(grp["blocks"][i], soff, slen)
            if data is None:
                failed.append(i)
            else:
                shards[i] = np.frombuffer(data, dtype=np.uint8)
        if failed:
            _M.incr("ec_degraded_reads")
            for i in range(k, k + m):
                if len(shards) >= k:
                    break
                data = self._try_read_shard(grp["blocks"][i], soff, slen)
                if data is not None:
                    shards[i] = np.frombuffer(data, dtype=np.uint8)
            if len(shards) < k:
                raise IOError(
                    f"EC group {grp['group_id']}: only {len(shards)} of "
                    f"{k}+{m} shards readable")
            shards.update(rs.rs_decode(shards, k, m, want=failed,
                                       device=self._c.device))
        # assemble the row window, then slice the requested bytes
        out = np.empty((row_hi - row_lo) * stripe, dtype=np.uint8)
        for c in range(row_lo * k, row_hi * k):
            r = c // k - row_lo
            out[(c - row_lo * k) * cell:(c - row_lo * k + 1) * cell] = \
                shards[c % k][r * cell:(r + 1) * cell]
        base = row_lo * stripe
        return out[lo - base:hi - base].tobytes()

    def _try_read_shard(self, blk: dict, offset: int,
                        length: int) -> bytes | None:
        for locd in blk["locations"]:
            try:
                return dt.fetch_block(tuple(locd["addr"]), blk["block_id"],
                                      offset, length,
                                      token=blk.get("token"),
                                      encrypt=self._c.config
                                      .encrypt_data_transfer)
            except (OSError, ConnectionError, IOError):
                _M.incr("ec_shard_read_failures")
        return None

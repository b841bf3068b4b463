"""Framed packet streaming and the op header (port of
hdrf_tpu/proto/datatransfer.py:36-38, 59-73, 89-104, 107-147, 157-219).

Op header: one frame ``[op_name, fields_dict]`` (proto/rpc.send_frame);
``send_op`` adds the caller's trace context as ``_trace`` and the ambient
deadline's remaining seconds as ``_deadline``, as the reference does.
Packet: ``[u32 data_len][u64 seqno][u8 flags][u32 crc32c(data)]`` + data,
the same wire bytes as the reference, so a reference DataNode's packet
stream lands unchanged in the port's worker.  A run ends with an empty
packet flagged LAST.
"""

from __future__ import annotations

import socket
import struct
from typing import Any, Iterator

from hdrf_tpu_torch import native
from hdrf_tpu_torch.proto.rpc import recv_exact, recv_frame, send_frame
from hdrf_tpu_torch.utils import retry, tracing

PKT_HDR = struct.Struct("<IQBI")
FLAG_LAST = 0x1

DEFAULT_PACKET = 64 * 1024

# EC cold-tier stripe ops (server/ec_tier.py; DN-protocol trust: stripe
# ops never carry client bytes).  STRIPE_CODED_READ is the coded-exchange
# sibling of STRIPE_READ: the request carries a per-DN chain plan and
# ``accept_enc`` (may the response ship LZ4'd payloads with per-item
# ``enc`` flags?); a peer without the op answers nothing, and the caller
# falls back to plain STRIPE_READ legs.
STRIPE_READ = "stripe_read"
STRIPE_WRITE = "stripe_write"
STRIPE_CODED_READ = "stripe_coded_read"


def send_op(sock: socket.socket, op: str, **fields: Any) -> None:
    tr = tracing.current_context()
    if tr is not None:
        fields["_trace"] = list(tr)
    # the remaining deadline budget rides the op header beside _trace
    hdr = retry.remaining_header()
    if hdr is not None:
        fields[retry.DEADLINE_KEY] = hdr
    send_frame(sock, [op, fields])


def recv_op(sock: socket.socket) -> tuple[str, dict]:
    op, fields = recv_frame(sock)
    return op, fields


def write_packet(sock: socket.socket, seqno: int, data: bytes,
                 last: bool = False) -> None:
    flags = FLAG_LAST if last else 0
    sock.sendall(PKT_HDR.pack(len(data), seqno, flags, native.crc32c(data)))
    if data:
        sock.sendall(data)


def read_packet_ex(sock: socket.socket) -> tuple[int, bytes, int]:
    """Returns (seqno, data, flags); raises IOError on checksum mismatch."""
    ln, seqno, flags, crc = PKT_HDR.unpack(recv_exact(sock, PKT_HDR.size))
    data = recv_exact(sock, ln) if ln else b""
    if native.crc32c(data) != crc:
        raise IOError(f"packet {seqno}: checksum mismatch")
    return seqno, data, flags


def read_packet(sock: socket.socket) -> tuple[int, bytes, bool]:
    seqno, data, flags = read_packet_ex(sock)
    return seqno, data, bool(flags & FLAG_LAST)


def iter_packets(sock: socket.socket) -> Iterator[tuple[int, bytes, bool]]:
    while True:
        seqno, data, last = read_packet(sock)
        yield seqno, data, last
        if last:
            return


def stream_bytes(sock: socket.socket, data: bytes,
                 packet_size: int = DEFAULT_PACKET,
                 base_seqno: int = 0) -> int:
    """Packetize ``data`` onto the socket, ending with an empty LAST packet.
    Returns the number of packets sent."""
    seqno = base_seqno
    for off in range(0, len(data), packet_size):
        write_packet(sock, seqno, data[off:off + packet_size])
        seqno += 1
    write_packet(sock, seqno, b"", last=True)
    return seqno - base_seqno + 1


def collect_packets(sock: socket.socket) -> bytes:
    """Receive a full packet run and return its payload bytes."""
    return b"".join(data for _, data, _ in iter_packets(sock))

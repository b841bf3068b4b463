"""Bulk data-transfer protocol: framed packet streaming on a raw TCP socket
(port of hdrf_tpu/proto/datatransfer.py, whole).

Modeled on the reference's ``DataTransferProtocol``
(hadoop-hdfs-client/.../datatransfer/DataTransferProtocol.java:42): a
connection carries one op — an op header, then for WRITE/READ a run of framed
packets with per-packet checksums, with acks flowing back on the same socket
(BlockReceiver's PacketResponder, BlockReceiver.java:1509).

Wire layout:

- Op header: one msgpack frame ``[op_name, fields_dict]`` (length-prefixed via
  proto.rpc.send_frame).  ``fields["_trace"]`` resumes a client span
  server-side (Receiver.java:94-98 continueTraceSpan).
- Packet:    ``[u32 data_len][u64 seqno][u8 flags][u32 crc32c(data)]`` + data
  (the reference's PacketHeader: 64 KB default payload, crc per checksum chunk;
  here one crc32c per packet — checksum chunking for range reads lives in
  BlockMeta.checksums).
- Ack:       ``[u64 seqno][u8 status]`` per packet, status 0 = SUCCESS; for
  pipelines the ack aggregates downstream status (worst wins), the analog of
  PipelineAck.

Ops (Receiver.java:101-135 op dispatch analog): WRITE_BLOCK, READ_BLOCK,
TRANSFER_BLOCK, COPY_BLOCK, BLOCK_CHECKSUM — dispatched by the DataNode's
xceiver loop.

The port's one departure is in how a sender reads its acks: on a thread,
as they arrive (:class:`AckPump`, the DFSOutputStream ResponseProcessor
role), where the reference reads them after its last packet or at a
flush barrier.  The bytes on the wire are the same.  On a network stack
that charges each queued segment against the receive window, thousands
of unread 9-byte acks close the window and the stream crawls
(stream_probe.py).
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import Any, Iterator

from hdrf_tpu_torch import native
from hdrf_tpu_torch.proto.rpc import recv_exact, recv_frame, send_frame
from hdrf_tpu_torch.utils import retry, tracing

PKT_HDR = struct.Struct("<IQBI")
FLAG_LAST = 0x1
# hflush/hsync markers (DFSOutputStream.java:573 hflush / :580 hsync; the
# reference rides syncBlock on the packet header, PacketHeader.java): a
# FLUSH-flagged packet makes the receiver expose the prefix to readers
# (visible length) before acking; SYNC additionally fsyncs the replica.
FLAG_FLUSH = 0x2
FLAG_SYNC = 0x4

ACK = struct.Struct("<QB")
ACK_SUCCESS = 0
ACK_ERROR = 1
# Admission shed (utils/qos.py ShedError crossing the write wire): the DN
# refused the block AT ADMISSION — retryable, nothing was stored.  Shed
# acks repurpose the seqno field to carry the retry-after hint in
# MILLISECONDS (the 8-byte slot is wasted on a refusal; the reference's
# PipelineAck rides ECN/restart hints in spare header fields the same way).
ACK_SHED = 2

DEFAULT_PACKET = 64 * 1024

# Op names (DataTransferProtocol.java op codes)
WRITE_BLOCK = "write_block"
READ_BLOCK = "read_block"
TRANSFER_BLOCK = "transfer_block"
COPY_BLOCK = "copy_block"
BLOCK_CHECKSUM = "block_checksum"
# EC cold-tier stripe ops (server/ec_tier.py; DN-protocol trust — stripe
# ops never carry client bytes).  STRIPE_CODED_READ is the coded-exchange
# sibling of STRIPE_READ: the request carries a per-DN chain plan plus
# negotiation fields (``accept_enc`` — may the response ship LZ4'd payloads
# with per-item ``enc`` flags?), so a peer that predates the op simply
# books unknown_ops and answers nothing — the caller's recv fails and it
# falls back to plain STRIPE_READ legs, byte-identical results either way.
STRIPE_READ = "stripe_read"
STRIPE_WRITE = "stripe_write"
STRIPE_CODED_READ = "stripe_coded_read"


def secure_socket(sock: socket.socket, token: dict | None, encrypt: bool):
    """Wrap a freshly connected data socket with the AEAD record layer when
    encryption is on (security.client_handshake, keyed by the block token —
    the datatransfer/sasl analog).  Returns the socket to use for the op."""
    if not encrypt:
        return sock
    from hdrf_tpu_torch import security

    if not token or not token.get("sig"):
        raise PermissionError("data-transfer encryption requires block "
                              "tokens (dfs.block.access.token.enable)")
    return security.client_handshake(sock, token)


def send_op(sock: socket.socket, op: str, **fields: Any) -> None:
    tr = tracing.current_context()
    if tr is not None:
        fields["_trace"] = list(tr)
    # remaining deadline budget rides the op header beside _trace (the
    # receiving DN rebinds it around its handler — datanode._xceive)
    hdr = retry.remaining_header()
    if hdr is not None:
        fields[retry.DEADLINE_KEY] = hdr
    send_frame(sock, [op, fields])


def recv_op(sock: socket.socket) -> tuple[str, dict]:
    op, fields = recv_frame(sock)
    return op, fields


def write_packet(sock: socket.socket, seqno: int, data: bytes,
                 last: bool = False, flags: int = 0) -> None:
    flags |= FLAG_LAST if last else 0
    sock.sendall(PKT_HDR.pack(len(data), seqno, flags, native.crc32c(data)))
    if data:
        sock.sendall(data)


def read_packet_ex(sock: socket.socket) -> tuple[int, bytes, int]:
    """Returns (seqno, data, flags); raises IOError on checksum mismatch —
    the receiver-side verify the reference does per checksum chunk."""
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


def iter_packets_ex(sock: socket.socket) -> Iterator[tuple[int, bytes, int]]:
    """Flag-preserving packet run iterator (the write path needs FLUSH/SYNC
    markers; readers of whole runs use iter_packets)."""
    while True:
        seqno, data, flags = read_packet_ex(sock)
        yield seqno, data, flags
        if flags & FLAG_LAST:
            return


def send_ack(sock: socket.socket, seqno: int, status: int = ACK_SUCCESS) -> None:
    sock.sendall(ACK.pack(seqno, status))


def read_ack(sock: socket.socket) -> tuple[int, int]:
    seqno, status = ACK.unpack(recv_exact(sock, ACK.size))
    return seqno, status


class AckPump:
    """The acks of the packets sent on ``sock``, read on a thread as they
    arrive and handed out in order by ``read_ack`` with :func:`read_ack`'s
    results.  The thread reads only the acks announced by ``expect``, so
    a pipeline with none owed (a stream idle after an hflush) is left
    unread, as the reference leaves it, and the socket's timeout cannot
    fire there.  The first read error (a reset, EOF, a timeout while an
    ack is owed) is raised by that and every later ``read_ack``.
    ``close`` (or leaving the ``with`` block) ends the thread."""

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._owed = 0
        self._closed = False
        self._cv = threading.Condition()
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        threading.Thread(target=self._run, name="ack-pump",
                         daemon=True).start()

    def expect(self, n: int = 1) -> None:
        """``n`` more packets were (or are about to be) sent."""
        with self._cv:
            self._owed += n
            self._cv.notify()

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while not self._owed and not self._closed:
                        self._cv.wait()
                    if self._closed:
                        return
                    self._owed -= 1
                self._q.put(read_ack(self._sock))
        except (ConnectionError, OSError) as e:
            self._q.put(e)

    def read_ack(self) -> tuple[int, int]:
        item = self._q.get()
        if isinstance(item, BaseException):
            self._q.put(item)
            raise item
        return item

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()

    def __enter__(self) -> "AckPump":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stream_acked(sock: socket.socket, data: bytes,
                 packet_size: int = DEFAULT_PACKET) -> list[tuple[int, int]]:
    """:func:`stream_bytes` with the acks read as they come (an
    :class:`AckPump`); returns every packet's ack in order."""
    n = -(-len(data) // packet_size) + 1
    with AckPump(sock) as pump:
        pump.expect(n)
        stream_bytes(sock, data, packet_size)
        return [pump.read_ack() for _ in range(n)]


def stream_bytes(sock: socket.socket, data: bytes,
                 packet_size: int = DEFAULT_PACKET, base_seqno: int = 0,
                 throttle=None) -> int:
    """Packetize ``data`` onto the socket, ending with an empty LAST packet
    (the reference's zero-payload trailer that carries lastPacketInBlock).
    Returns the number of packets sent.  ``throttle(nbytes)`` is invoked
    before each packet when given (DataTransferThrottler's per-packet
    gating in BlockSender.sendPacket)."""
    seqno = base_seqno
    for off in range(0, len(data), packet_size):
        pkt = data[off:off + packet_size]
        if throttle is not None:
            throttle(len(pkt))
        write_packet(sock, seqno, pkt)
        seqno += 1
    write_packet(sock, seqno, b"", last=True)
    return seqno - base_seqno + 1


def fetch_block(addr: tuple, block_id: int, offset: int = 0,
                length: int = -1, timeout: float = 60,
                token: dict | None = None, encrypt: bool = False) -> bytes:
    """One-shot READ_BLOCK: connect, request [offset, offset+length), collect
    the packet run, length-check.  Shared by the EC degraded-read path
    (client/striped.py) and DN reconstruction fan-in (server/datanode.py)."""
    from hdrf_tpu_torch.proto.rpc import recv_frame

    sock = socket.create_connection(addr, timeout=timeout)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock = secure_socket(sock, token, encrypt)
        send_op(sock, READ_BLOCK, block_id=block_id, offset=offset,
                length=length, token=token)
        hdr = recv_frame(sock)
        if hdr["status"] != 0:
            if hdr.get("error") == "ShedError":
                from hdrf_tpu_torch.utils import qos

                raise qos.ShedError(
                    f"datanode shed: {hdr.get('message', '')}",
                    retry_after_s=float(hdr.get("retry_after_s") or 0.0))
            raise IOError(f"datanode error: {hdr['error']}: "
                          f"{hdr.get('message', '')}")
        data = collect_packets(sock)
        if len(data) != hdr["length"]:
            raise IOError(f"short read: {len(data)} != {hdr['length']}")
        return data
    finally:
        sock.close()


def collect_packets(sock: socket.socket, ack_sock: socket.socket | None = None,
                    on_packet=None) -> bytes:
    """Receive a full packet run; optionally ack each packet on ``ack_sock``
    and/or forward via ``on_packet(seqno, data, last)`` (mirroring hook)."""
    parts: list[bytes] = []
    for seqno, data, last in iter_packets(sock):
        parts.append(data)
        if on_packet is not None:
            on_packet(seqno, data, last)
        if ack_sock is not None:
            send_ack(ack_sock, seqno)
    return b"".join(parts)

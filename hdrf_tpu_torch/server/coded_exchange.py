"""Coded-exchange primitive: the background bulk-transfer plane (port of
hdrf_tpu/server/coded_exchange.py).

Every background bulk move the cluster makes — repair gather legs and
stripe pushes today (server/ec_tier.py:292 `_gather`, `_place`), rebalance
and compaction moves tomorrow — shares three needs the foreground data
path does not: the bytes are *derived* (recomputable, so aggressive coding
is safe), the links are otherwise idle (so compression compute is free),
and the traffic must NEVER shed a tenant (so it rides the QoS control
lane, not a tenant bucket).  This module is that shared seam, the
Compressed Coded Distributed Computing shape (arXiv 1805.01993; arXiv
1802.03049's coded shuffles) folded onto this repo's existing planes:

- ``pack_many`` / ``unpack`` — smaller-of LZ4 negotiation for exchange
  intermediates through the batched codec dispatch
  (ops/dispatch.py ``block_compress_batch``: the device LZ4 seal on the
  card's backend via ops/lz4_device.py ``compress_many``, the host codec
  elsewhere).  Each payload ships with an ``enc`` flag; raw wins ties,
  so a peer that never asked (``accept_enc`` absent) or an incompressible
  intermediate costs zero extra bytes — mixed versions stay
  byte-identical.
- :class:`CodedExchange` — the DN-side sender: binds the QoS control lane
  (utils/qos.py ``background()`` — admitted, audited, never shed), paces
  under the balance throttle (DataTransferThrottler.java:28 analog the
  balancer already owns), and books the exchange byte ledger.
- ``book_repair_wire`` — the ``repair_wire_ratio`` counter family in the
  ec registry (bytes-on-wire at the repairing owner / bytes rebuilt): the
  measured face of ROADMAP item 4's acceptance bar, shared by the live
  repair path and the bench harnesses so both stamp the same counters.

Total wire bytes across a partial-sum repair are conserved (k XOR
contributions exist somewhere); the win this plane measures is the
repairing OWNER's ingress — k×stripe_len drops to |missing|×stripe_len —
with the remainder spread over otherwise-idle holder->holder hops
(``coded_relay_bytes`` keeps that honest).
"""

from __future__ import annotations

import time

from hdrf_tpu_torch.ops import dispatch
from hdrf_tpu_torch.utils import fault_injection, metrics, qos

_M = metrics.registry("coded_exchange")
_EC = metrics.registry("ec")

# below this, LZ4 block framing can't win — don't even try the codec
_MIN_PACK = 64


def backend_for(red) -> str:
    """Codec backend for exchange intermediates: the reduction config's
    backend when it resolves to the card (compress_many batches there),
    the native host codec otherwise (``cpu`` included, as the reference's
    non-accelerator backends)."""
    b = dispatch.resolve_backend(getattr(red, "backend", "native"))
    return b if b == "cuda" else "native"


def pack_many(datas: list[bytes], backend: str = "native"
              ) -> list[tuple[bytes, int]]:
    """Smaller-of LZ4 negotiation for a batch of exchange intermediates.

    Returns ``[(payload, enc), ...]`` aligned with ``datas``: ``enc=1``
    payloads are LZ4 blocks strictly smaller than the raw bytes, ``enc=0``
    payloads ARE the raw bytes (ties and incompressible inputs ship raw,
    so negotiation can only save).  The whole batch compresses through ONE
    ``block_compress_batch`` dispatch — the card's ``compress_many`` when
    the backend is cuda, per the idle-accelerator premise of background
    work."""
    if not datas:
        return []
    datas = [bytes(d) for d in datas]
    candidates = [d for d in datas if len(d) >= _MIN_PACK]
    blobs: dict[int, bytes] = {}
    if candidates:
        if backend == "cuda" and len({len(d) for d in candidates}) != 1:
            backend = "native"  # compress_many batches equal lengths only
        packed = dispatch.block_compress_batch("lz4", candidates, backend)
        it = iter(packed)
        blobs = {i: next(it) for i, d in enumerate(datas)
                 if len(d) >= _MIN_PACK}
    out: list[tuple[bytes, int]] = []
    for i, raw in enumerate(datas):
        blob = blobs.get(i)
        if blob is not None and len(blob) < len(raw):
            out.append((blob, 1))
            _M.incr("packed_intermediates")
            _M.incr("pack_saved_bytes", len(raw) - len(blob))
        else:
            out.append((raw, 0))
            _M.incr("incompressible_intermediates")
    _M.incr("pack_raw_bytes", sum(len(d) for d in datas))
    _M.incr("pack_wire_bytes", sum(len(p) for p, _ in out))
    return out


def pack(data: bytes, backend: str = "native") -> tuple[bytes, int]:
    """Single-payload face of :func:`pack_many`."""
    return pack_many([data], backend)[0]


def unpack(payload: bytes, enc: int, usize: int) -> bytes:
    """Invert :func:`pack`: ``enc=0`` payloads are already the raw bytes;
    ``enc=1`` decodes through the host LZ4 oracle (byte-serial output
    dependence — see block_decompress_batch's rationale)."""
    if not enc:
        return bytes(payload)
    from hdrf_tpu_torch.utils import codec

    return codec.decompress("lz4", bytes(payload), int(usize))


def book_repair_wire(wire_bytes: int, rebuilt_bytes: int,
                     relay_bytes: int = 0) -> None:
    """Stamp the ec registry's repair wire ledger: cumulative
    bytes-on-wire at the repairing owner, bytes rebuilt, and the
    ``repair_wire_ratio`` gauge (wire / rebuilt — the classic full gather
    runs at ~k, the coded partial-sum path at ~1 before compression).
    Shared by the live repair path and the bench harnesses."""
    _EC.incr("repair_wire_bytes", int(wire_bytes))
    _EC.incr("repair_rebuilt_bytes", int(rebuilt_bytes))
    if relay_bytes:
        _EC.incr("coded_relay_bytes", int(relay_bytes))
    rebuilt = _EC.counter("repair_rebuilt_bytes")
    if rebuilt > 0:
        _EC.gauge("repair_wire_ratio",
                  _EC.counter("repair_wire_bytes") / rebuilt)


class CodedExchange:
    """DN-side exchange sender: control lane + throttle + byte ledger.

    ``send`` is one background peer exchange — admitted through the DN's
    QoS gate under :data:`qos.BACKGROUND_TENANT` (so the audit trail
    proves the lane and foreground tenants can never be shed or debited
    for it), paced by the balance throttle the NN already budgets, and
    counted in the coded_exchange registry."""

    def __init__(self, dn) -> None:
        self._dn = dn

    @property
    def compress_on(self) -> bool:
        red = self._dn.reduction_ctx.config
        return bool(getattr(red, "coded_exchange_compress", True))

    @property
    def backend(self) -> str:
        return backend_for(self._dn.reduction_ctx.config)

    def lane(self):
        """The background control-lane context (re-exported so callers
        that only schedule — the scrubber's decode checks — need not
        import qos themselves)."""
        return qos.background()

    def send(self, addr, op: str, nbytes: int, **fields) -> dict:
        """One throttled, control-lane peer exchange.  ``nbytes`` is the
        payload size to pace under the balance throttle: the push bytes
        for writes, the expected response bytes for gather-style reads
        (the link cost either way)."""
        dn = self._dn
        with qos.background():
            fault_injection.point("coded_exchange.send", dn_id=dn.dn_id,
                                  op=op, tenant=qos.current_tenant())
            dn.qos.admit(qos.current_tenant(), op)
            dn.balance_throttler.throttle(max(int(nbytes), 0))
            t0 = time.monotonic()
            resp = dn._peer_call(addr, op, **fields)
            _M.incr("exchange_ops")
            _M.incr("exchange_wire_bytes", max(int(nbytes), 0))
            _M.observe("exchange_us", (time.monotonic() - t0) * 1e6)
        return resp

"""A stand-in DataNode for driving ``EcTier`` without a DataNode.

``EcTier`` and ``CodedExchange`` read a fixed set of DataNode attributes
(hdrf_tpu/server/datanode.py:120-276): ``dn_id``, ``config.data_dir``,
``containers``, ``index``, ``reduction_ctx.config``, ``qos``,
``balance_throttler``, ``coded``, ``_nns`` and ``_peer_call``.  The
stand-in carries exactly those, for either package (``modules("port")``
or ``modules("ref")``), so both run the same topology on the same data.

A peer call goes over a ``socket.socketpair()``: the caller sends the op
header with the package's ``datatransfer.send_op``, a thread of the
target stand-in reads it with ``recv_op``, rebinds the ``_deadline``
header and serves it through its ``EcTier.serve_read`` /
``serve_write`` / ``serve_coded_read``, and the caller reads the reply
with the package's ``rpc.recv_frame`` -- each package's own wire codec.
"""

from __future__ import annotations

import os
import socket
import threading
from types import SimpleNamespace

# the DataNode default (hdrf_tpu/config.py balancer_bandwidth)
BALANCER_BANDWIDTH = 100 * 1024 * 1024
# the NameNode's RS(6,3) (ec_data_shards / ec_parity_shards)
EC_K, EC_M = 6, 3


def modules(kind: str) -> SimpleNamespace:
    """The modules a stand-in needs, from the port or the reference."""
    if kind == "port":
        from hdrf_tpu_torch.proto import datatransfer, rpc
        from hdrf_tpu_torch.server import coded_exchange, ec_tier
        from hdrf_tpu_torch.utils import qos, retry, throttler
    else:
        from hdrf_tpu.proto import datatransfer, rpc
        from hdrf_tpu.server import coded_exchange, ec_tier
        from hdrf_tpu.utils import qos, retry, throttler
    return SimpleNamespace(dt=datatransfer, rpc=rpc, ec_tier=ec_tier,
                           coded_exchange=coded_exchange, qos=qos,
                           retry=retry, throttler=throttler)


class StandInNN:
    """Records every ``call`` (the NameNode's ``stripe_complete``)."""

    def __init__(self) -> None:
        self.calls: list = []

    def call(self, method: str, **kw):
        self.calls.append((method, kw))
        return {"ok": True}


class StandInDN:
    def __init__(self, mods, dn_id: str, data_dir: str, containers, index,
                 red_config, cluster: dict, nns: list,
                 bandwidth: int = BALANCER_BANDWIDTH) -> None:
        self.mods = mods
        self.dn_id = dn_id
        self.addr = ("127.0.0.1", 20000 + len(cluster))
        self.config = SimpleNamespace(data_dir=data_dir)
        self.containers = containers
        self.index = index
        self.reduction_ctx = SimpleNamespace(config=red_config)
        self.qos = mods.qos.AdmissionController()
        self.balance_throttler = mods.throttler.Throttler(bandwidth)
        self._nns = nns
        self._cluster = cluster
        cluster[self.addr] = self
        self.ec = mods.ec_tier.EcTier(self)
        self.coded = mods.coded_exchange.CodedExchange(self)

    @property
    def target(self) -> list:
        return [self.dn_id, self.addr[0], self.addr[1]]

    def _peer_call(self, addr, op: str, **fields) -> dict:
        peer = self._cluster.get(tuple(addr))
        if peer is None:
            raise ConnectionRefusedError(f"no stand-in at {addr}")
        a, b = socket.socketpair()
        t = threading.Thread(target=peer._xceive, args=(b,), daemon=True)
        t.start()
        try:
            self.mods.dt.send_op(a, op, **fields)
            return self.mods.rpc.recv_frame(a)
        finally:
            a.close()
            t.join()

    def _xceive(self, sock) -> None:
        dt, retry = self.mods.dt, self.mods.retry
        try:
            op, fields = dt.recv_op(sock)
            with retry.bind_remaining(fields.pop(retry.DEADLINE_KEY, None)):
                if op == dt.STRIPE_READ:
                    self.ec.serve_read(sock, fields)
                elif op == dt.STRIPE_WRITE:
                    self.ec.serve_write(sock, fields)
                elif op == dt.STRIPE_CODED_READ:
                    self.ec.serve_coded_read(sock, fields)
        except (OSError, ConnectionError):
            pass
        finally:
            sock.close()


def cluster(mods, root: str, owner_containers, owner_index, red_config,
            peer_store, peer_index, n_peers: int = 2,
            bandwidth: int = BALANCER_BANDWIDTH):
    """(owner, peers, nn): the owner over the given store and index, and
    ``n_peers`` peers, each over an empty store and index of its own made
    by ``peer_store(dir)`` / ``peer_index(dir)``."""
    reg: dict = {}
    nn = StandInNN()
    owner = StandInDN(mods, "dn-owner", os.path.join(root, "owner"),
                      owner_containers, owner_index, red_config, reg, [nn],
                      bandwidth)
    peers = []
    for i in range(n_peers):
        d = os.path.join(root, f"peer{i + 1}")
        peers.append(StandInDN(
            mods, f"dn-p{i + 1}", d, peer_store(os.path.join(d, "containers")),
            peer_index(os.path.join(d, "index")), red_config, reg, [nn],
            bandwidth))
    return owner, peers, nn


def targets(owner, peers, k: int = EC_K, m: int = EC_M) -> list:
    """k + m stripe slots spread round-robin over the owner and peers:
    slot i on holder i mod (1 + len(peers))."""
    hs = [owner, *peers]
    return [hs[i % len(hs)].target for i in range(k + m)]

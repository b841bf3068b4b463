"""Block access tokens: the BlockTokenSecretManager analog (port of
hdrf_tpu/security.py, whole).

The reference gates DataNode ops with HMAC'd block tokens minted by the
NameNode and verified by DataNodes sharing a rolling secret
(security/token/block/BlockTokenSecretManager.java:112).  Same scheme
here:

- the NN keeps a current + previous key (rolled every ``roll_interval_s``;
  verification accepts both, so a roll never invalidates in-flight tokens);
- keys reach DNs in heartbeat responses (the reference ships them in
  ExportedBlockKeys via DatanodeProtocol);
- a token binds (block_id, modes, expiry) with HMAC-SHA256; clients receive
  tokens inside block locations / allocations and echo them in the
  data-transfer op header; DNs verify before serving.

Enabled by ``NameNodeConfig.block_tokens`` (off by default, like
``dfs.block.access.token.enable``).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import time

from hdrf_tpu_torch.utils import metrics

_M = metrics.registry("block_tokens")


def _sign(key: bytes, block_id: int, modes: str, expiry: int) -> bytes:
    msg = f"{block_id}:{modes}:{expiry}".encode()
    return hmac.new(key, msg, hashlib.sha256).digest()


class BlockTokenSecretManager:
    def __init__(self, lifetime_s: float = 600.0, roll_interval_s: float = 300.0):
        self.lifetime_s = lifetime_s
        self.roll_interval_s = roll_interval_s
        self._cur = os.urandom(32)
        self._prev = self._cur
        self._rolled = time.time()

    # ------------------------------------------------------------- NN side

    def maybe_roll(self) -> None:
        if time.time() - self._rolled >= self.roll_interval_s:
            self._prev, self._cur = self._cur, os.urandom(32)
            self._rolled = time.time()
            _M.incr("key_rolls")

    def keys(self) -> list[bytes]:
        """Exported keys for DN heartbeats (ExportedBlockKeys analog)."""
        return [self._cur, self._prev]

    def mint(self, block_id: int, modes: str = "r") -> dict:
        """Token for ``block_id`` allowing ``modes`` ('r', 'w', or 'rw')."""
        expiry = int(time.time() + self.lifetime_s)
        _M.incr("tokens_minted")
        return {"block_id": block_id, "modes": modes, "expiry": expiry,
                "sig": _sign(self._cur, block_id, modes, expiry)}

    # ------------------------------------------------------------- DN side


class BlockTokenVerifier:
    """DN-side verification against the NN-distributed key set."""

    def __init__(self):
        self._keys: list[bytes] = []

    def update_keys(self, keys: list[bytes]) -> None:
        self._keys = [bytes(k) for k in keys]

    @property
    def enabled(self) -> bool:
        return bool(self._keys)

    def mint(self, block_id: int, modes: str, lifetime_s: float = 600.0) -> dict | None:
        """DN-side minting for DN->DN transfer legs (the reference's DNs hold
        the same symmetric keys and mint transfer tokens the same way)."""
        if not self._keys:
            return None
        expiry = int(time.time() + lifetime_s)
        return {"block_id": block_id, "modes": modes, "expiry": expiry,
                "sig": _sign(self._keys[0], block_id, modes, expiry)}

    def verify(self, token: dict | None, block_id: int, mode: str) -> None:
        """Raise PermissionError unless ``token`` authorizes ``mode`` on
        ``block_id`` under a known key."""
        if not self.enabled:
            return  # tokens not enabled cluster-wide
        if token is None:
            _M.incr("tokens_missing")
            raise PermissionError(f"block token required for {mode} "
                                  f"on block {block_id}")
        try:
            ok = (int(token["block_id"]) == block_id
                  and mode in token["modes"]
                  and token["expiry"] >= time.time()
                  and any(hmac.compare_digest(
                      _sign(k, block_id, token["modes"], token["expiry"]),
                      bytes(token["sig"])) for k in self._keys))
        except (KeyError, TypeError, ValueError):
            ok = False
        if not ok:
            _M.incr("tokens_rejected")
            raise PermissionError(f"invalid block token for {mode} "
                                  f"on block {block_id}")
        _M.incr("tokens_verified")


# ---------------------------------------------------------------------------
# Data-transfer encryption (the datatransfer/sasl analog)
# ---------------------------------------------------------------------------
#
# The reference encrypts the block-data wire with SASL (DIGEST-MD5 privacy /
# AES via DataTransferSaslUtil), keyed by the block access token.  Same trust
# model here, modern construction: both ends hold the token's HMAC signature
# (the client got it from the NN inside the block locations; the DN recomputes
# it from the NN-distributed block keys), a two-nonce handshake proves both
# sides know it and derives per-direction ChaCha20-Poly1305 session keys
# (native/src/chacha20.cpp, RFC 8439), and every subsequent frame is an AEAD
# record with a counter nonce — tamper or replay fails the tag, not just a
# checksum.

HANDSHAKE_OP = "sasl_handshake"


def _hkdf(secret: bytes, *parts: bytes) -> bytes:
    msg = b"|".join(parts)
    return hmac.new(secret, msg, hashlib.sha256).digest()


def session_keys(secret: bytes, nonce_c: bytes, nonce_s: bytes):
    """(client->server key, server->client key, proof key) from the shared
    token secret + both nonces."""
    base = _hkdf(secret, b"hdrf-dt-v1", nonce_c, nonce_s)
    return (_hkdf(base, b"c2s"), _hkdf(base, b"s2c"), _hkdf(base, b"proof"))


def token_secret(token: dict) -> bytes:
    """The shared secret for a handshake: the token's HMAC signature."""
    return bytes(token["sig"])


class EncryptedSocket:
    """AEAD record layer over a connected socket.

    Implements the two calls the transport helpers use (``sendall`` and
    ``recv_into``), so proto/datatransfer.py and proto/rpc.py frame codecs
    compose unchanged.  Records: ``[u32 ct_len][ciphertext || tag]``; nonce =
    4-byte direction tag + 8-byte LE counter (never reused per key; replay or
    reordering fails the tag because the counter is the implicit AAD)."""

    _LEN = 4

    def __init__(self, sock, send_key: bytes, recv_key: bytes):
        self._sock = sock
        self._send_key = send_key
        self._recv_key = recv_key
        self._send_ctr = 0
        self._recv_ctr = 0
        self._rbuf = bytearray()

    @staticmethod
    def _nonce(direction: bytes, ctr: int) -> bytes:
        return direction + ctr.to_bytes(8, "little")

    def sendall(self, data: bytes) -> None:
        from hdrf_tpu_torch import native

        sealed = native.aead_seal(self._send_key,
                                  self._nonce(b"dtx\0", self._send_ctr),
                                  b"", bytes(data))
        self._send_ctr += 1
        self._sock.sendall(len(sealed).to_bytes(4, "little") + sealed)

    def _read_record(self) -> None:
        from hdrf_tpu_torch import native
        from hdrf_tpu_torch.proto.rpc import recv_exact

        ln = int.from_bytes(recv_exact(self._sock, 4), "little")
        if ln < 16 or ln > (64 << 20):
            raise IOError(f"bad encrypted record length {ln}")
        sealed = recv_exact(self._sock, ln)
        pt = native.aead_open(self._recv_key,
                              self._nonce(b"dtx\0", self._recv_ctr),
                              b"", sealed)
        if pt is None:
            raise IOError("encrypted record failed authentication")
        self._recv_ctr += 1
        self._rbuf += pt

    def recv_into(self, view, n: int) -> int:
        while not self._rbuf:
            self._read_record()
        take = min(n, len(self._rbuf))
        view[:take] = self._rbuf[:take]
        del self._rbuf[:take]
        return take

    def recv(self, n: int) -> bytes:
        while not self._rbuf:
            self._read_record()
        take = min(n, len(self._rbuf))
        out = bytes(self._rbuf[:take])
        del self._rbuf[:take]
        return out

    # pass-throughs so existing call sites keep working
    def setsockopt(self, *a) -> None:
        self._sock.setsockopt(*a)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def shutdown(self, how) -> None:
        self._sock.shutdown(how)

    def close(self) -> None:
        self._sock.close()


def client_handshake(sock, token: dict):
    """Negotiate encryption as the connecting side; returns EncryptedSocket.
    Order: client offers (token identity + nonce), server challenges with
    its nonce, client proves knowledge of the token secret FIRST (the server
    holds two rolled keys and picks whichever candidate secret matches),
    then the server proves its own knowledge.  The op frame and everything
    after it ride the encrypted channel."""
    from hdrf_tpu_torch.proto.rpc import recv_frame, send_frame

    nonce_c = os.urandom(16)
    pub = {k: token[k] for k in ("block_id", "modes", "expiry")}
    send_frame(sock, [HANDSHAKE_OP, {"token": pub, "nonce": nonce_c}])
    ch = recv_frame(sock)
    if ch.get("status") != 0:
        raise PermissionError(f"handshake rejected: {ch.get('message')}")
    nonce_s = bytes(ch["nonce"])
    k_c2s, k_s2c, k_proof = session_keys(token_secret(token),
                                         nonce_c, nonce_s)
    transcript = nonce_c + nonce_s
    send_frame(sock, {"proof": hmac.new(k_proof, transcript + b"c",
                                        hashlib.sha256).digest()})
    fin = recv_frame(sock)
    if fin.get("status") != 0:
        raise PermissionError(f"handshake rejected: {fin.get('message')}")
    if not hmac.compare_digest(bytes(fin["proof"]),
                               hmac.new(k_proof, transcript + b"s",
                                        hashlib.sha256).digest()):
        raise PermissionError("server failed handshake proof")
    _M.incr("handshakes_client")
    return EncryptedSocket(sock, k_c2s, k_s2c)


def server_handshake(sock, fields: dict, keys: list[bytes]):
    """DN side, called when the first op frame is HANDSHAKE_OP (``fields``
    already read).  The token secret is its HMAC signature, which this side
    re-derives from the NN-distributed block keys (current or previous —
    the client's proof selects which); a client that cannot produce the
    proof holds no valid token and is refused before any data moves.
    Returns (EncryptedSocket, token dict with recovered sig) — the next
    frame on the encrypted channel is the real op."""
    from hdrf_tpu_torch.proto.rpc import recv_frame, send_frame

    token = fields["token"]
    nonce_c = bytes(fields["nonce"])
    try:
        bid = int(token["block_id"])
        modes = token["modes"]
        expiry = int(token["expiry"])
    except (KeyError, TypeError, ValueError):
        send_frame(sock, {"status": 1, "message": "malformed token"})
        raise PermissionError("malformed token in handshake")
    if expiry < time.time():
        send_frame(sock, {"status": 1, "message": "expired token"})
        raise PermissionError("expired token in handshake")
    if not keys:
        send_frame(sock, {"status": 1, "message": "no block keys"})
        raise PermissionError("no block keys available for handshake")
    nonce_s = os.urandom(16)
    send_frame(sock, {"status": 0, "nonce": nonce_s})
    proof_c = bytes(recv_frame(sock)["proof"])
    transcript = nonce_c + nonce_s
    for k in keys:
        sig = _sign(k, bid, modes, expiry)
        k_c2s, k_s2c, k_proof = session_keys(sig, nonce_c, nonce_s)
        if hmac.compare_digest(proof_c,
                               hmac.new(k_proof, transcript + b"c",
                                        hashlib.sha256).digest()):
            send_frame(sock, {"status": 0,
                              "proof": hmac.new(k_proof, transcript + b"s",
                                                hashlib.sha256).digest()})
            _M.incr("handshakes_server")
            return (EncryptedSocket(sock, k_s2c, k_c2s),
                    {**token, "sig": sig})
    send_frame(sock, {"status": 1, "message": "bad proof"})
    _M.incr("handshakes_rejected")
    raise PermissionError("client failed handshake proof")


# ---------------------------------------------------------------------------
# Delegation tokens (security/token/delegation analog)
# ---------------------------------------------------------------------------


class DelegationTokenManager:
    """NN-side issue/renew/cancel/verify of delegation tokens
    (AbstractDelegationTokenSecretManager + DelegationTokenSecretManager).

    A token = identifier {owner, renewer, issue, max_date, seq, key_id} +
    password = HMAC(master_key, identifier).  Master keys roll; keys and
    token lifecycle events are JOURNALED by the NameNode (the reference
    persists DelegationKey and token ops in the edit log the same way), so
    a standby promoted mid-lifetime keeps verifying and renewing.  The
    Kerberos leg that bootstraps token issuance in the reference has no
    analog here — token issuance is open, the managed lifecycle is the
    capability re-expressed."""

    def __init__(self, renew_interval_s: float = 86400.0,
                 max_lifetime_s: float = 7 * 86400.0,
                 key_roll_s: float = 86400.0):
        self.renew_interval_s = renew_interval_s
        self.max_lifetime_s = max_lifetime_s
        self.key_roll_s = key_roll_s
        self._keys: dict[int, bytes] = {}
        self._key_times: dict[int, float] = {}
        self._next_key_id = 1
        self._next_seq = 1
        self._tokens: dict[int, dict] = {}  # seq -> {ident..., expiry}

    # -- journaled state transitions (called from NN._apply AND live path)

    def apply_key(self, key_id: int, key: bytes,
                  created: float = 0.0) -> None:
        self._keys[key_id] = bytes(key)
        self._key_times[key_id] = created
        self._next_key_id = max(self._next_key_id, key_id + 1)

    def apply_issue(self, ident: dict, expiry: float) -> None:
        self._tokens[ident["seq"]] = {**ident, "expiry": expiry}
        self._next_seq = max(self._next_seq, ident["seq"] + 1)

    def apply_renew(self, seq: int, expiry: float) -> None:
        if seq in self._tokens:
            self._tokens[seq]["expiry"] = expiry

    def apply_cancel(self, seq: int) -> None:
        self._tokens.pop(seq, None)

    def snapshot(self) -> dict:
        return {"keys": {i: k for i, k in self._keys.items()},
                "key_times": dict(self._key_times),
                "tokens": dict(self._tokens),
                "next_key_id": self._next_key_id,
                "next_seq": self._next_seq}

    def restore(self, snap: dict) -> None:
        self._keys = {int(i): bytes(k) for i, k in snap["keys"].items()}
        self._key_times = {int(i): float(t)
                           for i, t in snap.get("key_times", {}).items()}
        self._tokens = {int(s): dict(t) for s, t in snap["tokens"].items()}
        self._next_key_id = snap["next_key_id"]
        self._next_seq = snap["next_seq"]

    # -- live-path helpers (NN builds the records, journals, then applies)

    def need_key(self) -> tuple[int, bytes, float] | None:
        """(key_id, key, created) to journal when no master key exists or
        the newest one is due for a roll (the rolling DelegationKey — old
        keys stay until their tokens' max_date passes, so a roll never
        invalidates an outstanding token)."""
        if not self._keys or \
                time.time() - self._key_times.get(max(self._keys), 0) \
                >= self.key_roll_s:
            return self._next_key_id, os.urandom(32), time.time()
        return None

    def purge_expired(self) -> int:
        """Drop tokens past expiry and master keys no outstanding token can
        reference (ExpiredTokenRemover analog).  Purely in-memory and
        time-deterministic, so active and standby both run it without
        journal records; verification re-checks expiry anyway."""
        now = time.time()
        dead = [s for s, t in self._tokens.items() if t["expiry"] < now]
        for s in dead:
            del self._tokens[s]
        if self._keys:
            live_keys = {int(t["key_id"]) for t in self._tokens.values()}
            live_keys.add(max(self._keys))  # the signing key stays
            for kid in [k for k in self._keys if k not in live_keys]:
                del self._keys[kid]
                self._key_times.pop(kid, None)
        return len(dead)

    def build_identifier(self, owner: str, renewer: str) -> dict:
        now = time.time()
        return {"owner": owner, "renewer": renewer, "issue": now,
                "max_date": now + self.max_lifetime_s,
                "seq": self._next_seq, "key_id": max(self._keys)}

    def password(self, ident: dict) -> bytes:
        key = self._keys[int(ident["key_id"])]
        msg = (f"{ident['owner']}:{ident['renewer']}:{ident['issue']}:"
               f"{ident['max_date']}:{ident['seq']}:"
               f"{ident['key_id']}").encode()
        return hmac.new(key, msg, hashlib.sha256).digest()

    def verify(self, token: dict | None) -> str:
        """Returns the owner on success; raises PermissionError otherwise."""
        if token is None:
            raise PermissionError("delegation token required")
        try:
            ident = {k: token[k] for k in ("owner", "renewer", "issue",
                                           "max_date", "seq", "key_id")}
            live = self._tokens.get(int(token["seq"]))
            ok = (live is not None
                  and live["expiry"] >= time.time()
                  and int(token["key_id"]) in self._keys
                  and hmac.compare_digest(self.password(ident),
                                          bytes(token["password"])))
        except (KeyError, TypeError, ValueError):
            ok = False
        if not ok:
            _M.incr("dtokens_rejected")
            raise PermissionError("invalid or expired delegation token")
        return token["owner"]

    def check_renew(self, seq: int, renewer: str) -> float:
        """Validate a renewal and return the new expiry (to journal)."""
        t = self._tokens.get(int(seq))
        if t is None:
            raise PermissionError(f"unknown delegation token {seq}")
        if t["renewer"] != renewer:
            raise PermissionError(f"{renewer} may not renew token {seq}")
        return min(time.time() + self.renew_interval_s, t["max_date"])

    def check_cancel(self, seq: int, who: str) -> None:
        t = self._tokens.get(int(seq))
        if t is None:
            raise PermissionError(f"unknown delegation token {seq}")
        if who not in (t["owner"], t["renewer"]):
            raise PermissionError(f"{who} may not cancel token {seq}")

"""OAuth2 access-token providers for the WebHDFS-over-HTTP surface (port
of hdrf_tpu/client/oauth2.py, whole).

Re-expression of the reference's ``web/oauth2`` package —
``AccessTokenProvider.java:36`` (the provider abstraction + cache),
``ConfCredentialBasedAccessTokenProvider.java`` (client-credentials grant)
and ``ConfRefreshTokenBasedAccessTokenProvider.java`` (refresh-token grant),
``AccessTokenTimer.java`` (expiry tracking with a refresh margin) — over
urllib instead of OkHttp.  The provider hands back a bearer token the HTTP
client attaches as ``Authorization: Bearer <token>``; the gateway side
validates bearers via RFC 7662 token introspection (see
server/http_gateway.py) so a stub IdP can drive the whole path in tests.
"""

from __future__ import annotations

import json
import time
import urllib.parse
import urllib.request

# refresh this many seconds BEFORE expiry (AccessTokenTimer.EXPIRE_BUFFER_MS)
EXPIRE_BUFFER_S = 30.0


class AccessTokenProvider:
    """Caches an access token until shortly before expiry; subclasses
    implement ``_fetch() -> (token, expires_in_s)``."""

    def __init__(self) -> None:
        self._token: str | None = None
        self._expiry = 0.0

    def access_token(self) -> str:
        if self._token is None or time.time() >= self._expiry:
            token, ttl = self._fetch()
            self._token = token
            self._expiry = time.time() + max(ttl - EXPIRE_BUFFER_S, 1.0)
        return self._token

    def _fetch(self) -> tuple[str, float]:  # pragma: no cover - abstract
        raise NotImplementedError


def _token_request(url: str, form: dict) -> tuple[str, float]:
    body = urllib.parse.urlencode(form).encode()
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": "application/x-www-form-urlencoded"})
    with urllib.request.urlopen(req, timeout=30) as r:
        out = json.loads(r.read())
    if "access_token" not in out:
        raise PermissionError(f"IdP returned no access_token: {out}")
    return out["access_token"], float(out.get("expires_in", 3600))


class ConfCredentialBasedAccessTokenProvider(AccessTokenProvider):
    """client_credentials grant from configured id+secret
    (ConfCredentialBasedAccessTokenProvider.java)."""

    def __init__(self, token_url: str, client_id: str, client_secret: str):
        super().__init__()
        self._url = token_url
        self._id = client_id
        self._secret = client_secret

    def _fetch(self) -> tuple[str, float]:
        return _token_request(self._url, {
            "grant_type": "client_credentials",
            "client_id": self._id, "client_secret": self._secret})


class ConfRefreshTokenBasedAccessTokenProvider(AccessTokenProvider):
    """refresh_token grant from a configured long-lived refresh token
    (ConfRefreshTokenBasedAccessTokenProvider.java)."""

    def __init__(self, token_url: str, client_id: str, refresh_token: str):
        super().__init__()
        self._url = token_url
        self._id = client_id
        self._refresh = refresh_token

    def _fetch(self) -> tuple[str, float]:
        return _token_request(self._url, {
            "grant_type": "refresh_token",
            "client_id": self._id, "refresh_token": self._refresh})

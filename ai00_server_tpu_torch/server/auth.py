"""HS256 JWT for the admin routes, on the standard library (hmac, base64).

Port of ``ai00_server_tpu/server/auth.py``: the same header, claims
(``sid``, ``exp``) and byte-for-byte encoding, so each package reads the
other's tokens.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_dec(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _sign(signing: bytes, secret: str) -> bytes:
    return hmac.new(secret.encode(), signing, hashlib.sha256).digest()


def encode_jwt(claims: dict, secret: str) -> str:
    h = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"},
                           separators=(",", ":")).encode())
    p = _b64url(json.dumps(claims, separators=(",", ":")).encode())
    return f"{h}.{p}.{_b64url(_sign(f'{h}.{p}'.encode(), secret))}"


def decode_jwt(token: str, secret: str) -> dict | None:
    """The claims when the signature holds and ``exp`` has not passed,
    else None."""
    try:
        h, p, s = token.split(".")
        if not hmac.compare_digest(_sign(f"{h}.{p}".encode(), secret),
                                   _b64url_dec(s)):
            return None
        claims = json.loads(_b64url_dec(p))
        if "exp" in claims and time.time() > float(claims["exp"]):
            return None
        return claims
    except Exception:
        return None


def make_token(app_id: str, secret: str, expire_sec: int = 86400) -> str:
    return encode_jwt(
        {"sid": app_id, "exp": int(time.time()) + int(expire_sec)}, secret)

"""ACME (RFC 8555) http-01 client for automatic TLS certificates.

Port of ``ai00_server_tpu/server/acme.py``, on aiohttp and
``cryptography`` (imported inside the functions that sign, so the package
imports without it):

    directory -> newNonce -> newAccount (ES256 JWS) -> newOrder
    -> http-01 challenge (token served at /.well-known/acme-challenge/)
    -> finalize (CSR) -> certificate download

The account key, the domain key and the certificate persist under
``cert_dir``; a certificate with more than ``RENEW_DAYS`` left is reused
without asking the CA.  The challenge token is published in a
``ChallengeStore`` that the HTTP app serves (``challenge_routes``); the
caller binds port 80, or routes the well-known path, before
``ensure_certificate``.  The directory defaults to Let's Encrypt's.
"""

from __future__ import annotations

import base64
import binascii
import datetime
import json
import logging
import os

import aiohttp

log = logging.getLogger(__name__)

LETSENCRYPT = "https://acme-v02.api.letsencrypt.org/directory"
RENEW_DAYS = 30  # renew when fewer days than this remain


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64json(obj) -> str:
    return _b64(json.dumps(obj, separators=(",", ":"),
                           sort_keys=False).encode())


class ChallengeStore:
    """token -> key-authorization published at
    ``/.well-known/acme-challenge/<token>``."""

    def __init__(self):
        self.tokens: dict[str, str] = {}

    def put(self, token: str, key_auth: str) -> None:
        self.tokens[token] = key_auth

    def pop(self, token: str) -> None:
        self.tokens.pop(token, None)

    def get(self, token: str) -> str | None:
        return self.tokens.get(token)


class AcmeError(RuntimeError):
    pass


class AcmeClient:
    def __init__(self, domain: str, cert_dir: str,
                 directory_url: str = LETSENCRYPT,
                 challenges: ChallengeStore | None = None,
                 contact: str | None = None):
        self.domain = domain
        self.cert_dir = cert_dir
        self.directory_url = directory_url
        self.challenges = challenges if challenges is not None \
            else ChallengeStore()
        self.contact = contact
        self._dir = None
        self._nonce = None
        self._kid = None
        self._key = None  # account private key (EC P-256)

    # -- paths ----------------------------------------------------------
    @property
    def account_key_path(self):
        return os.path.join(self.cert_dir, "account.key.pem")

    @property
    def cert_path(self):
        return os.path.join(self.cert_dir, f"{self.domain}.cert.pem")

    @property
    def key_path(self):
        return os.path.join(self.cert_dir, f"{self.domain}.key.pem")

    # -- local state ----------------------------------------------------
    def current_cert_ok(self) -> bool:
        """True when a stored certificate for the domain has more than
        RENEW_DAYS of validity left."""
        try:
            from cryptography import x509

            with open(self.cert_path, "rb") as f:
                cert = x509.load_pem_x509_certificate(f.read())
            remaining = cert.not_valid_after_utc \
                - datetime.datetime.now(datetime.timezone.utc)
            return remaining > datetime.timedelta(days=RENEW_DAYS) \
                and os.path.exists(self.key_path)
        except (OSError, ValueError):
            return False

    def _load_account_key(self):
        from cryptography.hazmat.primitives import serialization
        from cryptography.hazmat.primitives.asymmetric import ec

        os.makedirs(self.cert_dir, exist_ok=True)
        if os.path.exists(self.account_key_path):
            with open(self.account_key_path, "rb") as f:
                self._key = serialization.load_pem_private_key(
                    f.read(), password=None)
        else:
            self._key = ec.generate_private_key(ec.SECP256R1())
            pem = self._key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption())
            with open(self.account_key_path, "wb") as f:
                os.fchmod(f.fileno(), 0o600)
                f.write(pem)

    def _jwk(self) -> dict:
        nums = self._key.public_key().public_numbers()
        return {
            "crv": "P-256", "kty": "EC",
            "x": _b64(nums.x.to_bytes(32, "big")),
            "y": _b64(nums.y.to_bytes(32, "big")),
        }

    def thumbprint(self) -> str:
        import hashlib

        # RFC 7638: SHA-256 over the lexicographically ordered JWK.
        jwk = json.dumps(self._jwk(), separators=(",", ":"), sort_keys=True)
        return _b64(hashlib.sha256(jwk.encode()).digest())

    def _sign(self, protected: str, payload: str) -> str:
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.hazmat.primitives.asymmetric.utils import (
            decode_dss_signature,
        )

        der = self._key.sign(f"{protected}.{payload}".encode(),
                             ec.ECDSA(hashes.SHA256()))
        r, s = decode_dss_signature(der)
        return _b64(r.to_bytes(32, "big") + s.to_bytes(32, "big"))

    # -- protocol -------------------------------------------------------
    async def _fetch_directory(self, session):
        async with session.get(self.directory_url) as resp:
            if resp.status != 200:
                raise AcmeError(f"directory fetch: HTTP {resp.status}")
            self._dir = await resp.json()

    async def _new_nonce(self, session):
        async with session.head(self._dir["newNonce"]) as resp:
            self._nonce = resp.headers.get("Replay-Nonce")
        if not self._nonce:
            raise AcmeError("no Replay-Nonce from newNonce")

    async def _post(self, session, url: str, payload, use_jwk=False):
        """Signed JWS POST (POST-as-GET when payload is None)."""
        if self._nonce is None:
            await self._new_nonce(session)
        protected = {"alg": "ES256", "nonce": self._nonce, "url": url}
        if use_jwk:
            protected["jwk"] = self._jwk()
        else:
            protected["kid"] = self._kid
        prot64 = _b64json(protected)
        pay64 = "" if payload is None else _b64json(payload)
        body = {"protected": prot64, "payload": pay64,
                "signature": self._sign(prot64, pay64)}
        async with session.post(
                url, json=body,
                headers={"Content-Type": "application/jose+json"}) as resp:
            self._nonce = resp.headers.get("Replay-Nonce", self._nonce)
            raw = await resp.read()
            if resp.status >= 400:
                raise AcmeError(f"{url}: HTTP {resp.status}: {raw[:300]!r}")
            ctype = resp.headers.get("Content-Type", "")
            data = json.loads(raw) if "json" in ctype else raw
            return resp, data

    async def _register(self, session):
        payload = {"termsOfServiceAgreed": True}
        if self.contact:
            payload["contact"] = [f"mailto:{self.contact}"]
        resp, _ = await self._post(session, self._dir["newAccount"],
                                   payload, use_jwk=True)
        self._kid = resp.headers.get("Location")
        if not self._kid:
            raise AcmeError("newAccount returned no Location (kid)")

    def _make_csr(self):
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.x509.oid import NameOID

        key = ec.generate_private_key(ec.SECP256R1())
        csr = x509.CertificateSigningRequestBuilder().subject_name(
            x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, self.domain)])
        ).add_extension(
            x509.SubjectAlternativeName([x509.DNSName(self.domain)]),
            critical=False,
        ).sign(key, hashes.SHA256())
        key_pem = key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())
        return csr.public_bytes(serialization.Encoding.DER), key_pem

    async def _poll(self, session, url: str, want: set[str],
                    tries: int = 30, delay: float = 1.0):
        import asyncio

        for _ in range(tries):
            _, obj = await self._post(session, url, None)
            status = obj.get("status")
            if status in want:
                return obj
            if status in ("invalid", "revoked", "deactivated"):
                raise AcmeError(f"{url}: status {status}: "
                                f"{json.dumps(obj)[:300]}")
            await asyncio.sleep(delay)
        raise AcmeError(f"{url}: poll timed out")

    async def ensure_certificate(self, force: bool = False,
                                 poll_delay: float = 1.0
                                 ) -> tuple[str, str]:
        """Obtain (or reuse) a certificate; returns (cert_path, key_path).

        The http-01 token is published in ``self.challenges`` for the
        duration of the order — the caller's HTTP app must serve it on
        port 80 of the domain."""
        if not force and self.current_cert_ok():
            log.info("acme: existing certificate for %s still valid",
                     self.domain)
            return self.cert_path, self.key_path
        self._load_account_key()
        async with aiohttp.ClientSession() as session:
            await self._fetch_directory(session)
            await self._register(session)
            resp, order = await self._post(
                session, self._dir["newOrder"],
                {"identifiers": [{"type": "dns", "value": self.domain}]})
            order_url = resp.headers.get("Location")
            finalize = order["finalize"]
            tokens: list[str] = []
            try:
                for authz_url in order["authorizations"]:
                    _, authz = await self._post(session, authz_url, None)
                    if authz.get("status") == "valid":
                        continue
                    chall = next(
                        c for c in authz["challenges"]
                        if c["type"] == "http-01")
                    token = chall["token"]
                    tokens.append(token)
                    key_auth = f"{token}.{self.thumbprint()}"
                    self.challenges.put(token, key_auth)
                    await self._post(session, chall["url"], {})
                    await self._poll(session, authz_url, {"valid"},
                                     delay=poll_delay)
                csr_der, key_pem = self._make_csr()
                _resp, order = await self._post(session, finalize,
                                                {"csr": _b64(csr_der)})
                if order.get("status") != "valid":
                    order = await self._poll(session, order_url, {"valid"},
                                             delay=poll_delay)
                cert_url = order["certificate"]
                _resp, cert_pem = await self._post(session, cert_url, None)
                if isinstance(cert_pem, (dict, list)):
                    raise AcmeError("certificate download returned JSON")
            finally:
                # Every published token is withdrawn — an order with
                # several authorizations must not leave earlier tokens
                # publicly served for the process lifetime.
                for token in tokens:
                    self.challenges.pop(token)
        with open(self.key_path, "wb") as f:
            os.fchmod(f.fileno(), 0o600)
            f.write(key_pem)
        with open(self.cert_path, "wb") as f:
            f.write(cert_pem if isinstance(cert_pem, bytes)
                    else cert_pem.encode())
        log.info("acme: obtained certificate for %s", self.domain)
        return self.cert_path, self.key_path


def challenge_routes(store: ChallengeStore):
    """aiohttp routes serving ``/.well-known/acme-challenge/<token>``."""
    from aiohttp import web

    async def handler(request: "web.Request"):
        key_auth = store.get(request.match_info["token"])
        if key_auth is None:
            raise web.HTTPNotFound()
        return web.Response(text=key_auth,
                            content_type="application/octet-stream")

    return [web.get("/.well-known/acme-challenge/{token}", handler)]

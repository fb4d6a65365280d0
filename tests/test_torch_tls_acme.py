"""TLS and ACME listeners of the port's ``main.py``, held offline.

The certificate authority is ``tests/test_acme.py``'s in-process mock
(RFC 8555 directory, account, order, http-01 check over real HTTP on
localhost, finalize, download).  No test reaches a real authority:

* the port's ``AcmeClient`` obtains a certificate from the mock, reuses
  it while it is fresh, and withdraws its challenge token;
* ``main._acme_renew_loop`` replaces a near-expiry certificate and loads
  it into the live ``SSLContext``;
* ``main.start_listeners`` with ``tls = true`` and a self-signed
  certificate answers ``/api/models/info`` over HTTPS on localhost, warns
  about ``quic``, and with ``acme = true`` for a domain serves the
  certificate the mock issued.
"""

import asyncio
import datetime
import logging
import socket
import ssl

import aiohttp
import pytest
from aiohttp import web
from aiohttp.test_utils import TestServer

from ai00_server_tpu_torch import main as tmain
from ai00_server_tpu_torch.server.acme import (AcmeClient, ChallengeStore,
                                               challenge_routes)
from ai00_server_tpu_torch.server.app import Server
from ai00_server_tpu_torch.server.config import Config
from ai00_server_tpu_torch.testing import cpu_test_threads

from test_acme import MockCA

cpu_test_threads()

DOMAIN = "example.test"


def _pem(cert) -> bytes:
    from cryptography.hazmat.primitives import serialization

    return cert.public_bytes(serialization.Encoding.PEM)


def self_signed(path, name="localhost", days=30, age=0):
    """A self-signed EC certificate for ``name`` (and 127.0.0.1) written as
    ``path/cert.pem`` and ``path/key.pem``; returns both paths."""
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    subject = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(subject).issuer_name(subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=age))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(x509.SubjectAlternativeName([
                x509.DNSName(name),
                x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
                critical=False)
            .sign(key, hashes.SHA256()))
    path.mkdir(parents=True, exist_ok=True)
    cert_path, key_path = path / "cert.pem", path / "key.pem"
    cert_path.write_bytes(_pem(cert))
    key_path.write_bytes(key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()))
    return str(cert_path), str(key_path)


async def _start_ca():
    """The mock CA and a challenge server over one ``ChallengeStore``."""
    ca = MockCA()
    ca_server = TestServer(ca.app())
    await ca_server.start_server()
    store = ChallengeStore()
    chal_app = web.Application()
    chal_app.add_routes(challenge_routes(store))
    chal_server = TestServer(chal_app)
    await chal_server.start_server()
    ca.challenge_port = chal_server.port
    return ca, ca_server, store, chal_server


def _directory(ca_server) -> str:
    return f"http://127.0.0.1:{ca_server.port}/directory"


def test_acme_client_obtains_and_reuses_a_certificate(tmp_path):
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization

    async def main():
        ca, ca_server, store, chal_server = await _start_ca()
        client = AcmeClient(DOMAIN, str(tmp_path),
                            directory_url=_directory(ca_server),
                            challenges=store, contact="ops@example.test")
        try:
            cert_path, key_path = await client.ensure_certificate(
                poll_delay=0.01)
            assert ca.validated_token is not None
            assert store.get("tok-123") is None  # withdrawn
            await ca_server.close()  # a fresh certificate needs no CA
            assert await client.ensure_certificate() == (cert_path,
                                                         key_path)
            assert client.current_cert_ok()
            return cert_path, key_path, ca
        finally:
            await chal_server.close()

    cert_path, key_path, ca = asyncio.run(main())
    with open(cert_path, "rb") as f:
        cert = x509.load_pem_x509_certificate(f.read())
    cert.verify_directly_issued_by(ca.root)
    san = cert.extensions.get_extension_for_class(
        x509.SubjectAlternativeName).value
    assert DOMAIN in san.get_values_for_type(x509.DNSName)
    with open(key_path, "rb") as f:
        key = serialization.load_pem_private_key(f.read(), None)
    assert key.public_key().public_numbers() == \
        cert.public_key().public_numbers()


def test_current_cert_ok_false_without_files(tmp_path):
    client = AcmeClient(DOMAIN, str(tmp_path),
                        directory_url="http://127.0.0.1:1/directory")
    assert not client.current_cert_ok()


def test_renew_loop_hot_swaps_a_near_expiry_certificate(tmp_path):
    from cryptography import x509

    async def main():
        ca, ca_server, store, chal_server = await _start_ca()
        client = AcmeClient(DOMAIN, str(tmp_path),
                            directory_url=_directory(ca_server),
                            challenges=store)
        seeded_cert, seeded_key = self_signed(tmp_path / "seed", DOMAIN,
                                              days=2, age=80)
        for src, dst in ((seeded_cert, client.cert_path),
                         (seeded_key, client.key_path)):
            with open(src, "rb") as f, open(dst, "wb") as g:
                g.write(f.read())
        assert not client.current_cert_ok()
        ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(client.cert_path, client.key_path)
        task = asyncio.ensure_future(tmain._acme_renew_loop(
            client, store, "127.0.0.1", ssl_ctx, interval=0.02,
            http_port=0))
        try:
            for _ in range(400):
                await asyncio.sleep(0.02)
                if client.current_cert_ok():
                    break
        finally:
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            await ca_server.close()
            await chal_server.close()
        return ca

    ca = asyncio.run(main())
    with open(AcmeClient(DOMAIN, str(tmp_path)).cert_path, "rb") as f:
        cert = x509.load_pem_x509_certificate(f.read())
    cert.verify_directly_issued_by(ca.root)


async def _https_info(port: int, cafile: str, hostname: str | None = None):
    ctx = ssl.create_default_context(cafile=cafile)
    async with aiohttp.ClientSession() as http:
        async with http.get(f"https://127.0.0.1:{port}/api/models/info",
                            ssl=ctx, server_hostname=hostname) as r:
            return r.status, await r.json()


def _listen(config: Config, **kw) -> Config:
    config.listen.ip = "127.0.0.1"
    for k, v in kw.items():
        setattr(config.listen, k, v)
    return config


def test_tls_listener_answers_over_https(tmp_path, caplog):
    """``tls = true``, a self-signed certificate, ``quic = true`` (warned
    about; HTTP/1.1 over TLS served)."""
    cert, key = self_signed(tmp_path / "certs")
    config = _listen(Config(), tls=True, tls_cert=cert, tls_key=key,
                     quic=True)

    async def main():
        server = Server(config, device="cpu")
        runner, ssl_ctx, tasks = await tmain.start_listeners(
            server, config, "127.0.0.1", 0)
        try:
            assert ssl_ctx is not None and tasks == []
            port = runner.addresses[0][1]
            got = await _https_info(port, cert, "localhost")
            with pytest.raises(aiohttp.ClientError):
                async with aiohttp.ClientSession() as http:
                    await http.get(f"http://127.0.0.1:{port}/api/models/info")
            return got
        finally:
            await runner.cleanup()

    with caplog.at_level(logging.WARNING, logger="ai00_server_tpu_torch"):
        assert asyncio.run(main()) == (200, {"state": "none"})
    assert any("QUIC" in r.getMessage() for r in caplog.records)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_acme_listener_serves_the_issued_certificate(tmp_path):
    """``domain = "example.test"``, ``acme = true`` against the mock: the
    http-01 token is answered on ``http_port`` during the order, the
    listener serves the issued certificate (verified against the mock's
    root for the domain), the renewal loop runs beside it and the app also
    routes the challenge path."""
    async def main():
        ca = MockCA()
        ca_server = TestServer(ca.app())
        await ca_server.start_server()
        http_port = _free_port()
        ca.challenge_port = http_port
        root_pem = tmp_path / "root.pem"
        root_pem.write_bytes(_pem(ca.root))
        config = _listen(
            Config(), domain=DOMAIN, acme=True,
            acme_directory=_directory(ca_server),
            tls_cert=str(tmp_path / "certs" / "cert.pem"),
            tls_key=str(tmp_path / "certs" / "key.pem"))
        server = Server(config, device="cpu")
        runner, ssl_ctx, tasks = await tmain.start_listeners(
            server, config, "127.0.0.1", 0, http_port=http_port)
        try:
            assert ca.validated_token is not None and len(tasks) == 1
            assert not tasks[0].done()
            routes = {r.resource.canonical for r in server.app.router.routes()}
            assert "/.well-known/acme-challenge/{token}" in routes
            return await _https_info(runner.addresses[0][1], str(root_pem),
                                     DOMAIN)
        finally:
            for task in tasks:
                task.cancel()
            await runner.cleanup()
            await ca_server.close()

    assert asyncio.run(main()) == (200, {"state": "none"})
    assert (tmp_path / "certs" / f"{DOMAIN}.cert.pem").exists()

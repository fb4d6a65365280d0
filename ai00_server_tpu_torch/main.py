"""Server entry point.

Port of ``ai00_server_tpu/main.py``.  Usage::

    python -m ai00_server_tpu_torch.main --config assets/configs/Config.toml \
        [--ip 0.0.0.0] [--port 65530] [--device cuda|cpu]

The model named in ``[model]`` loads in the background while the HTTP
endpoints come up.  ``--device`` defaults to ``cuda`` and raises without a
usable card; ``cpu`` runs the plain versions of the kernels.  An ``[embed]``
section loads the external encoder behind ``/api/oai/embeds``
(``server/embed.py``) onto the same device.  A ``[web]`` zip is extracted
beside itself (``_webui/``, with the ``plugins/*.zip`` beside it under
``_webui/plugins/<name>/``) and served at ``/``.

Listeners (``start_listeners``): a ``domain`` other than ``"local"`` forces
TLS from ``tls_cert`` / ``tls_key``; with ``acme`` the certificate comes
from the ACME directory (``server/acme.py``, the http-01 token answered on
port 80 for the order) and is renewed in the background into the live
``SSLContext``; a failed order falls back to the configured files.  HTTP/3
(``quic``) is not served: it draws a warning.  An IPv6 address that is not
the wildcard also binds ``0.0.0.0``.

The JAX entry point enables XLA's persistent compile cache here.  The
port's counterpart needs no switch: ``nvcc`` builds each kernel source once
into ``ai00_server_tpu_torch/_build/`` (``ops/_build.py``, keyed by a hash
of the sources and flags), and a restart loads the libraries from there.
"""

from __future__ import annotations

import argparse
import asyncio
import ipaddress
import logging
import os
import ssl
import sys

from aiohttp import web

log = logging.getLogger("ai00_server_tpu_torch")


def parse_args(argv=None):
    p = argparse.ArgumentParser("ai00_server_tpu_torch")
    p.add_argument("--config", "-c", default="assets/configs/Config.toml")
    p.add_argument("--ip", default=None)
    p.add_argument("--port", "-p", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


async def amain(argv=None):
    args = parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")

    from .server.app import Server
    from .server.config import Config

    if os.path.exists(args.config):
        config = Config.from_toml(args.config)
    else:
        log.warning("config %s not found; using defaults", args.config)
        config = Config()

    server = Server(config, device=args.device)

    async def autoload():
        try:
            await server.middleware.reload(config.to_reload_request())
            log.info("model loaded: %s",
                     server.middleware.env.reload.model_path)
        except Exception:
            log.exception("initial model load failed")

    load_task = (asyncio.get_event_loop().create_task(autoload())
                 if config.model.get("name") else None)

    if config.embed:
        from .server import embed as embed_mod

        try:
            server.embedder = await embed_mod.load_embedder(
                config.embed, device=server.middleware.device)
        except Exception:
            log.exception("[embed] configured but the encoder failed to "
                          "load; /api/oai/embeds answers 400")
        else:
            if server.embedder is not None:
                log.info("external embedding model loaded: %s",
                         server.embedder.name)

    setup_webui(server, config)
    ip = args.ip or config.listen.ip
    port = args.port or config.listen.port
    runner, _ssl_ctx, tasks = await start_listeners(server, config, ip, port)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        for task in tasks + ([load_task] if load_task else []):
            task.cancel()
        await server.middleware.unload()
        await runner.cleanup()


def setup_webui(server, config) -> None:
    """Extract a configured ``[web]`` zip (over 1 KB) and its plugins and
    serve them: ``GET /`` the zip's ``index.html``, every other file at its
    path.  Call before the app starts."""
    from .server import files as files_mod

    zip_path = (config.web or {}).get("path")
    if not zip_path or not os.path.exists(zip_path) \
            or os.path.getsize(zip_path) <= 1024:
        return
    target = os.path.join(os.path.dirname(zip_path), "_webui")
    try:
        files_mod.unzip(zip_path, target)
        load_plugins(os.path.join(os.path.dirname(zip_path), "plugins"),
                     target)
        server.app.router.add_static("/", target, show_index=True)
    except Exception:
        log.exception("webui extraction failed")
        return
    server.web_root = target


async def start_listeners(server, config, ip: str, port: int,
                          http_port: int = 80):
    """Start ``server.app`` on ``ip:port`` as ``config.listen`` says (TLS,
    ACME, dual stack; see the module docstring).  Returns the runner, the
    ``SSLContext`` (None for plain HTTP) and the background tasks (the
    ACME renewal) for the caller to cancel."""
    listen = config.listen
    acme = listen.acme and listen.domain != "local"
    tls = listen.tls or listen.domain != "local"
    if listen.quic:
        log.warning("listen.quic = true, but HTTP/3 (QUIC) is not served: "
                    "HTTP/1.1 over TCP%s only", "+TLS" if tls else "")
    elif tls:
        log.info("the TLS listener serves HTTP/1.1 over TCP only (no "
                 "HTTP/3)")
    cert_file, key_file = listen.tls_cert, listen.tls_key
    client = store = None
    if acme:
        from .server import acme as acme_mod

        store = acme_mod.ChallengeStore()
        server.app.add_routes(acme_mod.challenge_routes(store))
        client = acme_mod.AcmeClient(
            listen.domain,
            cert_dir=os.path.dirname(cert_file) or "assets/certs",
            directory_url=listen.acme_directory or acme_mod.LETSENCRYPT,
            challenges=store, contact=listen.acme_contact or None)
        try:
            cert_file, key_file = await _acme_obtain(client, store, ip,
                                                     http_port)
        except Exception:
            log.exception("acme: certificate provisioning failed; falling "
                          "back to the configured files %s / %s",
                          cert_file, key_file)

    ssl_ctx, tasks = None, []
    if tls:
        ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(cert_file, key_file)
        if acme:
            tasks.append(asyncio.ensure_future(_acme_renew_loop(
                client, store, ip, ssl_ctx, http_port=http_port)))

    runner = web.AppRunner(server.app)
    await runner.setup()
    binds = [ip]
    try:
        addr = ipaddress.ip_address(ip)
        if addr.version == 6 and not addr.is_unspecified:
            binds.append("0.0.0.0")
    except ValueError:
        pass  # a host name: the resolver decides
    for host in binds:
        await web.TCPSite(runner, host, port, ssl_context=ssl_ctx).start()
    log.info("serving on %s://%s:%d (docs at /api-docs)",
             "https" if ssl_ctx else "http", ip, port)
    return runner, ssl_ctx, tasks


async def _acme_obtain(client, store, ip, http_port: int = 80):
    """One certificate order, with a plain-HTTP responder on ``http_port``
    for the CA's http-01 fetch while it runs."""
    from .server import acme as acme_mod

    http80 = web.Application()
    http80.add_routes(acme_mod.challenge_routes(store))
    runner80 = web.AppRunner(http80)
    await runner80.setup()
    try:
        try:
            await web.TCPSite(runner80, ip, http_port).start()
        except OSError as e:
            log.warning("acme: cannot bind :%d for http-01 (%s); relying "
                        "on an external route to /.well-known/"
                        "acme-challenge/", http_port, e)
        return await client.ensure_certificate()
    finally:
        await runner80.cleanup()


async def _acme_renew_loop(client, store, ip, ssl_ctx,
                           interval: float = 12 * 3600,
                           http_port: int = 80) -> None:
    """Every ``interval`` seconds: once fewer than ``acme.RENEW_DAYS``
    remain, order again and load the new chain into the live ``ssl_ctx``
    (new handshakes take it; no restart)."""
    while True:
        await asyncio.sleep(interval)
        try:
            if client.current_cert_ok():
                continue
            cert_file, key_file = await _acme_obtain(client, store, ip,
                                                     http_port)
            ssl_ctx.load_cert_chain(cert_file, key_file)
            log.info("acme: certificate renewed for %s", client.domain)
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("acme: renewal failed; retrying in %.0f s",
                          interval)


def load_plugins(plugins_dir: str, target: str) -> None:
    """Extract every ``<plugins_dir>/*.zip`` but ``api.zip`` into
    ``<target>/plugins/<stem>/``."""
    from .server import files as files_mod

    if not os.path.isdir(plugins_dir):
        return
    for entry in sorted(os.listdir(plugins_dir)):
        stem, ext = os.path.splitext(entry)
        if ext != ".zip" or stem == "api":
            continue
        dst = os.path.join(target, "plugins", stem)
        try:
            files_mod.unzip(os.path.join(plugins_dir, entry), dst)
            log.info("loaded plugin %s", stem)
        except Exception:
            log.exception("failed to load plugin %s", stem)


def main(argv=None):
    try:
        asyncio.run(amain(argv))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])

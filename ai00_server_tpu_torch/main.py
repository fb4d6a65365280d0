"""Server entry point.

Port of ``ai00_server_tpu/main.py``.  Usage::

    python -m ai00_server_tpu_torch.main --config assets/configs/Config.toml \
        [--ip 0.0.0.0] [--port 65530] [--device cuda|cpu]

The model named in ``[model]`` loads in the background while the HTTP
endpoints come up.  ``--device`` defaults to ``cuda`` and raises without a
usable card; ``cpu`` runs the plain versions of the kernels.  An ``[embed]``
section loads the external encoder behind ``/api/oai/embeds``
(``server/embed.py``) onto the same device.  TLS, ACME and the WebUI are
the ROADMAP "admin, profile and file routes" item.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
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
    if config.listen.tls or config.listen.acme \
            or config.listen.domain != "local":
        raise NotImplementedError(
            "TLS/ACME listeners are the ROADMAP 'admin, profile and file "
            "routes' item; serve with domain = \"local\"")

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

    ip = args.ip or config.listen.ip
    port = args.port or config.listen.port
    runner = web.AppRunner(server.app)
    await runner.setup()
    await web.TCPSite(runner, ip, port).start()
    log.info("serving on http://%s:%d", ip, port)
    try:
        while True:
            await asyncio.sleep(3600)
    finally:
        if load_task is not None and not load_task.done():
            load_task.cancel()
        await server.middleware.unload()
        await runner.cleanup()


def main(argv=None):
    try:
        asyncio.run(amain(argv))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])

"""HTTP server shell with lifetime-guard shutdown.

Mirrors src/httpserver.rs: bind (port 0 supported), serve the router,
and expose a guard whose release gracefully stops the server (the
reference returns a size-1 channel sender whose drop triggers a Notify →
graceful shutdown, httpserver.rs:25-46).  Here the guard is the
`HttpServer` object itself: `close()` (or leaving the async context)
shuts the listener down.
"""

from __future__ import annotations

import asyncio
import logging

from aiohttp import web

from ..engine.engine import EngineHandle
from .routes import build_app

log = logging.getLogger("vst.httpserver")


class HttpServer:
    def __init__(self, runner: web.AppRunner, host: str, port: int) -> None:
        self._runner = runner
        self.host = host
        self.port = port
        self._closed = False

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            await self._runner.cleanup()

    async def __aenter__(self) -> "HttpServer":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()


async def serve(addr: str, engine: EngineHandle) -> HttpServer:
    """Bind and serve; returns the running server (actual port resolved
    when binding :0, like the reference's returned SocketAddr,
    httpserver.rs:18-49)."""
    host, _, port_s = addr.rpartition(":")
    app = build_app(engine)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host or "127.0.0.1", int(port_s or 0))
    await site.start()
    port = runner.addresses[0][1]
    log.info("http server listening on %s:%s", host, port)
    return HttpServer(runner, host or "127.0.0.1", port)


async def wait_for_shutdown() -> None:
    """Block until SIGINT/SIGTERM (reference: lib.rs:279-295)."""
    import signal

    loop = asyncio.get_running_loop()
    event = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, event.set)
    await event.wait()

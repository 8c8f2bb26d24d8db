"""Service entry point — `python -m vector_store_tpu_torch --device cuda`.

Loads .env, initialises logging, runs engine + HTTP server on the given
torch device and waits for SIGINT/SIGTERM.
"""

from __future__ import annotations

import argparse
import asyncio
import logging

from .config import Config, load_dotenv

from . import new_index_factory, run, wait_for_shutdown


async def main() -> None:
    load_dotenv()
    cfg = Config()
    parser = argparse.ArgumentParser("vector_store_tpu_torch")
    parser.add_argument("--addr", default=cfg.http_addr, help="host:port to bind")
    parser.add_argument(
        "--device", default="cuda", help="torch device holding the indexes"
    )
    args = parser.parse_args()

    logging.basicConfig(
        level=cfg.log_level,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    server, engine = await run(
        args.addr,
        new_index_factory(
            max_batch=cfg.max_batch,
            window_s=cfg.batch_window_ms / 1000.0,
            device=args.device,
        ),
    )
    print(f"listening on http://{server.addr}", flush=True)
    try:
        await wait_for_shutdown()
    finally:
        await server.close()
        await engine.close()


if __name__ == "__main__":
    asyncio.run(main())

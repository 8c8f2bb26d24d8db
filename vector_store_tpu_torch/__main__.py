"""Service entry point — `python -m vector_store_tpu_torch --device cuda`.

Loads .env, initialises logging, runs engine + HTTP server on the given
torch device (`--n-devices N` shards every index over the first N cards,
0 over all of them) and waits for SIGINT/SIGTERM.  Optionally starts the
ingestion monitors against a source (the MemDb demo source with --demo; a
real CDC source would plug in here).  The demo source holds one table of
64 seeded 8-d rows and the index `demo.items` over it (the JAX package's
demo source starts empty), so the monitors have something to create and
fill: GET /api/v1/indexes lists it and .../demo/items/count reaches 64.
"""

from __future__ import annotations

import argparse
import asyncio
import logging

from .config import Config, load_dotenv

from . import new_index_factory, run, wait_for_shutdown


DEMO_INDEX, DEMO_ROWS, DEMO_DIMS = "demo.items", 64, 8


def demo_source():
    """A MemDb with one small table and one index over it."""
    import numpy as np

    from .ingest import MemDb

    db = MemDb()
    db.add_table("items", ("id",), DEMO_DIMS)
    rows = np.random.default_rng(0).standard_normal((DEMO_ROWS, DEMO_DIMS), dtype=np.float32)
    db.preload("items", [(i,) for i in range(DEMO_ROWS)], rows)
    db.add_index(DEMO_INDEX, "items")
    return db


async def main() -> None:
    load_dotenv()
    cfg = Config()
    parser = argparse.ArgumentParser("vector_store_tpu_torch")
    parser.add_argument("--addr", default=cfg.http_addr, help="host:port to bind")
    parser.add_argument(
        "--device", default="cuda", help="torch device holding the indexes"
    )
    parser.add_argument(
        "--n-devices",
        type=int,
        default=cfg.n_devices,
        help="devices to shard indexes over (1=one device, 0=all visible)",
    )
    parser.add_argument(
        "--demo",
        action="store_true",
        help="attach an in-memory demo DB source with the ingestion monitors",
    )
    args = parser.parse_args()

    logging.basicConfig(
        level=cfg.log_level,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    from .shard.mesh import make_mesh

    # 0 = every visible card; a count above the visible cards fails here
    n_devices = args.n_devices
    if n_devices != 1:
        n_devices = len(make_mesh(n_devices, args.device))
    server, engine = await run(
        args.addr,
        new_index_factory(
            max_batch=cfg.max_batch,
            window_s=cfg.batch_window_ms / 1000.0,
            device=args.device,
            n_devices=n_devices,
        ),
    )
    print(f"listening on http://{server.addr}  (swagger: /swagger-ui)", flush=True)

    monitor = None
    if args.demo:
        from .ingest import MonitorIndexes

        monitor = MonitorIndexes(demo_source(), engine)
        monitor.spawn()

    try:
        await wait_for_shutdown()
    finally:
        if monitor is not None:
            await monitor.stop()
        await server.close()
        await engine.close()


if __name__ == "__main__":
    asyncio.run(main())

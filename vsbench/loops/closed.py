"""The closed loop: `clients` clients, each sending its next request when
the previous one has been answered.

Its traffic parameter is `clients`, the number of clients sending at once.
Each client draws its queries uniformly from the pool with a generator of
its own, seeded from the run's seed and the client's number.
"""

from __future__ import annotations

import asyncio
import random
import time

from ..loop import Gate, Records


def check(traffic: dict) -> None:
    if int(traffic["clients"]) < 1:
        raise ValueError("traffic clients must be at least 1")


async def _client(ask, pool: int, rng: random.Random, out: Records, gate: Gate,
                  t_end: float | None, rounds: int | None) -> None:
    sent = 0
    while rounds is None or sent < rounds:
        await gate.wait_open()
        now = time.perf_counter()
        if t_end is not None and now >= t_end:
            return
        qi = rng.randrange(pool)
        i = out.open(now, qi)
        sent += 1
        gate.sent()
        try:
            answer = await ask(qi)
        except Exception as exc:  # noqa: BLE001 -- a failed request is recorded, not raised
            answer = exc
        finally:
            gate.answered()
        out.close(i, answer, time.perf_counter())


def start(ask, traffic: dict, seed: int, out: Records, gate: Gate, t_end: float | None = None,
          rounds: int | None = None) -> list[asyncio.Task]:
    """Start the clients; each stops at `t_end` (perf_counter seconds) or
    after `rounds` requests, and waits while `gate` holds.  Every request is
    recorded in `out`.  Returns the client tasks."""
    loop = asyncio.get_running_loop()
    pool = int(traffic["pool"])
    return [
        loop.create_task(
            _client(ask, pool, random.Random(int(seed) * 65_537 + c), out, gate, t_end, rounds),
            name=f"client-{c}",
        )
        for c in range(int(traffic["clients"]))
    ]

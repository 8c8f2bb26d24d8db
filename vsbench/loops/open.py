"""The open loop: requests arrive at a rate of their own, whatever the answers
do, each sent by a task of its own.

Traffic parameters:

    rate     mean arrivals a second (Poisson: exponential gaps drawn from a
             generator seeded from the run's seed)
    burst    optional {"every_s": p, "for_s": d, "times": f}: for the first
             d seconds of every p seconds the rate is f times `rate`

In set-up (`rounds` given) a round is one second of arrivals at the same
rate, so the warm-up meets the batch sizes the window will see.  While the
gate holds, arrivals wait and are sent when it opens.
"""

from __future__ import annotations

import asyncio
import random
import time

from ..loop import Gate, Records


def check(traffic: dict) -> None:
    if float(traffic["rate"]) <= 0:
        raise ValueError("traffic rate must be above 0")
    burst = traffic.get("burst")
    if burst is not None:
        if not 0 < float(burst["for_s"]) < float(burst["every_s"]) or float(burst["times"]) <= 0:
            raise ValueError("traffic burst needs 0 < for_s < every_s and times > 0")


def _rate(traffic: dict, since_start: float) -> float:
    rate = float(traffic["rate"])
    burst = traffic.get("burst")
    if burst and since_start % float(burst["every_s"]) < float(burst["for_s"]):
        rate *= float(burst["times"])
    return rate


async def _one(ask, qi: int, out: Records, gate: Gate) -> None:
    i = out.open(time.perf_counter(), qi)
    gate.sent()
    try:
        answer = await ask(qi)
    except Exception as exc:  # noqa: BLE001 -- a failed request is recorded, not raised
        answer = exc
    finally:
        gate.answered()
    out.close(i, answer, time.perf_counter())


async def _arrivals(ask, traffic: dict, seed: int, out: Records, gate: Gate,
                    t_end: float | None, rounds: int | None) -> None:
    rng = random.Random(int(seed) * 65_537 + 1)
    pool = int(traffic["pool"])
    start = time.perf_counter()
    stop = start + rounds if rounds is not None else t_end
    due = start + rng.expovariate(_rate(traffic, 0.0))
    sent: set[asyncio.Task] = set()
    loop = asyncio.get_running_loop()
    try:
        while due < stop:
            await asyncio.sleep(max(0.0, due - time.perf_counter()))
            await gate.wait_open()
            # every arrival due by now, in one wake-up
            now = time.perf_counter()
            while due <= now and due < stop:
                task = loop.create_task(_one(ask, rng.randrange(pool), out, gate))
                sent.add(task)
                task.add_done_callback(sent.discard)
                due += rng.expovariate(_rate(traffic, due - start))
        if sent:
            await asyncio.gather(*sent)
    except asyncio.CancelledError:
        for task in sent:
            task.cancel()
        await asyncio.gather(*sent, return_exceptions=True)
        raise


def start(ask, traffic: dict, seed: int, out: Records, gate: Gate, t_end: float | None = None,
          rounds: int | None = None) -> list[asyncio.Task]:
    """Start the arrivals; they stop at `t_end` (perf_counter seconds) or
    after `rounds` seconds.  The one task returned ends when every request
    sent has been answered.  Every request is recorded in `out`."""
    return [asyncio.get_running_loop().create_task(
        _arrivals(ask, traffic, seed, out, gate, t_end, rounds), name="arrivals")]

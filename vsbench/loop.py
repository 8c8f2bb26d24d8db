"""What every traffic loop shares: the gate, the records, the wait at the
end, and the lookup of a loop kind by name.

A traffic file (vsbench/traffic/<name>.json) names its loop kind under
"loop"; the kind is the module vsbench/loops/<loop>.py, found by that
name.  A loop module has

    check(traffic)      raises ValueError where the traffic's parameters
                        do not suit the loop
    start(ask, traffic, seed, out, gate, t_end=None, rounds=None)
                        starts the clients on the running event loop and
                        returns their tasks; each client stops at t_end
                        (perf_counter seconds) or after `rounds` requests,
                        waits while `gate` holds, and records every
                        request in `out`

Every traffic file also gives `limit` (k of every request), `pool` (number
of distinct queries drawn from) and `warmup_rounds` (requests each client
sends during set-up); the loop kind's own parameters are its module's to
read, and the queries' own (the vector corpus's `query_noise`) the
configuration's corpus's (vsbench/corpora).
"""

from __future__ import annotations

import asyncio
import importlib
import re
from array import array

_KIND = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def kind(traffic: dict):
    """The loop module that the traffic file names, its parameters checked."""
    name = str(traffic.get("loop", ""))
    if not _KIND.fullmatch(name):
        raise ValueError(f"traffic loop {name!r} is not a module name")
    try:
        mod = importlib.import_module(f"{__package__}.loops.{name}")
    except ModuleNotFoundError as exc:
        raise ValueError(f"no loop kind {name!r} (vsbench/loops/{name}.py)") from exc
    for key in ("limit", "pool", "warmup_rounds"):
        if int(traffic[key]) < 1:
            raise ValueError(f"traffic {key} must be at least 1")
    mod.check(traffic)
    return mod


class Gate:
    """Lets the clients send, or holds them between requests; says when no
    request is in flight.  The traced run closes it at the profiler slice's
    edges, so that no thread of the program is inside a torch call while
    the profiler starts or stops (stopping it under concurrent launches
    crashed the process)."""

    def __init__(self) -> None:
        self._open = asyncio.Event()
        self._open.set()
        self._idle = asyncio.Event()
        self._idle.set()
        self.in_flight = 0

    def sent(self) -> None:
        self.in_flight += 1
        self._idle.clear()

    def answered(self) -> None:
        self.in_flight -= 1
        if self.in_flight == 0:
            self._idle.set()

    async def hold(self) -> None:
        """Stop new requests and wait until every sent one is answered."""
        self._open.clear()
        await self._idle.wait()

    def release(self) -> None:
        self._open.set()

    async def wait_open(self) -> None:
        if not self._open.is_set():
            await self._open.wait()


class Records:
    """Every request a run sends, in arrays that the garbage collector does
    not track (a list of objects per request would make each full
    collection walk hundreds of thousands of them: pauses of ~0.3 s,
    measured).  Request i carried pool query qi[i], was sent at sent[i] and
    answered at done[i] (perf_counter seconds); state[i] is SENT until it
    is answered, then ANSWERED, or FAILED where it raised or its answer
    was malformed.  An answered request's item ids and scores are
    ids[i*k:(i+1)*k] and scores[i*k:(i+1)*k]: an answer may name fewer
    than k items (the rest of its ids read -1) and may give no scores
    (its scores read NaN)."""

    SENT, ANSWERED, FAILED = 0, 1, 2

    def __init__(self, k: int, answer_rows) -> None:
        self.k = k
        # answer -> (ids, scores or None) or None where it is malformed
        self._answer_rows = answer_rows
        self.sent = array("d")
        self.done = array("d")
        self.qi = array("q")
        self.state = array("b")
        self.ids = array("q")
        self.scores = array("f")
        self._pad_ids = array("q", [-1] * k)
        self._pad_scores = array("f", [float("nan")] * k)

    def __len__(self) -> int:
        return len(self.sent)

    def open(self, sent: float, qi: int) -> int:
        self.sent.append(sent)
        self.done.append(0.0)
        self.qi.append(qi)
        self.state.append(self.SENT)
        self.ids.extend(self._pad_ids)
        self.scores.extend(self._pad_scores)
        return len(self.sent) - 1

    def close(self, i: int, answer, done: float) -> None:
        self.done[i] = done
        got = None if isinstance(answer, BaseException) else self._answer_rows(answer)
        if got is not None:
            ids, scores = got
            if len(ids) > self.k or (scores is not None and len(scores) != len(ids)):
                got = None
        if got is None:
            self.state[i] = self.FAILED
            return
        at = i * self.k
        self.ids[at : at + len(ids)] = array("q", ids)
        if scores is not None:
            self.scores[at : at + len(ids)] = array("f", scores)
        self.state[i] = self.ANSWERED


async def finish(tasks: list[asyncio.Task], wait_s: float) -> int:
    """Wait up to `wait_s` for the clients' outstanding requests; cancel the
    rest (they stay unanswered).  Returns how many were cancelled."""
    if not tasks:
        return 0
    _, pending = await asyncio.wait(tasks, timeout=wait_s)
    for t in pending:
        t.cancel()
    if pending:
        await asyncio.gather(*pending, return_exceptions=True)
    for t in tasks:
        if not t.cancelled():
            t.result()
    return len(pending)

"""Micro-batching frontend for device queries.

The reference throttles per-index concurrency with semaphores
(2 in-flight for opensearch: src/index/opensearch.rs:109-113; 2×rayon
threads for usearch: src/index/usearch.rs:115-118) because its backends
process one query per call.  A TPU wants the opposite: *coalesce*
concurrent requests into one fixed-shape batched device step.  The
micro-batcher collects requests for up to `window_s` (or until
`max_batch`), pads to the shape bucket and runs one device call in a
worker thread, then fans results back out to each caller's future.

Structure: submissions append to a pending list and wake a single
drainer task.  The drainer waits out the batching window (cut short by
the kick event when a full batch accumulates), then launches the flush
as a detached task and loops — up to `depth` flushes run concurrently
(bounded by a semaphore), so batch n+1 dispatches to the device while
batch n's host readback is still crossing the link.  The flush_fn is
expected to be dispatch-then-fetch shaped (index.search_dispatch): the
device serializes the compute steps, the link pipelines the readbacks.
One in-flight batch (depth=1) reproduces the old strictly-serial
behavior.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Sequence


class MicroBatcher:
    """Coalesce awaitable submissions into batched flush calls.

    flush_fn(items) -> sequence of per-item results; runs in the default
    executor so the event loop keeps serving while the device steps.
    """

    def __init__(
        self,
        flush_fn: Callable[[list], Sequence[Any]],
        max_batch: int = 256,
        window_s: float = 0.002,
        depth: int = 4,
    ) -> None:
        self._flush_fn = flush_fn
        self._max_batch = max_batch
        self._window_s = window_s
        self._depth = max(1, depth)
        self._sem = asyncio.Semaphore(self._depth)
        self._pending: list[tuple[Any, asyncio.Future]] = []
        self._drainer: asyncio.Task | None = None
        self._flushes: set[asyncio.Task] = set()
        self._kick = asyncio.Event()
        self._closed = False

    async def submit(self, item: Any) -> Any:
        if self._closed:
            raise RuntimeError("batcher closed")
        fut = asyncio.get_running_loop().create_future()
        self._pending.append((item, fut))
        if len(self._pending) >= self._max_batch:
            self._kick.set()
        if self._drainer is None or self._drainer.done():
            self._drainer = asyncio.get_running_loop().create_task(
                self._drain()
            )
        return await fut

    async def _flush(self, batch: list[tuple[Any, asyncio.Future]]) -> None:
        items = [it for it, _ in batch]
        loop = asyncio.get_running_loop()
        try:
            results = await loop.run_in_executor(None, self._flush_fn, items)
            if len(results) != len(batch):
                # zip() would silently strand the unmatched futures
                # forever; fail the whole batch loudly instead
                raise RuntimeError(
                    f"flush_fn returned {len(results)} results "
                    f"for {len(batch)} items"
                )
            for (_, fut), res in zip(batch, results):
                if not fut.done():
                    fut.set_result(res)
        except Exception as exc:  # noqa: BLE001 — propagate to callers
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(exc)
        finally:
            self._sem.release()

    async def _drain(self) -> None:
        while self._pending:
            # batching window: wait for more arrivals unless already full
            if len(self._pending) < self._max_batch and self._window_s > 0:
                try:
                    await asyncio.wait_for(self._kick.wait(), self._window_s)
                except asyncio.TimeoutError:
                    pass
            self._kick.clear()
            # pipeline-depth bound: block here (not in submit) so callers
            # keep accumulating into bigger batches while the device is
            # saturated
            await self._sem.acquire()
            batch = self._pending[: self._max_batch]
            self._pending = self._pending[self._max_batch :]
            if not batch:
                self._sem.release()
                return
            task = asyncio.get_running_loop().create_task(self._flush(batch))
            self._flushes.add(task)
            task.add_done_callback(self._flushes.discard)

    async def close(self) -> None:
        self._closed = True
        while self._drainer is not None and not self._drainer.done():
            self._kick.set()
            await asyncio.sleep(0)
            try:
                await self._drainer
            except asyncio.CancelledError:
                pass
        if self._flushes:
            await asyncio.gather(*self._flushes, return_exceptions=True)

"""Index-set monitor — schema poller driving engine index lifecycle (the
port's own copy of vector_store_tpu/ingest/monitor_indexes.py).

Port of the reference's monitor_indexes actor (src/monitor_indexes.rs):
ticks at 1 s (:32-33), skips work unless the schema version changed
(:41-43), diffs the discovered index set against the engine's and issues
del_index/add_index (:52-54,148-158), and resets its cached version on
error to force a full re-poll (:47-50).

Extension: in the reference, the (old) engine wired the DB feed to the
index internally (db.rs:115-119).  Here the monitor owns that wiring —
after add_index it opens the per-index `EmbeddingStream` and spawns the
monitor_items bridge into the index actor.
"""

from __future__ import annotations

import asyncio
import logging

from ..engine.engine import EngineHandle
from ..types import IndexId
from . import monitor_items
from .source import DbSource

log = logging.getLogger("vst.monitor_indexes")

TICK_S = 1.0  # reference: monitor_indexes.rs:32


class MonitorIndexes:
    def __init__(
        self, db: DbSource, engine: EngineHandle, tick_s: float = TICK_S
    ) -> None:
        self._db = db
        self._engine = engine
        self._tick_s = tick_s
        self._schema_version: str | None = None
        self._feeds: dict[IndexId, tuple] = {}  # id -> (stream, task)
        self._task: asyncio.Task | None = None
        self._stop = asyncio.Event()

    def spawn(self) -> asyncio.Task:
        self._task = asyncio.get_running_loop().create_task(
            self.run(), name="monitor-indexes"
        )
        return self._task

    async def run(self) -> None:
        while not self._stop.is_set():
            try:
                await self.tick()
            except Exception:  # noqa: BLE001
                # error → reset cached version to force full re-poll
                # (monitor_indexes.rs:47-50)
                log.exception("monitor_indexes: tick failed")
                self._schema_version = None
            try:
                await asyncio.wait_for(self._stop.wait(), timeout=self._tick_s)
            except asyncio.TimeoutError:
                pass

    async def tick(self) -> None:
        version = await self._db.latest_schema_version()
        if version == self._schema_version:
            return  # no DDL since last look (monitor_indexes.rs:41-43)
        discovered = {m.id: m for m in await self._db.get_indexes()}
        current = set(self._feeds)

        for index_id in current - set(discovered):
            await self._engine.del_index(index_id)
            stream, task = self._feeds.pop(index_id)
            stream.stop()
            await stream.close()

        for index_id in set(discovered) - current:
            meta = discovered[index_id]
            await self._engine.add_index(meta)
            handle = await self._engine.get_index(index_id)
            if handle is None:
                # creation failed (engine logged it); retry next change
                self._schema_version = None
                continue
            stream = await self._db.get_db_index(meta)
            task = monitor_items.spawn(stream, handle)
            self._feeds[index_id] = (stream, task)

        self._schema_version = version

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task
        for stream, task in self._feeds.values():
            stream.stop()
            await stream.close()
            await task
        self._feeds.clear()

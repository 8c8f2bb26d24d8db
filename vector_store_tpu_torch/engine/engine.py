"""Engine — the index registry actor.

Mirrors the reference engine actor (src/engine.rs): one task owning
`{IndexId: IndexHandle}`, driven by a four-message protocol
(GetIndexIds / AddIndex / DelIndex / GetIndex, engine.rs:22-36) behind a
typed async façade (`EngineExt`, engine.rs:38-75).  Semantics preserved:

  * AddIndex is idempotent-skip when the id is present (engine.rs:96-100);
  * creation goes through the factory; failures are logged and the
    message dropped (engine.rs:103-110);
  * DelIndex closes the index handle, terminating its actor
    (engine.rs:113-116 — dropping the sender);
  * mailbox capacity 10 (engine.rs:80).
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass
from typing import Optional

from ..types import IndexId, IndexMetadata
from .actor import IndexHandle
from .factory import IndexFactory

log = logging.getLogger("vst.engine")

ENGINE_MAILBOX_CAPACITY = 10
_CLOSE = object()


@dataclass
class GetIndexIds:
    reply: asyncio.Future


@dataclass
class AddIndex:
    metadata: IndexMetadata
    reply: Optional[asyncio.Future] = None


@dataclass
class DelIndex:
    index_id: IndexId


@dataclass
class GetIndex:
    index_id: IndexId
    reply: asyncio.Future


class EngineHandle:
    """Typed façade over the engine mailbox (EngineExt, engine.rs:38-75)."""

    def __init__(self, queue: asyncio.Queue, task: asyncio.Task) -> None:
        self._queue = queue
        self._task = task
        self._closed = False

    async def get_index_ids(self) -> list[IndexId]:
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(GetIndexIds(fut))
        return await fut

    async def add_index(self, metadata: IndexMetadata) -> None:
        """Request index creation; acked once the registry applied it
        (creation failure is logged, not raised — engine.rs:103-107)."""
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(AddIndex(metadata, fut))
        await fut

    async def del_index(self, index_id: IndexId) -> None:
        await self._queue.put(DelIndex(index_id))

    async def get_index(self, index_id: IndexId) -> Optional[IndexHandle]:
        fut = asyncio.get_running_loop().create_future()
        await self._queue.put(GetIndex(index_id, fut))
        return await fut

    async def close(self) -> None:
        """Shut the engine down, closing every index actor."""
        if not self._closed:
            self._closed = True
            await self._queue.put(_CLOSE)
            await self._task


async def new_engine(factory: IndexFactory) -> EngineHandle:
    """Spawn the engine actor (engine.rs:77-131)."""
    queue: asyncio.Queue = asyncio.Queue(ENGINE_MAILBOX_CAPACITY)

    async def loop() -> None:
        indexes: dict[IndexId, IndexHandle] = {}
        while True:
            msg = await queue.get()
            if msg is _CLOSE:
                break
            if isinstance(msg, GetIndexIds):
                msg.reply.set_result(list(indexes))
            elif isinstance(msg, AddIndex):
                mid = msg.metadata.id
                if mid not in indexes:  # idempotent-skip, engine.rs:96-100
                    try:
                        indexes[mid] = factory.create_index(mid, msg.metadata)
                    except Exception:  # noqa: BLE001 — log & drop
                        log.exception("engine: failed to create index %s", mid)
                if msg.reply is not None:
                    msg.reply.set_result(None)
            elif isinstance(msg, DelIndex):
                handle = indexes.pop(msg.index_id, None)
                if handle is not None:
                    handle.close()
            elif isinstance(msg, GetIndex):
                msg.reply.set_result(indexes.get(msg.index_id))
            else:
                log.error("engine: unknown message %r", msg)
        for handle in indexes.values():
            handle.close()
        for handle in indexes.values():
            await handle.join()

    task = asyncio.get_running_loop().create_task(loop(), name="engine")
    return EngineHandle(queue, task)

"""ANN index backend: the per-index actor over a graph, exact or IVF index
on a torch device.

Counterpart of vector_store_tpu/engine/ann_index.py.  With `n_devices` > 1
the index is document-sharded over a device list (shard/).  Queries go
through a MicroBatcher
that coalesces concurrent Ann requests into one device batch; consecutive
AddOrReplace / Remove messages in the mailbox are applied as one batched
insert/delete.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..types import IndexId, IndexMetadata, IndexParams, PrimaryKey
from ..utils import metrics

from ..core.index import SlotIndex
from ..core.ivf import IvfIndex
from .actor import (
    Add,
    AddOrReplace,
    AddOrReplaceBatch,
    Ann,
    Compact,
    Count,
    IndexHandle,
    Remove,
    RemoveBatch,
    Search,
    spawn_index_actor,
)
from .batcher import MicroBatcher
from .keymap import KeyMap

log = logging.getLogger("vst.ann")


@dataclass
class _UpsertRun:
    """Coalesced run of consecutive AddOrReplace/AddOrReplaceBatch
    messages, applied as one batched insert.  `spans[j]` is the item range
    carried by `replies[j]`, so a validation error reaches its own reply."""

    items: list  # [(PrimaryKey, np.ndarray raw)]
    replies: list = field(default_factory=list)  # [asyncio.Future]
    spans: list = field(default_factory=list)  # [(start, end)] per reply


@dataclass
class _RemoveRun:
    """Coalesced run of consecutive Remove messages: one delete step."""

    keys: list


BACKENDS = ("graph", "exact", "ivf")


class AnnIndexBackend:
    """Message processor for one index: `backend` "graph" (kind ann),
    "exact" or "ivf"."""

    def __init__(
        self,
        index_id: IndexId,
        params: IndexParams,
        max_batch: int = 256,
        window_s: float = 0.002,
        backend: str = "graph",
        reserve_rows: int = 0,
        device="cuda",
        n_devices: int = 1,
    ) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        self.index_id = index_id
        self.params = params
        # `device` may be a device list, which is then the mesh as given
        if n_devices > 1 and backend == "ivf":
            # document-sharded IVF (the add/remove/search/count surface of
            # the single-device IvfIndex)
            from ..shard.sharded_ivf import ShardedIvfIndex

            self.index = ShardedIvfIndex(params, n_devices=n_devices, device=device)
        elif n_devices > 1:
            # document-sharded graph / exact index
            from ..shard.sharded_index import ShardedSlotIndex

            self.index = ShardedSlotIndex(
                params, n_devices=n_devices, exact=backend == "exact", device=device
            )
        elif backend == "ivf":
            # reserve_rows: bulk-load hint, sizes the clustering and the
            # staging bank for the expected final row count (core/ivf.py)
            self.index = IvfIndex(
                params,
                reserve_rows=reserve_rows,
                initial_capacity=reserve_rows or None,
                device=device,
            )
        else:
            self.index = SlotIndex(params, exact=backend == "exact", device=device)
        self.keymap = KeyMap()
        self._batcher = MicroBatcher(
            self._run_query_batch, max_batch=max_batch, window_s=window_s
        )
        self._loop = asyncio.get_running_loop()
        self._inflight: set[asyncio.Task] = set()
        # pairs the index state with its keymap between the query flush
        # threads and the compaction swap: a query must never map new
        # slots through the old keymap (or the reverse)
        self._serve_lock = threading.Lock()

    # -- device-side batch execution (worker thread) ----------------------

    def _run_query_batch(self, items: list) -> list:
        """items: [(embedding, k)] -> [(keys, distances)] per item."""
        k_max = max(k for _, k in items)
        queries = np.stack([e for e, _ in items])
        metrics.counter("vst_ann_queries_total", index=str(self.index_id)).inc(
            len(items)
        )
        # the lock covers the enqueue and the keymap snapshot only; the
        # readback (fetch) runs outside it, so several flush threads keep
        # device batches in flight
        with self._serve_lock:
            with metrics.timed("vst_ann_batch_seconds", backend=type(self.index).__name__):
                if hasattr(self.index, "search_dispatch"):
                    fetch = self.index.search_dispatch(queries, k_max)
                else:  # sharded backends search whole under the lock
                    res = self.index.search(queries, k_max)
                    fetch = lambda: res  # noqa: E731
                keymap = self.keymap
        dist, slots = fetch()
        out = []
        for j, (_, k) in enumerate(items):
            keys, dists = [], []
            for s, d in zip(slots[j][:k], dist[j][:k]):
                if s < 0:
                    continue
                key = keymap.key_of(int(s))
                if key is None:
                    continue  # slot tombstoned between search and mapping
                keys.append(key)
                dists.append(float(d))
            out.append((keys, dists))
        return out

    def _apply_upserts(self, batch: list[tuple[PrimaryKey, np.ndarray]]) -> None:
        for key, _ in batch:
            # a bad key must fail before the insert, or it leaves a row
            # that count() sees and no lookup can reach
            try:
                hash(key)
            except TypeError as exc:
                raise ValueError(f"unusable primary key {key!r}: {exc}") from exc
        vecs = np.stack([v for _, v in batch])
        metrics.counter("vst_ann_upserts_total", index=str(self.index_id)).inc(
            len(batch)
        )
        slots = self.index.add(vecs)
        dead = []
        for (key, _), slot in zip(batch, slots):
            old = self.keymap.bind(key, int(slot))
            if old is not None:
                dead.append(old)
        if dead:
            self.index.remove(np.asarray(dead, dtype=np.int64))

    # -- actor message handling ------------------------------------------

    def _check_dims(self, embedding: np.ndarray) -> np.ndarray:
        embedding = np.asarray(embedding, dtype=np.float32).reshape(-1)
        if embedding.shape[0] != self.params.dimensions:
            raise ValueError(
                f"index {self.index_id}: expected embedding of "
                f"{self.params.dimensions} dimensions, got {embedding.shape[0]}"
            )
        return embedding

    def coalesce(self, msgs: list) -> list:
        """Mailbox-drain hook (actor.py loop): merge consecutive mutation
        messages so N queued upserts/removes cost one device step.  Runs
        never cross a message of another type, so per-key order holds."""
        out: list = []
        for msg in msgs:
            prev = out[-1] if out else None
            if isinstance(msg, (AddOrReplace, AddOrReplaceBatch)):
                if not isinstance(prev, _UpsertRun):
                    prev = _UpsertRun(items=[])
                    out.append(prev)
                start = len(prev.items)
                if isinstance(msg, AddOrReplace):
                    prev.items.append((msg.primary_key, msg.embedding))
                else:
                    prev.items.extend(msg.items)
                if msg.reply is not None:
                    prev.replies.append(msg.reply)
                    prev.spans.append((start, len(prev.items)))
            elif isinstance(msg, (Remove, RemoveBatch)):
                if not isinstance(prev, _RemoveRun):
                    prev = _RemoveRun(keys=[])
                    out.append(prev)
                if isinstance(msg, Remove):
                    prev.keys.append(msg.key)
                else:
                    prev.keys.extend(msg.keys)
            else:
                out.append(msg)
        return out

    async def _apply_upsert_run(self, run: _UpsertRun) -> None:
        items = []
        errors: dict[int, ValueError] = {}
        for j, (k, e) in enumerate(run.items):
            # a malformed upsert must not poison its neighbours, and an
            # acked message whose items were dropped gets the error
            try:
                items.append((k, self._check_dims(e)))
            except ValueError as exc:
                errors[j] = exc
                log.exception("index %s: dropping bad upsert", self.index_id)
        if items:
            await self._loop.run_in_executor(None, self._apply_upserts, items)
        for reply, (start, end) in zip(run.replies, run.spans):
            if reply.done():
                continue
            err = next((errors[j] for j in range(start, end) if j in errors), None)
            if err is not None:
                reply.set_exception(err)
            else:
                reply.set_result(None)

    async def _apply_remove_run(self, run: _RemoveRun) -> None:
        slots = [
            s for s in (self.keymap.unbind(k) for k in run.keys) if s is not None
        ]
        if slots:
            await self._loop.run_in_executor(
                None, self.index.remove, np.asarray(slots, dtype=np.int64)
            )

    async def __call__(self, msg) -> None:
        if isinstance(msg, (AddOrReplace, AddOrReplaceBatch)):
            # direct path (no coalescing loop): a one-message run
            await self._apply_upsert_run(self.coalesce([msg])[0])
        elif isinstance(msg, _UpsertRun):
            await self._apply_upsert_run(msg)
        elif isinstance(msg, (Remove, RemoveBatch)):
            await self._apply_remove_run(self.coalesce([msg])[0])
        elif isinstance(msg, _RemoveRun):
            await self._apply_remove_run(msg)
        elif isinstance(msg, Ann):
            emb = self._check_dims(msg.embedding)
            # detach, so the actor loop keeps draining and the batcher can
            # coalesce concurrent queries
            task = self._loop.create_task(
                self._answer_ann(emb, msg), name=f"ann-{self.index_id}"
            )
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)
        elif isinstance(msg, Count):
            msg.reply.set_result(self.index.count())
        elif isinstance(msg, Compact):
            if hasattr(self.index, "compact_prepare"):
                await self._compact_slots()
            else:
                # id-stable backend (IVF): compact() reclusters under the
                # index's own lock and returns {}, the keymap is untouched
                remap = await self._loop.run_in_executor(None, self.index.compact)
                if remap:
                    raise RuntimeError("id-stable backend returned a remap")
            msg.reply.set_result(self.index.count())
        elif isinstance(msg, (Add, Search)):
            raise TypeError("ANN index does not serve the text protocol")
        else:
            raise TypeError(f"unknown message {msg!r}")

    async def _compact_slots(self) -> None:
        """Slot-moving compaction (graph/exact, sharded or not): rebuild offline in the
        executor while queries keep serving the old (state, keymap) pair,
        then swap the state and a new keymap in one serve-lock section."""
        scratch, remap = await self._loop.run_in_executor(None, self.index.compact_prepare)
        new_keymap = KeyMap()
        for old, new in remap.items():
            key = self.keymap.key_of(old)
            if key is not None:
                new_keymap.bind(key, new)
        with self._serve_lock:
            self.index.compact_install(scratch)
            self.keymap = new_keymap

    async def _answer_ann(self, emb: np.ndarray, msg: Ann) -> None:
        try:
            res = await self._batcher.submit((emb, msg.limit.value))
            if not msg.reply.done():
                msg.reply.set_result(res)
        except Exception as exc:  # noqa: BLE001 -- route to the caller
            if not msg.reply.done():
                msg.reply.set_exception(exc)

    async def shutdown(self) -> None:
        if self._inflight:
            await asyncio.gather(*self._inflight, return_exceptions=True)
        await self._batcher.close()


class AnnIndexFactory:
    """Factory producing index actors of one backend on `device`."""

    def __init__(
        self,
        default_params: Optional[IndexParams] = None,
        max_batch: int = 256,
        window_s: float = 0.002,
        backend: str = "graph",
        reserve_rows: int = 0,
        device="cuda",
        n_devices: int = 1,
    ) -> None:
        self.default_params = default_params
        self.max_batch = max_batch
        self.window_s = window_s
        self.backend = backend
        self.reserve_rows = reserve_rows
        self.device = device
        self.n_devices = n_devices

    def create_index(
        self, index_id: IndexId, metadata: Optional[IndexMetadata] = None
    ) -> IndexHandle:
        params = metadata.params if metadata is not None else self.default_params
        if params is None:
            raise ValueError(f"no params for index {index_id}")
        backend = AnnIndexBackend(
            index_id,
            params,
            max_batch=self.max_batch,
            window_s=self.window_s,
            backend=self.backend,
            reserve_rows=self.reserve_rows,
            device=self.device,
            n_devices=self.n_devices,
        )
        handle = spawn_index_actor(backend, name=str(index_id))
        # in-process callers (benchmarks, the chip smoke) reach the index
        # directly through the handle, as the API layer reaches `metadata`
        handle.backend = backend
        return handle

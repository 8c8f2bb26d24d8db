"""The system under test for text cells: vector_store_tpu_torch's engine,
in process, serving a BM25 index (kind `text`).

The index is made as the service makes it: `new_index_factory()` with its
defaults and `EngineHandle.add_index` of kind `text`.  The passages go in
through `IndexHandle.add_batch`, `load_batch` passages a message, passage
i under the primary key (i,); each message is applied before the next is
sent (the handle resolves once the backend applied the whole batch).
Queries go through `IndexHandle.search`, the entry the text-search route
calls per request.  A program without `IndexHandle.add_batch` has no
batched text load: `start` raises at once, and never falls back to one
`add` a passage.

`loaded` is the index's own count after the load; `load_s` is the seconds
the load's messages took, from the first sent to the last applied, without
the seconds the corpus took to make their passages (printed beside it on
standard error).
"""

from __future__ import annotations

import sys
import time

from vsbench.drivers.ann_engine import program_counters

INDEX = ("bench", "passages")
# the program's counters of query batches (engine/text_index.py,
# text/bm25.py), which the harness reads over the window
BATCH_COUNTERS = {"queries": "vst_text_queries_total", "batches": "vst_text_batch_seconds_count",
                  "seconds": "vst_text_batch_seconds_sum"}


class System:
    def __init__(self, config: dict, device: str) -> None:
        self.config = config
        self.device = device
        self.engine = None
        self.handle = None
        # the index's count once the last batch was applied
        self.loaded = 0
        self.load_s = 0.0
        self._limit = {}

    async def start(self, passages) -> None:
        from vector_store_tpu_torch.engine.actor import IndexHandle

        if not hasattr(IndexHandle, "add_batch"):
            raise RuntimeError("the program has no batched text load (IndexHandle.add_batch)")
        from vector_store_tpu_torch import IndexId, IndexMetadata, new_index_factory
        from vector_store_tpu_torch.engine.engine import new_engine

        index_id = IndexId.from_parts(*INDEX)
        self.engine = await new_engine(new_index_factory(device=self.device))
        await self.engine.add_index(IndexMetadata(index_id=index_id, kind=self.config["index"]["kind"]))
        self.handle = await self.engine.get_index(index_id)
        if self.handle is None:
            raise RuntimeError("the engine made no text index")
        batch = int(self.config["load_batch"])
        n = len(passages)
        made_s = 0.0
        t0 = time.perf_counter()
        for off in range(0, n, batch):
            t_made = time.perf_counter()
            texts = passages[off : min(off + batch, n)]
            made_s += time.perf_counter() - t_made
            await self.handle.add_batch([((off + j,), text) for j, text in enumerate(texts)])
        self.loaded = await self.handle.count()
        self.load_s = time.perf_counter() - t0 - made_s
        print(f"vsbench: the corpus made its passages in {made_s:.2f} s of the load's "
              f"{self.load_s + made_s:.2f} s", file=sys.stderr, flush=True)

    async def ask(self, query: str, k: int):
        from vector_store_tpu_torch import Limit

        limit = self._limit.get(k)
        if limit is None:
            limit = self._limit[k] = Limit(k)
        return await self.handle.search(query, limit)

    @staticmethod
    def answer_rows(answer, k: int, n: int) -> tuple[list[int], None] | None:
        """(passages, no scores) of an answer, or None where it is
        malformed: more than k keys, a key that names no passage, or a
        repeated key.  Fewer than k is an answer: fewer passages scored
        above 0."""
        try:
            rows = [int(key[0]) for key in answer if len(key) == 1]
        except (TypeError, ValueError, IndexError):
            return None
        if len(rows) != len(answer) or len(rows) > k or len(set(rows)) != len(rows):
            return None
        if rows and (min(rows) < 0 or max(rows) >= n):
            return None
        return rows, None

    def counters(self) -> dict[str, float]:
        return program_counters()

    async def close(self) -> None:
        """Close the engine: the index actor drains its mailbox, awaits its
        queries and closes its batcher (its flushes end first)."""
        if self.engine is not None:
            await self.engine.close()
        self.handle = None
        self.engine = None

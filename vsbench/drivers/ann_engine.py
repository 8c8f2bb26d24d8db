"""The system under test for ANN cells: vector_store_tpu_torch's engine, in
process.

The index is made as the service makes it: `new_index_factory()` with its
defaults, `EngineHandle.add_index`, then the rows through
`IndexHandle.add_or_replace_batch`, row i under the primary key (i,).
Each batch is applied before the next is sent (a `count()` after it), so
every load makes the same calls to the index.  Queries go through
`IndexHandle.ann`, the entry the HTTP route calls per request.

The configuration's "index" object gives the metadata: kind and the
IndexParams fields.  `loaded` is the index's own count after the load,
which the harness holds against the rows it sent; `load_s` is the load's
seconds, from the first batch sent to the last one applied.
"""

from __future__ import annotations

import re
import time

import numpy as np

INDEX = ("bench", "rows")
# the program's counters of query batches (engine/ann_index.py), which the
# harness reads over the window: queries, batches, and the batches' seconds
BATCH_COUNTERS = {"queries": "vst_ann_queries_total", "batches": "vst_ann_batch_seconds_count",
                  "seconds": "vst_ann_batch_seconds_sum"}
_LINE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})? (\S+)$")


def program_counters() -> dict[str, float]:
    """The program's metrics registry (its Prometheus text), summed over
    labels, by series name (histograms as <name>_sum and <name>_count)."""
    from vector_store_tpu_torch.utils import metrics

    out: dict[str, float] = {}
    for line in metrics.render().splitlines():
        m = _LINE.match(line)
        if m and not m.group(1).endswith("_bucket"):
            out[m.group(1)] = out.get(m.group(1), 0.0) + float(m.group(3))
    return out


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

    async def start(self, rows: np.ndarray) -> None:
        import torch

        from vector_store_tpu_torch import IndexId, IndexMetadata, IndexParams, new_index_factory
        from vector_store_tpu_torch.engine.engine import new_engine

        # as the service's run() does: full float32 products for the routes
        torch.backends.cuda.matmul.allow_tf32 = False
        spec = dict(self.config["index"])
        kind = spec.pop("kind")
        index_id = IndexId.from_parts(*INDEX)
        self.engine = await new_engine(new_index_factory(device=self.device))
        await self.engine.add_index(IndexMetadata(index_id, IndexParams(**spec), kind=kind))
        self.handle = await self.engine.get_index(index_id)
        if self.handle is None:
            raise RuntimeError(f"the engine made no index of kind {kind!r}")
        batch = int(self.config["load_batch"])
        n = len(rows)
        t0 = time.perf_counter()
        for off in range(0, n, batch):
            end = min(off + batch, n)
            await self.handle.add_or_replace_batch([((i,), rows[i]) for i in range(off, end)])
            # the actor answers after it applied every earlier message
            self.loaded = await self.handle.count()
        self.load_s = time.perf_counter() - t0

    async def ask(self, query: np.ndarray, k: int):
        from vector_store_tpu_torch import Limit

        limit = self._limit.get(k)
        if limit is None:
            limit = self._limit[k] = Limit(k)
        return await self.handle.ann(query, limit)

    @staticmethod
    def answer_rows(answer, k: int, n: int) -> tuple[list[int], list[float]] | None:
        """(rows, distances) of an answer, or None where it is malformed:
        not k keys and k distances, a key that names no row, a repeated
        key or a distance that is not finite."""
        try:
            keys, dists = answer
            rows = [int(key[0]) for key in keys if len(key) == 1]
            dists = [float(x) for x in dists]
        except (TypeError, ValueError, IndexError):
            return None
        if len(rows) != k or len(keys) != k or len(dists) != k or len(set(rows)) != k:
            return None
        if min(rows) < 0 or max(rows) >= n or not all(np.isfinite(dists)):
            return None
        return rows, dists

    def counters(self) -> dict[str, float]:
        return program_counters()

    async def close(self) -> None:
        """Close the engine: the index actor drains its mailbox, awaits its
        queries and closes its batcher (its flushes end first)."""
        if self.engine is not None:
            await self.engine.close()
        self.handle = None
        self.engine = None

"""File-backed ingestion sources: JSONL and fvecs datasets (the port's own
copy of vector_store_tpu/ingest/filesource.py).

The pluggable-source counterpart of the reference's ScyllaDB data plane
(SURVEY §7.3: "ship an in-memory fake source and a file/JSONL source").
Both implement the DbSource protocol so the monitors drive them exactly
like a live database: the file is the initial bulk scan; there are no
live updates after it (the stream stays open — a CDC tail could be
layered on a growing file later).

JSONL format, one event per line:
    {"key": [...]|scalar, "embedding": [f32...] | null, "timestamp": micros?}
fvecs: the SIFT wire format, keys are row numbers.  Its reader is native
(utils/native.py builds native/io.cpp at first use); without a C++ compiler
a source with fmt="fvecs" raises RuntimeError when it is first read.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

import numpy as np

from ..types import DbEmbedding, IndexId, IndexMetadata, IndexParams, Timestamp
from .source import EmbeddingStream


class FileSource:
    """Single-index DbSource over one data file."""

    def __init__(
        self,
        path: str,
        index_id: str,
        params: Optional[IndexParams] = None,
        fmt: str = "jsonl",  # "jsonl" | "fvecs"
        max_rows: int = 10_000_000,
    ) -> None:
        self.path = path
        self.fmt = fmt
        self.max_rows = max_rows
        self._params = params
        self._index_id = IndexId(index_id)
        self._version = "file-v1"

    async def latest_schema_version(self) -> Optional[str]:
        return self._version

    async def get_indexes(self) -> list[IndexMetadata]:
        params = self._params
        if params is None:
            # peek dimensions from the file
            if self.fmt == "jsonl":
                with open(self.path) as fh:
                    for line in fh:
                        ev = json.loads(line)
                        if ev.get("embedding"):
                            params = IndexParams(dimensions=len(ev["embedding"]))
                            break
            else:
                from ..utils.native import read_fvecs

                row = read_fvecs(self.path, 1)
                params = IndexParams(dimensions=row.shape[1])
            if params is None:
                raise ValueError(f"{self.path}: could not infer dimensions")
            self._params = params
        return [
            IndexMetadata(
                index_id=self._index_id,
                params=params,
                version=self._version,
                key_columns=("row",),
            )
        ]

    # concurrent scan slices (the reference's shards×3, db_index.rs:253-258)
    SCAN_PARALLELISM = 6

    async def get_db_index(self, metadata: IndexMetadata) -> EmbeddingStream:
        stream = EmbeddingStream(("row",))
        r = self.SCAN_PARALLELISM

        async def scan_fvecs(rows: np.ndarray, part: int) -> None:
            # row-range slice per task: r concurrent producers feed the
            # one bounded stream (token-range scan shape, db_index.rs:217-237)
            for i in range(part, len(rows), r):
                if stream.stopped:
                    break
                await stream.put(
                    DbEmbedding((int(i),), rows[i].copy(), Timestamp(i + 1))
                )

        async def scan_jsonl(lines: list[str], part: int) -> None:
            for i in range(part, len(lines), r):
                if stream.stopped:
                    break
                ev = json.loads(lines[i])
                key = ev["key"]
                key = tuple(key) if isinstance(key, list) else (key,)
                emb = ev.get("embedding")
                await stream.put(
                    DbEmbedding(
                        key,
                        None if emb is None else np.asarray(emb, dtype=np.float32),
                        Timestamp(int(ev.get("timestamp", i + 1))),
                    )
                )

        async def scan() -> None:
            loop = asyncio.get_running_loop()
            if self.fmt == "fvecs":
                from ..utils.native import read_fvecs

                rows = await loop.run_in_executor(
                    None, lambda: read_fvecs(self.path, self.max_rows)
                )
                await asyncio.gather(*(scan_fvecs(rows, p) for p in range(r)))
            else:

                def read_lines() -> list[str]:
                    with open(self.path) as fh:
                        return [
                            ln for ln in (x.strip() for x in fh) if ln
                        ][: self.max_rows]

                lines = await loop.run_in_executor(None, read_lines)
                await asyncio.gather(*(scan_jsonl(lines, p) for p in range(r)))
            # file exhausted: no live tail — leave the stream open like a
            # quiet CDC feed (monitor_items keeps serving queries)

        asyncio.get_running_loop().create_task(scan())
        return stream

"""Document-sharded IVF over a device list (counterpart of
vector_store_tpu/shard/sharded_ivf.py).

S single-device `IvfIndex` shards under one coordinator, one shard on
each entry of the mesh.  Each shard keeps its own bank, host mirrors,
staging and clustered placement, k-means, coarse bank and search enqueue
(core/ivf.py); this module keeps only what the shards must agree on:

  * the deal: rows go round-robin from a start shard that advances with
    every row ever dealt, so a stream of single-row upserts spreads across
    shards instead of piling onto shard 0;
  * global ids: `gid = local_rowid * S + shard`, independent of capacity
    (rowids are stable across bucket growth and reclustering inside each
    shard, so no remap ever reaches the engine's keymap; int32 bounds
    rowids to 2^31 / S per shard);
  * one (K, B) bank geometry: every shard grows when any one would
    overflow, before any places; a recluster takes K from the fullest
    shard and widens B until every shard places;
  * when to recluster (the live count doubled; `compact()` always);
  * the merge of the shards' top-k lists on the first shard's device
    (shard/mesh.py::gid_merge);
  * the snapshot, the shards' arrays stacked [S, K, B, ...], the JAX
    package's format, which loads in either package.

Where the JAX package runs one `shard_map` step over stacked arrays, the
coordinator runs a step on every shard before it reads anything back.
The sharded path has none of IvfIndex's bulk-load (`reserve_rows`),
growth cap (GROW_BYTES_MAX) or incremental compact, as in the JAX package.
"""

from __future__ import annotations

import json
import threading

import numpy as np

from ..core.ivf import (
    CLUSTER_MIN_ROWS,
    PROBE_DEFAULT,
    IvfIndex,
    IvfState,
    bucket_for,
    k_for,
    widen_bucket,
)
from ..core.topk import as_batch, host_answer
from ..types import IndexParams
from ..utils.persistio import atomic_savez
from .mesh import gid_merge, make_mesh


class ShardedIvfIndex:
    """Host wrapper over a device list with IvfIndex's surface.

    Ids returned by search/add are global (`rowid * n_shards + shard`,
    stable across growth and reclustering); `decode()` splits one back into
    (shard, local rowid)."""

    # per-shard rows of one ingest step
    INGEST_CHUNK = 16384

    def __init__(
        self,
        params: IndexParams,
        mesh=None,
        n_devices: int | None = None,
        probes: int = PROBE_DEFAULT,
        cluster_min: int = CLUSTER_MIN_ROWS,
        initial_capacity: int | None = None,
        rows_per_bucket: int | None = None,
        coarse: bool | None = None,
        rescore: int = 8,
        device="cuda",
    ) -> None:
        self.mesh = make_mesh(n_devices, mesh or device)
        self.n_shards = len(self.mesh)
        rows = -(-(initial_capacity or 0) // self.n_shards)
        self.shards = [
            IvfIndex(
                params,
                initial_capacity=rows,
                probes=probes,
                cluster_min=cluster_min,
                rows_per_bucket=rows_per_bucket,
                coarse=coarse,
                rescore=rescore,
                device=dev,
            )
            for dev in self.mesh
        ]
        self._init(clustered_at=0, rr=0)

    def _init(self, clustered_at: int, rr: int) -> None:
        # the settings every shard shares
        for name in ("params", "space", "dtype", "dims", "probes", "cluster_min",
                     "rows_per_bucket", "rescore"):
            setattr(self, name, getattr(self.shards[0], name))
        self._clustered_at = clustered_at  # total live count at the last recluster
        self._rr = rr  # the deal's start shard
        self._lock = threading.Lock()

    # -- introspection ------------------------------------------------------

    def count(self) -> int:
        return sum(sh.count() for sh in self.shards)

    @property
    def states(self) -> list[IvfState]:
        return [sh.state for sh in self.shards]

    @property
    def n_clusters(self) -> int:
        return self.shards[0].n_clusters

    @property
    def bucket(self) -> int:
        return self.shards[0].state.bucket

    @property
    def _clustered(self) -> bool:
        return self.shards[0].clustered

    @property
    def coarse(self) -> bool:
        """Whether the shards serve the two-stage scan; settable between
        searches, on every shard at once."""
        return self.shards[0].coarse

    @coarse.setter
    def coarse(self, on: bool) -> None:
        for sh in self.shards:
            sh.coarse = on

    def decode(self, gid: int) -> tuple[int, int]:
        """gid -> (shard, local rowid)."""
        rowid, shard = divmod(int(gid), self.n_shards)
        return shard, rowid

    # -- mutation -----------------------------------------------------------

    def add(self, vectors) -> np.ndarray:
        vectors, _ = as_batch(vectors, self.dims)
        n = len(vectors)
        S = self.n_shards
        gids = np.empty((n,), dtype=np.int64)
        with self._lock:
            for done in range(0, n, S * self.INGEST_CHUNK):
                chunk = vectors[done : done + S * self.INGEST_CHUNK]
                take = len(chunk)
                deal = []  # (shard, its block on its device, its local rowids)
                for j in range(min(S, take)):
                    s = (self._rr + j) % S
                    sh = self.shards[s]
                    rid = sh.take_rowids(len(chunk[j::S]))
                    gids[done + j : done + take : S] = rid * np.int64(S) + s
                    deal.append((sh, sh.to_device(chunk[j::S]), rid))
                if self._clustered:
                    self._add_clustered(deal)
                else:
                    while not all(sh.staging_fits(len(r)) for sh, _, r in deal):
                        self._grow_bucket()
                    for sh, blk, rid in deal:
                        sh.place_staging(blk, rid)
                self._rr = (self._rr + take) % S
            self._maybe_recluster()
        return gids

    def _grow_bucket(self) -> None:
        """Double B on every shard: all shards keep one bank geometry."""
        for sh in self.shards:
            sh.grow_bucket()

    def _add_clustered(self, deal) -> None:
        # the assignment is enqueued on every shard, then read back
        cids = [sh.assign(blk) for sh, blk, _ in deal]
        cids = [c.cpu().numpy() for c in cids]
        while True:  # every shard must place at the one shared bucket width
            plans = [sh.plan_clustered(c) for (sh, _, _), c in zip(deal, cids)]
            if not any(p[-1].any() for p in plans):
                break
            self._grow_bucket()
        for (sh, blk, rid), c, plan in zip(deal, cids, plans):
            sh.place_clustered(blk, c, plan, rid)

    def remove(self, gids) -> None:
        gids = np.unique(np.asarray(gids, dtype=np.int64).reshape(-1))
        gids = gids[gids >= 0]
        if gids.size == 0:
            return
        rowid, shard = np.divmod(gids, self.n_shards)
        with self._lock:
            for s, sh in enumerate(self.shards):
                sh.remove(rowid[shard == s])

    # -- clustering ---------------------------------------------------------

    def _maybe_recluster(self) -> None:
        n_live = self.count()
        if n_live < self.cluster_min:
            return
        if self._clustered and n_live < 2 * self._clustered_at:
            return
        self._recluster_locked()

    def compact(self) -> dict:
        """Recluster every shard (drops tombstones); ids are stable -> {}."""
        with self._lock:
            if self.count() > 0:
                self._recluster_locked()
        return {}

    def _recluster_locked(self) -> None:
        """Every shard k-means its own rows into one shared (K, B): K from
        the fullest shard, B widened until every shard places.  An empty
        shard takes the new geometry and places nothing."""
        live = [sh.live_slots() for sh in self.shards]
        n_max = max(len(f) for f in live)
        if n_max == 0:
            return
        k_new = k_for(n_max, self.rows_per_bucket)
        # k-means and assignment enqueued on every shard, then read back
        runs = [sh.kmeans(f, k_new) for sh, f in zip(self.shards, live)]
        cids = [c.cpu().numpy() for _, c in runs]
        b_new = bucket_for(n_max, k_new)
        while True:
            plans = [sh.plan_recluster(c, k_new, b_new) for sh, c in zip(self.shards, cids)]
            if all(p is not None for p in plans):
                break
            b_new = widen_bucket(b_new)
        # one shard at a time: a shard's old bank goes as soon as its new one stands
        for sh, f, (cent, _), c, plan in zip(self.shards, live, runs, cids, plans):
            sh.apply_recluster(cent, f, c, plan)
        self._clustered_at = self.count()

    # -- query --------------------------------------------------------------

    def search_dispatch(self, queries, k: int, probes: int | None = None):
        """Enqueue a batched query on every shard, then the merge on the
        first shard's device; returns fetch() -> (dist, gids), the host
        readback, which may run outside the lock (IvfIndex.search_dispatch
        says why that is safe)."""
        return self._dispatch(queries, k, probes or self.probes, flat=False)

    def search(self, queries, k: int, probes: int | None = None):
        """(dist[n, k] ascending, gids[n, k]); absent results (inf, -1)."""
        return self.search_dispatch(queries, k, probes)()

    def exact_search(self, queries, k: int):
        """Brute-force oracle over all shards (recall measurement)."""
        return self._dispatch(queries, k, self.probes, flat=True)()

    def _dispatch(self, queries, k: int, probes: int, flat: bool):
        queries, single = as_batch(queries, self.dims)
        with self._lock:
            parts = [sh.enqueue_search(queries, k, probes, flat) for sh in self.shards]
            # one merge a QCHUNK chunk, as the shards chunk the batch
            merged = [
                gid_merge([(d[c], i[c]) for d, i in parts], k) for c in range(len(parts[0][0]))
            ]
        return lambda: host_answer([d for d, _ in merged], [i for _, i in merged], single)

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot the sharded bank to one npz in the JAX package's format
        (kind "ivf-sharded": the shards' arrays stacked [S, K, B, ...],
        bf16 as f32).  The coarse banks are derived data and are not
        saved."""
        with self._lock:
            snaps = [sh.snapshot() for sh in self.shards]
            meta = {
                **snaps[0][0],
                "kind": "ivf-sharded",
                "n_shards": self.n_shards,
                "clustered_at": self._clustered_at,
                **{f: [m[f] for m, _ in snaps] for f in ("next_rowid", "n_live", "free")},
            }
            arrays = {f: np.stack([a[f] for _, a in snaps]) for f in snaps[0][1]}
            atomic_savez(
                path, meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays
            )

    @classmethod
    def load(cls, path: str, mesh=None, n_devices: int | None = None, device="cuda"):
        """An index from a snapshot written by `save` or by the JAX package,
        onto a mesh of as many shards as the snapshot has."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("kind") != "ivf-sharded":
                raise ValueError("not a sharded ivf snapshot")
            S = meta["n_shards"]
            idx = cls.__new__(cls)
            idx.mesh = make_mesh(n_devices or S, mesh or device)
            if len(idx.mesh) != S:
                raise ValueError(f"snapshot has {S} shards, mesh has {len(idx.mesh)} devices")
            idx.n_shards = S
            fields = ("n_used", "centroids", "vectors", "scales", "valid", "rowid")
            stacked = {f: z[f] for f in fields}  # each read once
        per = ("next_rowid", "n_live", "free")
        idx.shards = [
            IvfIndex.restore(
                {**meta, **{f: meta[f][s] for f in per}},
                {f: a[s] for f, a in stacked.items()},
                dev,
            )
            for s, dev in enumerate(idx.mesh)
        ]
        # the deal resumes from the rows ever dealt
        idx._init(clustered_at=meta["clustered_at"], rr=sum(meta["next_rowid"]) % S)
        return idx

"""Document-sharded IVF over a device list (counterpart of
vector_store_tpu/shard/sharded_ivf.py).

Every shard owns an independent IVF bank (core/ivf.py's `IvfState`) on its
entry of the mesh.  A query batch goes to every shard, each runs the same
probe-scan locally (kernels B1/B2 on CUDA tensors, their plain versions on
CPU ones), and the per-shard top-k lists meet in one merge on the first
shard's device (shard/mesh.py::gid_merge).

Global ids: `gid = local_rowid * S + shard`, independent of capacity
(rowids are stable across bucket growth and reclustering inside each
shard, so no remap ever reaches the engine's keymap; int32 bounds rowids
to 2^31 / S per shard).  The rotated round-robin deal keeps shard fill
balanced within one row without any device-side coordination.

A recluster runs per shard: each shard k-means its own rows.  All shards
share one (K, B) bank geometry, so the snapshot stacks them as
[S, K, B, D] arrays, the JAX package's format, and loads in either
package.

Where the JAX package runs one `shard_map` step over stacked arrays, this
module loops over a list of per-shard states and reuses the device steps
of core/ivf.py.  A step is enqueued on every shard before anything is
read back.  As in the single-device port there is no fixed-shape padding
and every top-k is exact.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict

import numpy as np
import torch

from ..core.distance import preprocess
from ..core.ivf import (
    ASSIGN_CHUNK,
    CLUSTER_MIN_ROWS,
    LLOYD_ITERS,
    LLOYD_SAMPLE,
    PROBE_DEFAULT,
    QCHUNK,
    ROWS_PER_BUCKET,
    SPILL,
    IvfState,
    _assign_pass,
    _compute_dtype,
    _from_numpy,
    _gather_dequant,
    _lloyd_iter,
    _storage_dtype,
    assign_top,
    bucket_for,
    coarse_flag,
    derive_coarse,
    grow_bucket,
    init,
    k_for,
    permute_build,
    place,
    plan_placement,
    scan_path,
    search_flat,
    search_two_stage,
    state_to_numpy,
    unvalidate,
)
from ..core.ivf_cuda import scan_masks, search_clustered_fused, search_clustered_pool
from ..core.topk import SENTINEL
from ..types import IndexParams
from ..utils.persistio import atomic_savez
from .mesh import gid_merge, make_mesh


class _ShardBook:
    """Host-side placement bookkeeping for one shard (the mirrors IvfIndex
    keeps, without the device state)."""

    def __init__(self, k: int, b: int) -> None:
        self.n_used = np.zeros((k,), dtype=np.int64)
        self.valid_h = np.zeros((k, b), dtype=bool)
        self.rowid_h = np.full((k, b), -1, dtype=np.int64)
        self.loc = np.full((0, 2), -1, dtype=np.int64)  # rowid -> (k, pos)
        self.free: dict[int, list[int]] = {}
        self.next_rowid = 0
        self.n_live = 0

    def grow_loc(self, n: int) -> None:
        if self.next_rowid + n > len(self.loc):
            new_len = max(2 * len(self.loc), self.next_rowid + n, 1024)
            pad = np.full((new_len - len(self.loc), 2), -1, dtype=np.int64)
            self.loc = np.concatenate([self.loc, pad])

    def grow_bucket(self, b_old: int) -> None:
        self.valid_h = np.pad(self.valid_h, ((0, 0), (0, b_old)))
        self.rowid_h = np.pad(self.rowid_h, ((0, 0), (0, b_old)), constant_values=-1)


class ShardedIvfIndex:
    """Host wrapper mirroring IvfIndex over a device list.

    Ids returned by search/add are global (`rowid * n_shards + shard`,
    stable across growth and reclustering); `decode()` splits one back into
    (shard, local rowid).  The numpy-in/numpy-out surface of IvfIndex,
    SlotIndex and ShardedSlotIndex."""

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
        self.params = params
        self.space = params.space
        self.dtype = params.dtype if params.dtype in ("float32", "int8") else "bfloat16"
        self.dims = params.dimensions
        self.probes = probes
        self.cluster_min = cluster_min
        # the coarse bank is a per-shard derived cache, stale wholesale after
        # any write (sharded mutations come in batches)
        self.coarse = coarse_flag(coarse, self.dtype, self.dims)
        self.rescore = rescore
        self._coarse_banks: list[torch.Tensor] | None = None
        self._coarse_stale = True
        self.rows_per_bucket = rows_per_bucket or ROWS_PER_BUCKET
        self.mesh = make_mesh(n_devices, mesh or device)
        self.n_shards = len(self.mesh)
        rows0 = max(-(-(initial_capacity or 0) // self.n_shards), cluster_min)
        k = k_for(rows0, self.rows_per_bucket)
        b = bucket_for(rows0, k)
        self._states = [init(self.dims, k, b, self.dtype, dev) for dev in self.mesh]
        self._books = [_ShardBook(k, b) for _ in range(self.n_shards)]
        self._clustered = False
        self._clustered_at = 0
        self._rr = 0  # rotating round-robin start shard (persists across adds)
        self._lock = threading.Lock()

    # -- introspection ------------------------------------------------------

    def count(self) -> int:
        return sum(b.n_live for b in self._books)

    @property
    def states(self) -> list[IvfState]:
        return self._states

    @property
    def n_clusters(self) -> int:
        return self._states[0].n_clusters

    @property
    def bucket(self) -> int:
        return self._states[0].bucket

    def decode(self, gid: int) -> tuple[int, int]:
        """gid -> (shard, local rowid)."""
        rowid, shard = divmod(int(gid), self.n_shards)
        return shard, rowid

    # -- helpers ------------------------------------------------------------

    def _idx(self, s: int, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.mesh[s])

    def _grow_bucket(self) -> None:
        """Double B on every shard -- realloc event, ids unaffected; all
        shards keep one bank geometry."""
        B = self.bucket
        self._states = [grow_bucket(s) for s in self._states]
        for book in self._books:
            book.grow_bucket(B)
        self._coarse_stale = True
        self._coarse_banks = None

    def _to_dev(self, s: int, blk: np.ndarray) -> torch.Tensor:
        """One host->device copy per shard block; bf16 and int8 banks round
        it to bf16 first, as the JAX package ships it."""
        t = torch.as_tensor(blk, dtype=torch.float32, device=self.mesh[s])
        return t if self.dtype == "float32" else t.to(torch.bfloat16)

    # -- mutation -----------------------------------------------------------

    def add(self, vectors) -> np.ndarray:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        n, d = vectors.shape
        if d != self.dims:
            raise ValueError(f"dimension mismatch: index {self.dims}, got {d}")
        S = self.n_shards
        gids = np.empty((n,), dtype=np.int64)
        with self._lock:
            done = 0
            while done < n:
                take = min(n - done, S * self.INGEST_CHUNK)
                chunk = vectors[done : done + take]
                # rotated round-robin deal: the start shard advances with
                # every row ever dealt, so a stream of single-row upserts
                # spreads across shards instead of piling onto shard 0
                s0 = self._rr
                vecs: list = [None] * S
                rids: list = [np.empty((0,), np.int64)] * S
                for j in range(S):
                    s = (s0 + j) % S
                    p = chunk[j::S]
                    book = self._books[s]
                    book.grow_loc(len(p))
                    local = book.next_rowid + np.arange(len(p), dtype=np.int64)
                    book.next_rowid += len(p)
                    rids[s] = local
                    vecs[s] = self._to_dev(s, p) if len(p) else None
                    gids[done + j : done + take : S] = local * np.int64(S) + s
                if self._clustered:
                    self._add_clustered(vecs, rids)
                else:
                    self._add_staging(vecs, rids)
                for s in range(S):
                    self._books[s].n_live += len(rids[s])
                self._rr = (s0 + take) % S
                done += take
            self._coarse_stale = True  # new codes landed on every shard
            self._maybe_recluster()
        return gids

    def _plan_staging(self, lens: list[int]) -> tuple[list, list]:
        """Sequential per-shard fill from the per-cluster fill counts (rows
        placed before a _grow_bucket keep their slots)."""
        S = self.n_shards
        K, B = self.n_clusters, self.bucket
        while max(int(self._books[s].n_used.sum()) + lens[s] for s in range(S)) > K * B:
            self._grow_bucket()
            B = self.bucket
        ks: list = [None] * S
        poss: list = [None] * S
        for s in range(S):
            book = self._books[s]
            mm = lens[s]
            if mm == 0:
                continue
            rem = B - book.n_used
            cum = np.cumsum(rem)
            j = np.arange(mm)
            kk = np.searchsorted(cum, j, side="right")
            prev = np.where(kk > 0, cum[np.maximum(kk - 1, 0)], 0)
            pp = book.n_used[kk] + (j - prev)
            np.add.at(book.n_used, kk, 1)
            ks[s], poss[s] = kk, pp
        return ks, poss

    def _add_staging(self, vecs, rids) -> None:
        ks, poss = self._plan_staging([len(r) for r in rids])
        self._scatter(vecs, ks, poss, rids)

    def _add_clustered(self, vecs, rids) -> None:
        S = self.n_shards
        # the assignment is enqueued on every shard, then read back
        cids_dev = []
        for s in range(S):
            if vecs[s] is None:
                cids_dev.append(None)
                continue
            cent = self._states[s].centroids
            prep = preprocess(vecs[s].float(), self.space).to(cent.dtype)
            cids_dev.append(assign_top(cent, prep, self.space, SPILL))
        cids = [c.cpu().numpy() if c is not None else np.empty((0, SPILL), np.int32) for c in cids_dev]
        while True:  # every shard must place at the one shared bucket width
            trial = []
            for s in range(S):
                book = self._books[s]
                used = book.n_used.copy()
                free_try = {k: v[:] for k, v in book.free.items()}
                kk, pp, unplaced = plan_placement(cids[s], used, self.bucket, free=free_try)
                if unplaced.any():
                    break
                trial.append((used, free_try, kk, pp))
            if len(trial) == S:
                break
            self._grow_bucket()
        ks: list = [None] * S
        poss: list = [None] * S
        for s, (used, free_new, kk, pp) in enumerate(trial):
            book = self._books[s]
            book.n_used = used
            book.free = free_new
            ks[s], poss[s] = kk, pp
        self._scatter(vecs, ks, poss, rids)

    def _scatter(self, vecs, ks, poss, rids) -> None:
        for s in range(self.n_shards):
            if vecs[s] is None:
                continue
            kk, pp, rr = ks[s], poss[s], rids[s]
            place(
                self._states[s],
                vecs[s],
                self._idx(s, kk),
                self._idx(s, pp),
                self._idx(s, rr),
                self.space,
                self.dtype,
            )
            book = self._books[s]
            book.valid_h[kk, pp] = True
            book.rowid_h[kk, pp] = rr
            book.loc[rr, 0] = kk
            book.loc[rr, 1] = pp

    def remove(self, gids) -> None:
        gids = np.unique(np.asarray(gids, dtype=np.int64).reshape(-1))
        gids = gids[gids >= 0]
        if gids.size == 0:
            return
        with self._lock:
            S = self.n_shards
            rowid, shard = np.divmod(gids, S)
            for s in range(S):
                book = self._books[s]
                mine = rowid[shard == s]
                mine = mine[mine < book.next_rowid]
                if mine.size:
                    mine = mine[book.loc[mine, 0] >= 0]
                if mine.size == 0:
                    continue
                ks, pp = book.loc[mine, 0], book.loc[mine, 1]
                if self._clustered:
                    for k_, p_ in zip(ks.tolist(), pp.tolist()):
                        book.free.setdefault(k_, []).append(p_)
                book.valid_h[ks, pp] = False
                book.loc[mine] = -1
                book.n_live -= len(mine)
                unvalidate(self._states[s], self._idx(s, ks), self._idx(s, pp))

    # -- clustering ---------------------------------------------------------

    def _maybe_recluster(self) -> None:
        n_live = self.count()
        if n_live < self.cluster_min:
            return
        if self._clustered and n_live < 2 * self._clustered_at:
            return
        self._recluster_locked()

    def compact(self) -> dict:
        """Per-shard recluster (drops tombstones); ids are stable -> {}."""
        with self._lock:
            if self.count() > 0:
                self._recluster_locked()
        return {}

    def _recluster_locked(self) -> None:
        S = self.n_shards
        flat_live = [np.flatnonzero(book.valid_h.reshape(-1)) for book in self._books]
        ns = [len(f) for f in flat_live]
        n_max = max(ns)
        if n_max == 0:
            return
        k_new = k_for(n_max, self.rows_per_bucket)  # the fullest shard sizes all
        a_chunk = ASSIGN_CHUNK if k_new <= (1 << 15) else 1024

        # per-shard k-means from a strided live sample (an empty shard seeds
        # from slot 0 and places nothing), enqueued shard after shard
        cents = []
        live_dev = []
        for s, (st, fl, nn) in enumerate(zip(self._states, flat_live, ns)):
            seeds = np.zeros((k_new,), dtype=np.int64)
            if nn:
                sample = fl[:: max(nn // k_new, 1)][:k_new]
                seeds = np.tile(sample, -(-k_new // len(sample)))[:k_new]
            cent = _gather_dequant(st.vectors, st.scales, self._idx(s, seeds)).to(
                st.centroids.dtype
            )
            if nn:
                cap = min(nn, LLOYD_SAMPLE)
                sample = self._idx(s, fl[:: max(nn // cap, 1)][:cap])
                for _ in range(LLOYD_ITERS):
                    cent = _lloyd_iter(st.vectors, st.scales, cent, sample, self.space, a_chunk)
            cents.append(cent)
            live_dev.append(self._idx(s, fl))
        # assign every live row per shard (top-SPILL for the cascade): all
        # shards enqueued, then read back
        cids_dev = [
            _assign_pass(st.vectors, st.scales, cent, fl, self.space, SPILL, a_chunk)
            if nn
            else None
            for st, cent, fl, nn in zip(self._states, cents, live_dev, ns)
        ]
        all_cids = [
            c.cpu().numpy() if c is not None else np.empty((0, SPILL), np.int32) for c in cids_dev
        ]

        # host placement per shard into one shared (k_new, b_new)
        b_new = bucket_for(n_max, k_new)
        while True:
            plans = []
            for s in range(S):
                used = np.zeros((k_new,), dtype=np.int64)
                kk, pp, unplaced = plan_placement(all_cids[s], used, b_new)
                if unplaced.any():
                    break
                plans.append((used, kk, pp))
            if len(plans) == S:
                break
            b_new = -(-int(b_new * 1.5) // 128) * 128  # stay 128-aligned

        # the device permute, one shard at a time: a shard's old bank goes
        # as soon as its new one stands
        for s, (used, kk, pp) in enumerate(plans):
            perm = np.full((k_new, b_new), SENTINEL, dtype=np.int64)
            perm[kk, pp] = flat_live[s]
            self._states[s] = permute_build(self._states[s], cents[s], self._idx(s, perm))
            # host mirrors follow the same permutation (empty shards reset too)
            book = self._books[s]
            placed = book.rowid_h.reshape(-1)[flat_live[s]]
            book.rowid_h = np.full((k_new, b_new), -1, dtype=np.int64)
            book.rowid_h[kk, pp] = placed
            book.valid_h = np.zeros((k_new, b_new), dtype=bool)
            book.valid_h[kk, pp] = True
            book.n_used = used
            book.loc[placed, 0] = kk
            book.loc[placed, 1] = pp
            book.free = {}
        self._clustered = True
        self._clustered_at = self.count()
        self._coarse_stale = True  # whole bank permuted on every shard
        self._coarse_banks = None

    # -- query --------------------------------------------------------------

    def search(self, queries, k: int, probes: int | None = None):
        """(dist[n, k] ascending, gids[n, k]); absent results (inf, -1)."""
        return self._search(queries, k, probes, oracle=False)

    def exact_search(self, queries, k: int):
        """Brute-force oracle over all shards (recall measurement)."""
        return self._search(queries, k, None, oracle=True)

    def _search(self, queries, k, probes, oracle):
        probes = probes or self.probes
        queries = np.asarray(queries, dtype=np.float32)
        single = queries.ndim == 1
        if single:
            queries = queries[None, :]
        n, d = queries.shape
        if d != self.dims:
            raise ValueError(f"dimension mismatch: index {self.dims}, got {d}")
        outs_d, outs_i = [], []
        with self._lock:
            states = self._states
            if oracle or not self._clustered:
                mode = "flat"
            elif self.coarse:
                mode = "two_stage"
                if self._coarse_banks is None or self._coarse_stale:
                    self._coarse_banks = [derive_coarse(s.vectors) for s in states]
                    self._coarse_stale = False
                cand = min(
                    max(self.rescore * k, 64), min(probes, self.n_clusters) * self.bucket
                )
            else:
                mode = scan_path(k, self.dims)
            masks = [scan_masks(s) for s in states] if mode != "flat" else None
            for off in range(0, n, QCHUNK):
                blk = torch.from_numpy(queries[off : off + QCHUNK])
                parts = []
                for s, st in enumerate(states):  # enqueued on every shard
                    q = blk.to(self.mesh[s], non_blocking=True)
                    if mode == "flat":
                        parts.append(search_flat(st, q, self.space, k))
                    elif mode == "two_stage":
                        parts.append(
                            search_two_stage(
                                st, self._coarse_banks[s], q, self.space, k, probes, cand,
                                masks=masks[s],
                            )
                        )
                    elif mode == "fused":
                        parts.append(
                            search_clustered_fused(st, q, self.space, k, probes, masks[s])
                        )
                    else:
                        parts.append(
                            search_clustered_pool(st, q, self.space, k, probes, masks[s])
                        )
                dd, ii = gid_merge(parts, k)
                outs_d.append(dd)
                outs_i.append(ii)
            # every chunk is in flight: one fetch for all of them, under the
            # lock (a later write updates the banks in place)
            dist = torch.cat(outs_d).cpu().numpy()
            ids = torch.cat(outs_i).cpu().numpy().astype(np.int64)
        ids[~np.isfinite(dist)] = -1
        if single:
            return dist[0], ids[0]
        return dist, ids

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot the sharded bank to one npz in the JAX package's format
        (kind "ivf-sharded": the per-shard arrays stacked [S, K, B, ...],
        bf16 as f32).  The coarse banks are derived data and are not
        saved."""
        with self._lock:
            meta = {
                "format": 1,
                "kind": "ivf-sharded",
                "n_shards": self.n_shards,
                "params": asdict(self.params),
                "dtype": self.dtype,
                "probes": self.probes,
                "cluster_min": self.cluster_min,
                "rows_per_bucket": self.rows_per_bucket,
                "coarse": self.coarse,
                "rescore": self.rescore,
                "clustered": self._clustered,
                "clustered_at": self._clustered_at,
                "next_rowid": [b.next_rowid for b in self._books],
                "n_live": [b.n_live for b in self._books],
                "free": [{str(c): v for c, v in b.free.items()} for b in self._books],
            }
            per_shard = [state_to_numpy(s) for s in self._states]
            arrays = {f: np.stack([a[f] for a in per_shard]) for f in per_shard[0]}
            atomic_savez(
                path,
                n_used=np.stack([b.n_used for b in self._books]),
                meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                **arrays,
            )

    @classmethod
    def load(cls, path: str, mesh=None, n_devices: int | None = None, device="cuda"):
        """An index from a snapshot written by `save` or by the JAX package,
        onto a mesh of as many shards as the snapshot has."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("kind") != "ivf-sharded":
                raise ValueError("not a sharded ivf snapshot")
            idx = cls.__new__(cls)
            idx.params = IndexParams(**meta["params"])
            idx.space = idx.params.space
            idx.dtype = meta["dtype"]
            idx.dims = idx.params.dimensions
            idx.probes = meta["probes"]
            idx.cluster_min = meta["cluster_min"]
            idx.rows_per_bucket = meta.get("rows_per_bucket", ROWS_PER_BUCKET)
            idx.coarse = (
                meta.get("coarse", os.environ.get("VST_IVF_COARSE") == "1")
                and idx.dtype == "int8"
                and idx.dims % 2 == 0
            )
            idx.rescore = meta.get("rescore", 8)
            idx._coarse_banks = None
            idx._coarse_stale = True
            idx.mesh = make_mesh(n_devices or meta["n_shards"], mesh or device)
            if len(idx.mesh) != meta["n_shards"]:
                raise ValueError(
                    f"snapshot has {meta['n_shards']} shards, mesh has "
                    f"{len(idx.mesh)} devices"
                )
            idx.n_shards = meta["n_shards"]
            idx._clustered = meta["clustered"]
            idx._clustered_at = meta["clustered_at"]
            idx._lock = threading.Lock()
            valid = np.asarray(z["valid"])  # [S, K, B]
            rowid = np.asarray(z["rowid"])
            n_used = np.asarray(z["n_used"])
            idx._books = []
            for s in range(idx.n_shards):
                book = _ShardBook(valid.shape[1], valid.shape[2])
                book.n_used = n_used[s].astype(np.int64)
                book.valid_h = valid[s].copy()
                book.rowid_h = np.where(valid[s], rowid[s].astype(np.int64), -1)
                book.next_rowid = meta["next_rowid"][s]
                book.n_live = meta["n_live"][s]
                book.free = {int(c): list(v) for c, v in meta["free"][s].items()}
                book.loc = np.full((max(book.next_rowid, 1), 2), -1, dtype=np.int64)
                ks, poss = np.nonzero(valid[s])
                live_ids = rowid[s][ks, poss].astype(np.int64)
                book.loc[live_ids, 0] = ks
                book.loc[live_ids, 1] = poss
                idx._books.append(book)
            # the deal's cursor resumes from the rows ever dealt
            idx._rr = int(sum(b.next_rowid for b in idx._books) % idx.n_shards)
            centroids, vectors, scales = z["centroids"], z["vectors"], z["scales"]
            idx._states = [
                IvfState(
                    centroids=_from_numpy(centroids[s], dev).to(_compute_dtype(idx.dtype)),
                    vectors=_from_numpy(vectors[s], dev).to(_storage_dtype(idx.dtype)),
                    scales=_from_numpy(scales[s], dev).float(),
                    valid=_from_numpy(valid[s], dev),
                    rowid=_from_numpy(rowid[s], dev).to(torch.int32),
                )
                for s, dev in enumerate(idx.mesh)
            ]
        return idx

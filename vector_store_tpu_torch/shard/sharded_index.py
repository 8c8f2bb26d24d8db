"""Document-sharded graph / exact index over a device list (counterpart of
vector_store_tpu/shard/sharded_index.py).

Each entry of the mesh owns an independent GraphState shard.  A query
batch goes to every shard, each runs the same batched beam search (or the
exact scan) locally, and the per-shard top-k lists meet in one merge on
the first shard's device (shard/mesh.py::gid_merge).

Global ids: `gid = slot * S + shard` (S = shard count, fixed for the
index's lifetime), independent of capacity, so ids given out before a
capacity-doubling growth stay valid after it.  With the balanced
round-robin deal gid also equals the global insertion order.

Where the JAX package runs one `shard_map` step over stacked
[S, C, ...] arrays, this module loops over a list of per-shard states and
reuses the device steps of core/{build,index,cluster}.py; the
arrays are stacked only in a snapshot, which is the JAX package's format.
Queries are not padded to fixed batch sizes; insert blocks keep their
padding (core/index.py says why).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from dataclasses import asdict

import numpy as np
import torch

from ..core import build, cluster, graph
from ..core.graph import GraphState
from ..core.index import (
    INSERT_BLOCK,
    ROUTE_MIN_ROWS,
    config_from_params,
    routing_sample_for,
    search_state,
)
from ..core.ivf import from_numpy
from ..core.persist import config_from_meta
from ..core.topk import as_batch, host_answer
from ..types import IndexParams
from ..utils.persistio import atomic_savez_compressed
from .mesh import gid_merge, make_mesh


class ShardedSlotIndex:
    """Host wrapper mirroring SlotIndex over a device list.

    Ids returned by search/add are global (`slot * n_shards + shard`,
    stable across capacity growth); `decode()` splits one back into
    (shard, slot).  Rows are dealt to shards round-robin by the host, so
    shard sizes stay balanced without any device-side coordination."""

    def __init__(
        self,
        params: IndexParams,
        mesh=None,
        n_devices: int | None = None,
        initial_capacity_per_shard: int | None = None,
        exact: bool = False,
        device="cuda",
    ) -> None:
        self.params = params
        self.mesh = make_mesh(n_devices, mesh or device)
        self.n_shards = len(self.mesh)
        cap = initial_capacity_per_shard or max(
            min(params.capacity // self.n_shards, 1 << 16), 2 * INSERT_BLOCK
        )
        self.cfg = config_from_params(params, cap)
        if exact:
            # scan-only shards: the adjacency is a 1-wide stub
            self.cfg = dataclasses.replace(self.cfg, degree=1)
        self._exact = exact
        self._reset(cap)
        self._lock = threading.Lock()

    def _reset(self, cap: int) -> None:
        """Fresh empty shards of `cap` rows each under self.cfg."""
        self._states = [graph.init(self.cfg, cap, dev) for dev in self.mesh]
        self._frontiers = np.zeros((self.n_shards,), dtype=np.int64)
        self._sizes = np.zeros((self.n_shards,), dtype=np.int64)
        self._route_built_at = 0  # max per-shard frontier at the last build
        self._rr = 0  # rotating round-robin start shard (persists across adds)

    # -- introspection ----------------------------------------------------

    @property
    def states(self) -> list[GraphState]:
        return self._states

    @property
    def capacity(self) -> int:
        return self._states[0].capacity

    def count(self) -> int:
        return int(self._sizes.sum())

    def decode(self, gid: int) -> tuple[int, int]:
        """gid -> (shard, slot).  The encoding never involves capacity, so
        ids survive growth."""
        slot, shard = divmod(int(gid), self.n_shards)
        return shard, slot

    # -- mutation ---------------------------------------------------------

    def _ensure_capacity(self, per_shard_need: int) -> None:
        """Double every shard together until a block of headroom is left."""
        cap = self.capacity
        need = int(self._frontiers.max()) + per_shard_need
        if need + INSERT_BLOCK <= cap:
            return
        new_cap = cap
        while need + INSERT_BLOCK > new_cap:
            new_cap *= 2
        self._states = [graph.grow(s, new_cap) for s in self._states]
        self.cfg = dataclasses.replace(self.cfg, routing_sample=routing_sample_for(new_cap))

    def add(self, vectors) -> np.ndarray:
        """Insert vectors round-robin across shards -> global ids [n]."""
        vectors, _ = as_batch(vectors, self.cfg.dims)
        n, d = vectors.shape
        S = self.n_shards
        gids = np.empty((n,), dtype=np.int64)
        step = build.upload_impl if self._exact else build.insert_impl
        with self._lock:
            done = 0
            while done < n:
                take = min(n - done, S * INSERT_BLOCK)
                chunk = vectors[done : done + take]
                # rotated round-robin deal: the start shard advances with
                # every row ever dealt, so a stream of single-row upserts
                # spreads across shards instead of piling onto shard 0
                s0 = self._rr
                self._ensure_capacity(-(-take // S))
                for j in range(S):
                    s = (s0 + j) % S
                    p = chunk[j::S]
                    m = len(p)
                    if m == 0:
                        continue
                    base = int(self._frontiers[s])
                    gids[done + j : done + take : S] = (base + np.arange(m)) * np.int64(S) + s
                    dev = self.mesh[s]
                    # a padded block with a live mask, as SlotIndex.add
                    blk = torch.zeros((INSERT_BLOCK, d), dtype=torch.float32, device=dev)
                    blk[:m] = torch.as_tensor(p, device=dev)
                    if self.cfg.dtype != "float32":
                        blk = blk.to(torch.bfloat16)  # as the JAX package ships it
                    live = torch.arange(INSERT_BLOCK, device=dev) < m
                    step(self._states[s], base, blk, live, self.cfg)
                    self._frontiers[s] += m
                    self._sizes[s] += m
                self._rr = (s0 + take) % S
                done += take
                self._maybe_rebuild_router_locked()
            # bound router staleness at the end of the call, as SlotIndex.add
            f = int(self._frontiers.max())
            if not self._exact and f >= ROUTE_MIN_ROWS and f >= 1.25 * self._route_built_at:
                self._rebuild_router_locked(f)
        return gids

    # -- hierarchical router ------------------------------------------------

    def _maybe_rebuild_router_locked(self) -> None:
        """Per-shard router rebuild when the biggest shard doubled."""
        f = int(self._frontiers.max())
        if self._exact or f < ROUTE_MIN_ROWS:
            return
        if f < 2 * self._route_built_at:
            return
        self._rebuild_router_locked(f)

    def _rebuild_router_locked(self, frontier: int, k: int | None = None) -> None:
        """Every shard clusters its own rows (core/cluster.py::build_router)
        with one `route_k`, taken from the fullest shard."""
        k = k or cluster.route_k_for(frontier)
        cfg = dataclasses.replace(self.cfg, route_k=k)
        for s, st in enumerate(self._states):
            cent, members, m_cnt = cluster.build_router(st, cfg, k, cfg.route_members_per)
            self._states[s] = dataclasses.replace(
                st, route_centroids=cent, route_members=members, route_cnt=m_cnt
            )
        self.cfg = cfg
        self._route_built_at = frontier

    def remove(self, gids) -> None:
        # dedup: a slot repeated in one batch would decrement the live
        # count twice
        gids = np.unique(np.asarray(gids, dtype=np.int64).reshape(-1))
        if gids.size == 0:
            return
        with self._lock:
            S = self.n_shards
            slot, shard = np.divmod(gids, S)
            ok = (slot >= 0) & (slot < self.capacity)
            for s in range(S):
                mine = slot[(shard == s) & ok]
                if mine.size == 0:
                    continue
                t = torch.as_tensor(mine.astype(np.int32), device=self.mesh[s])
                build.delete_impl(self._states[s], t, torch.ones_like(t, dtype=torch.bool))
            # the host count mirrors the device's: delete_impl decrements
            # only for rows that were live, so unknown or already-removed
            # gids cannot desync count()
            self._sizes = np.asarray([int(st.size) for st in self._states], dtype=np.int64)

    # -- query ------------------------------------------------------------

    def search_dispatch(self, queries, k: int):
        """Enqueue a batched query on every shard, then the merge on the
        first shard's device; returns fetch() -> (dist, gids), the host
        readback, which may run outside the lock: a later in-place update
        of a shard is enqueued after that shard's search, and the results
        are fresh tensors (SlotIndex.search_dispatch)."""
        queries, single = as_batch(queries, self.cfg.dims)
        with self._lock:
            q_host = torch.from_numpy(queries)
            parts = [  # enqueued on every shard
                search_state(st, q_host.to(dev, non_blocking=True), self.cfg, k, self._exact)
                for st, dev in zip(self._states, self.mesh)
            ]
            dist, ids = gid_merge(parts, k, capacity=self.capacity)
        return lambda: host_answer(dist, ids, single)

    def search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(dist[n, k] ascending, gids[n, k]); absent results (inf, -1)."""
        return self.search_dispatch(queries, k)()

    # -- maintenance --------------------------------------------------------

    def compact(self) -> dict[int, int]:
        """Reclaim tombstoned rows across all shards by rebuilding from the
        live rows; returns {old_gid: new_gid} for the owner's keymap."""
        scratch, remap = self.compact_prepare()
        self.compact_install(scratch)
        return remap

    def compact_prepare(self) -> tuple["ShardedSlotIndex", dict[int, int]]:
        """Rebuild the live rows into a scratch sharded index; the serving
        state stays untouched, so concurrent queries see the (old state,
        old gids) pair throughout.  The prepare/install contract of
        SlotIndex.compact_prepare."""
        with self._lock:
            S = self.n_shards
            vec_parts, gid_parts = [], []
            for s, st in enumerate(self._states):
                slots = torch.nonzero(st.valid).squeeze(1)
                if slots.numel() == 0:
                    continue
                rows = st.vectors[slots].float()
                if self.cfg.quantized:
                    rows = rows * st.scales[slots][:, None]
                vec_parts.append(rows.cpu().numpy())
                gid_parts.append(slots.cpu().numpy().astype(np.int64) * S + s)
            vectors = (
                np.concatenate(vec_parts)
                if vec_parts
                else np.zeros((0, self.cfg.dims), dtype=np.float32)
            )
            old_gids = np.concatenate(gid_parts) if gid_parts else np.zeros((0,), np.int64)
            cap = max(1 << max(len(vectors) // S, 1).bit_length(), 2 * INSERT_BLOCK)
            # the re-add rebuilds the router from scratch
            new_cfg = dataclasses.replace(
                self.cfg, routing_sample=routing_sample_for(cap), route_k=0
            )
        scratch = ShardedSlotIndex.__new__(ShardedSlotIndex)
        scratch.params = self.params
        scratch.mesh = self.mesh
        scratch.n_shards = S
        scratch.cfg = new_cfg
        scratch._exact = self._exact
        scratch._reset(cap)
        scratch._lock = threading.Lock()
        # the rows are stored preprocessed; preprocessing again is idempotent
        new_gids = scratch.add(vectors)
        return scratch, {int(o): int(n) for o, n in zip(old_gids, new_gids)}

    def compact_install(self, scratch: "ShardedSlotIndex") -> None:
        """Swap in the state prepared by compact_prepare."""
        with self._lock:
            self.cfg = scratch.cfg
            self._states = scratch._states
            self._frontiers = scratch._frontiers
            self._sizes = scratch._sizes
            self._route_built_at = scratch._route_built_at
            self._rr = scratch._rr

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot the shards to one npz in the JAX package's format (the
        per-shard arrays stacked [S, C, ...], bf16 as f32), under the index
        lock: the insert steps update the state in place."""
        with self._lock:
            meta = {
                "format": 1,
                "sharded": True,
                "n_shards": self.n_shards,
                "params": asdict(self.params),
                "cfg": asdict(self.cfg),
                "exact": self._exact,
                "frontiers": self._frontiers.tolist(),
                "sizes": self._sizes.tolist(),
                "route_built_at": self._route_built_at,
            }
            per_shard = [graph.state_to_numpy(s) for s in self._states]
            arrays = {f: np.stack([a[f] for a in per_shard]) for f in per_shard[0]}
            atomic_savez_compressed(
                path,
                **arrays,
                meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            )

    @classmethod
    def load(
        cls, path: str, mesh=None, n_devices: int | None = None, device="cuda"
    ) -> "ShardedSlotIndex":
        """An index from a snapshot written by `save` or by the JAX package,
        onto a mesh of as many shards as the snapshot has."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if not meta.get("sharded"):
                raise ValueError("not a sharded snapshot (use core.persist.load)")
            cfg = config_from_meta(meta["cfg"])  # without the JAX package's fused_gather
            idx = cls.__new__(cls)
            idx.params = IndexParams(**meta["params"])
            idx.mesh = make_mesh(n_devices or meta["n_shards"], mesh or device)
            if len(idx.mesh) != meta["n_shards"]:
                raise ValueError(
                    f"snapshot has {meta['n_shards']} shards, mesh has "
                    f"{len(idx.mesh)} devices"
                )
            idx.n_shards = meta["n_shards"]
            idx.cfg = cfg
            idx._exact = meta.get("exact", False)
            idx._frontiers = np.asarray(meta["frontiers"], dtype=np.int64)
            idx._sizes = np.asarray(meta["sizes"], dtype=np.int64)
            idx._route_built_at = meta.get("route_built_at", 0)
            idx._rr = int(idx._frontiers.sum() % idx.n_shards)
            idx._lock = threading.Lock()
            dtypes = {"vectors": cfg.tdtype, "route_centroids": cfg.compute_dtype}
            stacked = {f: z[f] for f in graph._FIELDS}

            def put(f: str, s: int, dev) -> torch.Tensor:
                t = from_numpy(stacked[f][s], dev)
                return t.to(dtypes[f]) if f in dtypes else t

            idx._states = [
                GraphState(**{f: put(f, s, dev) for f in stacked})
                for s, dev in enumerate(idx.mesh)
            ]
        return idx

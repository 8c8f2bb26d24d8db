"""Host-side graph/exact index wrapper (counterpart of
vector_store_tpu/core/index.py).

`SlotIndex` is the synchronous numpy-in/numpy-out face of the device
index.  It owns what the device steps must not see: the allocation cursor,
the capacity-doubling policy, the insert blocks and the router rebuild
schedule.  Key <-> slot mapping is the engine's (engine/keymap.py).

Differences from the JAX package, by design:
  * queries are not padded to fixed batch buckets (those bounded XLA
    compiles; eager PyTorch has none);
  * the expand round always runs kernel B3, whose CUDA or plain version is
    chosen by the device of the tensors (no backend probe);
  * the device is explicit (`device=`) and nothing falls back to the CPU.
Insert blocks keep their padding: the candidate pool of a block is
min(ef_add, P + M), so a short last block would prune over fewer
candidates and build another graph.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..types import IndexParams
from ..utils import metrics

from . import build, bruteforce, cluster, graph, search
from .distance import preprocess
from .graph import GraphConfig, GraphState
from .topk import as_batch, host_answer

# Insert block: adds go in blocks of this many rows; the last partial block
# is padded with dead lanes.
INSERT_BLOCK = 256

# Above this many rows the centroid router replaces the flat strided
# routing sample, and is rebuilt every time the row count doubles.
ROUTE_MIN_ROWS = 1 << 18


def routing_sample_for(capacity: int) -> int:
    """Routing-stage sample size: capacity / 8 within [4096, 256K].  The
    cap was sized for a 16 GB TPU chip and changes results, so it is kept
    as the JAX package has it until it is re-derived on the card."""
    return int(min(max(4096, capacity // 8), 1 << 18))


def config_from_params(params: IndexParams, capacity: int = 1 << 16) -> GraphConfig:
    """Translate the usearch-style knobs into the graph configuration."""
    return GraphConfig(
        dims=params.dimensions,
        degree=max(params.connectivity, 4),
        ef_search=max(params.expansion_search, 64),
        ef_add=max(params.expansion_add, 64),
        space=params.space,
        dtype=params.dtype if params.dtype in ("float32", "int8") else "bfloat16",
        routing_sample=routing_sample_for(capacity),
        entry_points=16,
    )


def search_state(
    state: GraphState, q: torch.Tensor, cfg: GraphConfig, k: int, exact: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enqueue the search of one query batch on one graph state: the beam
    search, or with `exact` the scan of every live row."""
    if exact:
        qp = preprocess(q, cfg.space).to(cfg.compute_dtype)
        scales = state.scales if cfg.quantized else None
        return bruteforce.search(qp, state.vectors, state.valid, cfg.space, k, scales=scales)
    return search.search_impl(state, q, cfg, k)


class SlotIndex:
    """Single-device ANN index over integer slots.

    Every device step (mutation or query enqueue) runs under one lock.  The
    steps update the state in place, and a query's kernels are enqueued on
    the same stream before any later update, so a query never sees a
    half-applied mutation."""

    def __init__(
        self,
        params: IndexParams,
        initial_capacity: int | None = None,
        exact: bool = False,
        insert_block: int = INSERT_BLOCK,
        device: str | torch.device = "cuda",
    ) -> None:
        self.params = params
        if exact:
            # graph-free upload ingests in big blocks at copy speed
            insert_block = max(insert_block, 4096)
        self.insert_block = insert_block
        self.device = torch.device(device)
        cap = initial_capacity or min(params.capacity, 1 << 16)
        cap = max(cap, 2 * insert_block)
        self.cfg = config_from_params(params, cap)
        if exact:
            # the scan never reads adjacency: keep it 1 wide
            self.cfg = dataclasses.replace(self.cfg, degree=1)
        self._state: GraphState = graph.init(self.cfg, cap, self.device)
        self._exact = exact
        self._route_built_at = 0  # frontier at the last router (re)build
        self._lock = threading.Lock()

    @classmethod
    def restore(
        cls,
        params: IndexParams,
        cfg: GraphConfig,
        state: GraphState,
        exact: bool,
        insert_block: int,
    ) -> "SlotIndex":
        """An index around an existing state (compaction's scratch index)."""
        idx = cls.__new__(cls)
        idx.params = params
        idx.cfg = cfg
        idx.insert_block = insert_block
        idx.device = state.device
        idx._exact = exact
        idx._state = state
        idx._route_built_at = int(state.frontier) if cfg.route_k > 0 else 0
        idx._lock = threading.Lock()
        return idx

    # -- introspection ----------------------------------------------------

    @property
    def state(self) -> GraphState:
        return self._state

    def count(self) -> int:
        return int(self._state.size)

    @property
    def capacity(self) -> int:
        return self._state.capacity

    @property
    def frontier(self) -> int:
        return int(self._state.frontier)

    # -- mutation ----------------------------------------------------------

    def _ensure_capacity(self, needed_rows: int) -> None:
        """Double the capacity until a block of headroom is left."""
        state = self._state
        need = int(state.frontier) + needed_rows
        cap = state.capacity
        if need + self.insert_block <= cap:
            return
        new_cap = cap
        while need + self.insert_block > new_cap:
            new_cap *= 2
        with metrics.span("vst_graph_grow_seconds"):
            self._state = graph.grow(state, new_cap)
        self.cfg = dataclasses.replace(self.cfg, routing_sample=routing_sample_for(new_cap))

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Insert vectors; returns their slots [n]."""
        vectors, _ = as_batch(vectors, self.cfg.dims)
        n, d = vectors.shape
        with self._lock:
            self._ensure_capacity(n)
            base = int(self._state.frontier)
            slots = np.arange(base, base + n, dtype=np.int32)
            step = build.upload_impl if self._exact else build.insert_impl
            block = self.insert_block
            for off in range(0, n, block):
                with metrics.span("vst_graph_insert_block_seconds"):
                    m = min(block, n - off)
                    blk = torch.zeros((block, d), dtype=torch.float32, device=self.device)
                    blk[:m] = torch.as_tensor(vectors[off : off + m], device=self.device)
                    if self.cfg.dtype != "float32":
                        # bf16 and int8 banks see the rows rounded to bf16 first,
                        # as the JAX package ships them (index.py:214-221)
                        blk = blk.to(torch.bfloat16)
                    live = torch.arange(block, device=self.device) < m
                    step(self._state, base + off, blk, live, self.cfg)
                self._maybe_rebuild_router_locked(base + off + m)
            # bound router staleness at the end of the call: a bulk load can
            # otherwise end with up to half the bank ring-assigned onto a
            # stale centroid set
            f = base + n
            if not self._exact and f >= ROUTE_MIN_ROWS and f >= 1.25 * self._route_built_at:
                self._rebuild_router_locked(f)
            return slots

    # -- hierarchical router ------------------------------------------------

    def _maybe_rebuild_router_locked(self, frontier: int) -> None:
        """Recluster when the bank doubled since the last build."""
        if self._exact or frontier < ROUTE_MIN_ROWS:
            return
        if frontier < 2 * self._route_built_at:
            return
        self._rebuild_router_locked(frontier)

    def _rebuild_router_locked(self, frontier: int, k: int | None = None) -> None:
        k = k or cluster.route_k_for(frontier)
        cfg = dataclasses.replace(self.cfg, route_k=k)
        with metrics.span("vst_graph_router_rebuild_seconds"):
            centroids, members, m_cnt = cluster.build_router(
                self._state, cfg, k, cfg.route_members_per
            )
        self.cfg = cfg
        self._state = dataclasses.replace(
            self._state, route_centroids=centroids, route_members=members, route_cnt=m_cnt
        )
        self._route_built_at = frontier

    def rebuild_router(self) -> None:
        """Force a router rebuild at the current frontier (add() does the
        same on doubling)."""
        with self._lock:
            f = int(self._state.frontier)
            if not self._exact and f >= ROUTE_MIN_ROWS:
                self._rebuild_router_locked(f)

    def refine(self, passes: int = 1, block: int = 256) -> None:
        """NN-descent refinement sweeps over the whole graph
        (build.refine_block_impl)."""
        with self._lock:
            for _ in range(passes):
                frontier = int(self._state.frontier)
                for base in range(0, frontier, block):
                    build.refine_block_impl(self._state, base, block, self.cfg)

    def compact(self) -> dict[int, int]:
        """Reclaim tombstoned rows by rebuilding from the live rows; returns
        {old_slot: new_slot} for the owner's keymap."""
        scratch, remap = self.compact_prepare()
        self.compact_install(scratch)
        return remap

    def compact_prepare(self) -> tuple["SlotIndex", dict[int, int]]:
        """Rebuild the live rows into a scratch index without touching the
        serving state.  Returns (scratch, {old_slot: new_slot}); the owner
        swaps its keymap and calls compact_install atomically with respect
        to its queries.  Mutations must not run between the two (the actor
        mailbox serialises them against Compact)."""
        with self._lock:
            state = self._state
            live_slots = torch.nonzero(state.valid).squeeze(1)
            vectors = state.vectors[live_slots].float()
            if self.cfg.quantized:
                vectors = vectors * state.scales[live_slots][:, None]
            vectors = vectors.cpu().numpy()
            live_slots = live_slots.cpu().numpy()
            cfg = self.cfg
        cap = max(1 << int(max(len(live_slots), 1) - 1).bit_length(), 2 * self.insert_block)
        new_cfg = dataclasses.replace(cfg, routing_sample=routing_sample_for(cap), route_k=0)
        scratch = SlotIndex.restore(
            self.params,
            new_cfg,
            graph.init(new_cfg, cap, self.device),
            self._exact,
            self.insert_block,
        )
        # the rows are preprocessed already; preprocessing again is
        # idempotent in every space
        new_slots = scratch.add(vectors)
        return scratch, {int(o): int(n) for o, n in zip(live_slots, new_slots)}

    def compact_install(self, scratch: "SlotIndex") -> None:
        """Swap in the state prepared by compact_prepare."""
        with self._lock:
            self.cfg = scratch.cfg
            self._state = scratch._state
            self._route_built_at = scratch._route_built_at

    def remove(self, slots: np.ndarray) -> None:
        # dedup: a repeated slot would decrement the live count twice
        slots = np.unique(np.asarray(slots, dtype=np.int32).reshape(-1))
        if slots.size == 0:
            return
        with self._lock:
            t = torch.as_tensor(slots, device=self.device)
            build.delete_impl(self._state, t, torch.ones_like(t, dtype=torch.bool))

    # -- query -------------------------------------------------------------

    def search_dispatch(self, queries: np.ndarray, k: int, exact: bool | None = None):
        """Enqueue a batched query; returns fetch() -> (dist, slots).

        The device work is enqueued under the index lock on the current
        stream; fetch() does the host readback and may run outside the
        lock: a later in-place update is enqueued after these kernels, and
        the results are fresh tensors, so several batches can be in flight
        (MicroBatcher pipeline depth)."""
        exact = self._exact if exact is None else exact
        queries, single = as_batch(queries, self.cfg.dims)
        with self._lock, metrics.span("index.search_dispatch", series=False):
            q = torch.as_tensor(queries, device=self.device)
            dist, ids = search_state(self._state, q, self.cfg, k, exact)
        return lambda: host_answer(dist, ids, single)

    def search(
        self, queries: np.ndarray, k: int, exact: bool | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched ANN query -> (dist[n, k], slots[n, k]); missing results
        are (+inf, -1).  `exact` overrides the index's default backend."""
        return self.search_dispatch(queries, k, exact)()

    def exact_search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Brute-force oracle over the same state (recall measurement)."""
        return self.search(queries, k, exact=True)

    def get_vectors(self, slots: np.ndarray) -> np.ndarray:
        """Stored (preprocessed) rows for slots; bf16 widens to f32."""
        t = self._state.vectors[torch.as_tensor(np.asarray(slots, dtype=np.int64), device=self.device)]
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

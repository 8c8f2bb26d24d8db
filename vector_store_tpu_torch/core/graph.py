"""Device-resident ANN graph index: state and lifecycle, in PyTorch
(counterpart of vector_store_tpu/core/graph.py).

The index is a set of fixed-shape tensors on one device:

  vectors   [C, D]   storage dtype (f32 / bf16 / int8 + scale), ingest-
                     preprocessed (unit-norm for cosine space)
  neighbors [C, R]   int32 fixed-degree adjacency, SENTINEL-padded
  nbr_dist  [C, R]   f32 cached edge lengths
  valid     [C]      bool liveness (False = tombstone)
  size      []       int32 live count
  frontier  []       int32 rows allocated so far (sequential)
  route_*            the centroid router (core/cluster.py); 1-row dummies
                     while cfg.route_k == 0 (flat strided routing)

Where the JAX package rebuilt these arrays through donated buffers, the
port's steps (core/build.py) update them in place.  Entry points come from
a routing stage: a strided sample of the bank scored by one matmul, or the
centroid router once the bank is large.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .distance import gathered, pairwise
from .ivf import _from_numpy
from .quantize import quantize_rows
from .topk import INF, SENTINEL, topk_ascending, topk_ascending_stable

INVALID = SENTINEL


@dataclass
class GraphState:
    vectors: torch.Tensor  # [C, D] storage dtype
    scales: torch.Tensor  # [C] f32 per-row dequant scale (1.0 unless int8)
    neighbors: torch.Tensor  # [C, R] int32
    nbr_dist: torch.Tensor  # [C, R] f32
    valid: torch.Tensor  # [C] bool
    size: torch.Tensor  # [] int32
    frontier: torch.Tensor  # [] int32
    route_centroids: torch.Tensor  # [K', D] compute dtype
    route_members: torch.Tensor  # [K', Bm] int32 ring of member slots
    route_cnt: torch.Tensor  # [K'] int32 ring cursors

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dims(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


_FIELDS = tuple(f.name for f in fields(GraphState))


@dataclass(frozen=True)
class GraphConfig:
    """Configuration of the graph steps, field for field the JAX package's
    (vector_store_tpu/core/graph.py:68-136) without `fused_gather`: the
    port's expand round always runs the gather-score kernel B3, and the
    device of the tensors decides between the CUDA kernel and its plain
    version.  `approx_topk` keeps its name but only selects the sort-free
    pool merge: every top-k here is exact."""

    dims: int
    degree: int = 32  # R, usearch connectivity
    ef_search: int = 64  # beam pool P
    ef_add: int = 128  # insert candidate pool
    beam_width: int = 4  # nodes expanded per search iteration
    iters: int = 0  # 0 -> derived: max(8, ef_search // beam_width)
    space: str = "cosine"
    dtype: str = "bfloat16"  # storage dtype: "float32" | "bfloat16" | "int8"
    routing_sample: int = 1024  # strided sample scored by matmul for entry
    entry_points: int = 8  # entries per query taken from the routing stage
    route_k: int = 0  # centroid count (0 = flat routing)
    route_members_per: int = 16  # ring size Bm per centroid
    route_probes: int = 8  # clusters probed per query
    prune_alpha: float = 1.2  # robust-prune slack (DiskANN-style)
    keep_nearest: int = -1  # -1 -> degree // 2 plain-nearest edges
    approx_topk: bool = True  # sort-free pool merge (merge_pool_fast)

    @property
    def n_keep_nearest(self) -> int:
        return self.degree // 2 if self.keep_nearest < 0 else self.keep_nearest

    @property
    def search_iters(self) -> int:
        return self.iters if self.iters > 0 else max(8, self.ef_search // self.beam_width)

    @property
    def tdtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[
            self.dtype
        ]

    @property
    def quantized(self) -> bool:
        return self.dtype == "int8"

    @property
    def compute_dtype(self) -> torch.dtype:
        """Dtype distance operands are rounded to (int8 banks dequantise to
        bf16); products are summed in f32."""
        return torch.float32 if self.dtype == "float32" else torch.bfloat16


def router_shapes(cfg: GraphConfig) -> tuple[int, int]:
    """(K', Bm') of the router fields: 1-wide dummies while routing is flat."""
    if cfg.route_k > 0:
        return cfg.route_k, cfg.route_members_per
    return 1, 1


def init_router(cfg: GraphConfig, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    k, bm = router_shapes(cfg)
    return (
        torch.zeros((k, cfg.dims), dtype=cfg.compute_dtype, device=device),
        torch.full((k, bm), SENTINEL, dtype=torch.int32, device=device),
        torch.zeros((k,), dtype=torch.int32, device=device),
    )


def init(cfg: GraphConfig, capacity: int, device) -> GraphState:
    """Fresh empty index with reserved capacity."""
    rc, rm, rn = init_router(cfg, device)
    return GraphState(
        vectors=torch.zeros((capacity, cfg.dims), dtype=cfg.tdtype, device=device),
        scales=torch.ones((capacity,), dtype=torch.float32, device=device),
        neighbors=torch.full((capacity, cfg.degree), INVALID, dtype=torch.int32, device=device),
        nbr_dist=torch.full((capacity, cfg.degree), INF, dtype=torch.float32, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        size=torch.zeros((), dtype=torch.int32, device=device),
        frontier=torch.zeros((), dtype=torch.int32, device=device),
        route_centroids=rc,
        route_members=rm,
        route_cnt=rn,
    )


def grow(state: GraphState, new_capacity: int) -> GraphState:
    """Capacity growth: a new state with every row buffer padded (contents
    kept; the router is capacity-independent)."""
    c = state.capacity
    if new_capacity <= c:
        raise ValueError(f"new capacity {new_capacity} <= {c}")

    def pad(t, fill):
        extra = torch.full((new_capacity - c, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
        return torch.cat([t, extra])

    return GraphState(
        vectors=pad(state.vectors, 0),
        scales=pad(state.scales, 1.0),
        neighbors=pad(state.neighbors, INVALID),
        nbr_dist=pad(state.nbr_dist, INF),
        valid=pad(state.valid, False),
        size=state.size,
        frontier=state.frontier,
        route_centroids=state.route_centroids,
        route_members=state.route_members,
        route_cnt=state.route_cnt,
    )


def state_from_numpy(src, device) -> GraphState:
    """A state from any object with the GraphState fields as arrays (e.g. a
    JAX GraphState read out with np.asarray); bf16 arrays keep their bits."""
    return GraphState(**{f: _from_numpy(getattr(src, f), device) for f in _FIELDS})


def state_to_numpy(state: GraphState) -> dict[str, np.ndarray]:
    """The fields as numpy arrays; bf16 fields widen exactly to f32."""
    out = {}
    for f in _FIELDS:
        t = getattr(state, f).detach().cpu()
        out[f] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out


def gather_rows(vectors: torch.Tensor, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows for (possibly SENTINEL) ids -> (rows, is_sentinel).  Sentinel
    ids are clipped into range for the gather; the caller masks them."""
    is_sent = ids >= vectors.shape[0]
    safe = ids.clamp(0, vectors.shape[0] - 1).long()
    return vectors[safe], is_sent


def gather_vectors(
    state: GraphState, ids: torch.Tensor, cfg: GraphConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows in the compute dtype; int8 rows are dequantised in f32 and
    rounded to bf16, as the JAX package's XLA path does."""
    rows, is_sent = gather_rows(state.vectors, ids)
    if cfg.quantized:
        sc = state.scales[ids.clamp(0, state.capacity - 1).long()]
        rows = (rows.float() * sc[..., None]).to(cfg.compute_dtype)
    return rows, is_sent


def store_vectors(vecs_f32: torch.Tensor, cfg: GraphConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Preprocessed f32 rows -> (storage rows, scales) for the bank."""
    if cfg.quantized:
        return quantize_rows(vecs_f32)
    ones = torch.ones((vecs_f32.shape[0],), dtype=torch.float32, device=vecs_f32.device)
    return vecs_f32.to(cfg.tdtype), ones


def _routed_entries(
    state: GraphState, queries: torch.Tensor, cfg: GraphConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Entries from the centroid router: [Q, K] centroid distances -> top
    `route_probes` clusters -> score their ring members -> best
    `entry_points`."""
    Q = queries.shape[0]
    K, Bm = state.route_members.shape
    cd = pairwise(queries, state.route_centroids.to(queries.dtype), cfg.space)
    p = min(cfg.route_probes, K)
    _, cids = topk_ascending(cd, p)
    cand = state.route_members[cids].reshape(Q, p * Bm)
    vecs, is_sent = gather_vectors(state, cand, cfg)
    d = gathered(queries, vecs, cfg.space).masked_fill(is_sent, INF)
    E = min(cfg.entry_points, p * Bm)
    dist, pos = topk_ascending_stable(d, E)
    ids = torch.gather(cand, 1, pos).masked_fill(torch.isinf(dist), SENTINEL)
    return dist, ids


def routing_entries(
    state: GraphState,
    queries: torch.Tensor,  # [Q, D] preprocessed, compute dtype
    cfg: GraphConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Entry points (dist[Q, E], ids[Q, E]): the best `entry_points` of a
    strided sample of allocated rows, or of the centroid router's members
    when cfg.route_k is set."""
    if cfg.route_k > 0:
        return _routed_entries(state, queries, cfg)
    C = state.capacity
    S = min(cfg.routing_sample, C)
    # sequential allocation makes a stride a uniform sample over insertion
    # order; rows past the frontier are masked
    stride = max(C // S, 1)
    sample_ids = (torch.arange(S, dtype=torch.int32, device=state.device) * stride) % C
    in_range = sample_ids < state.frontier
    sample_vecs, _ = gather_vectors(state, sample_ids, cfg)
    d = pairwise(queries, sample_vecs, cfg.space).masked_fill(~in_range[None, :], INF)
    # the [Q, S] reduction is where the JAX package goes approximate; the
    # port keeps an exact top-k without the stable tie order
    dist, pos = topk_ascending(d, min(cfg.entry_points, S))
    ids = sample_ids[pos].masked_fill(torch.isinf(dist), SENTINEL)
    return dist, ids

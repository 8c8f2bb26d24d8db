"""Centroid router construction (counterpart of vector_store_tpu/core/cluster.py).

Above SlotIndex's ROUTE_MIN_ROWS the flat strided routing sample gives way
to a two-level router:

  centroids [K, D]   k-means centroids of the bank (one matmul to score)
  members   [K, Bm]  per-centroid ring of member slots (entry candidates)
  m_cnt     [K]      assignments per centroid (ring write cursor)

Construction is k-means on the device: a strided-sample init, LLOYD_ITERS
Lloyd iterations over a sample of up to LLOYD_SAMPLE rows in ASSIGN_CHUNK
chunks, then one assignment pass that fills the rings.  Inserts keep the
rings current (`ring_assign`, core/build.py); SlotIndex rebuilds the router
as the bank grows.
"""

from __future__ import annotations

import torch

from .distance import normalize, pairwise
from .graph import GraphConfig, GraphState, gather_vectors
from .topk import SENTINEL, rank_in_run

# Assignment matmul chunk: rows scored against the centroid bank per step.
ASSIGN_CHUNK = 4096
# Lloyd refinement sample cap and iteration count.
LLOYD_SAMPLE = 1 << 18
LLOYD_ITERS = 2


def route_k_for(rows: int) -> int:
    """Centroid count: ~64 rows per cluster, a multiple of 128, in
    [4096, 65536]."""
    k = min(max(rows // 64, 4096), 1 << 16)
    return (k // 128) * 128


def assign(centroids: torch.Tensor, vecs: torch.Tensor, space: str) -> torch.Tensor:
    """[M] int32 nearest centroid of each row (ties to the lowest id)."""
    return torch.argmin(pairwise(vecs, centroids, space), dim=-1).to(torch.int32)


def ring_assign(
    members: torch.Tensor,  # [K, Bm] int32, updated in place
    m_cnt: torch.Tensor,  # [K] int32, updated in place
    cids: torch.Tensor,  # [M] int32 assigned centroid per row
    slots: torch.Tensor,  # [M] int32 row ids
    live: torch.Tensor,  # [M] bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write a batch of rows into their centroids' member rings.

    Rows sorted by centroid and ranked within each run land at ring
    positions (cursor + rank) % Bm.  When a run wraps the ring, the
    latest-ranked row of each position wins, as a sequential scatter would
    leave it; only those rows are written, so no position is written twice."""
    K, Bm = members.shape
    key = torch.where(live, cids, K)  # dead lanes sort last
    order = torch.sort(key, stable=True).indices
    key_s, slot_s = key[order], slots[order]
    rank = rank_in_run(key_s)
    ok = key_s < K
    row = key_s.clamp(max=K - 1).long()
    run_len = torch.bincount(row[ok], minlength=K)
    last = ok & (rank >= run_len[row] - Bm)
    lanes = torch.nonzero(last).squeeze(1)
    pos = ((m_cnt[row] + rank) % Bm).long()
    members[row[lanes], pos[lanes]] = slot_s[lanes]
    m_cnt += run_len.to(torch.int32)
    return members, m_cnt


def seed_centroids(state: GraphState, cfg: GraphConfig, route_k: int) -> torch.Tensor:
    """Strided sample of allocated rows as initial centroids [K, D]."""
    f = max(int(state.frontier), 1)
    stride = max(f // route_k, 1)
    ids = (torch.arange(route_k, dtype=torch.int64, device=state.device) * stride) % f
    centroids, _ = gather_vectors(state, ids, cfg)
    return centroids.to(cfg.compute_dtype)


def lloyd_chunk(
    state: GraphState,
    cfg: GraphConfig,
    centroids: torch.Tensor,  # [K, D]
    off: int,
    sample_n_max: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Partial segment sums/counts over sample rows [off, off + CHUNK)."""
    k = centroids.shape[0]
    f = max(int(state.frontier), 1)
    sample_n = min(f, sample_n_max)
    stride = max(f // sample_n, 1)
    lane = off + torch.arange(ASSIGN_CHUNK, dtype=torch.int64, device=state.device)
    ids = (lane * stride) % f
    vecs, _ = gather_vectors(state, ids, cfg)
    vecs = vecs.to(cfg.compute_dtype)
    live = state.valid[ids.clamp(0, state.capacity - 1)] & (lane < sample_n)
    # dead lanes add into a spill row k that is dropped
    cid = torch.where(live, assign(centroids, vecs, cfg.space).long(), k)
    sums = torch.zeros((k + 1, vecs.shape[1]), dtype=torch.float32, device=state.device)
    cnts = torch.zeros((k + 1,), dtype=torch.float32, device=state.device)
    sums.index_add_(0, cid, vecs.float())
    cnts.index_add_(0, cid, torch.ones_like(cid, dtype=torch.float32))
    return sums[:k], cnts[:k]


def lloyd_finish(
    centroids: torch.Tensor, sums: torch.Tensor, cnts: torch.Tensor, space: str
) -> torch.Tensor:
    mean = sums / cnts.clamp(min=1.0)[:, None]
    if space == "cosine":
        mean = normalize(mean)
    return torch.where((cnts > 0)[:, None], mean.to(centroids.dtype), centroids)


def fill_chunk(
    state: GraphState,
    cfg: GraphConfig,
    centroids: torch.Tensor,
    members: torch.Tensor,
    m_cnt: torch.Tensor,
    off: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Assign rows [off, off + CHUNK) into member rings (in place)."""
    ids = off + torch.arange(ASSIGN_CHUNK, dtype=torch.int32, device=state.device)
    vecs, _ = gather_vectors(state, ids, cfg)
    live = state.valid[ids.clamp(0, state.capacity - 1).long()] & (ids < state.frontier)
    cid = assign(centroids, vecs.to(cfg.compute_dtype), cfg.space)
    return ring_assign(members, m_cnt, cid, ids, live)


def build_router(
    state: GraphState,
    cfg: GraphConfig,
    route_k: int,
    members_per: int,
    lloyd_iters: int = LLOYD_ITERS,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cluster the bank and fill the member rings.  Returns (centroids
    [route_k, D], members [route_k, Bm], m_cnt [route_k]) for a state whose
    cfg has route_k set."""
    frontier = int(state.frontier)
    if frontier < route_k:
        raise ValueError(f"{frontier} rows cannot seed {route_k} centroids")
    centroids = seed_centroids(state, cfg, route_k)
    sample_n = min(frontier, LLOYD_SAMPLE)
    for _ in range(lloyd_iters):
        sums = torch.zeros((route_k, cfg.dims), dtype=torch.float32, device=state.device)
        cnts = torch.zeros((route_k,), dtype=torch.float32, device=state.device)
        for off in range(0, sample_n, ASSIGN_CHUNK):
            s, c = lloyd_chunk(state, cfg, centroids, off, LLOYD_SAMPLE)
            sums += s
            cnts += c
        centroids = lloyd_finish(centroids, sums, cnts, cfg.space)
    members = torch.full((route_k, members_per), SENTINEL, dtype=torch.int32, device=state.device)
    m_cnt = torch.zeros((route_k,), dtype=torch.int32, device=state.device)
    for off in range(0, frontier, ASSIGN_CHUNK):
        fill_chunk(state, cfg, centroids, members, m_cnt, off)
    return centroids, members, m_cnt

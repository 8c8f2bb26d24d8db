"""Batched incremental graph construction: insert, delete, upload, refine
(counterpart of vector_store_tpu/core/build.py).

A block of M new vectors is grafted into the graph by one step:

  1. candidates: a beam search of the existing graph (insert_cfg: wide
     and shallow, kernel B3 in every round) plus the M x M block among the
     new vectors themselves (which also bootstraps an empty graph);
  2. robust prune (DiskANN-style alpha rule) picks <= R diverse forward
     neighbours per new node: one scan of the sorted candidate pool (one
     kernel launch on the card) with the candidate-pairwise distances from
     one batched matmul;
  3. rows, scales, forward edges and edge lengths are written in place;
  4. reverse edges: edges sorted by (target, length), each target's first
     REVERSE_ROUNDS edges offered to its row in order (one kernel launch
     on the card, one warp a target; on the CPU rounds of the rank-r edges,
     so no round writes one target row twice).

Deletes are tombstones (valid = False): dead nodes keep routing traffic
and are filtered from results.  Every step updates the state's tensors in
place (where JAX donated its buffers) and returns the state.
"""

from __future__ import annotations

import dataclasses

import torch

from . import graph_cuda
from .cluster import ring_assign
from .distance import gathered, pairwise, preprocess
from .graph import GraphConfig, GraphState, gather_vectors, store_vectors
from .search import search_pool
from .topk import INF, SENTINEL, dedup_by_id, topk_ascending_stable

# Reverse-edge rounds: edges ranked >= this within their target are dropped
# (only when many same-batch nodes pick one hub neighbour).
REVERSE_ROUNDS = 16


def _pairwise_batched(vecs: torch.Tensor, space: str) -> torch.Tensor:
    """[M, C, D] -> per-node candidate-pairwise distances [M, C, C] f32."""
    v = vecs.float()
    dots = torch.bmm(v, v.transpose(1, 2))
    if space == "dot":
        return -dots
    if space == "cosine":
        return 1.0 - dots
    sq = torch.sum(v * v, dim=-1)
    return sq[:, :, None] + sq[:, None, :] - 2.0 * dots


def _robust_prune(
    cand_dist: torch.Tensor,  # [M, C] ascending query -> candidate distances
    cand_ids: torch.Tensor,  # [M, C]
    cand_vecs: torch.Tensor,  # [M, C, D]
    cfg: GraphConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Select <= R diverse neighbours per node (alpha-RobustPrune).

    Best first: keep c unless some kept s has alpha * d(s, c) <= d(q, c)
    (the first n_keep_nearest candidates are kept regardless); stop at R.
    Returns (dist[M, R], ids[M, R]) padded with (+inf, SENTINEL).  The
    selection is one launch of the prune kernel on the card
    (graph_cuda.robust_prune), its plain loop on the CPU."""
    pd = _pairwise_batched(cand_vecs, cfg.space)
    shift = _dot_shift(pd, cand_dist) if cfg.space == "dot" else None
    return graph_cuda.robust_prune(
        pd,
        cand_dist.contiguous(),
        cand_ids.contiguous(),
        shift,
        cfg.prune_alpha,
        cfg.degree,
        cfg.n_keep_nearest,
    )


def _dot_shift(pd: torch.Tensor, cand_dist: torch.Tensor) -> torch.Tensor:
    """The prune's shift in the dot space, a device scalar <= 0.  dot
    "distances" can be negative, where alpha > 1 would tighten the rule
    instead of loosening it: both sides are shifted to >= 0 by the
    batch-wide minimum (the returned distances stay unshifted)."""
    return torch.minimum(
        pd.masked_fill(~torch.isfinite(pd), INF).min(),
        cand_dist.masked_fill(~torch.isfinite(cand_dist), INF).min(),
    ).clamp(max=0.0)


def _apply_reverse_edges(
    neighbors: torch.Tensor,  # [C, R], updated in place
    nbr_dist: torch.Tensor,  # [C, R], updated in place
    tgt: torch.Tensor,  # [E] edge targets
    src: torch.Tensor,  # [E] edge sources
    d: torch.Tensor,  # [E] edge lengths
    e_live: torch.Tensor,  # [E] bool
) -> None:
    """Degree-clamped reverse-edge insertion: an edge replaces its target's
    longest edge when it is shorter, a target's edges in order of length,
    those ranked REVERSE_ROUNDS or later dropped.  One launch of the
    reverse-edge kernel on the card (graph_cuda.reverse_edges), the rounds
    loop on the CPU."""
    graph_cuda.reverse_edges(neighbors, nbr_dist, tgt, src, d, e_live, REVERSE_ROUNDS)


def insert_cfg(cfg: GraphConfig) -> GraphConfig:
    """Search configuration for insert-time candidates: wide and shallow
    (beam 16, pool ef_add / 2 with a floor of 32, >= 4 rounds), where the
    serving beam is narrow and deep.  The prune draws on the pool plus the
    M x M batch block, so the smaller pool leaves its candidate count
    unchanged."""
    width = max(cfg.beam_width, 16)
    pool = max(32, cfg.ef_add // 2)
    return dataclasses.replace(cfg, ef_search=pool, beam_width=width, iters=max(4, pool // width))


def insert_impl(
    state: GraphState,
    base_slot: int,  # first of M contiguous fresh rows
    vecs: torch.Tensor,  # [M, D] raw new vectors
    live: torch.Tensor,  # [M] bool, padding lanes False
    cfg: GraphConfig,
) -> GraphState:
    """Graft a block of new nodes into the graph (in place).  The block
    occupies rows [base_slot, base_slot + M); base_slot >= frontier."""
    M = vecs.shape[0]
    dev = state.device
    frontier = state.frontier.clone()  # the pre-block frontier
    slots = base_slot + torch.arange(M, dtype=torch.int32, device=dev)
    vecs_f32 = preprocess(vecs.float(), cfg.space)
    vecs = vecs_f32.to(cfg.compute_dtype)

    # 1. candidates from the existing graph (pre-block state) ...
    g_dist, g_ids = search_pool(state, vecs, insert_cfg(cfg))  # [M, P]
    # ... and from the block itself; graph ids (< frontier) and block
    # slots (>= frontier) are disjoint, so a plain concat needs no dedup
    b_mask = torch.eye(M, dtype=torch.bool, device=dev) | ~live[None, :] | ~live[:, None]
    b_dist = pairwise(vecs, vecs, cfg.space).masked_fill(b_mask, INF)
    b_ids = slots[None, :].expand(M, M).masked_fill(b_mask, SENTINEL)
    cand_dist = torch.cat([g_dist, b_dist], dim=1)
    cand_ids = torch.cat([g_ids, b_ids], dim=1)
    pool = min(cfg.ef_add, cand_dist.shape[1])
    cand_dist, pos = topk_ascending_stable(cand_dist, pool)
    cand_ids = torch.gather(cand_ids, 1, pos)

    # 2. robust prune over rows from the bank (graph ids) or the block
    is_batch = cand_ids >= frontier
    from_store, is_sent = gather_vectors(state, cand_ids, cfg)
    from_batch = vecs[(cand_ids.long() - base_slot).clamp(0, M - 1)]
    cand_vecs = torch.where((is_batch & ~is_sent)[..., None], from_batch, from_store)
    sel_d, sel_i = _robust_prune(cand_dist, cand_ids, cand_vecs, cfg)

    # 3. rows and forward edges of the live lanes (JAX: mode="drop" scatters)
    lanes = torch.nonzero(live).squeeze(1)
    w = slots[lanes].long()
    store_rows, store_scales = store_vectors(vecs_f32[lanes], cfg)
    state.vectors[w] = store_rows
    state.scales[w] = store_scales
    state.neighbors[w] = sel_i[lanes]
    state.nbr_dist[w] = sel_d[lanes]
    state.valid[w] = True

    # 4. reverse edges, onto pre-existing rows only
    R = cfg.degree
    tgt = sel_i.reshape(-1)
    d = sel_d.reshape(-1)
    e_live = live[:, None].expand(M, R).reshape(-1) & (tgt != SENTINEL) & (d < INF) & (tgt < frontier)
    src = slots[:, None].expand(M, R).reshape(-1)
    _apply_reverse_edges(state.neighbors, state.nbr_dist, tgt, src, d, e_live)

    # 5. router maintenance: new rows join their centroid's ring
    if cfg.route_k > 0:
        ad = pairwise(vecs, state.route_centroids.to(vecs.dtype), cfg.space)
        cid = torch.argmin(ad, dim=-1).to(torch.int32)
        ring_assign(state.route_members, state.route_cnt, cid, slots, live)

    state.size += live.sum().to(torch.int32)
    state.frontier = torch.maximum(frontier, torch.where(live, slots + 1, 0).max())
    return state


def delete_impl(state: GraphState, slots: torch.Tensor, live: torch.Tensor) -> GraphState:
    """Tombstone a batch of rows (in place); padding lanes have live=False.
    Rows stay traversable until a compaction reclaims them.  A slot outside
    the bank (an id never issued) changes nothing.  This differs from the
    JAX package on purpose: its scatter drops such a slot too, but it
    counts it as removed wherever row C-1 is live (`was` reads the clipped
    slot), so its size falls by one for a row it kept."""
    live = live & (slots >= 0) & (slots < state.capacity)
    was = state.valid[slots.clamp(0, state.capacity - 1).long()] & live
    state.valid[slots[torch.nonzero(live).squeeze(1)].long()] = False
    state.size -= was.sum().to(torch.int32)
    return state


def upload_impl(
    state: GraphState,
    base_slot: int,
    vecs: torch.Tensor,  # [M, D]
    live: torch.Tensor,  # [M] bool
    cfg: GraphConfig,
) -> GraphState:
    """Graph-free ingest for the exact backend: write rows only (in place)."""
    M = vecs.shape[0]
    slots = base_slot + torch.arange(M, dtype=torch.int32, device=state.device)
    lanes = torch.nonzero(live).squeeze(1)
    w = slots[lanes].long()
    store_rows, store_scales = store_vectors(preprocess(vecs[lanes].float(), cfg.space), cfg)
    state.vectors[w] = store_rows
    state.scales[w] = store_scales
    state.valid[w] = True
    state.size += live.sum().to(torch.int32)
    state.frontier = torch.maximum(state.frontier, torch.where(live, slots + 1, 0).max())
    return state


def refine_block_impl(
    state: GraphState,
    base_slot: int,  # block start (contiguous rows)
    block: int,
    cfg: GraphConfig,
) -> GraphState:
    """NN-descent local join (in place): recompute the forward edges of rows
    [base, base + block) from their 2-hop neighbourhood, then offer each
    refined edge to its target through the reverse edges."""
    C = state.capacity
    R = cfg.degree
    slots = base_slot + torch.arange(block, dtype=torch.int32, device=state.device)
    in_range = slots < state.frontier
    node_vecs, _ = gather_vectors(state, slots, cfg)

    hop1 = state.neighbors[slots.clamp(0, C - 1).long()]  # [B, R]
    hop2 = state.neighbors[hop1.clamp(0, C - 1).long().reshape(-1)].reshape(block, R * R)
    hop2 = hop2.masked_fill((hop1 == SENTINEL).repeat_interleave(R, dim=1), SENTINEL)
    cand_ids = torch.cat([hop1, hop2], dim=1)  # [B, R + R^2]

    cand_vecs, is_sent = gather_vectors(state, cand_ids, cfg)
    cand_dist = gathered(node_vecs, cand_vecs, cfg.space)
    del cand_vecs
    bad = is_sent | (cand_ids == slots[:, None])
    cand_dist, cand_ids = dedup_by_id(cand_dist.masked_fill(bad, INF), cand_ids.masked_fill(bad, SENTINEL))
    pool = min(cfg.ef_add, cand_dist.shape[1])
    cand_dist, pos = topk_ascending_stable(cand_dist, pool)
    cand_ids = torch.gather(cand_ids, 1, pos)

    cand_vecs, _ = gather_vectors(state, cand_ids, cfg)
    sel_d, sel_i = _robust_prune(cand_dist, cand_ids, cand_vecs, cfg)
    lanes = torch.nonzero(in_range).squeeze(1)
    w = slots[lanes].long()
    state.neighbors[w] = sel_i[lanes]
    state.nbr_dist[w] = sel_d[lanes]

    tgt = sel_i.reshape(-1)
    d = sel_d.reshape(-1)
    e_live = in_range[:, None].expand(block, R).reshape(-1) & (tgt != SENTINEL) & (d < INF)
    src = slots[:, None].expand(block, R).reshape(-1)
    _apply_reverse_edges(state.neighbors, state.nbr_dist, tgt, src, d, e_live)
    return state

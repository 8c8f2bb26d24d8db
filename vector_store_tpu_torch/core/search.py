"""Batched beam search over the device-resident graph (counterpart of
vector_store_tpu/core/search.py).

A block of queries advances in lockstep through cfg.search_iters
expand-gather-score-merge rounds (a Python loop where JAX had `lax.scan`):

  1. pick the best `B` unexpanded pool entries per query
  2. read their adjacency rows, neighbors[sel] -> [Q, B*R] candidates, and
  3. score the candidate rows: both in one launch of kernel B3
     (core/graph_cuda.py::expand_score_fused)
  4. drop repeats and merge into the per-query pool (core/topk.py)

The pool doubles as the visited set: a merge keeps the expanded flag of
entries already processed, so re-discovered nodes are never re-expanded.
"""

from __future__ import annotations

import torch

from .distance import preprocess
from .graph import GraphConfig, GraphState, routing_entries
from .graph_cuda import expand_score_fused
from .topk import INF, SENTINEL, merge_pool, merge_pool_fast, topk_ascending_stable


def _init_pool(
    state: GraphState, queries: torch.Tensor, cfg: GraphConfig
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Seed the pool from the routing stage; pad to P with sentinels."""
    P = cfg.ef_search
    e_dist, e_ids = routing_entries(state, queries, cfg)  # [Q, E]
    if e_ids.shape[1] > P:
        e_dist, pos = topk_ascending_stable(e_dist, P)
        e_ids = torch.gather(e_ids, 1, pos)
    pad = P - e_ids.shape[1]
    pool_dist = torch.nn.functional.pad(e_dist, (0, pad), value=INF)
    pool_ids = torch.nn.functional.pad(e_ids, (0, pad), value=SENTINEL)
    return pool_dist, pool_ids, torch.zeros_like(pool_dist, dtype=torch.bool)


def select_frontier(pool, B: int):
    """Step 1: the best B unexpanded entries per query, marked expanded.
    Returns (sel_ids [Q, B] int32, sel_live [Q, B] bool, the new expanded
    flags [Q, P])."""
    pool_dist, pool_ids, pool_exp = pool
    frontier_dist = pool_dist.masked_fill(pool_exp, INF)
    sel_d, sel_pos = topk_ascending_stable(frontier_dist, B)
    sel_ids = torch.gather(pool_ids, 1, sel_pos)
    sel_live = sel_d < INF
    pool_exp = pool_exp | torch.zeros_like(pool_exp).scatter_(1, sel_pos, sel_live)
    return sel_ids, sel_live, pool_exp


def _expand_round(state: GraphState, queries_f32: torch.Tensor, cfg: GraphConfig, pool):
    sel_ids, sel_live, pool_exp = select_frontier(pool, cfg.beam_width)
    # 2-3. adjacency rows -> candidates [Q, B*R], scored; (SENTINEL, INF)
    # for dead beams and adjacency padding
    cand_ids, cand_dist = expand_score_fused(
        state.vectors, state.scales, state.neighbors, queries_f32, sel_ids, sel_live, cfg.space
    )
    # 4. merge into the pool (repeats keep their expanded copy)
    merge = merge_pool_fast if cfg.approx_topk else merge_pool
    return merge(pool[0], pool[1], pool_exp, cand_dist, cand_ids)


def search_pool(
    state: GraphState,
    queries: torch.Tensor,  # [Q, D] preprocessed, compute dtype
    cfg: GraphConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the fixed-trip beam search; returns the sorted pool (dist[Q, P],
    ids[Q, P]) with tombstoned nodes included (the insert path keeps them
    as waypoints; search_impl filters them)."""
    # B3 scores in f32: the queries are rounded to the compute dtype by the
    # caller, then widened, as the JAX package's fused path does
    queries_f32 = queries.float().contiguous()
    pool = _init_pool(state, queries, cfg)
    for _ in range(cfg.search_iters):
        pool = _expand_round(state, queries_f32, cfg, pool)
    pool_dist, pool_ids, _ = pool
    return pool_dist, pool_ids


def search_impl(
    state: GraphState,
    queries: torch.Tensor,  # [Q, D] raw
    cfg: GraphConfig,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k live nodes per query: (dist[Q, k] ascending, ids[Q, k]);
    absent results are (+inf, SENTINEL)."""
    queries = preprocess(queries.float(), cfg.space).to(cfg.compute_dtype)
    pool_dist, pool_ids = search_pool(state, queries, cfg)

    # tombstones helped traversal but are not returned
    alive = state.valid[pool_ids.clamp(0, state.capacity - 1).long()] & (pool_ids != SENTINEL)
    pool_dist = pool_dist.masked_fill(~alive, INF)
    pool_ids = pool_ids.masked_fill(~alive, SENTINEL)

    k_eff = min(k, pool_dist.shape[1])
    top_d, pos = topk_ascending_stable(pool_dist, k_eff)
    top_i = torch.gather(pool_ids, 1, pos)
    if k > k_eff:
        top_d = torch.nn.functional.pad(top_d, (0, k - k_eff), value=INF)
        top_i = torch.nn.functional.pad(top_i, (0, k - k_eff), value=SENTINEL)
    return top_d, top_i

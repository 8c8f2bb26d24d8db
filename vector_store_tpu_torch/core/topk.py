"""Top-k selection and sorted-pool merge primitives (counterpart of
vector_store_tpu/core/topk.py).

INF marks an empty or dead candidate; SENTINEL is the "no row" id and
sorts after every real id.  The beam-search pool is kept as fixed-shape,
distance-sorted tensors (dist[Q, P], ids[Q, P], expanded[Q, P]); a merge
concatenates new candidates, drops duplicate ids and keeps the best P.

Ties: `jax.lax.top_k` breaks them toward the lowest index, and the merges
below keep that order (stable sorts), so pools match the JAX package's
wherever distances tie.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float("inf")
SENTINEL = 2**31 - 1


def topk_ascending(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis -> (dist[..., k], idx[..., k]) sorted.

    Exact: the JAX package switches to `approx_min_k` on large reductions
    (its `topk_ascending_approx`); the port keeps exact top-k everywhere (a
    divergence by design)."""
    return torch.topk(dist, k, dim=-1, largest=False, sorted=True)


def topk_ascending_stable(
    dist: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """As topk_ascending, but ties go to the lowest position (the order
    `jax.lax.top_k` and `jnp.argmin` give)."""
    d, idx = torch.sort(dist, dim=-1, stable=True)
    return d[..., :k], idx[..., :k]


def lexsort_stable(keys: list[torch.Tensor]) -> torch.Tensor:
    """Permutation along the last axis that sorts lexicographically by
    `keys` (most significant first), stably: a stable sort by each key
    from the least significant up.  Takes the place of a multi-key
    `jax.lax.sort`."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else torch.gather(key, -1, perm)
        order = torch.sort(k, dim=-1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, -1, order)
    return perm


def _dup_of_prev(ids_s: torch.Tensor) -> torch.Tensor:
    """True where a sorted id equals its left neighbour."""
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[..., 1:] = ids_s[..., 1:] == ids_s[..., :-1]
    return dup


def merge_pool_fast(
    pool_dist: torch.Tensor,  # [Q, P] ascending
    pool_ids: torch.Tensor,  # [Q, P]
    pool_expanded: torch.Tensor,  # [Q, P] bool
    new_dist: torch.Tensor,  # [Q, C]
    new_ids: torch.Tensor,  # [Q, C]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-free pool merge: new candidates already in the pool, and
    repeats within the new block, are masked; the survivors meet the pool
    in one top-k over P + C lanes.  A repeated id carries the same
    distance in every copy, so which copy survives does not matter."""
    P = pool_dist.shape[-1]
    ids_s, order = torch.sort(new_ids, dim=-1, stable=True)
    dist_s = torch.gather(new_dist, -1, order)
    in_pool = (ids_s[:, :, None] == pool_ids[:, None, :]).any(dim=-1)  # [Q, C]
    bad = in_pool | _dup_of_prev(ids_s)
    new_dist = dist_s.masked_fill(bad, INF)
    new_ids = ids_s.masked_fill(bad, SENTINEL)
    all_dist = torch.cat([pool_dist, new_dist], dim=-1)
    all_ids = torch.cat([pool_ids, new_ids], dim=-1)
    all_exp = torch.cat([pool_expanded, torch.zeros_like(bad)], dim=-1)
    top_d, pos = topk_ascending_stable(all_dist, P)
    return top_d, torch.gather(all_ids, -1, pos), torch.gather(all_exp, -1, pos)


def dedup_by_id(
    dist: torch.Tensor,  # [..., C]
    ids: torch.Tensor,  # [..., C] int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask duplicate ids (keep the first-best copy) by sorting on
    (id, dist).  Returns (dist, ids) sorted by id, duplicates replaced by
    (+inf, SENTINEL)."""
    perm = lexsort_stable([ids, dist])
    ids_s = torch.gather(ids, -1, perm)
    dist_s = torch.gather(dist, -1, perm)
    dup = _dup_of_prev(ids_s)
    return dist_s.masked_fill(dup, INF), ids_s.masked_fill(dup, SENTINEL)


def merge_pool(
    pool_dist: torch.Tensor,  # [Q, P] ascending
    pool_ids: torch.Tensor,  # [Q, P]
    pool_expanded: torch.Tensor,  # [Q, P] bool
    new_dist: torch.Tensor,  # [Q, C]
    new_ids: torch.Tensor,  # [Q, C]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge new candidates into the beam pool, dedup'd by id, best P kept.

    Sorting on (id, not-expanded) puts the pool's expanded copy of a
    repeated id first, so its expanded flag survives: membership in the
    pool is the visited set."""
    P = pool_dist.shape[-1]
    all_dist = torch.cat([pool_dist, new_dist], dim=-1)
    all_ids = torch.cat([pool_ids, new_ids], dim=-1)
    all_exp = torch.cat([pool_expanded, torch.zeros_like(new_dist, dtype=torch.bool)], dim=-1)
    perm = lexsort_stable([all_ids, (~all_exp).to(torch.int32)])
    ids_s = torch.gather(all_ids, -1, perm)
    dist_s = torch.gather(all_dist, -1, perm)
    exp_s = torch.gather(all_exp, -1, perm)
    dup = _dup_of_prev(ids_s)
    dist_s = dist_s.masked_fill(dup, INF)
    ids_s = ids_s.masked_fill(dup, SENTINEL)
    exp_s = exp_s & ~dup
    top_d, pos = topk_ascending_stable(dist_s, P)
    return top_d, torch.gather(ids_s, -1, pos), torch.gather(exp_s, -1, pos)


def rank_in_run(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal keys (1-D, sorted).

    Turns a sorted key stream into conflict-free scatter positions for the
    reverse-edge rounds (build.py) and the ring assign (cluster.py)."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=sorted_keys.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return (idx - run_start).to(torch.int32)


# --------------------------------------------------------------------------
# the host side of every index's add and search_dispatch


def as_batch(rows, dims: int) -> tuple[np.ndarray, bool]:
    """A row or a batch of them (vectors to add, queries) as [n, dims] f32,
    and whether it was one."""
    rows = np.asarray(rows, dtype=np.float32)
    single = rows.ndim == 1
    if single:
        rows = rows[None, :]
    _, d = rows.shape
    if d != dims:
        raise ValueError(f"dimension mismatch: index {dims}, got {d}")
    return rows, single


def host_answer(dist, ids, single: bool) -> tuple[np.ndarray, np.ndarray]:
    """A top-k read back to the host: (dist, ids int64), absent results
    (inf, -1); a single query's row alone.  `dist` and `ids` are tensors,
    or lists of per-chunk tensors, each joined just before its readback."""
    dist_h = (torch.cat(dist) if isinstance(dist, list) else dist).cpu().numpy()
    ids_h = (torch.cat(ids) if isinstance(ids, list) else ids).cpu().numpy().astype(np.int64)
    ids_h[~np.isfinite(dist_h)] = -1
    if single:
        return dist_h[0], ids_h[0]
    return dist_h, ids_h

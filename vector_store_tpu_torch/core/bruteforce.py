"""Exact (brute-force) top-k search (counterpart of
vector_store_tpu/core/bruteforce.py).

The recall oracle of the graph index (SlotIndex.exact_search) and the
search of kind "exact".  One float32 matmul per bank chunk, with a running
[Q, k] top-k merged after each chunk; int8 chunks are dequantised to bf16
first, as the JAX package does.  The JAX package selects within a chunk
with `approx_min_k`; the port's top-k is exact.
"""

from __future__ import annotations

import torch

from .distance import pairwise
from .topk import INF, SENTINEL, topk_ascending, topk_ascending_stable

CHUNK = 1 << 17


def search(
    queries: torch.Tensor,  # [Q, D] preprocessed, compute dtype
    bank: torch.Tensor,  # [N, D] f32 / bf16 / int8
    valid: torch.Tensor,  # [N] bool, tombstones False
    space: str,
    k: int,
    chunk: int = CHUNK,
    scales: torch.Tensor | None = None,  # [N] int8 dequant scales
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist[Q, k] ascending, ids[Q, k] int32); masked or missing rows are
    (+inf, SENTINEL)."""
    Q = queries.shape[0]
    N = bank.shape[0]
    dequant = scales is not None and bank.dtype == torch.int8
    best_d = torch.full((Q, k), INF, dtype=torch.float32, device=queries.device)
    best_i = torch.full((Q, k), SENTINEL, dtype=torch.int32, device=queries.device)
    for off in range(0, N, chunk):
        b = bank[off : off + chunk]
        if dequant:
            b = (b.float() * scales[off : off + chunk, None]).to(torch.bfloat16)
        d = pairwise(queries, b, space).masked_fill(~valid[None, off : off + chunk], INF)
        cd, ci = topk_ascending(d, min(k, b.shape[0]))
        ci = (ci + off).to(torch.int32).masked_fill(torch.isinf(cd), SENTINEL)
        best_d, pos = topk_ascending_stable(torch.cat([best_d, cd], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, ci], dim=1), 1, pos)
    return best_d, best_i

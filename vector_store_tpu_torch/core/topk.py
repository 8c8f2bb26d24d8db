"""Top-k conventions shared by the IVF paths (counterpart of
vector_store_tpu/core/topk.py:15-22).

INF marks an empty or dead candidate; SENTINEL is the "no row" id and
sorts after every real id.
"""

from __future__ import annotations

import torch

INF = float("inf")
SENTINEL = 2**31 - 1


def topk_ascending(dist: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis -> (dist[..., k], idx[..., k]) sorted.

    Exact: the JAX package switches to `approx_min_k` on large reductions;
    the port keeps `torch.topk` everywhere (a divergence by design)."""
    return torch.topk(dist, k, dim=-1, largest=False, sorted=True)


def topk_ascending_stable(
    dist: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """As topk_ascending, but ties go to the lowest position (the order
    `jax.lax.top_k` and `jnp.argmin` give)."""
    d, idx = torch.sort(dist, dim=-1, stable=True)
    return d[..., :k], idx[..., :k]

"""Distance primitives in PyTorch (counterpart of vector_store_tpu/core/distance.py).

All functions return *ascending* distances (smaller = closer):

    cosine: 1 - cos(q, x)     (vectors pre-normalised at ingest)
    l2:     squared L2
    dot:    -<q, x>

Operands of any floating dtype are widened to float32 before the product,
so a bf16 operand contributes its exact value and the sum is taken in
float32 — the same numbers JAX gets from a bf16 `dot_general` with
`preferred_element_type=float32`.  A bf16 torch matmul would instead round
its *output* to bf16.
"""

from __future__ import annotations

import torch

Space = str  # "cosine" | "l2" | "dot"


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise rows (cosine space stores unit vectors)."""
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    return (xf / torch.clamp(n, min=eps)).to(x.dtype)


def preprocess(x: torch.Tensor, space: Space) -> torch.Tensor:
    """Ingest-time transform: cosine-space vectors are stored unit-length."""
    if space == "cosine":
        return normalize(x)
    return x


def pairwise(
    queries: torch.Tensor,  # [Q, D]
    bank: torch.Tensor,  # [N, D]
    space: Space,
    bank_sqnorm: torch.Tensor | None = None,  # [N] optional |x|^2
) -> torch.Tensor:  # [Q, N] ascending distances, f32
    """Dense Q x N distance block via one float32 matmul."""
    q = queries.float()
    x = bank.float()
    dots = q @ x.T
    if space == "dot":
        return -dots
    if space == "cosine":
        return 1.0 - dots
    if bank_sqnorm is None:
        bank_sqnorm = torch.sum(x * x, dim=-1)
    q_sq = torch.sum(q * q, dim=-1, keepdim=True)
    return q_sq + bank_sqnorm[None, :] - 2.0 * dots


def gathered(
    queries: torch.Tensor,  # [Q, D]
    cand_vecs: torch.Tensor,  # [Q, C, D] per-query candidate vectors
    space: Space,
) -> torch.Tensor:  # [Q, C] ascending distances, f32
    """Per-query candidate distances as a batched mat-vec."""
    q = queries.float()
    c = cand_vecs.float()
    dots = torch.bmm(c, q[:, :, None])[..., 0]
    if space == "dot":
        return -dots
    if space == "cosine":
        return 1.0 - dots
    c_sq = torch.sum(c * c, dim=-1)
    q_sq = torch.sum(q * q, dim=-1, keepdim=True)
    return q_sq + c_sq - 2.0 * dots

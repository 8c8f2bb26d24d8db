"""Plain reference for cosine ANN search: an exact scan in float32.

Imports torch alone (nothing of the program): the rows and queries it is
given are the benchmark's own, made again from the seed.  TF32 is turned
off, so every product is a float32 one.

    distance(q, x) = 1 - <q / |q|, x / |x|>
"""

from __future__ import annotations

import torch

# rows scored per matmul: [pool, BLOCK] f32 distances (8,192 x 128k = 4 GiB)
BLOCK = 1 << 17


def _f32_products() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def topk(rows: torch.Tensor, queries: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by cosine distance: (distances [q, k] ascending, row
    indices [q, k])."""
    _f32_products()
    q = normalize(queries)
    best_d = torch.full((len(q), k), float("inf"), device=q.device)
    best_i = torch.full((len(q), k), -1, dtype=torch.long, device=q.device)
    for off in range(0, len(rows), BLOCK):
        x = normalize(rows[off : off + BLOCK])
        d = 1.0 - q @ x.T
        kk = min(k, d.shape[1])
        bd, bi = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        cat_d = torch.cat([best_d, bd], 1)
        cat_i = torch.cat([best_i, bi + off], 1)
        order = torch.sort(cat_d, dim=1, stable=True)[1][:, :k]
        best_d = torch.gather(cat_d, 1, order)
        best_i = torch.gather(cat_i, 1, order)
    return best_d, best_i


def pair_distances(rows: torch.Tensor, queries: torch.Tensor, qidx: torch.Tensor,
                   keys: torch.Tensor, block: int = 1 << 16) -> torch.Tensor:
    """[m, k] distances from query qidx[i] to row keys[i, j], in float32;
    keys must be valid row indices."""
    _f32_products()
    q = normalize(queries)
    out = torch.empty(keys.shape, dtype=torch.float32, device=keys.device)
    for off in range(0, len(keys), block):
        kb = keys[off : off + block]
        x = normalize(rows[kb.reshape(-1)]).reshape(*kb.shape, -1)
        qb = q[qidx[off : off + block]]
        out[off : off + block] = 1.0 - torch.einsum("mkd,md->mk", x, qb)
    return out

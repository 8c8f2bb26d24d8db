"""Plain reference for cosine ANN search: an exact scan in float32.

Imports torch alone (nothing of the program): the rows and queries it is
given are the benchmark's own, made again from the seed.  TF32 is turned
off, so every product is a float32 one.

    distance(q, x) = 1 - <q / |q|, x / |x|>

As a reference module (see vsbench/judge.py) it gives every pool query's
exact top-k and one number compared of its own:

  dist_gap    the widest gap, over every key of every answer, between the
              distance the program returned and the reference's float32
              distance from the query to the row the key names: it fails
              a wrong key (the engine's key mapping) and a wrong score
              (the kernels).

Its control (`lower`) is the same exact search over rows stored in a lower
precision:

    int8, int4  per-row symmetric codes of the normalised rows,
                scale = max|x| / 127 (or 7), as the program's int8 rows
    fp8         float8 e4m3 of the normalised rows, scaled per row so that
                the largest element is 448
    bf16        the rows rounded to bfloat16 (what the graph stores)
"""

from __future__ import annotations

import torch

# rows scored per matmul: [pool, BLOCK] f32 distances (8,192 x 128k = 4 GiB)
BLOCK = 1 << 17

# dist_gap reads every answered key's distance: an answer without them is bad
SCORES = True

LEVELS = {"int8": 127.0, "int4": 7.0}


def _f32_products() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def _merge(best_d, best_i, d, off, k):
    """The k best of (best_d, best_i) and the block's distances d, whose
    row indices start at `off`."""
    bd, bi = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False, sorted=True)
    cat_d = torch.cat([best_d, bd], 1)
    cat_i = torch.cat([best_i, bi + off], 1)
    order = torch.sort(cat_d, dim=1, stable=True)[1][:, :k]
    return torch.gather(cat_d, 1, order), torch.gather(cat_i, 1, order)


def topk(rows: torch.Tensor, queries: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by cosine distance: (distances [q, k] ascending, row
    indices [q, k])."""
    _f32_products()
    q = normalize(queries)
    best_d = torch.full((len(q), k), float("inf"), device=q.device)
    best_i = torch.full((len(q), k), -1, dtype=torch.long, device=q.device)
    for off in range(0, len(rows), BLOCK):
        x = normalize(rows[off : off + BLOCK])
        best_d, best_i = _merge(best_d, best_i, 1.0 - q @ x.T, off, k)
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


def exact(rows: torch.Tensor, queries: torch.Tensor, k: int) -> torch.Tensor:
    """[q, k] row indices of every query's exact top-k (every list is full
    where there are k rows)."""
    return topk(rows, queries, k)[1]


def compared(rows: torch.Tensor, queries: torch.Tensor, judged, exact_ids: torch.Tensor) -> dict[str, float]:
    """dist_gap over the judged answers (vsbench/judge.py's Judged); 2, the
    widest a cosine distance can be off, where nothing was answered."""
    if len(judged.qidx) == 0:
        return {"dist_gap": 2.0}
    dev = rows.device
    ids = torch.as_tensor(judged.ids, device=dev)
    given = ids >= 0
    ref = pair_distances(rows, queries, torch.as_tensor(judged.qidx, device=dev),
                         torch.where(given, ids, 0))
    gap = (torch.as_tensor(judged.scores, device=dev) - ref).abs()
    return {"dist_gap": float(torch.where(given, gap, 0.0).max())}


def store(x: torch.Tensor, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(values as float32, scale [n]) of normalised rows x in `precision`:
    a row reads scale * values."""
    if precision == "bf16":
        return x.to(torch.bfloat16).float(), torch.ones(len(x), device=x.device)
    absmax = torch.clamp(x.abs().amax(dim=1), min=1e-12)
    if precision == "fp8":
        scale = absmax / 448.0
        return (x / scale[:, None]).to(torch.float8_e4m3fn).float(), scale
    levels = LEVELS[precision]
    scale = absmax / levels
    return torch.clamp(torch.round(x / scale[:, None]), -levels, levels), scale


def lower(rows: torch.Tensor, queries: torch.Tensor, k: int,
          precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The control's answers: (row indices [q, k], distances [q, k]), the
    exact top-k of every query over the rows stored in `precision`."""
    q = normalize(queries)
    best_d = torch.full((len(q), k), float("inf"), device=q.device)
    best_i = torch.full((len(q), k), -1, dtype=torch.long, device=q.device)
    for off in range(0, len(rows), BLOCK):
        vals, scale = store(normalize(rows[off : off + BLOCK]), precision)
        best_d, best_i = _merge(best_d, best_i, 1.0 - (q @ vals.T) * scale[None, :], off, k)
    return best_i, best_d

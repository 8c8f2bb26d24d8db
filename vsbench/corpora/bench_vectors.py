"""Float rows and a query pool of noisy rows, made from the seed.

The bench corpus recipe (the repository's `make_dataset`, here on a torch
Generator so that the rows are made on the card), sized by the
configuration's "rows", "index.dimensions" and "data" and the traffic's
"pool" and "query_noise":

  * rows: n rows around max(n // rows_per_centre, 16) standard-normal
    centres, each row its centre plus `sigma` times a standard-normal draw;
  * queries: `pool` distinct rows plus `query_noise` times a standard-normal
    draw, from a second generator, so the pool does not depend on how the
    rows were made.

The same seed on the same device gives the same numbers, whichever side
(the driver or the reference) asks for them.  Nothing is written to disk.
"""

from __future__ import annotations

import numpy as np
import torch

# rows made per call on the device: 128k x 768 f32 is 0.4 GB
CHUNK = 1 << 17

_MIX = 0x9E3779B97F4A7C15


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * _MIX + stream) % (1 << 64))
    return g


def _sizes(config: dict, traffic: dict) -> tuple[dict, int, int, int, float]:
    """(recipe, rows, dimensions, pool, query noise) of a cell."""
    return (config["data"], int(config["rows"]), int(config["index"]["dimensions"]),
            int(traffic["pool"]), float(traffic["query_noise"]))


def row_chunks(recipe: dict, n: int, d: int, seed: int, device):
    """Yield (offset, rows [m, d] f32 on `device`) over the n rows in order."""
    g = _generator(seed, 1, device)
    n_centres = max(n // int(recipe["rows_per_centre"]), 16)
    centres = torch.randn((n_centres, d), generator=g, device=device)
    for off in range(0, n, CHUNK):
        m = min(CHUNK, n - off)
        which = torch.randint(n_centres, (m,), generator=g, device=device)
        x = torch.randn((m, d), generator=g, device=device)
        x.mul_(float(recipe["sigma"])).add_(centres[which])
        yield off, x


def rows_on(recipe: dict, n: int, d: int, seed: int, device) -> torch.Tensor:
    """All n rows as one [n, d] f32 tensor on `device`."""
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    for off, x in row_chunks(recipe, n, d, seed, device):
        out[off : off + len(x)] = x
    return out


def rows_to_host(recipe: dict, n: int, d: int, seed: int, device) -> np.ndarray:
    """The n rows as a host array, made on `device` a chunk at a time."""
    out = np.empty((n, d), dtype=np.float32)
    for off, x in row_chunks(recipe, n, d, seed, device):
        out[off : off + len(x)] = x.cpu().numpy()
    return out


def pool_draw(n: int, d: int, pool: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(row index [pool] of each query's source row, noise [pool, d]): the
    pool's random part, on `device`."""
    g = _generator(seed, 2, device)
    idx = torch.randperm(n, generator=g, device=device)[:pool]
    noise = torch.randn((pool, d), generator=g, device=device)
    return idx, noise


def pool_from(src: torch.Tensor, noise: torch.Tensor, scale: float) -> torch.Tensor:
    """[pool, d] f32 queries: the source rows `src` [pool, d] plus `scale` x
    noise."""
    return src + scale * noise


def for_driver(config: dict, traffic: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """(rows [n, d] f32, queries [pool, d] f32) as host arrays, made on
    `device`: what the driver loads and what the clients send."""
    recipe, n, d, pool, noise_scale = _sizes(config, traffic)
    rows = rows_to_host(recipe, n, d, seed, device)
    idx, noise = pool_draw(n, d, pool, seed, device)
    src = torch.as_tensor(rows[idx.cpu().numpy()], device=device)
    return rows, pool_from(src, noise, noise_scale).cpu().numpy()


def for_reference(config: dict, traffic: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The same rows and queries as f32 tensors on `device`."""
    recipe, n, d, pool, noise_scale = _sizes(config, traffic)
    rows = rows_on(recipe, n, d, seed, device)
    idx, noise = pool_draw(n, d, pool, seed, device)
    return rows, pool_from(rows[idx], noise, noise_scale)

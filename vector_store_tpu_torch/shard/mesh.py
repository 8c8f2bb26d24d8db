"""The device list a sharded index spreads over, and the merge of the
shards' answers (counterpart of vector_store_tpu/shard/mesh.py).

Document sharding is the only axis a vector store has: each shard owns
its rows, a query batch goes to every shard, and the shards' top-k lists
meet in one merge.  The JAX package is single-controller: one process,
state arrays with a leading shard axis placed one block per device, every
step a `shard_map`.  Here one process holds a list of per-shard states,
one per entry of the mesh, and loops over them; CUDA launches are
asynchronous, so a step is enqueued on every shard before anything is
read back.

A mesh is a list of `torch.device`.  An entry may repeat: several logical
shards then share one device, which is how the CPU tests run four shards
and how one card can hold the layout of four.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.topk import SENTINEL


def make_mesh(n_devices: int | None = None, device="cuda") -> list[torch.device]:
    """The mesh of `n_devices` shards on `device`.

    "cuda": the first n visible cards, all of them for None or 0.  A
    sequence of devices is the mesh as given (every sharded class takes
    `mesh=`, such a list, or `n_devices=` with `device=`).  Any other device
    ("cpu", "cuda:1"): n logical shards on that one device (1 for None or
    0)."""
    if isinstance(device, (list, tuple)):
        return [torch.device(d) for d in device]
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        n = n_devices or have
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * (n_devices or 1)


def gid_merge(
    parts: Sequence[tuple[torch.Tensor, torch.Tensor]],  # per shard (val [Q, k'], id [Q, k'])
    k: int,
    capacity: int | None = None,
    descending: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode each shard's local ids as global ones and merge the lists.

    gid = local * S + shard (SENTINEL stays SENTINEL): independent of any
    capacity, so ids given out before a growth stay valid after it.  With
    `capacity`, local ids are clipped into [0, capacity) first, as the
    graph's merge does.  The [Q, k'] pairs move to the first shard's
    device and are joined shard-major along the last axis; the best k are
    taken ascending (distances) or descending (scores).  Among equal values
    the lower position in that shard-major row comes first, the order
    `jax.lax.top_k` gives the JAX package."""
    S = len(parts)
    dev0 = parts[0][0].device
    vals, gids = [], []
    for shard, (v, i) in enumerate(parts):
        local = i if capacity is None else i.clamp(0, capacity - 1)
        gid = torch.where(i == SENTINEL, SENTINEL, local * S + shard)
        vals.append(v.to(dev0, non_blocking=True))
        gids.append(gid.to(dev0, non_blocking=True))
    flat_v = torch.cat(vals, dim=-1)
    flat_i = torch.cat(gids, dim=-1)
    mv, pos = torch.sort(flat_v, dim=-1, descending=descending, stable=True)
    return mv[..., :k], torch.gather(flat_i, -1, pos[..., :k])

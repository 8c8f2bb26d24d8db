"""Index persistence: checkpoint/restore of the device graph (counterpart
of vector_store_tpu/core/persist.py, and the same file format).

The reference has **no** persistence: indexes are memory-only and rebuilt
from the source of truth on every (re)create (SURVEY §5; reference
src/httproutes.rs:76-79 recreate, src/db_index.rs:104-130 full rescan).
Rebuild-from-source remains the parity behaviour; this module closes the
gap the reference left open: it snapshots the device-resident graph
(vectors + adjacency + liveness + router) plus the host-side key map to
one ``.npz``, so a large index restarts without re-scanning.

A snapshot written by either package loads in the other.  The port's
`GraphConfig` has no `fused_gather` (its expand round always runs kernel
B3): `save` writes none, which the JAX package's `load` accepts since it
sets the field itself, and `load` drops the key from a JAX-written cfg.
"""

from __future__ import annotations

import json
from dataclasses import asdict, fields
from typing import Optional

import numpy as np
import torch

from ..types import IndexParams
from ..utils.persistio import atomic_savez_compressed
from . import graph
from .graph import GraphConfig, GraphState
from .index import SlotIndex

FORMAT_VERSION = 1

_CFG_FIELDS = frozenset(f.name for f in fields(GraphConfig))


def save(path: str, index: SlotIndex, keymap_blob: Optional[dict] = None) -> None:
    """Snapshot a SlotIndex (and optionally the engine's key map) to npz.

    Holds the index lock for the whole snapshot: the insert steps update
    the state in place, so an unlocked read during live ingest could tear
    the frontier against the bank."""
    with index._lock:
        meta = {
            "format": FORMAT_VERSION,
            "params": asdict(index.params),
            "cfg": asdict(index.cfg),
            "exact": index._exact,
            "insert_block": index.insert_block,
        }
        # int8 banks snapshot in their native byte width (a cast to f32
        # would quadruple the file); bf16 has no portable npz encoding, so
        # it rides as f32 (state_to_numpy widens it) and re-narrows on load
        arrays = graph.state_to_numpy(index._state)
        atomic_savez_compressed(
            path,
            **arrays,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            keymap=np.frombuffer(json.dumps(keymap_blob or {}).encode(), dtype=np.uint8),
        )


def config_from_meta(meta_cfg: dict, **override) -> GraphConfig:
    """GraphConfig from a snapshot's cfg, without the fields this package
    does not have (`fused_gather`, a backend-local choice of the JAX
    package, not index data)."""
    kept = {k: v for k, v in meta_cfg.items() if k in _CFG_FIELDS}
    return GraphConfig(**{**kept, **override})


def load(path: str, device: str | torch.device = "cuda") -> tuple[SlotIndex, dict]:
    """Restore a SlotIndex on `device`; returns (index, keymap_blob)."""
    device = torch.device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["format"] != FORMAT_VERSION:
            raise ValueError(f"unsupported snapshot format {meta['format']}")
        params = IndexParams(**meta["params"])
        cfg = config_from_meta(meta["cfg"])
        exact = meta.get("exact", False)
        # older snapshots predate the insert_block field: re-derive the
        # block size SlotIndex.__init__ would have chosen for the mode
        insert_block = meta.get("insert_block", 4096 if exact else 256)

        def dev(name: str, dtype: torch.dtype | None = None) -> torch.Tensor:
            t = torch.from_numpy(np.array(z[name])).to(device)
            return t if dtype is None else t.to(dtype)

        if "route_centroids" in z.files:
            router = (
                dev("route_centroids", cfg.compute_dtype),
                dev("route_members"),
                dev("route_cnt"),
            )
        else:  # pre-router snapshot: dummy tensors, flat routing
            cfg = config_from_meta(meta["cfg"], route_k=0)
            router = graph.init_router(cfg, device)
        state = GraphState(
            vectors=dev("vectors", cfg.tdtype),
            scales=dev("scales"),
            neighbors=dev("neighbors"),
            nbr_dist=dev("nbr_dist"),
            valid=dev("valid"),
            size=dev("size"),
            frontier=dev("frontier"),
            route_centroids=router[0],
            route_members=router[1],
            route_cnt=router[2],
        )
        index = SlotIndex.restore(params, cfg, state, exact, insert_block)
        keymap_blob = json.loads(bytes(z["keymap"]).decode())
    return index, keymap_blob

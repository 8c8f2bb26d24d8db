"""Document-sharded BM25 over a device list (counterpart of
vector_store_tpu/text/sharded_bm25.py).

The single-device BM25Index (text/bm25.py) streams every document row
through one device; a collection past one device's memory shards across
the mesh as the ANN banks do (shard/sharded_index.py): documents deal
round-robin to shards, a query batch goes to every shard, each scores its
rows with the same scorer, and the per-shard top-k lists meet in one
descending merge on the first shard's device.

Host bookkeeping (tokenisation, vocabulary, df/idf, phrase sequences, slot
allocation) is the base class's, unchanged: a flat slot space where slot s
lives on shard `s % S` at row `s // S`.  Sequential slot allocation
therefore deals documents round-robin with no coordination, and the gid a
shard emits (`row * S + shard`) is the flat host slot, so every host-side
consumer (keymap, phrase and AST verification) works as it is.  The
average document length is global.

Two things override the base class (`add_batch` is the base class's, so
a batch lands on the same flat slots as the same documents added one by
one):
  * `_device_arrays`: one (terms, tf, length, valid) tuple per shard, with
    the same power-of-two row buckets and dirty-row writes;
  * `_score`: the scorer on every shard, then the merge (scores merge
    descending, unlike the distance merges of the ANN indexes).

Ties: among equal scores a shard's list holds the lower row first, and the
merge keeps the lower position in the shard-major concatenation of the
lists, which is what `jax.lax.top_k` gives the JAX package.  The
single-device index breaks ties by lower slot instead; the two orders
differ only among documents of exactly equal score.
"""

from __future__ import annotations

import numpy as np
import torch

from ..shard.mesh import gid_merge, make_mesh
from ..utils import metrics
from .bm25 import BM25Index, _score_topk


class ShardedBM25Index(BM25Index):
    """BM25Index with its document bank sharded across a device list.

    The host API of the base class (add -> flat slot, remove(slot),
    search(texts, k) -> [(slot, score)]); only where the rows live and the
    scoring step differ."""

    MIN_SHARD_ROWS = 128  # row-bucket floor (tests shrink it to force growth)

    def __init__(
        self,
        initial_capacity: int = 1 << 14,
        mesh=None,
        n_devices: int | None = None,
        device="cuda",
    ) -> None:
        self.mesh = make_mesh(n_devices, mesh or device)
        self.n_shards = len(self.mesh)
        super().__init__(initial_capacity, device=self.mesh[0])

    # -- device residency --------------------------------------------------

    def _device_arrays(self):
        """One (terms, tf, length, valid) tuple per shard, brought up to
        date (under the lock)."""
        S = self.n_shards
        hosts = (self._terms, self._tf, self._length, self._valid)
        per = -(-max(self._frontier, 1) // S)  # rows per shard up to the frontier
        R = 1 << max(per, self.MIN_SHARD_ROWS).bit_length()  # doubling buckets
        host_cap = self._terms.shape[0]
        R = min(R, -(-host_cap // S) or 1)
        if self._dev is None or self._dev_rows != R:
            # (re)size: every shard uploads its rows, flat slot j * S + s
            # to row j of shard s; rows past the host arrays are zeros
            def rows_of(a: np.ndarray, s: int) -> torch.Tensor:
                block = a[s : R * S : S]
                if len(block) < R:
                    block = np.concatenate(
                        [block, np.zeros((R - len(block),) + a.shape[1:], a.dtype)]
                    )
                return torch.from_numpy(np.ascontiguousarray(block)).to(self.mesh[s], copy=True)

            with metrics.span("vst_text_upload_seconds"):
                self._dev = None  # the old tensors go before the new arrive
                self._dev = [tuple(rows_of(a, s) for a in hosts) for s in range(S)]
            self._dev_rows = R
            self._dirty_slots.clear()
        elif self._dirty_slots:
            with metrics.span("vst_text_flush_seconds"):
                slots = np.fromiter(self._dirty_slots, dtype=np.int64)
                slots = slots[slots < R * S]
                for s in range(S):
                    mine = slots[slots % S == s]
                    if mine.size == 0:
                        continue
                    at = torch.from_numpy(mine // S).to(self.mesh[s])
                    for dev, host in zip(self._dev[s], hosts):
                        dev[at] = torch.from_numpy(host[mine]).to(self.mesh[s])
            self._dirty_slots.clear()
        return self._dev

    # -- scoring -----------------------------------------------------------

    def _score(self, arrays, packed, avg, k: int, use_ops: bool):
        """The scorer on every shard (enqueued on all before the merge
        reads any), then the descending merge; ids are flat host slots,
        SENTINEL for empty lanes, as the single-device scorer's."""
        parts = []
        for shard_arrays, dev in zip(arrays, self.mesh):
            parts.append(
                _score_topk(
                    *shard_arrays,
                    *(torch.from_numpy(a).to(dev) for a in packed),
                    torch.tensor(avg, dtype=torch.float32, device=dev),
                    k,
                    use_ops=use_ops,
                )
            )
        return gid_merge(parts, k, descending=True)

"""IVF bucketed backend in PyTorch (counterpart of vector_store_tpu/core/ivf.py).

Storage is bucketed by k-means cluster: vectors[K, B, D].  A probed
cluster is one contiguous block, so a query reads p blocks of B*D bytes
and scores them in the probe-scan kernels (core/ivf_cuda.py).  Row ids
are an indirection (`rowid[K, B]`): a row's public id is a monotonic
counter, so reclustering -- triggered whenever the live count doubles --
re-places every row without invalidating ids.  Deletes are tombstones;
inserts append to bucket tails, spilling to the next-nearest cluster when
full.

With `coarse` (or VST_IVF_COARSE=1) an int8 index serves the two-stage
scan: a derived int4 copy of the bank (`derive_coarse`, half the bytes)
is scanned by B2's packed mode, and the best `cand` rows per query are
rescored against their int8 rows (`search_two_stage`).  `save`/`load`
write and read the JAX package's npz snapshot format.

Differences from the JAX package, all by design:
  * `place`, `unvalidate` and `update_coarse` update tensors in place where
    JAX rebuilt them through buffer donation;
  * no fixed-shape padding of scatters, assigns, query batches or coarse
    repacks (those bounded XLA compiles; eager PyTorch has none);
  * top-k is exact `torch.topk` where JAX used `approx_min_k`;
  * a query batch of more than FUSED_MAX_DIMS dims (B1's shared-memory
    limit, `scan_path`) goes to B2 + one top-k;
  * the device is explicit (`device=`) and nothing falls back to the CPU.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import asdict, dataclass

import numpy as np
import torch

from ..types import IndexParams
from ..utils.persistio import atomic_savez

from . import ivf_cuda
from .distance import gathered, normalize, pairwise, preprocess
from .ivf_cuda import (
    pool_scan_fused,
    route,
    scan_masks,
    search_clustered_fused,
    search_clustered_pool,
)
from .quantize import pack_int4_from_int8, quantize_rows
from .topk import INF, SENTINEL, topk_ascending

# Rows accumulated (sequential buckets) before the first clustering.
CLUSTER_MIN_ROWS = 1 << 16
# Spill candidates per insert: a row tries its SPILL nearest clusters in order.
SPILL = 4
# Query-batch chunk: bounds the [q, p*B] pool and the [q, K] route transients.
QCHUNK = 256
PROBE_DEFAULT = 16
# Largest k served by B1 (a warp keeps each running top-k, one entry per
# lane); larger k takes B2 + one torch.topk.
FUSED_MAX_K = 32
# Past this bank size, cluster overflow goes to the least-filled clusters
# (marked dirty for the incremental compact) instead of doubling the bank.
# VST_IVF_GROW_MAX_GB sets it, as in the JAX package (default 4).
GROW_BYTES_MAX = int(float(os.environ.get("VST_IVF_GROW_MAX_GB", "4")) * (1 << 30))
# A recluster gathers the old bank into the new one on the device, which
# holds both at once.  Where that cannot fit it stages the permutation
# through host memory instead (`permute_via_host`).  The rule: on CUDA, at
# the moment of the recluster, the new bank plus the permutation's index
# arrays must fit in what the device has free while the old bank is still
# held (`torch.cuda.mem_get_info` plus the allocator's unused cache); on the
# CPU never.  Setting this attribute to a byte count replaces the rule on
# any device: the host path is taken when old + new bank exceed it.
HOST_PERMUTE_BYTES: int | None = None
# Rows per bucket target (see the JAX package for the geometry trade).
ROWS_PER_BUCKET = int(os.environ.get("VST_IVF_ROWS_PER_BUCKET", "170"))
# k-means: assignment chunk, Lloyd sample cap and iterations
# (vector_store_tpu/core/cluster.py:47-51).
ASSIGN_CHUNK = 4096
LLOYD_SAMPLE = 1 << 18
LLOYD_ITERS = 2
# Clusters scanned per chunk of the full-bank scan.
FLAT_SCAN_CLUSTERS = 128
# Rows per add() step.
ADD_CHUNK = 8192
# Clusters repacked per derive_coarse step (bounds the unpack transient).
COARSE_CHUNK = 128


@dataclass
class IvfState:
    centroids: torch.Tensor  # [K, D] compute dtype
    vectors: torch.Tensor  # [K, B, D] storage dtype
    scales: torch.Tensor  # [K, B] f32 (int8 dequant; 1.0 otherwise)
    valid: torch.Tensor  # [K, B] bool
    rowid: torch.Tensor  # [K, B] int32 public ids (indirection)

    @property
    def n_clusters(self) -> int:
        return self.vectors.shape[0]

    @property
    def bucket(self) -> int:
        return self.vectors.shape[1]

    @property
    def dims(self) -> int:
        return self.vectors.shape[2]


_FIELDS = ("centroids", "vectors", "scales", "valid", "rowid")


def k_for(rows: int, rows_per_bucket: int | None = None) -> int:
    """Cluster count: ~rows_per_bucket rows each, 128-aligned, <= 64K."""
    rpb = rows_per_bucket or ROWS_PER_BUCKET
    k = min(max(rows // rpb, 1024), 1 << 16)
    return max((k // 128) * 128, 128)


def bucket_for(rows: int, k: int) -> int:
    """Bucket width with 1.5x slack for skew and future inserts, in
    multiples of 128 (the live-prefix sub-block)."""
    return max(int(np.ceil(1.5 * rows / k / 128)) * 128, 128)


def _storage_dtype(dtype: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[
        dtype
    ]


def _compute_dtype(dtype: str) -> torch.dtype:
    return torch.float32 if dtype == "float32" else torch.bfloat16


def init(dims: int, k: int, bucket: int, dtype: str, device) -> IvfState:
    return IvfState(
        centroids=torch.zeros((k, dims), dtype=_compute_dtype(dtype), device=device),
        vectors=torch.zeros((k, bucket, dims), dtype=_storage_dtype(dtype), device=device),
        scales=torch.ones((k, bucket), dtype=torch.float32, device=device),
        valid=torch.zeros((k, bucket), dtype=torch.bool, device=device),
        rowid=torch.full((k, bucket), SENTINEL, dtype=torch.int32, device=device),
    )


def grow_bucket(s: IvfState) -> IvfState:
    """The state with every bucket twice as wide (contents kept)."""

    def grow(t, fill):
        return torch.cat([t, torch.full_like(t, fill)], dim=1)

    return IvfState(
        centroids=s.centroids,
        vectors=grow(s.vectors, 0),
        scales=grow(s.scales, 1.0),
        valid=grow(s.valid, False),
        rowid=grow(s.rowid, SENTINEL),
    )


def _from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16, as JAX reads out
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # copy: JAX read-outs are read-only


def state_from_numpy(src, device) -> IvfState:
    """A state from any object with the five IvfState fields as arrays
    (e.g. a JAX IvfState read out with np.asarray)."""
    return IvfState(**{f: _from_numpy(getattr(src, f), device) for f in _FIELDS})


def state_to_numpy(state: IvfState) -> dict[str, np.ndarray]:
    """The five fields as numpy arrays; bf16 fields widen exactly to f32."""
    out = {}
    for f in _FIELDS:
        t = getattr(state, f).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[f] = t.numpy()
    return out


# --------------------------------------------------------------------------
# device steps


def assign_top(
    centroids: torch.Tensor, vecs: torch.Tensor, space: str, a: int
) -> torch.Tensor:
    """[M, D] preprocessed rows -> their `a` nearest clusters [M, a] int32."""
    d = pairwise(vecs, centroids, space)
    _, cids = topk_ascending(d, a)
    return cids.to(torch.int32)


def place(
    state: IvfState,
    vecs_raw: torch.Tensor,  # [M, D] raw rows
    ks: torch.Tensor,  # [M] target cluster
    poss: torch.Tensor,  # [M] target position
    rowids: torch.Tensor,  # [M]
    space: str,
    dtype: str,
) -> None:
    """Write a prepared batch into its (cluster, position) slots, in place."""
    vecs = preprocess(vecs_raw.float(), space)
    if dtype == "int8":
        rows, scl = quantize_rows(vecs)
    else:
        rows = vecs.to(_storage_dtype(dtype))
        scl = torch.ones((vecs.shape[0],), dtype=torch.float32, device=vecs.device)
    state.vectors[ks, poss] = rows
    state.scales[ks, poss] = scl
    state.valid[ks, poss] = True
    state.rowid[ks, poss] = rowids.to(torch.int32)


def unvalidate(state: IvfState, ks: torch.Tensor, poss: torch.Tensor) -> None:
    """Tombstone slots, in place."""
    state.valid[ks, poss] = False


def search_flat(
    state: IvfState, queries: torch.Tensor, space: str, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-bank exact scan (staging-phase serving): chunked matmul and
    exact top-k with a running merge.  Rows and query round to the compute
    dtype first, as in the JAX package."""
    cdt = state.centroids.dtype
    q = preprocess(queries.float(), space).to(cdt)
    Q = q.shape[0]
    K, B, D = state.vectors.shape
    quantized = state.vectors.dtype == torch.int8
    best_d = torch.full((Q, k), INF, dtype=torch.float32, device=q.device)
    best_r = torch.full((Q, k), SENTINEL, dtype=torch.int32, device=q.device)
    for k0 in range(0, K, FLAT_SCAN_CLUSTERS):
        k1 = min(k0 + FLAT_SCAN_CLUSTERS, K)
        cand = state.vectors[k0:k1].reshape(-1, D).float()
        if quantized:
            cand = cand * state.scales[k0:k1].reshape(-1, 1)
        d = pairwise(q, cand.to(cdt), space)
        d = d.masked_fill(~state.valid[k0:k1].reshape(1, -1), INF)
        cd, pos = topk_ascending(d, min(k, d.shape[1]))
        cr = state.rowid[k0:k1].reshape(-1)[pos]
        best_d, mpos = topk_ascending(torch.cat([best_d, cd], dim=1), k)
        best_r = torch.gather(torch.cat([best_r, cr], dim=1), 1, mpos)
    best_r = torch.where(torch.isinf(best_d), SENTINEL, best_r)
    return best_d, best_r


# --- recluster steps


def _gather_dequant(
    vectors: torch.Tensor, scales: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """Flat-bank row gather with int8 dequant -> [n, D] f32."""
    K, B, D = vectors.shape
    rows = vectors.reshape(K * B, D)[ids].float()
    if vectors.dtype == torch.int8:
        rows = rows * scales.reshape(K * B)[ids][:, None]
    return rows


def _lloyd_iter(vectors, scales, centroids, ids, space, chunk):
    """One Lloyd iteration over the sample rows `ids` (flat bank slots)."""
    cdt = centroids.dtype
    k, D = centroids.shape
    sums = torch.zeros((k, D), dtype=torch.float32, device=vectors.device)
    cnts = torch.zeros((k,), dtype=torch.float32, device=vectors.device)
    for off in range(0, len(ids), chunk):
        rows = _gather_dequant(vectors, scales, ids[off : off + chunk])
        cid = torch.argmin(pairwise(rows.to(cdt), centroids, space), dim=1)
        sums.index_add_(0, cid, rows)
        cnts.index_add_(0, cid, torch.ones_like(cid, dtype=torch.float32))
    mean = sums / torch.clamp(cnts, min=1.0)[:, None]
    if space == "cosine":
        mean = normalize(mean)
    return torch.where((cnts > 0)[:, None], mean.to(cdt), centroids)


def _assign_pass(vectors, scales, centroids, ids, space, a, chunk) -> torch.Tensor:
    """Top-`a` cluster assignment [n, a] int32 of the rows `ids`."""
    cdt = centroids.dtype
    out = []
    for off in range(0, len(ids), chunk):
        rows = _gather_dequant(vectors, scales, ids[off : off + chunk])
        out.append(assign_top(centroids, rows.to(cdt), space, a))
    return torch.cat(out)


def permute_build(
    old: IvfState,
    centroids: torch.Tensor,
    perm: torch.Tensor,  # [K', B'] flat source slot in old (SENTINEL = empty)
) -> IvfState:
    """Recluster materialisation: gather old flat rows into new buckets."""
    Ko, Bo, D = old.vectors.shape
    ok = perm != SENTINEL
    src = torch.clamp(perm, 0, Ko * Bo - 1)
    return IvfState(
        centroids=centroids,
        vectors=old.vectors.reshape(Ko * Bo, D)[src],
        scales=old.scales.reshape(-1)[src],
        valid=ok,
        rowid=torch.where(ok, old.rowid.reshape(-1)[src], SENTINEL),
    )


def permute_through_host(device: torch.device, old_bytes: int, new_bytes: int, slots: int) -> bool:
    """Whether a recluster into a bank of `new_bytes` and `slots` slots must
    go through host memory (the rule stated at HOST_PERMUTE_BYTES)."""
    if HOST_PERMUTE_BYTES is not None:
        return old_bytes + new_bytes > HOST_PERMUTE_BYTES
    if device.type != "cuda":
        return False
    free, _ = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    # int64 perm, its clamped copy and the mask; scales, valid and rowid
    index_bytes = slots * (8 + 8 + 1 + 4 + 1 + 4 + 4)
    return new_bytes + index_bytes > free


def permute_via_host(
    box: list,  # [IvfState]: the only reference to the old state
    centroids: torch.Tensor,
    perm: np.ndarray,  # [K', B'] flat source slot in old (SENTINEL = empty)
) -> IvfState:
    """`permute_build` staged through host memory, for a bank too big to
    hold twice: the old bank comes down in K-slices (never reshaped on the
    device, which would copy it), is freed before the new one is allocated,
    is gathered on the host and goes up again.  The result equals
    `permute_build`'s tensor for tensor (an empty slot holds the old bank's
    last row there too)."""
    s = box[0]
    device = s.vectors.device
    K, B, D = s.vectors.shape
    vec_h = torch.empty((K * B, D), dtype=s.vectors.dtype)
    kstep = max((1 << 28) // (B * D * s.vectors.element_size()), 1)
    for k0 in range(0, K, kstep):
        blk = s.vectors[k0 : k0 + kstep].cpu()
        vec_h[k0 * B : (k0 + blk.shape[0]) * B] = blk.reshape(-1, D)
    scl_h = s.scales.cpu().reshape(-1)
    rid_h = s.rowid.cpu().reshape(-1)
    del blk, s
    box.clear()  # the old bank goes before the new one is allocated
    if device.type == "cuda":
        torch.cuda.empty_cache()

    perm_t = torch.from_numpy(np.ascontiguousarray(perm))
    ok = perm_t != SENTINEL
    src = torch.clamp(perm_t, 0, K * B - 1)
    new_vec = vec_h[src]
    del vec_h
    return IvfState(
        centroids=centroids,
        vectors=new_vec.to(device),
        scales=scl_h[src].to(device),
        valid=ok.to(device),
        rowid=torch.where(ok, rid_h[src], SENTINEL).to(device),
    )


# --------------------------------------------------------------------------
# two-stage scan: int4 coarse probe + int8 exact rescore


def derive_coarse(vectors: torch.Tensor) -> torch.Tensor:
    """[K, B, D] int8 bank -> nibble-packed [K, B, D/2] uint8, packed
    COARSE_CHUNK clusters at a time (the f32 transient stays [CH, B, D])."""
    K, B, D = vectors.shape
    out = torch.empty((K, B, D // 2), dtype=torch.uint8, device=vectors.device)
    for k0 in range(0, K, COARSE_CHUNK):
        out[k0 : k0 + COARSE_CHUNK] = pack_int4_from_int8(vectors[k0 : k0 + COARSE_CHUNK])
    return out


def update_coarse(coarse: torch.Tensor, vectors: torch.Tensor, ks: torch.Tensor) -> None:
    """Repack the touched clusters `ks` of the coarse bank, in place."""
    coarse[ks] = pack_int4_from_int8(vectors[ks])


def _rescore_flat(
    state: IvfState,
    q: torch.Tensor,  # [Q, D] preprocessed, compute dtype
    bd: torch.Tensor,  # [Q, C] coarse distances (INF = masked)
    bflat: torch.Tensor,  # [Q, C] flat bank slots (cluster * B + position)
    space: str,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact rescore of the coarse survivors against their stored rows
    (dequantized, rounded to the compute dtype as in the JAX package)."""
    K, B, D = state.vectors.shape
    safe = torch.clamp(bflat, 0, K * B - 1).long()
    rows = state.vectors.reshape(K * B, D)[safe].float()  # [Q, C, D]
    if state.vectors.dtype == torch.int8:
        rows = rows * state.scales.reshape(K * B)[safe][..., None]
    d = gathered(q, rows.to(state.centroids.dtype), space)
    d = d.masked_fill(torch.isinf(bd), INF)
    rid = state.rowid.reshape(K * B)[safe]
    top_d, pos = topk_ascending(d, min(k, d.shape[1]))
    top_r = torch.gather(rid, 1, pos)
    top_r = torch.where(torch.isinf(top_d), SENTINEL, top_r)
    return ivf_cuda._pad_k(top_d, top_r, k)


def search_two_stage(
    state: IvfState,
    coarse: torch.Tensor,  # [K, B, D/2] uint8 derived bank
    queries: torch.Tensor,  # [Q, D] raw f32
    space: str,
    k: int,
    probes: int,
    cand: int,
    masks=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """int4 coarse probe-scan -> top-`cand` per query -> int8 rescore.

    Same contract as the single-stage search.  The packed bank is scanned
    by B2 (`pool_scan_fused(packed=True)`: the kernel on CUDA tensors, its
    plain version on CPU ones).  The query is the one JAX's `_route`
    returns, rounded to the centroid dtype, in both stages.  The
    top-`cand` is exact where JAX took `approx_min_k` at p*B >= 16384."""
    q, cids, p = route(state, queries, space, probes, rounded=True)
    B = state.bucket
    C = min(cand, p * B)
    rid_masked, nsb = masks if masks is not None else scan_masks(state)
    pool = pool_scan_fused(coarse, state.scales, rid_masked, q.float(), cids, space, True, nsb)
    bd, pos = topk_ascending(pool, C)  # pool lane r*B + j: row j of cids[:, r]
    bflat = torch.gather(cids, 1, pos // B).long() * B + pos % B
    return _rescore_flat(state, q, bd, bflat, space, k)


def coarse_flag(coarse: bool | None, dtype: str, dims: int) -> bool:
    """Whether an index serves the two-stage scan (int4 coarse + int8
    rescore): an explicit argument wins, else VST_IVF_COARSE=1 opts in (=0
    vetoes even the argument); int8 banks with even D only."""
    env4 = os.environ.get("VST_IVF_COARSE")
    if coarse is None:
        coarse = env4 == "1"
    elif env4 == "0":
        coarse = False
    return bool(coarse) and dtype == "int8" and dims % 2 == 0


def scan_path(k: int, dims: int) -> str:
    """The kernel that serves a clustered single-stage query batch: "fused"
    (B1: any bucket size and probe count) when k <= FUSED_MAX_K and the
    dims fit its shared memory (ivf_cuda.FUSED_MAX_DIMS), else "pool" (B2
    + one torch.topk: any k)."""
    if k <= FUSED_MAX_K and dims <= ivf_cuda.FUSED_MAX_DIMS:
        return "fused"
    return "pool"


# --------------------------------------------------------------------------


def plan_placement(
    cids: np.ndarray,
    n_used: np.ndarray,
    bucket: int,
    free: dict[int, list[int]] | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side slot allocation with spill cascade.

    cids [M, A] preference-ordered clusters per row.  Returns
    (ks, poss, unplaced_mask); n_used (and `free`, when given) are
    updated in place.  Tombstoned positions in `free` are reused
    before the append cursor advances, so delete/reinsert churn does
    not leak slots (leaked slots forced bucket-doubling reallocations
    of the whole bank even at flat live count)."""
    m = len(cids)
    ks = np.full((m,), -1, dtype=np.int64)
    poss = np.zeros((m,), dtype=np.int64)
    pending = np.arange(m)
    for a in range(cids.shape[1]):
        if len(pending) == 0:
            break
        want = cids[pending, a]
        order = np.argsort(want, kind="stable")
        w_sorted = want[order]
        starts = np.r_[0, np.flatnonzero(np.diff(w_sorted)) + 1]
        ends = np.r_[starts[1:], len(w_sorted)]
        still = []
        for s0, s1 in zip(starts, ends):
            c = int(w_sorted[s0])
            rows = pending[order[s0:s1]]
            fl = free.get(c) if free is not None else None
            take = min(len(fl), len(rows)) if fl else 0
            if take:
                got = rows[:take]
                ks[got] = c
                poss[got] = [fl.pop() for _ in range(take)]
                if not fl:
                    free.pop(c, None)
                rows = rows[take:]
            if len(rows):
                fit = min(len(rows), max(bucket - int(n_used[c]), 0))
                if fit:
                    got = rows[:fit]
                    ks[got] = c
                    poss[got] = n_used[c] + np.arange(fit)
                    n_used[c] += fit
                    rows = rows[fit:]
            if len(rows):
                still.append(rows)
        pending = (
            np.concatenate(still) if still else np.empty((0,), np.int64)
        )
    return ks, poss, ks < 0


class IvfIndex:
    """Host wrapper: numpy in, numpy out, state on `device`.

    Ids are monotonic rowids, stable across bucket growth, reclustering
    and compaction (the engine keymap never needs a remap event)."""

    def __init__(
        self,
        params: IndexParams,
        initial_capacity: int | None = None,
        probes: int = PROBE_DEFAULT,
        cluster_min: int = CLUSTER_MIN_ROWS,
        rows_per_bucket: int | None = None,
        coarse: bool | None = None,
        rescore: int = 8,
        reserve_rows: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        self.params = params
        self.space = params.space
        self.dtype = params.dtype if params.dtype in ("float32", "int8") else "bfloat16"
        self.dims = params.dimensions
        self.probes = probes
        self.device = torch.device(device)
        self.coarse = coarse_flag(coarse, self.dtype, self.dims)
        # rescored candidates per query: max(rescore * k, 64)
        self.rescore = rescore
        self._coarse_bank: torch.Tensor | None = None
        self._coarse_stale = True
        self._coarse_dirty: set[int] = set()
        self.cluster_min = cluster_min
        self.rows_per_bucket = rows_per_bucket or ROWS_PER_BUCKET
        # bulk-load mode: the first clustering sizes k and the bucket for
        # `reserve_rows`, and doubling reclusters wait until the live count
        # exceeds it
        self._reserve = int(reserve_rows or 0)
        rows0 = max(initial_capacity or 0, cluster_min)
        k = k_for(rows0, self.rows_per_bucket)
        b = bucket_for(rows0, k)
        self._state = init(self.dims, k, b, self.dtype, self.device)
        self._clustered = False
        self._clustered_at = 0  # live count at last recluster
        # host mirrors (placement bookkeeping without device readbacks)
        self._n_used = np.zeros((k,), dtype=np.int64)
        self._valid_h = np.zeros((k, b), dtype=bool)
        self._rowid_h = np.full((k, b), -1, dtype=np.int64)
        self._loc = np.full((0, 2), -1, dtype=np.int64)  # rowid -> (k, pos)
        # tombstoned (cluster -> positions) free for reuse
        self._free: dict[int, list[int]] = {}
        # clusters that received spilled rows: the incremental compact's list
        self._dirty: set[int] = set()
        self._next_rowid = 0
        self._n_live = 0
        self._lock = threading.Lock()

    # -- introspection ------------------------------------------------------

    def count(self) -> int:
        return self._n_live

    @property
    def state(self) -> IvfState:
        return self._state

    @property
    def n_clusters(self) -> int:
        return self._state.n_clusters

    # -- helpers ------------------------------------------------------------

    def _idx(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.device)

    def _grow_loc(self, n: int) -> None:
        if self._next_rowid + n > len(self._loc):
            new_len = max(2 * len(self._loc), self._next_rowid + n, 1024)
            pad = np.full((new_len - len(self._loc), 2), -1, dtype=np.int64)
            self._loc = np.concatenate([self._loc, pad])

    def _grow_bucket(self) -> None:
        """Double B -- realloc event, ids unaffected."""
        s = self._state
        self._state = grow_bucket(s)
        B = s.bucket
        self._valid_h = np.pad(self._valid_h, ((0, 0), (0, B)))
        self._rowid_h = np.pad(self._rowid_h, ((0, 0), (0, B)), constant_values=-1)
        self._coarse_stale = True  # bank shape changed; re-derive
        self._coarse_bank = None

    # -- mutation -----------------------------------------------------------

    def add(self, vectors) -> np.ndarray:
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None, :]
        n, d = vectors.shape
        if d != self.dims:
            raise ValueError(f"dimension mismatch: index {self.dims}, got {d}")
        with self._lock:
            self._grow_loc(n)
            rowids = np.arange(self._next_rowid, self._next_rowid + n, dtype=np.int64)
            self._next_rowid += n
            for off in range(0, n, ADD_CHUNK):
                blk = vectors[off : off + ADD_CHUNK]
                rid = rowids[off : off + ADD_CHUNK]
                if self._clustered:
                    self._add_clustered(blk, rid)
                else:
                    self._add_staging(blk, rid)
            self._n_live += n
            self._maybe_recluster()
        return rowids

    def _to_dev(self, blk: np.ndarray) -> torch.Tensor:
        """One host->device copy per block.  bf16 and int8 banks round the
        block to bf16 first, as the JAX package ships it (ivf.py:885-895),
        so `place` normalises and quantizes the same values."""
        t = torch.as_tensor(blk, dtype=torch.float32, device=self.device)
        if self.dtype != "float32":
            t = t.to(torch.bfloat16)
        return t

    def _scatter(self, blk: torch.Tensor, ks, poss, rid) -> None:
        place(
            self._state,
            blk,
            self._idx(ks),
            self._idx(poss),
            self._idx(rid),
            self.space,
            self.dtype,
        )
        self._valid_h[ks, poss] = True
        self._rowid_h[ks, poss] = rid
        self._loc[rid, 0] = ks
        self._loc[rid, 1] = poss
        self._mark_coarse_dirty(ks)

    def _mark_coarse_dirty(self, ks: np.ndarray) -> None:
        """Clusters whose rows were written since the coarse bank was derived
        (tombstones need no repack: the scan reads validity live).  Tracked
        whenever a derived bank exists, so `coarse` may be switched on an
        index between searches."""
        if not self._coarse_stale:
            self._coarse_dirty.update(int(c) for c in np.unique(ks))

    def _add_staging(self, blk, rid: np.ndarray) -> None:
        """Sequential fill before the first clustering, by per-cluster fill
        counts (rows placed before a _grow_bucket keep their slots)."""
        blk = self._to_dev(blk)
        m = len(blk)
        K, B = self._state.n_clusters, self._state.bucket
        while int(self._n_used.sum()) + m > K * B:
            self._grow_bucket()
            B = self._state.bucket
        rem = B - self._n_used  # free tail slots per cluster, in order
        cum = np.cumsum(rem)
        j = np.arange(m)
        ks = np.searchsorted(cum, j, side="right")
        prev = np.where(ks > 0, cum[np.maximum(ks - 1, 0)], 0)
        poss = self._n_used[ks] + (j - prev)
        np.add.at(self._n_used, ks, 1)
        self._scatter(blk, ks, poss, rid)

    @staticmethod
    def _place_overflow(ks, poss, unplaced, used, bucket) -> bool:
        """Assign overflow rows to the clusters with the most free tail
        slots (mutates ks/poss/used in place).  False if the whole bank
        is genuinely full (caller must grow after all)."""
        over = np.flatnonzero(unplaced)
        space = np.maximum(bucket - used, 0)
        order = np.argsort(-space, kind="stable")
        cum = np.cumsum(space[order])
        if cum[-1] < len(over):
            return False
        j = np.searchsorted(cum, np.arange(1, len(over) + 1), side="left")
        target = order[j]
        prev = np.r_[0, cum[:-1]]
        off = np.arange(len(over)) - prev[j]
        ks[over] = target
        poss[over] = used[target] + off
        np.add.at(used, target, 1)
        return True

    def _add_clustered(self, blk, rid: np.ndarray) -> None:
        blk = self._to_dev(blk)  # one copy, shared by assign and place
        prep = preprocess(blk.float(), self.space).to(self._state.centroids.dtype)
        cids = assign_top(self._state.centroids, prep, self.space, SPILL).cpu().numpy()
        while True:
            used = self._n_used.copy()
            free_try = {k: v[:] for k, v in self._free.items()}
            ks, poss, unplaced = plan_placement(
                cids, used, self._state.bucket, free=free_try
            )
            if not unplaced.any():
                break
            K, B, D = self._state.vectors.shape
            bank_bytes = K * B * D * self._state.vectors.element_size()
            if 2 * bank_bytes > GROW_BYTES_MAX and self._place_overflow(
                ks, poss, unplaced, used, B
            ):
                # growth-capped: overflow went to the emptiest clusters;
                # `spilled` below marks them dirty for the incremental compact
                break
            self._grow_bucket()
        self._n_used = used
        self._free = free_try
        spilled = ks != cids[:, 0]
        if spilled.any():
            self._dirty.update(int(c) for c in np.unique(ks[spilled]))
        self._scatter(blk, ks, poss, rid)

    def remove(self, rowids) -> None:
        rowids = np.unique(np.asarray(rowids, dtype=np.int64).reshape(-1))
        rowids = rowids[(rowids >= 0) & (rowids < self._next_rowid)]
        if rowids.size == 0:
            return
        with self._lock:
            rowids = rowids[self._loc[rowids, 0] >= 0]
            if rowids.size == 0:
                return
            ks, poss = self._loc[rowids, 0], self._loc[rowids, 1]
            if self._clustered:
                for k, p in zip(ks.tolist(), poss.tolist()):
                    self._free.setdefault(k, []).append(p)
            unvalidate(self._state, self._idx(ks), self._idx(poss))
            self._valid_h[ks, poss] = False
            self._loc[rowids] = -1
            self._n_live -= len(rowids)

    # -- clustering ---------------------------------------------------------

    def _maybe_recluster(self) -> None:
        if self._n_live < self.cluster_min:
            return
        if self._clustered and (
            self._n_live < 2 * self._clustered_at or self._n_live <= self._reserve
        ):
            return
        self._recluster_locked()

    def compact(self, full: bool | None = None) -> dict:
        """Maintenance pass; ids are stable, so the returned remap is empty.

        full=True reclusters from scratch (drops tombstoned slots);
        full=False re-places only rows that spilled past their first-choice
        cluster.  None picks full only when the live count doubled since
        the last recluster."""
        with self._lock:
            if self._n_live == 0:
                return {}
            if full is None:
                full = not self._clustered or self._n_live >= 2 * self._clustered_at
            if full:
                self._recluster_locked()
            else:
                self._reassign_dirty_locked()
        return {}

    def _reassign_dirty_locked(self) -> None:
        """Incremental recluster: move rows of clusters that received
        spilled inserts to their first-choice cluster where it has room
        (centroids unchanged)."""
        if not self._dirty or not self._clustered:
            self._dirty = set()
            return
        s = self._state
        K, B, D = s.vectors.shape
        dirty = np.fromiter(self._dirty, dtype=np.int64)
        self._dirty = set()
        rows_k, rows_p = np.nonzero(self._valid_h[dirty])
        if len(rows_k) == 0:
            return
        flat = dirty[rows_k] * B + rows_p
        a_chunk = ASSIGN_CHUNK if K <= (1 << 15) else 1024
        cids = (
            _assign_pass(
                s.vectors, s.scales, s.centroids, self._idx(flat), self.space, SPILL, a_chunk
            )
            .cpu()
            .numpy()
        )
        move = cids[:, 0] != flat // B
        if not move.any():
            return
        # first choice only; plan before freeing the movers' own slots, so
        # a new slot never aliases a mover's source and the chunked
        # gather + place below reads the bank safely while it changes
        flat_mv, first_mv = flat[move], cids[move, :1]
        used = self._n_used.copy()
        free_try = {k: v[:] for k, v in self._free.items()}
        ks, poss, unplaced = plan_placement(first_mv, used, B, free=free_try)
        if unplaced.any():
            self._dirty.update(int(c) for c in np.unique(flat_mv[unplaced] // B))
        placed = ~unplaced
        if not placed.any():
            return
        self._n_used = used
        self._free = free_try
        flat_mv, ks, poss = flat_mv[placed], ks[placed], poss[placed]
        old_k, old_p = flat_mv // B, flat_mv % B
        rowids = self._rowid_h[old_k, old_p]
        src, ks_t, poss_t = self._idx(flat_mv), self._idx(ks), self._idx(poss)
        rid_t = self._idx(rowids)
        CH = 16384
        for off in range(0, len(flat_mv), CH):
            sl = slice(off, off + CH)
            rows = _gather_dequant(self._state.vectors, self._state.scales, src[sl])
            # rows are stored preprocessed; preprocess is idempotent
            place(self._state, rows, ks_t[sl], poss_t[sl], rid_t[sl], self.space, self.dtype)
        unvalidate(self._state, self._idx(old_k), self._idx(old_p))
        self._mark_coarse_dirty(ks)  # moved rows wrote new codes into ks
        self._valid_h[old_k, old_p] = False
        for k_, p_ in zip(old_k.tolist(), old_p.tolist()):
            self._free.setdefault(int(k_), []).append(int(p_))
        self._valid_h[ks, poss] = True
        self._rowid_h[ks, poss] = rowids
        self._loc[rowids, 0] = ks
        self._loc[rowids, 1] = poss

    def _recluster_locked(self) -> None:
        s = self._state
        flat_live = np.flatnonzero(self._valid_h.reshape(-1))
        n = len(flat_live)
        if n == 0:
            return
        k_new = k_for(max(n, self._reserve), self.rows_per_bucket)
        cdt = s.centroids.dtype
        a_chunk = ASSIGN_CHUNK if k_new <= (1 << 15) else 1024

        # k-means: strided live sample init + Lloyd iterations
        stride = max(n // k_new, 1)
        centroids = _gather_dequant(
            s.vectors, s.scales, self._idx(flat_live[::stride][:k_new])
        ).to(cdt)
        if centroids.shape[0] < k_new:  # degenerate case: repeat
            reps = -(-k_new // centroids.shape[0])
            centroids = centroids.repeat(reps, 1)[:k_new]
        sample_n = min(n, LLOYD_SAMPLE)
        s_stride = max(n // sample_n, 1)
        sample = self._idx(flat_live[::s_stride][:sample_n])
        for _ in range(LLOYD_ITERS):
            centroids = _lloyd_iter(s.vectors, s.scales, centroids, sample, self.space, a_chunk)

        # assign every live row (top-SPILL for the placement cascade)
        all_cids = (
            _assign_pass(
                s.vectors, s.scales, centroids, self._idx(flat_live), self.space, SPILL, a_chunk
            )
            .cpu()
            .numpy()
        )

        # host placement into fresh buckets, then the device permute
        b_new = bucket_for(max(n, self._reserve), k_new)
        while True:
            used = np.zeros((k_new,), dtype=np.int64)
            ks, poss, unplaced = plan_placement(all_cids, used, b_new)
            if not unplaced.any():
                break
            b_new = -(-int(b_new * 1.5) // 128) * 128  # stay 128-aligned
        perm = np.full((k_new, b_new), SENTINEL, dtype=np.int64)
        perm[ks, poss] = flat_live
        rowid_flat = self._rowid_h.reshape(-1)
        bank_row = s.dims * s.vectors.element_size()
        if permute_through_host(
            self.device, s.vectors.numel() * s.vectors.element_size(),
            k_new * b_new * bank_row, k_new * b_new,
        ):
            box = [s]
            del s  # the box holds the only reference to the old bank now
            self._state = None
            self._state = permute_via_host(box, centroids, perm)
        else:
            self._state = permute_build(s, centroids, self._idx(perm))
            del s

        # host mirrors follow the same permutation
        placed_rowids = rowid_flat[flat_live]
        self._rowid_h = np.full((k_new, b_new), -1, dtype=np.int64)
        self._rowid_h[ks, poss] = placed_rowids
        self._valid_h = np.zeros((k_new, b_new), dtype=bool)
        self._valid_h[ks, poss] = True
        self._n_used = used
        self._loc[placed_rowids, 0] = ks
        self._loc[placed_rowids, 1] = poss
        self._free = {}  # every tombstone was just dropped
        # rows the recluster itself had to spill stay on the incremental list
        spilled = ks != all_cids[:, 0]
        self._dirty = {int(c) for c in np.unique(ks[spilled])}
        self._clustered = True
        self._clustered_at = self._n_live
        self._coarse_stale = True  # whole bank permuted; re-derive
        self._coarse_bank = None

    # -- query ----------------------------------------------------------------

    def _refresh_coarse_locked(self) -> torch.Tensor:
        """Bring the derived int4 bank up to date (under the lock, before a
        two-stage search): a full derive after a shape change or recluster,
        or when more than K/4 clusters are dirty; else repack the dirty
        clusters in place."""
        if self._coarse_bank is None or self._coarse_stale:
            self._coarse_bank = derive_coarse(self._state.vectors)
            self._coarse_stale = False
            self._coarse_dirty.clear()
            return self._coarse_bank
        if self._coarse_dirty:
            ks = sorted(self._coarse_dirty)
            self._coarse_dirty.clear()
            if len(ks) > self._state.n_clusters // 4:
                self._coarse_bank = derive_coarse(self._state.vectors)
            else:
                update_coarse(self._coarse_bank, self._state.vectors, self._idx(ks))
        return self._coarse_bank

    def search_dispatch(self, queries, k: int, probes: int | None = None):
        """Enqueue a batched query; returns fetch() -> (dist, rowids).

        The device work is enqueued under the index lock on the current
        stream; fetch() does the host readback and may run outside the
        lock.  A later in-place update is enqueued after these kernels on
        the same stream, and the results are fresh tensors, so several
        batches can be in flight (MicroBatcher pipeline depth)."""
        probes = probes or self.probes
        queries = np.asarray(queries, dtype=np.float32)
        single = queries.ndim == 1
        if single:
            queries = queries[None, :]
        n, d = queries.shape
        if d != self.dims:
            raise ValueError(f"dimension mismatch: index {self.dims}, got {d}")
        outs_d, outs_i = [], []
        with self._lock:
            state = self._state
            clustered = self._clustered
            masks = scan_masks(state) if clustered else None
            two_stage = clustered and self.coarse
            coarse_bank = self._refresh_coarse_locked() if two_stage else None
            path = scan_path(k, state.dims)
            for off in range(0, n, QCHUNK):
                q = torch.as_tensor(queries[off : off + QCHUNK], device=self.device)
                if two_stage:
                    cand = min(
                        max(self.rescore * k, 64),
                        min(probes, state.n_clusters) * state.bucket,
                    )
                    dd, ii = search_two_stage(
                        state, coarse_bank, q, self.space, k, probes, cand, masks=masks
                    )
                elif not clustered:
                    dd, ii = search_flat(state, q, self.space, k)
                elif path == "fused":
                    dd, ii = search_clustered_fused(
                        state, q, self.space, k, probes, masks
                    )
                else:
                    dd, ii = search_clustered_pool(
                        state, q, self.space, k, probes, masks
                    )
                outs_d.append(dd)
                outs_i.append(ii)

        def fetch() -> tuple[np.ndarray, np.ndarray]:
            dist = torch.cat(outs_d).cpu().numpy()
            ids = torch.cat(outs_i).cpu().numpy().astype(np.int64)
            ids[~np.isfinite(dist)] = -1
            if single:
                return dist[0], ids[0]
            return dist, ids

        return fetch

    def search(
        self, queries, k: int, probes: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(dist[n, k] ascending, rowids[n, k]); absent results (inf, -1)."""
        return self.search_dispatch(queries, k, probes)()

    def exact_search(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Exact scan over the same bank (the recall oracle)."""
        queries = np.asarray(queries, dtype=np.float32)
        single = queries.ndim == 1
        if single:
            queries = queries[None, :]
        with self._lock:
            d, i = search_flat(
                self._state, torch.as_tensor(queries, device=self.device), self.space, k
            )
        d = d.cpu().numpy()
        i = i.cpu().numpy().astype(np.int64)
        i[~np.isfinite(d)] = -1
        if single:
            return d[0], i[0]
        return d, i

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        """Snapshot the bucketed bank to one uncompressed npz, in the JAX
        package's format (format 1, kind "ivf"; ivf.py:1509-1551): bf16
        vectors travel as f32, centroids as f32.  The coarse bank is derived
        data and is not saved."""
        with self._lock:
            meta = {
                "format": 1,
                "kind": "ivf",
                "params": asdict(self.params),
                "dtype": self.dtype,
                "probes": self.probes,
                "cluster_min": self.cluster_min,
                "rows_per_bucket": self.rows_per_bucket,
                "coarse": self.coarse,
                "rescore": self.rescore,
                "clustered": self._clustered,
                "clustered_at": self._clustered_at,
                "n_live": self._n_live,
                "next_rowid": self._next_rowid,
                "free": {str(c): v for c, v in self._free.items()},
            }
            arrays = state_to_numpy(self._state)  # bf16 widens exactly to f32
            atomic_savez(
                path,
                n_used=self._n_used,
                meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                **arrays,
            )

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> "IvfIndex":
        """An index from a snapshot written by `save` or by the JAX package;
        the host mirrors are rebuilt from the bank (ivf.py:1579-1595)."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("kind") != "ivf":
                raise ValueError("not an ivf snapshot")
            if meta.get("format") != 1:
                raise ValueError(f"unknown ivf snapshot format {meta.get('format')!r}")
            idx = cls.__new__(cls)
            idx.params = IndexParams(**meta["params"])
            idx.space = idx.params.space
            idx.dtype = meta["dtype"]
            idx.dims = idx.params.dimensions
            idx.probes = meta["probes"]
            idx.device = torch.device(device)
            idx.cluster_min = meta["cluster_min"]
            idx.rows_per_bucket = meta.get("rows_per_bucket", ROWS_PER_BUCKET)
            idx.coarse = (
                meta.get("coarse", os.environ.get("VST_IVF_COARSE") == "1")
                and idx.dtype == "int8"
                and idx.dims % 2 == 0
            )
            idx.rescore = meta.get("rescore", 8)
            idx._coarse_bank = None
            idx._coarse_stale = True
            idx._coarse_dirty = set()
            idx._reserve = 0  # a load is not a bulk load
            idx._clustered = meta["clustered"]
            idx._clustered_at = meta["clustered_at"]
            idx._n_live = meta["n_live"]
            idx._next_rowid = meta["next_rowid"]
            idx._free = {int(c): list(v) for c, v in meta["free"].items()}
            idx._dirty = set()
            idx._n_used = np.asarray(z["n_used"], dtype=np.int64)
            valid = np.asarray(z["valid"])
            rowid = np.asarray(z["rowid"])
            idx._valid_h = valid.copy()
            idx._rowid_h = np.where(valid, rowid.astype(np.int64), -1)
            idx._loc = np.full((max(idx._next_rowid, 1), 2), -1, dtype=np.int64)
            ks, poss = np.nonzero(valid)
            live_ids = rowid[ks, poss].astype(np.int64)
            idx._loc[live_ids, 0] = ks
            idx._loc[live_ids, 1] = poss
            idx._lock = threading.Lock()
            dev = idx.device
            idx._state = IvfState(
                centroids=_from_numpy(z["centroids"], dev).to(_compute_dtype(idx.dtype)),
                vectors=_from_numpy(z["vectors"], dev).to(_storage_dtype(idx.dtype)),
                scales=_from_numpy(z["scales"], dev).float(),
                valid=_from_numpy(valid, dev),
                rowid=_from_numpy(rowid, dev).to(torch.int32),
            )
        return idx

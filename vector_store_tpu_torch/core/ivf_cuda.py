"""Fused IVF probe-scan: the CUDA kernels B1/B2 and their plain versions.

Counterpart of vector_store_tpu/core/ivf_pallas.py.  The kernels live in
csrc/ivf_scan.cu:

  search_fused     -> ivf_search_fused (B1): per query, score the live
                      prefix of its p probed buckets and keep the k best.
  pool_scan_fused  -> ivf_pool_scan (B2): the same scoring, returned as the
                      raw [Q, p*B] distance pool (optionally over the
                      int4 split-nibble bank).

Each wrapper chooses by the device of the tensors it is given: CPU tensors
go to the plain PyTorch version beside it, CUDA tensors launch the kernel
(or raise).  LAUNCHES counts kernel launches only.

search_clustered_fused / search_clustered_pool add the centroid route in
plain torch, as XLA did outside the Pallas kernels.
"""

from __future__ import annotations

import torch

from .distance import pairwise, preprocess
from .quantize import int4_scale, unpack_int4
from .topk import INF, SENTINEL, topk_ascending, topk_ascending_stable

# live-prefix granularity: a bucket is scanned up to nsb[c] * SUB_BLOCK rows
SUB_BLOCK = 128
# shared memory a block may opt into on sm_90 (B1 keeps its pool there)
MAX_SMEM_BYTES = 232_448
# the plain versions gather [q, p, B, D] f32 blocks; bound that transient
_PLAIN_BYTES = 1 << 29

LAUNCHES = {"search_fused": 0, "pool_scan": 0}

_SPACES = {"cosine": 0, "dot": 1, "l2": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_PACKED = 3


def live_prefix_blocks(valid: torch.Tensor, block: int = SUB_BLOCK) -> torch.Tensor:
    """Per-cluster count of `block`-row sub-blocks covering the live rows:
    ceil((last live slot + 1) / block).  [K] int32; 0 for empty buckets."""
    K, B = valid.shape
    lane = torch.arange(1, B + 1, dtype=torch.int32, device=valid.device)
    upper = torch.where(valid, lane, 0).amax(dim=1)
    return ((upper + block - 1) // block).to(torch.int32)


def _full_prefix(vectors: torch.Tensor) -> torch.Tensor:
    K, B = vectors.shape[:2]
    return torch.full((K,), -(-B // SUB_BLOCK), dtype=torch.int32, device=vectors.device)


# --------------------------------------------------------------------------
# plain PyTorch versions


def pool_scan_plain(
    vectors: torch.Tensor,  # [K, B, D'] bank (D' = D/2 uint8 when packed)
    scales: torch.Tensor,  # [K, B] f32
    rowid_masked: torch.Tensor,  # [K, B] int32, SENTINEL where dead
    queries_prep: torch.Tensor,  # [Q, D] f32 preprocessed
    cids: torch.Tensor,  # [Q, p] int32 probed clusters
    space: str,
    packed: bool = False,
    nsb: torch.Tensor | None = None,  # [K] int32 live-prefix sub-blocks
) -> torch.Tensor:
    """Distance pool [Q, p*B] f32: lane r*B + j scores row j of bucket
    cids[q, r]; INF on tombstones and past the live prefix."""
    if nsb is None:
        nsb = _full_prefix(vectors)
    Q, p = cids.shape
    B = vectors.shape[1]
    D = queries_prep.shape[1]
    qf = queries_prep.float()
    scaled = packed or vectors.dtype == torch.int8
    step = max(1, _PLAIN_BYTES // max(p * B * D * 4, 1))
    out = []
    for off in range(0, Q, step):
        cg = cids[off : off + step].long()
        q = qf[off : off + step]
        rows = vectors[cg]  # [q, p, B, D']
        x = (unpack_int4(rows) if packed else rows).float()
        dots = torch.einsum("qpbd,qd->qpb", x, q)
        if space == "l2":
            sq = torch.sum(x * x, dim=-1)
        del x
        if scaled:
            s = int4_scale(scales[cg]) if packed else scales[cg]
            dots = dots * s
            if space == "l2":
                sq = sq * s * s
        if space == "l2":
            q_sq = torch.sum(q * q, dim=-1)
            d = q_sq[:, None, None] + sq - 2.0 * dots
        elif space == "dot":
            d = -dots
        else:
            d = 1.0 - dots
        live = torch.arange(B, device=vectors.device) < (nsb[cg] * SUB_BLOCK)[..., None]
        dead = (rowid_masked[cg] == SENTINEL) | ~live
        out.append(d.masked_fill(dead, INF).reshape(len(cg), p * B))
    return torch.cat(out) if out else qf.new_empty((0, p * B))


def search_fused_plain(
    vectors: torch.Tensor,
    scales: torch.Tensor,
    rowid_masked: torch.Tensor,
    queries_prep: torch.Tensor,
    cids: torch.Tensor,
    space: str,
    k: int,
    nsb: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist [Q, k] ascending, rowid [Q, k] int32; SENTINEL where INF).
    Ties go to the lowest pool position, as in the kernel."""
    pool = pool_scan_plain(
        vectors, scales, rowid_masked, queries_prep, cids, space, False, nsb
    )
    Q, P = pool.shape
    kk = min(k, P)
    top_d, pos = topk_ascending_stable(pool, kk)
    rids = rowid_masked[cids.long()].reshape(Q, P)
    top_r = torch.gather(rids, 1, pos)
    top_r = torch.where(torch.isinf(top_d), SENTINEL, top_r)
    return _pad_k(top_d, top_r, k)


def _pad_k(top_d, top_r, k):
    kk = top_d.shape[1]
    if k > kk:
        top_d = torch.nn.functional.pad(top_d, (0, k - kk), value=INF)
        top_r = torch.nn.functional.pad(top_r, (0, k - kk), value=SENTINEL)
    return top_d, top_r


# --------------------------------------------------------------------------
# kernel wrappers


def _kernel_inputs(vectors, scales, rowid_masked, queries_prep, cids, nsb, D):
    """Validate what the kernels take; return (vec, qsq, stream)."""
    dev = vectors.device
    K, B = vectors.shape[:2]
    Q, p = cids.shape
    for name, t, dtype, shape in (
        ("scales", scales, torch.float32, (K, B)),
        ("rowid_masked", rowid_masked, torch.int32, (K, B)),
        ("queries_prep", queries_prep, torch.float32, (Q, D)),
        ("cids", cids, torch.int32, (Q, p)),
        ("nsb", nsb, torch.int32, (K,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not vectors.is_contiguous():
        raise ValueError("vectors must be contiguous")
    if Q > 65535:
        raise ValueError(f"query batch {Q} exceeds 65535")
    row_bytes = vectors.shape[2] * vectors.element_size()
    vec = int(row_bytes % 16 == 0 and vectors.data_ptr() % 16 == 0)
    qsq = torch.sum(queries_prep * queries_prep, dim=-1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return vec, qsq, stream


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def search_fused(
    vectors: torch.Tensor,  # [K, B, D] int8 / bf16 / f32
    scales: torch.Tensor,  # [K, B] f32
    rowid_masked: torch.Tensor,  # [K, B] int32, SENTINEL where dead
    queries_prep: torch.Tensor,  # [Q, D] f32 preprocessed
    cids: torch.Tensor,  # [Q, p] int32
    space: str,
    k: int,
    nsb: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """B1: (dist [Q, k] f32 ascending, rowid [Q, k] int32)."""
    if nsb is None:
        nsb = _full_prefix(vectors)
    if vectors.device.type == "cpu":
        return search_fused_plain(
            vectors, scales, rowid_masked, queries_prep, cids, space, k, nsb
        )
    if vectors.device.type != "cuda":
        raise ValueError(f"no kernel for device {vectors.device}")
    if vectors.dtype not in _DTYPES:
        raise ValueError(f"unsupported bank dtype {vectors.dtype}")
    K, B, D = vectors.shape
    Q, p = cids.shape
    smem = (D + p * B) * 4
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"candidate pool of {p} probes x bucket {B} needs {smem} bytes of "
            f"shared memory; the limit is {MAX_SMEM_BYTES}"
        )
    vec, qsq, stream = _kernel_inputs(
        vectors, scales, rowid_masked, queries_prep, cids, nsb, D
    )
    out_d = torch.empty((Q, k), dtype=torch.float32, device=vectors.device)
    out_r = torch.empty((Q, k), dtype=torch.int32, device=vectors.device)
    if Q == 0 or k == 0:
        return out_d, out_r
    from ..kernels.build import load_library

    err = load_library().ivf_search_fused(
        _DTYPES[vectors.dtype],
        vectors.data_ptr(),
        scales.data_ptr(),
        rowid_masked.data_ptr(),
        queries_prep.data_ptr(),
        qsq.data_ptr(),
        cids.data_ptr(),
        nsb.data_ptr(),
        Q,
        B,
        D,
        p,
        k,
        _SPACES[space],
        int(vectors.dtype == torch.int8),
        vec,
        out_d.data_ptr(),
        out_r.data_ptr(),
        stream,
    )
    _check_launch("ivf_search_fused", err)
    LAUNCHES["search_fused"] += 1
    return out_d, out_r


def pool_scan_fused(
    vectors: torch.Tensor,  # [K, B, D] or packed [K, B, D/2] uint8
    scales: torch.Tensor,
    rowid_masked: torch.Tensor,
    queries_prep: torch.Tensor,  # [Q, D] f32 preprocessed
    cids: torch.Tensor,
    space: str,
    packed: bool = False,
    nsb: torch.Tensor | None = None,
) -> torch.Tensor:
    """B2: distance pool [Q, p*B] f32 (INF where dead or past the prefix)."""
    if nsb is None:
        nsb = _full_prefix(vectors)
    if vectors.device.type == "cpu":
        return pool_scan_plain(
            vectors, scales, rowid_masked, queries_prep, cids, space, packed, nsb
        )
    if vectors.device.type != "cuda":
        raise ValueError(f"no kernel for device {vectors.device}")
    K, B = vectors.shape[:2]
    Q, p = cids.shape
    D = queries_prep.shape[1]
    if packed:
        if vectors.dtype != torch.uint8 or 2 * vectors.shape[2] != D:
            raise ValueError("packed bank must be uint8 [K, B, D/2]")
        code = _PACKED
    elif vectors.dtype in _DTYPES and vectors.shape[2] == D:
        code = _DTYPES[vectors.dtype]
    else:
        raise ValueError(f"unsupported bank {vectors.dtype} {tuple(vectors.shape)}")
    vec, qsq, stream = _kernel_inputs(
        vectors, scales, rowid_masked, queries_prep, cids, nsb, D
    )
    out = torch.empty((Q, p * B), dtype=torch.float32, device=vectors.device)
    if Q == 0 or p == 0:
        return out
    from ..kernels.build import load_library

    err = load_library().ivf_pool_scan(
        code,
        vectors.data_ptr(),
        scales.data_ptr(),
        rowid_masked.data_ptr(),
        queries_prep.data_ptr(),
        qsq.data_ptr(),
        cids.data_ptr(),
        nsb.data_ptr(),
        Q,
        B,
        D,
        p,
        _SPACES[space],
        int(packed or vectors.dtype == torch.int8),
        vec,
        out.data_ptr(),
        stream,
    )
    _check_launch("ivf_pool_scan", err)
    LAUNCHES["pool_scan"] += 1
    return out


# --------------------------------------------------------------------------
# clustered search: centroid route + kernel


def scan_masks(state) -> tuple[torch.Tensor, torch.Tensor]:
    """(rowids with SENTINEL where dead [K, B] int32, live-prefix sub-blocks
    [K] int32): what both kernels take besides the bank.  Computed once per
    query batch and shared by its chunks."""
    return torch.where(state.valid, state.rowid, SENTINEL), live_prefix_blocks(state.valid)


def route(state, queries: torch.Tensor, space: str, probes: int):
    """Preprocessed f32 queries and their top-`probes` clusters [Q, p] int32.

    The JAX package routes with bf16 centroids and f32 accumulation, i.e. an
    exact product of bf16-rounded operands.  The query is rounded the same
    way and the product taken in float32 with TF32 off: TF32 would keep ~10
    mantissa bits of each operand and change which clusters are probed.
    The flag is process-wide, so it is set once at the service entry
    (`run`) and only checked here."""
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the centroid route "
            "needs full float32 products to probe the clusters the JAX "
            "package probes"
        )
    qf = preprocess(queries.float(), space)
    cd = pairwise(qf.to(state.centroids.dtype), state.centroids, space)
    p = min(probes, state.n_clusters)
    _, cids = topk_ascending(cd, p)
    return qf, cids.to(torch.int32), p


def search_clustered_fused(
    state, queries: torch.Tensor, space: str, k: int, probes: int, masks=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Route + B1.  (dist [Q, k] ascending, rowids [Q, k]; INF/SENTINEL
    padded).  `masks` is scan_masks(state), computed here if not given."""
    qf, cids, _ = route(state, queries, space, probes)
    rid_masked, nsb = masks if masks is not None else scan_masks(state)
    return search_fused(
        state.vectors, state.scales, rid_masked, qf, cids, space, k, nsb
    )


def search_clustered_pool(
    state, queries: torch.Tensor, space: str, k: int, probes: int, masks=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Route + B2 + one top-k: the large-k path (any k)."""
    qf, cids, p = route(state, queries, space, probes)
    rid_masked, nsb = masks if masks is not None else scan_masks(state)
    pool = pool_scan_fused(
        state.vectors, state.scales, rid_masked, qf, cids, space, nsb=nsb
    )
    Q, P = pool.shape
    rids = rid_masked[cids.long()].reshape(Q, P)
    top_d, pos = topk_ascending(pool, min(k, P))
    top_r = torch.gather(rids, 1, pos)
    top_r = torch.where(torch.isinf(top_d), SENTINEL, top_r)
    return _pad_k(top_d, top_r, k)

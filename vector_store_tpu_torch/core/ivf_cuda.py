"""Fused IVF probe-scan: the CUDA kernels B1/B2 and their plain versions.

Counterpart of vector_store_tpu/core/ivf_pallas.py.  The kernels live in
csrc/ivf_scan.cu:

  search_fused     -> ivf_search_fused (B1): per query, score the live
                      prefix of its p probed buckets and keep the k best,
                      in one of four score modes (f32, qi8, bf16, stub).
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
# threads of one B1 block (kFusedThreads in csrc/ivf_scan.cu)
_FUSED_THREADS = 512
# the plain versions gather [q, p, B, D] f32 blocks; bound that transient
_PLAIN_BYTES = 1 << 29

LAUNCHES = {"search_fused": 0, "pool_scan": 0}
# B1 launches by score mode (each one also counts in LAUNCHES["search_fused"])
SCORE_LAUNCHES = {"f32": 0, "qi8": 0, "bf16": 0, "stub": 0}

_SPACES = {"cosine": 0, "dot": 1, "l2": 2}
_SCORES = {"f32": 0, "qi8": 1, "bf16": 2, "stub": 3}
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


def score_query(
    queries_prep: torch.Tensor, vectors: torch.Tensor, space: str, score: str
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """B1's query operand in a score mode, as ivf_pallas.search_fused
    builds it (ivf_pallas.py:448-463): (query, per-query scale or None).

    f32 and stub take the f32 query as it is; bf16 rounds it to bf16; qi8
    quantizes it symmetrically per query to int8 codes (round half to even,
    clip +-127) and returns their scale max|q|/127.  qi8 and bf16 need int8
    rows and cosine or dot."""
    if score not in _SCORES:
        raise ValueError(f"unknown score mode {score!r}")
    if score in ("qi8", "bf16") and (space == "l2" or vectors.dtype != torch.int8):
        raise ValueError(f"score={score!r} needs int8 rows and cosine/dot")
    if score == "qi8":
        qs = torch.clamp(torch.amax(torch.abs(queries_prep), dim=1), min=1e-30) / 127.0
        codes = torch.clamp(torch.round(queries_prep / qs[:, None]), -127, 127)
        return codes.to(torch.int8), qs
    if score == "bf16":
        return queries_prep.to(torch.bfloat16).float(), None
    return queries_prep, None


def _pool_plain(
    vectors, scales, rowid_masked, q_in, cids, space, packed, nsb, score="f32", qscale=None
) -> torch.Tensor:
    """The distance pool of B2, and of B1 in every score mode.

    qi8 takes exact integer dots (in float64, one rounding to f32 as the
    kernel's int32 -> f32) scaled by scale[slot] * qscale[q]; stub scores
    a row as its element 0 times its scale, with no distance transform."""
    if nsb is None:
        nsb = _full_prefix(vectors)
    Q, p = cids.shape
    B = vectors.shape[1]
    D = q_in.shape[1]
    qf = q_in.double() if score == "qi8" else q_in.float()
    scaled = packed or vectors.dtype == torch.int8
    step = max(1, _PLAIN_BYTES // max(p * B * D * qf.element_size(), 1))
    out = []
    for off in range(0, Q, step):
        cg = cids[off : off + step].long()
        q = qf[off : off + step]
        if score == "stub":
            d = vectors[:, :, 0][cg].float() * scales[cg]
        elif score == "qi8":
            dots = torch.einsum("qpbd,qd->qpb", vectors[cg].double(), q).float()
            dots = dots * (scales[cg] * qscale[off : off + step, None, None])
            d = -dots if space == "dot" else 1.0 - dots
        else:
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
    return torch.cat(out) if out else q_in.new_empty((0, p * B), dtype=torch.float32)


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
    return _pool_plain(vectors, scales, rowid_masked, queries_prep, cids, space, packed, nsb)


def search_fused_plain(
    vectors: torch.Tensor,
    scales: torch.Tensor,
    rowid_masked: torch.Tensor,
    queries_prep: torch.Tensor,
    cids: torch.Tensor,
    space: str,
    k: int,
    nsb: torch.Tensor | None = None,
    score: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dist [Q, k] ascending, rowid [Q, k] int32; SENTINEL where INF).
    Ties go to the lowest pool position, as in the kernel."""
    q_in, qscale = score_query(queries_prep, vectors, space, score)
    pool = _pool_plain(
        vectors, scales, rowid_masked, q_in, cids, space, False, nsb, score, qscale
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


def fused_smem_bytes(dims: int, probes: int, bucket: int, score: str = "f32") -> int:
    """Shared memory of one B1 block: the staged query and the [p*B] pool
    (f32), plus in the stub mode a 16-byte copy slot per thread and warp."""
    smem = (dims + probes * bucket) * 4
    if score == "stub":
        smem = -(-smem // 16) * 16 + (_FUSED_THREADS + _FUSED_THREADS // 32) * 16
    return smem


def fused_fits(dims: int, probes: int, bucket: int, score: str = "f32") -> bool:
    """Whether B1 can take a query batch of this geometry: its pool must
    fit one block's shared memory (MAX_SMEM_BYTES)."""
    return fused_smem_bytes(dims, probes, bucket, score) <= MAX_SMEM_BYTES


def search_fused(
    vectors: torch.Tensor,  # [K, B, D] int8 / bf16 / f32
    scales: torch.Tensor,  # [K, B] f32
    rowid_masked: torch.Tensor,  # [K, B] int32, SENTINEL where dead
    queries_prep: torch.Tensor,  # [Q, D] f32 preprocessed
    cids: torch.Tensor,  # [Q, p] int32
    space: str,
    k: int,
    nsb: torch.Tensor | None = None,
    score: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """B1: (dist [Q, k] f32 ascending, rowid [Q, k] int32).

    `score` as ivf_pallas.search_fused: "f32" (the serving mode), "qi8"
    (int8 query, s8 x s8 -> s32 dots), "bf16" (bf16-rounded query) or
    "stub" (the copy-floor ablation: a row scores as element 0 x scale)."""
    if nsb is None:
        nsb = _full_prefix(vectors)
    if vectors.device.type == "cpu":
        return search_fused_plain(
            vectors, scales, rowid_masked, queries_prep, cids, space, k, nsb, score
        )
    if vectors.device.type != "cuda":
        raise ValueError(f"no kernel for device {vectors.device}")
    if vectors.dtype not in _DTYPES:
        raise ValueError(f"unsupported bank dtype {vectors.dtype}")
    K, B, D = vectors.shape
    Q, p = cids.shape
    if not fused_fits(D, p, B, score):
        raise ValueError(
            f"candidate pool of {p} probes x bucket {B} needs "
            f"{fused_smem_bytes(D, p, B, score)} bytes of shared memory; the "
            f"limit is {MAX_SMEM_BYTES}"
        )
    vec, qsq, stream = _kernel_inputs(
        vectors, scales, rowid_masked, queries_prep, cids, nsb, D
    )
    if score == "stub" and not vec:
        raise ValueError("score='stub' copies rows in 16-byte chunks: row bytes "
                         "and the bank's address must be multiples of 16")
    q_in, qscale = score_query(queries_prep, vectors, space, score)
    out_d = torch.empty((Q, k), dtype=torch.float32, device=vectors.device)
    out_r = torch.empty((Q, k), dtype=torch.int32, device=vectors.device)
    if Q == 0 or k == 0:
        return out_d, out_r
    from ..kernels.build import load_library

    err = load_library().ivf_search_fused(
        _DTYPES[vectors.dtype],
        _SCORES[score],
        vectors.data_ptr(),
        scales.data_ptr(),
        rowid_masked.data_ptr(),
        q_in.data_ptr(),
        qsq.data_ptr(),
        None if qscale is None else qscale.data_ptr(),
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
    SCORE_LAUNCHES[score] += 1
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


def route(state, queries: torch.Tensor, space: str, probes: int, rounded: bool = False):
    """Preprocessed f32 queries and their top-`probes` clusters [Q, p] int32.

    The JAX package routes with bf16 centroids and f32 accumulation, i.e. an
    exact product of bf16-rounded operands.  The query is rounded the same
    way and the product taken in float32 with TF32 off: TF32 would keep ~10
    mantissa bits of each operand and change which clusters are probed.
    The flag is process-wide, so it is set once at the service entry
    (`run`) and only checked here.

    The single-stage kernels score with the unrounded f32 query.
    `rounded=True` returns the query rounded to the centroid dtype instead,
    as the JAX `_route` does (ivf.py:410-422): the two-stage scan scores
    with that one."""
    if queries.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the centroid route "
            "needs full float32 products to probe the clusters the JAX "
            "package probes"
        )
    qf = preprocess(queries.float(), space)
    qc = qf.to(state.centroids.dtype)
    cd = pairwise(qc, state.centroids, space)
    p = min(probes, state.n_clusters)
    _, cids = topk_ascending(cd, p)
    return (qc if rounded else qf), cids.to(torch.int32), p


def search_clustered_fused(
    state,
    queries: torch.Tensor,
    space: str,
    k: int,
    probes: int,
    masks=None,
    score: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Route + B1.  (dist [Q, k] ascending, rowids [Q, k]; INF/SENTINEL
    padded).  `masks` is scan_masks(state), computed here if not given;
    `score` is B1's score mode (the service keeps "f32")."""
    qf, cids, _ = route(state, queries, space, probes)
    rid_masked, nsb = masks if masks is not None else scan_masks(state)
    return search_fused(
        state.vectors, state.scales, rid_masked, qf, cids, space, k, nsb, score
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

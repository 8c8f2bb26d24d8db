"""Fused IVF probe-scan: the CUDA kernels B1/B2 and their plain versions.

Counterpart of vector_store_tpu/core/ivf_pallas.py.  The kernels live in
csrc/ivf_scan.cu:

  search_fused     -> ivf_search_fused (B1): per query, score the live
                      prefix of its p probed buckets and keep the k best,
                      in one of four score modes (f32, qi8, bf16, stub).
                      Three launches: a work list of tiles (one bucket, up
                      to TILE of the (query, rank) pairs probing it), the
                      scan (each tile reads its bucket once and keeps a
                      top-k per pair), the merge of the p partial lists.
  pool_scan_fused  -> ivf_pool_scan (B2): the same scoring (f32 mode),
                      returned as the raw [Q, p*B] distance pool
                      (optionally over the int4 split-nibble bank).  Two
                      launches: B1's work list, then a scan of its tiles
                      whose epilogue stores each pair's scores to the pool.

Each wrapper chooses by the device of the tensors it is given: CPU tensors
go to the plain PyTorch version beside it, CUDA tensors launch the kernel
(or raise).  LAUNCHES counts B1 and B2 calls (B1_KERNELS_PER_CALL and
B2_KERNELS_PER_CALL launches each), never the plain versions.

search_clustered_fused / search_clustered_pool add the centroid route in
plain torch, as XLA did outside the Pallas kernels.
"""

from __future__ import annotations

import torch

from .distance import pairwise, preprocess
from .quantize import int4_scale, unpack_int4
from .topk import INF, SENTINEL, lexsort_stable, topk_ascending, topk_ascending_stable

# live-prefix granularity: a bucket is scanned up to nsb[c] * SUB_BLOCK rows
SUB_BLOCK = 128
# B1's limits (csrc/ivf_scan.cu): (query, rank) pairs per tile; pairs per
# work list (a larger batch is cut into chunks of MAX_PAIRS // p queries,
# three launches each); dims, which alone set a scan block's shared memory
TILE = 16
MAX_PAIRS = 8192
FUSED_MAX_DIMS = 3072
# B2 past FUSED_MAX_DIMS takes the row in chunks whose queries stage at
# most POOL_CHUNK_DIMS dims a pair (pool_chunk), so that two scan blocks
# fit an SM
POOL_CHUNK_DIMS = 1024
# CUDA launches of one B1 call (work list, scan, merge) and of one B2 call
# (work list, scan)
B1_KERNELS_PER_CALL = 3
B2_KERNELS_PER_CALL = 2
# the plain versions gather [q, p, B, D] f32 blocks; bound that transient
_PLAIN_BYTES = 1 << 29

# B1 calls (each B1_KERNELS_PER_CALL launches) and B2 calls (each
# B2_KERNELS_PER_CALL)
LAUNCHES = {"search_fused": 0, "pool_scan": 0}
# B1 launches by score mode (each one also counts in LAUNCHES["search_fused"])
SCORE_LAUNCHES = {"f32": 0, "qi8": 0, "bf16": 0, "stub": 0}

_SPACES = {"cosine": 0, "dot": 1, "l2": 2}
_SCORES = {"f32": 0, "qi8": 1, "bf16": 2, "stub": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_PACKED = 3
_INT_MAX = 2**31 - 1  # a partial entry's position where its distance is INF


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


def _check_score(vectors: torch.Tensor, space: str, score: str) -> None:
    if score not in _SCORES:
        raise ValueError(f"unknown score mode {score!r}")
    if score in ("qi8", "bf16") and (space == "l2" or vectors.dtype != torch.int8):
        raise ValueError(f"score={score!r} needs int8 rows and cosine/dot")


def score_query(
    queries_prep: torch.Tensor, vectors: torch.Tensor, space: str, score: str
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """B1's query operand in a score mode, as ivf_pallas.search_fused
    builds it (ivf_pallas.py:448-463): (query, per-query scale or None).

    f32 and stub take the f32 query as it is; bf16 rounds it to bf16; qi8
    quantizes it symmetrically per query to int8 codes (round half to even,
    clip +-127) and returns their scale max|q|/127.  qi8 and bf16 need int8
    rows and cosine or dot."""
    _check_score(vectors, space, score)
    if score == "qi8":
        m = torch.clamp(torch.amax(torch.abs(queries_prep), dim=1), min=1e-30)
        # a tensor divisor: torch divides a CUDA tensor by a Python scalar
        # through its reciprocal, which rounds differently from m / 127
        qs = m / torch.full_like(m, 127.0)
        codes = torch.clamp(torch.round(queries_prep / qs[:, None]), -127, 127)
        return codes.to(torch.int8), qs
    if score == "bf16":
        return queries_prep.to(torch.bfloat16).float(), None
    return queries_prep, None


def pool_chunk(D: int, packed: bool) -> int:
    """Row elements (packed: bytes, two dims each) per chunk of B2's scan:
    the whole row up to FUSED_MAX_DIMS dims, else equal chunks, each a
    multiple of 256 elements, whose queries stage at most POOL_CHUNK_DIMS
    dims; the last chunk may be shorter."""
    dw = D // 2 if packed else D
    if D <= FUSED_MAX_DIMS:
        return dw
    per = POOL_CHUNK_DIMS // 2 if packed else POOL_CHUNK_DIMS
    n = -(-dw // per)  # chunks
    size = -(-dw // n)
    return -(-size // 256) * 256


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


def query_digits(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 query as B1's tensor-core path takes it, in plain torch:
    (digits [Q, 4, D] int8, factor [Q] f32) with
    q = factor * (d1 * 2^21 + d2 * 2^14 + d3 * 2^7 + d4), each |d| <= 64:
    the query at a power of two 2^e that puts max|q| in [32, 64), cut into
    four base-128 digits by round-half-even, the residual dropped."""
    q = queries.float()
    m = torch.amax(torch.abs(q), dim=1)
    e = torch.where(m > 0, torch.frexp(m)[1] - 1 - 5, 0).to(torch.int32)  # ilogb(m) - 5
    v = torch.ldexp(q, -e[:, None].float())
    digits = []
    for _ in range(4):
        d = torch.round(v)
        digits.append(d)
        v = (v - d) * 128.0
    fac = torch.ldexp(torch.ones_like(m), (e - 21).float())
    return torch.stack(digits, 1).to(torch.int8), fac


def _pad_k(top_d, top_r, k):
    kk = top_d.shape[1]
    if k > kk:
        top_d = torch.nn.functional.pad(top_d, (0, k - kk), value=INF)
        top_r = torch.nn.functional.pad(top_r, (0, k - kk), value=SENTINEL)
    return top_d, top_r


# --------------------------------------------------------------------------
# kernel wrappers


def _kernel_inputs(vectors, scales, rowid_masked, queries_prep, cids, nsb, D):
    """Validate what the kernels take; return (vec, stream)."""
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
    row_bytes = vectors.shape[2] * vectors.element_size()
    vec = int(row_bytes % 16 == 0 and vectors.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return vec, stream


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _b1_limits(D: int, p: int, k: int) -> None:
    if D > FUSED_MAX_DIMS:
        raise ValueError(f"B1 takes at most {FUSED_MAX_DIMS} dims, got {D}")
    if p > MAX_PAIRS:
        raise ValueError(f"B1 takes at most {MAX_PAIRS} probes, got {p}")
    if not 1 <= k <= 32:
        raise ValueError(f"B1 takes 1 <= k <= 32, got {k}")


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
    "stub" (the copy-floor ablation: a row scores as element 0 x scale).
    On CUDA the kernel builds the query operand of the mode itself, from
    the f32 query, and the call does not synchronise the host: any bucket
    size, k <= 32, D <= FUSED_MAX_DIMS."""
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
    _check_score(vectors, space, score)
    vec, stream = _kernel_inputs(vectors, scales, rowid_masked, queries_prep, cids, nsb, D)
    if score == "stub" and not vec:
        raise ValueError("score='stub' copies rows in 16-byte chunks: row bytes "
                         "and the bank's address must be multiples of 16")
    out_d = torch.empty((Q, k), dtype=torch.float32, device=vectors.device)
    out_r = torch.empty((Q, k), dtype=torch.int32, device=vectors.device)
    if Q == 0 or k == 0:
        return out_d, out_r
    _b1_limits(D, p, k)
    from ..kernels.build import load_library

    lib = load_library()
    qc = MAX_PAIRS // p  # queries per work list
    n = min(Q, qc) * p
    # work list (3n + 2), partials (2nk), the stub's sink (256)
    ws = torch.empty(3 * n + 2 + 2 * n * k + 256, dtype=torch.int32, device=vectors.device)
    for off in range(0, Q, qc):
        m = min(qc, Q - off)
        with torch.cuda.device(vectors.device):  # the launch runs on the current device
            err = lib.ivf_search_fused(
                _DTYPES[vectors.dtype],
                _SCORES[score],
                vectors.data_ptr(),
                scales.data_ptr(),
                rowid_masked.data_ptr(),
                queries_prep[off].data_ptr(),
                cids[off].data_ptr(),
                nsb.data_ptr(),
                m,
                B,
                D,
                p,
                k,
                _SPACES[space],
                int(vectors.dtype == torch.int8),
                vec,
                ws.data_ptr(),
                out_d[off].data_ptr(),
                out_r[off].data_ptr(),
                stream,
            )
        _check_launch("ivf_search_fused", err)
        LAUNCHES["search_fused"] += 1
        SCORE_LAUNCHES[score] += 1
    return out_d, out_r


def worklist(cids: torch.Tensor, tile: int = TILE):
    """B1's work list of a [Q, p] int32 probe list: (order [N], tile_start
    [N], tile_n [N], n_tiles [1]) with N = Q*p pairs e = q*p + r.  Tile t
    (t < n_tiles) holds the pairs order[tile_start[t] : + tile_n[t]]: one
    bucket, at most `tile` pairs; every pair lies in exactly one tile;
    entries past n_tiles are unused.  Nothing is read back to the host.

    On CPU tensors, the plain version (worklist_plain); on CUDA, the work
    list kernel B1 launches first, alone (it groups by a hash, so its tile
    order differs from the plain version's)."""
    if cids.device.type == "cpu":
        return worklist_plain(cids, tile)
    if cids.device.type != "cuda":
        raise ValueError(f"no kernel for device {cids.device}")
    N = cids.numel()
    if tile != TILE or not 0 < N <= MAX_PAIRS:
        raise ValueError(f"the kernel takes tile {TILE} and 1..{MAX_PAIRS} pairs")
    cids = cids.to(torch.int32).contiguous()
    ws = torch.empty(3 * N + 2, dtype=torch.int32, device=cids.device)
    from ..kernels.build import load_library

    with torch.cuda.device(cids.device):  # the launch runs on the current device
        err = load_library().ivf_b1_worklist(
            cids.data_ptr(), N, ws.data_ptr(), ws[N:].data_ptr(), ws[2 * N :].data_ptr(),
            ws[3 * N :].data_ptr(), torch.cuda.current_stream(cids.device).cuda_stream,
        )
    _check_launch("ivf_b1_worklist", err)
    return ws[:N], ws[N : 2 * N], ws[2 * N : 3 * N], ws[3 * N : 3 * N + 1]


def worklist_plain(cids: torch.Tensor, tile: int = TILE):
    """worklist() in plain torch: the pairs grouped by bucket in a stable
    sort of the flat cids, each bucket's run cut into tiles of `tile`,
    the tiles compacted to the front.  No host synchronisation."""
    flat = cids.reshape(-1).long()
    N = flat.numel()
    order = torch.sort(flat, stable=True)[1]
    c_sorted = flat[order]
    i = torch.arange(N, device=flat.device)
    new_run = torch.ones(N, dtype=torch.bool, device=flat.device)
    new_run[1:] = c_sorted[1:] != c_sorted[:-1]
    run_start = torch.cummax(torch.where(new_run, i, 0), dim=0)[0]
    head = (i - run_start) % tile == 0
    tix = torch.cumsum(head.long(), 0) - 1  # each pair's tile
    n_tiles = head.sum().reshape(1)
    tile_start = torch.zeros(N, dtype=torch.long, device=flat.device)
    tile_n = torch.zeros(N, dtype=torch.long, device=flat.device)
    tile_start[tix[head]] = i[head]
    tile_n.index_add_(0, tix, torch.ones_like(tix))
    return tuple(t.to(torch.int32) for t in (order, tile_start, tile_n, n_tiles))


def split_topk_plain(
    pool: torch.Tensor, rids: torch.Tensor, p: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """B1's top-k as its kernels take it, in plain torch: a [Q, p*B] pool
    (lane r*B + j scores row j of the r-th probed bucket) and its rowids
    [Q, p*B].  Partials: per (query, rank) the k best (distance, row),
    ties to the lowest row, INF entries at position INT_MAX; then the
    merge of the p*k partials in (distance, position r*B + j) order.
    Returns (dist [Q, k], rowid [Q, k] int32; SENTINEL where INF)."""
    Q, P = pool.shape
    B = P // p
    kk = min(k, B)
    d, j = topk_ascending_stable(pool.reshape(Q, p, B), kk)  # [Q, p, kk]
    pos = torch.arange(p, device=pool.device)[None, :, None] * B + j
    pos = torch.where(torch.isinf(d), _INT_MAX, pos)
    if kk < k:
        d = torch.nn.functional.pad(d, (0, k - kk), value=INF)
        pos = torch.nn.functional.pad(pos, (0, k - kk), value=_INT_MAX)
    d, pos = d.reshape(Q, p * k), pos.reshape(Q, p * k)
    perm = lexsort_stable([d, pos])[:, :k]
    top_d, top_p = torch.gather(d, 1, perm), torch.gather(pos, 1, perm)
    fin = ~torch.isinf(top_d)
    top_r = torch.gather(rids, 1, torch.where(fin, top_p, 0))
    return top_d, torch.where(fin, top_r, SENTINEL).to(torch.int32)


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
    """B2: distance pool [Q, p*B] f32 (INF where dead or past the prefix).

    On CUDA: B1's work list, then a scan of its tiles (each reads its
    bucket once for its pairs) that stores the pool; two launches per
    chunk of MAX_PAIRS // p queries, no host synchronisation, any D."""
    if nsb is None:
        nsb = _full_prefix(vectors)
    if vectors.device.type == "cpu":
        return pool_scan_plain(
            vectors, scales, rowid_masked, queries_prep, cids, space, packed, nsb
        )
    if vectors.device.type != "cuda":
        raise ValueError(f"no kernel for device {vectors.device}")
    D = queries_prep.shape[1]
    if packed:
        if vectors.dtype != torch.uint8 or 2 * vectors.shape[2] != D:
            raise ValueError("packed bank must be uint8 [K, B, D/2]")
        code = _PACKED
    elif vectors.dtype in _DTYPES and vectors.shape[2] == D:
        code = _DTYPES[vectors.dtype]
    else:
        raise ValueError(f"unsupported bank {vectors.dtype} {tuple(vectors.shape)}")
    K, B = vectors.shape[:2]
    Q, p = cids.shape
    if p > MAX_PAIRS:
        raise ValueError(f"B2 takes at most {MAX_PAIRS} probes, got {p}")
    vec, stream = _kernel_inputs(vectors, scales, rowid_masked, queries_prep, cids, nsb, D)
    out = torch.empty((Q, p * B), dtype=torch.float32, device=vectors.device)
    if Q == 0 or p == 0:
        return out
    from ..kernels.build import load_library

    lib = load_library()
    qc = MAX_PAIRS // p  # queries per work list
    n = min(Q, qc) * p
    ws = torch.empty(3 * n + 2 + 256, dtype=torch.int32, device=vectors.device)
    for off in range(0, Q, qc):
        with torch.cuda.device(vectors.device):  # the launch runs on the current device
            err = lib.ivf_pool_scan(
                code,
                vectors.data_ptr(),
                scales.data_ptr(),
                rowid_masked.data_ptr(),
                queries_prep[off].data_ptr(),
                cids[off].data_ptr(),
                nsb.data_ptr(),
                min(qc, Q - off),
                B,
                D,
                pool_chunk(D, packed),
                p,
                _SPACES[space],
                int(packed or vectors.dtype == torch.int8),
                vec,
                ws.data_ptr(),
                out[off].data_ptr(),
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

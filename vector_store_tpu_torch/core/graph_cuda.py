"""The graph's CUDA kernels and their plain versions: B3 (beam-search
gather+score) and the insert's robust prune.

B3 is the counterpart of vector_store_tpu/core/graph_pallas.py and of the
expand round's adjacency read around it (vector_store_tpu/core/search.py:
66-98).  One kernel template in csrc/graph_gather.cu, two entry points:

  expand_score_fused  -> graph_expand_score: the expand round's candidates
                         read through the adjacency (neighbors[sel_ids],
                         dead beams and ids >= C as SENTINEL) and scored,
                         one launch a round (core/search.py::_expand_round);
  gather_score_fused  -> graph_gather_score: the candidate ids given, the
                         counterpart of graph_pallas.gather_score_fused.

robust_prune -> graph_robust_prune (csrc/graph_prune.cu): the alpha-
RobustPrune selection of core/build.py::_robust_prune, one launch an insert
or refine block, where the JAX package runs a lax.scan
(vector_store_tpu/core/build.py:61-123) and no Pallas kernel.

reverse_edges -> graph_reverse_edges (csrc/graph_reverse.cu): the reverse
edges of core/build.py::_apply_reverse_edges, one launch an insert or
refine block after one sort of the edges by target, where the JAX package
runs a fori_loop of rounds (vector_store_tpu/core/build.py:126-165) and no
Pallas kernel.

Each wrapper chooses by the device of the tensors it is given: CPU tensors
go to the plain PyTorch version beside it, CUDA tensors launch the kernel
(or raise).  LAUNCHES counts kernel launches only, by entry point; while a
torch.profiler runs, each launch is also a range kernel.b3_<entry point>
(kernel.robust_prune for the prune, kernel.reverse_edges for the reverse
edges).
"""

from __future__ import annotations

import torch

from ..utils import metrics
from .ivf_cuda import _DTYPES, _SPACES, _check_launch
from .topk import INF, SENTINEL, lexsort_stable, rank_in_run, topk_ascending_stable

LAUNCHES = {"gather_score": 0, "expand_score": 0, "robust_prune": 0, "reverse_edges": 0}

# the plain version gathers [q, BR, D] f32 rows; bound that transient
_PLAIN_BYTES = 1 << 29
# the prune kernel holds a node's candidates in shared memory (at most 13
# bytes each, csrc/graph_prune.cu), which bounds the candidates a node
PRUNE_MAX_CANDIDATES = 16384
# the reverse-edge kernel holds a target's row in a warp's registers, at
# most 8 slots a lane (csrc/graph_reverse.cu)
REVERSE_MAX_DEGREE = 256


def gather_score_plain(
    vectors: torch.Tensor,  # [C, D] f32 / bf16 / int8
    scales: torch.Tensor,  # [C] f32 per-row dequant scale
    queries_prep: torch.Tensor,  # [Q, D] f32 preprocessed
    cand_safe: torch.Tensor,  # [Q, BR] int32, pre-clipped to [0, C)
    space: str,
) -> torch.Tensor:
    """Distances [Q, BR] f32: a gather, then an f32 einsum."""
    Q, BR = cand_safe.shape
    D = vectors.shape[1]
    step = max(1, _PLAIN_BYTES // max(BR * D * 4, 1))
    out = []
    for off in range(0, Q, step):
        ids = cand_safe[off : off + step].long()
        q = queries_prep[off : off + step].float()
        x = vectors[ids].float()  # [q, BR, D]
        dots = torch.einsum("qbd,qd->qb", x, q)
        sq = torch.sum(x * x, dim=-1) if space == "l2" else None
        del x
        if vectors.dtype == torch.int8:
            s = scales[ids]
            dots = dots * s
            if sq is not None:
                sq = sq * s * s
        if space == "l2":
            d = torch.sum(q * q, dim=-1, keepdim=True) + sq - 2.0 * dots
        elif space == "dot":
            d = -dots
        else:
            d = 1.0 - dots
        out.append(d)
    return torch.cat(out) if out else queries_prep.new_empty((0, BR), dtype=torch.float32)


def expand_score_plain(
    vectors: torch.Tensor,  # [C, D] f32 / bf16 / int8
    scales: torch.Tensor,  # [C] f32
    neighbors: torch.Tensor,  # [C, R] int32, SENTINEL-padded
    queries_f32: torch.Tensor,  # [Q, D] f32 preprocessed
    sel_ids: torch.Tensor,  # [Q, B] int32 nodes to expand
    sel_live: torch.Tensor,  # [Q, B] bool
    space: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The expand round's steps 2-3 in plain torch: (cand_ids [Q, B*R]
    int32, cand_dist [Q, B*R] f32); SENTINEL and INF for dead beams and ids
    >= C."""
    C = vectors.shape[0]
    Q, B = sel_ids.shape
    R = neighbors.shape[1]
    nbrs = neighbors[sel_ids.clamp(0, C - 1).long()]  # [Q, B, R]
    cand_ids = nbrs.masked_fill(~sel_live[..., None], SENTINEL).reshape(Q, B * R)
    is_sent = cand_ids >= C
    cand_dist = gather_score_plain(vectors, scales, queries_f32, cand_ids.clamp(0, C - 1), space)
    return cand_ids.masked_fill(is_sent, SENTINEL), cand_dist.masked_fill(is_sent, INF)


def _check(dev, *specs) -> None:
    for name, t, dtype, shape in specs:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: want {dtype} {shape} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bank(vectors: torch.Tensor) -> tuple[int, int]:
    """(dtype code, vec) of a bank the kernel takes; raises otherwise."""
    if vectors.device.type != "cuda":
        raise ValueError(f"no kernel for device {vectors.device}")
    if vectors.dtype not in _DTYPES:
        raise ValueError(f"unsupported bank dtype {vectors.dtype}")
    if not vectors.is_contiguous():
        raise ValueError("vectors must be contiguous")
    if vectors.shape[0] == 0:
        raise ValueError("empty bank")
    row_bytes = vectors.shape[1] * vectors.element_size()
    return _DTYPES[vectors.dtype], int(row_bytes % 16 == 0 and vectors.data_ptr() % 16 == 0)


def expand_score_fused(
    vectors: torch.Tensor,  # [C, D] f32 / bf16 / int8
    scales: torch.Tensor,  # [C] f32
    neighbors: torch.Tensor,  # [C, R] int32, SENTINEL-padded
    queries_f32: torch.Tensor,  # [Q, D] f32 preprocessed
    sel_ids: torch.Tensor,  # [Q, B] int32
    sel_live: torch.Tensor,  # [Q, B] bool
    space: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """B3 through the adjacency: (cand_ids [Q, B*R] int32, cand_dist
    [Q, B*R] f32).  Candidate b*R + r of query q is neighbors[clamp(
    sel_ids[q, b]), r] where sel_live[q, b]; dead beams and ids >= C come
    out as (SENTINEL, INF).  One launch, no host synchronisation."""
    if vectors.device.type == "cpu":
        return expand_score_plain(
            vectors, scales, neighbors, queries_f32, sel_ids, sel_live, space
        )
    code, vec = _bank(vectors)
    C, D = vectors.shape
    Q, B = sel_ids.shape
    R = neighbors.shape[1]
    _check(
        vectors.device,
        ("scales", scales, torch.float32, (C,)),
        ("neighbors", neighbors, torch.int32, (C, R)),
        ("queries_f32", queries_f32, torch.float32, (Q, D)),
        ("sel_ids", sel_ids, torch.int32, (Q, B)),
        ("sel_live", sel_live, torch.bool, (Q, B)),
    )
    cand_ids = torch.empty((Q, B * R), dtype=torch.int32, device=vectors.device)
    cand_dist = torch.empty((Q, B * R), dtype=torch.float32, device=vectors.device)
    if Q == 0 or B * R == 0:
        return cand_ids, cand_dist
    from ..kernels.build import load_library

    with (
        torch.cuda.device(vectors.device),  # the launch runs on the current device
        metrics.span("kernel.b3_expand_score", series=False),
    ):
        err = load_library().graph_expand_score(
            code,
            vectors.data_ptr(),
            scales.data_ptr(),
            queries_f32.data_ptr(),
            neighbors.data_ptr(),
            sel_ids.data_ptr(),
            sel_live.data_ptr(),
            Q,
            B,
            R,
            C,
            D,
            _SPACES[space],
            int(vectors.dtype == torch.int8),
            vec,
            cand_ids.data_ptr(),
            cand_dist.data_ptr(),
            torch.cuda.current_stream(vectors.device).cuda_stream,
        )
    _check_launch("graph_expand_score", err)
    LAUNCHES["expand_score"] += 1
    return cand_ids, cand_dist


def gather_score_fused(
    vectors: torch.Tensor,  # [C, D] f32 / bf16 / int8
    scales: torch.Tensor,  # [C] f32
    queries_prep: torch.Tensor,  # [Q, D] f32 preprocessed
    cand_safe: torch.Tensor,  # [Q, BR] int32, pre-clipped to [0, C)
    space: str,
) -> torch.Tensor:
    """B3 with the candidate ids given: distances [Q, BR] f32 of each query
    to its candidate rows (the counterpart of graph_pallas.gather_score_fused;
    the caller clips sentinel ids into range before the call and masks
    their distances after)."""
    if vectors.device.type == "cpu":
        return gather_score_plain(vectors, scales, queries_prep, cand_safe, space)
    code, vec = _bank(vectors)
    C, D = vectors.shape
    Q, BR = cand_safe.shape
    _check(
        vectors.device,
        ("scales", scales, torch.float32, (C,)),
        ("queries_prep", queries_prep, torch.float32, (Q, D)),
        ("cand_safe", cand_safe, torch.int32, (Q, BR)),
    )
    out = torch.empty((Q, BR), dtype=torch.float32, device=vectors.device)
    if Q == 0 or BR == 0:
        return out
    from ..kernels.build import load_library

    with (
        torch.cuda.device(vectors.device),  # the launch runs on the current device
        metrics.span("kernel.b3_gather_score", series=False),
    ):
        err = load_library().graph_gather_score(
            code,
            vectors.data_ptr(),
            scales.data_ptr(),
            queries_prep.data_ptr(),
            cand_safe.data_ptr(),
            Q,
            BR,
            C,
            D,
            _SPACES[space],
            int(vectors.dtype == torch.int8),
            vec,
            out.data_ptr(),
            torch.cuda.current_stream(vectors.device).cuda_stream,
        )
    _check_launch("graph_gather_score", err)
    LAUNCHES["gather_score"] += 1
    return out


def robust_prune_plain(
    pd: torch.Tensor,  # [M, C, C] f32 candidate-pairwise distances
    cand_dist: torch.Tensor,  # [M, C] f32 query -> candidate distances
    cand_ids: torch.Tensor,  # [M, C] int32
    shift: torch.Tensor | None,  # f32 scalar subtracted from both sides, or None
    alpha: float,
    R: int,
    n_keep: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """alpha-RobustPrune in plain torch: a loop over the candidates in order.
    Keep t unless some kept s has alpha * d(s, t) <= d(q, t) (the first
    n_keep candidates are kept regardless); stop at R.  Returns (dist, ids)
    [M, min(R, C)], the kept candidates by ascending distance, padded with
    (+inf, SENTINEL)."""
    M, C = cand_dist.shape
    pd_cmp, cd_cmp = (pd, cand_dist) if shift is None else (pd - shift, cand_dist - shift)
    # dominated[m, t, c]: keeping candidate t removes candidate c
    dominated = alpha * pd_cmp <= cd_cmp[:, None, :]
    finite = cand_dist < INF
    removed = torch.zeros((M, C), dtype=torch.bool, device=cand_dist.device)
    kept = torch.zeros((M, C), dtype=torch.bool, device=cand_dist.device)
    kept_cnt = torch.zeros((M,), dtype=torch.int32, device=cand_dist.device)
    for t in range(C):
        can_keep = finite[:, t] & (kept_cnt < R)
        if t >= n_keep:
            can_keep &= ~removed[:, t]
        kept[:, t] = can_keep
        kept_cnt += can_keep
        removed |= can_keep[:, None] & dominated[:, t, :]

    sel_dist = cand_dist.masked_fill(~kept, INF)
    sel_ids = cand_ids.masked_fill(~kept, SENTINEL)
    top_d, pos = topk_ascending_stable(sel_dist, R)
    top_i = torch.gather(sel_ids, 1, pos).masked_fill(torch.isinf(top_d), SENTINEL)
    return top_d, top_i


def robust_prune(
    pd: torch.Tensor,  # [M, C, C] f32
    cand_dist: torch.Tensor,  # [M, C] f32
    cand_ids: torch.Tensor,  # [M, C] int32
    shift: torch.Tensor | None,  # f32 scalar on the same device, or None
    alpha: float,
    R: int,
    n_keep: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """robust_prune_plain's result in one launch: (dist [M, min(R, C)] f32,
    ids [M, min(R, C)] int32), equal bit for bit.  The shift stays on the
    device: no host synchronisation."""
    if pd.device.type == "cpu":
        return robust_prune_plain(pd, cand_dist, cand_ids, shift, alpha, R, n_keep)
    dev = pd.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    M, C = cand_dist.shape
    if R < 0 or C > PRUNE_MAX_CANDIDATES:
        raise ValueError(f"the prune takes R >= 0 and at most {PRUNE_MAX_CANDIDATES} "
                         f"candidates, got R {R}, C {C}")
    W = min(R, C)
    _check(
        dev,
        ("pd", pd, torch.float32, (M, C, C)),
        ("cand_dist", cand_dist, torch.float32, (M, C)),
        ("cand_ids", cand_ids, torch.int32, (M, C)),
    )
    if shift is not None:
        _check(dev, ("shift", shift, torch.float32, ()))
    out_d = torch.empty((M, W), dtype=torch.float32, device=dev)
    out_i = torch.empty((M, W), dtype=torch.int32, device=dev)
    if M == 0 or W == 0:
        return out_d, out_i
    from ..kernels.build import load_library

    with (
        torch.cuda.device(dev),  # the launch runs on the current device
        metrics.span("kernel.robust_prune", series=False),
    ):
        err = load_library().graph_robust_prune(
            pd.data_ptr(),
            cand_dist.data_ptr(),
            cand_ids.data_ptr(),
            None if shift is None else shift.data_ptr(),
            alpha,
            M,
            C,
            W,
            min(n_keep, C),
            out_d.data_ptr(),
            out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_launch("graph_robust_prune", err)
    LAUNCHES["robust_prune"] += 1
    return out_d, out_i


def reverse_edges_plain(
    neighbors: torch.Tensor,  # [C, R] int32, updated in place
    nbr_dist: torch.Tensor,  # [C, R] f32, updated in place
    tgt: torch.Tensor,  # [E] int32 edge targets
    src: torch.Tensor,  # [E] int32 edge sources
    d: torch.Tensor,  # [E] f32 edge lengths
    e_live: torch.Tensor,  # [E] bool
    rounds: int,
) -> None:
    """Degree-clamped reverse-edge insertion in plain torch: an edge
    replaces its target's longest edge when it is shorter.  Race-free by
    round: edges sorted by (target, length) and ranked within each target,
    round r applying the rank-r edges; ranks >= rounds are dropped."""
    sort_tgt = tgt.masked_fill(~e_live, SENTINEL)
    perm = lexsort_stable([sort_tgt, d])  # by target, shorter edges first
    tgt_s, d_s, src_s, live_s = sort_tgt[perm], d[perm], src[perm], e_live[perm]
    rank = rank_in_run(tgt_s)
    act = live_s & (tgt_s != SENTINEL) & (rank < rounds)
    # the lanes of each round, in one readback: lanes ordered by rank
    lanes = torch.nonzero(act).squeeze(1)
    lanes = lanes[torch.sort(rank[lanes], stable=True).indices]
    counts = torch.bincount(rank[lanes].long(), minlength=rounds).tolist()
    start = 0
    for n in counts:
        if n == 0:
            break  # ranks are dense: no lane of a later round either
        sel = lanes[start : start + n]
        start += n
        t = tgt_s[sel].long()  # distinct within a round
        rows_n, rows_d = neighbors[t], nbr_dist[t]
        worst = torch.argmax(rows_d, dim=1, keepdim=True)
        better = (d_s[sel] < torch.gather(rows_d, 1, worst)[:, 0])[:, None]
        upd = better & (torch.arange(rows_d.shape[1], device=t.device)[None, :] == worst)
        neighbors.index_copy_(0, t, torch.where(upd, src_s[sel][:, None], rows_n))
        nbr_dist.index_copy_(0, t, torch.where(upd, d_s[sel][:, None], rows_d))


def reverse_edges(
    neighbors: torch.Tensor,  # [C, R] int32, updated in place
    nbr_dist: torch.Tensor,  # [C, R] f32, updated in place
    tgt: torch.Tensor,  # [E] int32
    src: torch.Tensor,  # [E] int32
    d: torch.Tensor,  # [E] f32
    e_live: torch.Tensor,  # [E] bool
    rounds: int,
) -> None:
    """reverse_edges_plain's result in one launch after one stable sort of
    the edges by target: neighbors and nbr_dist equal bit for bit.  The
    kernel walks each target's first `rounds` edges by (length, index) with
    one warp; no host read, no allocation beyond the sort's."""
    if neighbors.device.type == "cpu":
        return reverse_edges_plain(neighbors, nbr_dist, tgt, src, d, e_live, rounds)
    dev = neighbors.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    C, R = neighbors.shape
    (E,) = tgt.shape
    if not 0 < R <= REVERSE_MAX_DEGREE or rounds < 0:
        raise ValueError(f"the reverse edges take 1 <= R <= {REVERSE_MAX_DEGREE} and "
                         f"rounds >= 0, got R {R}, rounds {rounds}")
    _check(
        dev,
        ("neighbors", neighbors, torch.int32, (C, R)),
        ("nbr_dist", nbr_dist, torch.float32, (C, R)),
        ("tgt", tgt, torch.int32, (E,)),
        ("src", src, torch.int32, (E,)),
        ("d", d, torch.float32, (E,)),
        ("e_live", e_live, torch.bool, (E,)),
    )
    if E == 0 or C == 0 or rounds == 0:
        return
    tgt_s, perm = torch.sort(torch.where(e_live, tgt, SENTINEL), stable=True)
    from ..kernels.build import load_library

    with (
        torch.cuda.device(dev),  # the launch runs on the current device
        metrics.span("kernel.reverse_edges", series=False),
    ):
        err = load_library().graph_reverse_edges(
            neighbors.data_ptr(),
            nbr_dist.data_ptr(),
            tgt_s.data_ptr(),
            perm.data_ptr(),
            src.data_ptr(),
            d.data_ptr(),
            E,
            C,
            R,
            rounds,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_launch("graph_reverse_edges", err)
    LAUNCHES["reverse_edges"] += 1

"""Graph beam-search gather+score: the CUDA kernel B3 and its plain versions.

Counterpart of vector_store_tpu/core/graph_pallas.py and of the expand
round's adjacency read around it (vector_store_tpu/core/search.py:66-98).
One kernel template in csrc/graph_gather.cu, two entry points:

  expand_score_fused  -> graph_expand_score: the expand round's candidates
                         read through the adjacency (neighbors[sel_ids],
                         dead beams and ids >= C as SENTINEL) and scored,
                         one launch a round (core/search.py::_expand_round);
  gather_score_fused  -> graph_gather_score: the candidate ids given, the
                         counterpart of graph_pallas.gather_score_fused.

Each wrapper chooses by the device of the tensors it is given: CPU tensors
go to the plain PyTorch version beside it, CUDA tensors launch the kernel
(or raise).  LAUNCHES counts kernel launches only, by entry point.
"""

from __future__ import annotations

import torch

from .ivf_cuda import _DTYPES, _SPACES, _check_launch
from .topk import INF, SENTINEL

LAUNCHES = {"gather_score": 0, "expand_score": 0}

# the plain version gathers [q, BR, D] f32 rows; bound that transient
_PLAIN_BYTES = 1 << 29


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

    with torch.cuda.device(vectors.device):  # the launch runs on the current device
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

    with torch.cuda.device(vectors.device):  # the launch runs on the current device
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

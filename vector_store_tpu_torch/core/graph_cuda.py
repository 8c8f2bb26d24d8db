"""Graph beam-search gather+score: the CUDA kernel B3 and its plain version.

Counterpart of vector_store_tpu/core/graph_pallas.py.  The kernel lives in
csrc/graph_gather.cu (graph_gather_score): for each query and each of its
candidate slots, read the bank row, dequantize it in f32 and score it.

The wrapper chooses by the device of the tensors it is given: CPU tensors
go to the plain PyTorch version beside it, CUDA tensors launch the kernel
(or raise).  LAUNCHES counts kernel launches only.
"""

from __future__ import annotations

import torch

from .ivf_cuda import _DTYPES, _SPACES, _check_launch

LAUNCHES = {"gather_score": 0}

# candidates scored by one block (csrc/graph_gather.cu kRowsPerBlock)
ROWS_PER_BLOCK = 64

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


def gather_score_fused(
    vectors: torch.Tensor,  # [C, D] f32 / bf16 / int8
    scales: torch.Tensor,  # [C] f32
    queries_prep: torch.Tensor,  # [Q, D] f32 preprocessed
    cand_safe: torch.Tensor,  # [Q, BR] int32, pre-clipped to [0, C)
    space: str,
) -> torch.Tensor:
    """B3: distances [Q, BR] f32 of each query to its candidate rows.

    The caller clips sentinel ids into range before the call and masks
    their distances after (core/search.py::_expand_round)."""
    if vectors.device.type == "cpu":
        return gather_score_plain(vectors, scales, queries_prep, cand_safe, space)
    if vectors.device.type != "cuda":
        raise ValueError(f"no kernel for device {vectors.device}")
    if vectors.dtype not in _DTYPES:
        raise ValueError(f"unsupported bank dtype {vectors.dtype}")
    C, D = vectors.shape
    Q, BR = cand_safe.shape
    dev = vectors.device
    for name, t, dtype, shape in (
        ("scales", scales, torch.float32, (C,)),
        ("queries_prep", queries_prep, torch.float32, (Q, D)),
        ("cand_safe", cand_safe, torch.int32, (Q, BR)),
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
    if C == 0:
        raise ValueError("empty bank")
    if -(-BR // ROWS_PER_BLOCK) > 65535:
        raise ValueError(f"{BR} candidates per query exceed the grid")
    out = torch.empty((Q, BR), dtype=torch.float32, device=dev)
    if Q == 0 or BR == 0:
        return out
    row_bytes = D * vectors.element_size()
    vec = int(row_bytes % 16 == 0 and vectors.data_ptr() % 16 == 0)
    from ..kernels.build import load_library

    err = load_library().graph_gather_score(
        _DTYPES[vectors.dtype],
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
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _check_launch("graph_gather_score", err)
    LAUNCHES["gather_score"] += 1
    return out

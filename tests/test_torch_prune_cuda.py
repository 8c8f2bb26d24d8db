"""The insert's robust-prune kernel (csrc/graph_prune.cu) against its plain
version on the card, bit for bit: distances and ids, on chip_smoke's
PRUNE_CASES (the insert and refine shapes, dot with negative distances, l2,
C = 1,024, C not a multiple of 32, all-INF nodes, an unsorted pool, R > C),
and a graph built through SlotIndex.add with each: the same edges.

Needs a CUDA card, and skips without one.  This file imports no JAX, so it
runs on the card without the CPU harness's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_prune_cuda.py
"""

import pytest
import torch

import chip_smoke
from vector_store_tpu_torch import IndexParams
from vector_store_tpu_torch.core import graph_cuda
from vector_store_tpu_torch.core.index import SlotIndex


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(chip_smoke.PRUNE_CASES))
def test_prune_kernel_equals_plain_bit_for_bit(cuda, name):
    assert chip_smoke.prune_check(torch, "cuda", [name]) == 1


@pytest.mark.cuda
def test_prune_kernel_refuses_what_it_cannot_hold(cuda):
    C = graph_cuda.PRUNE_MAX_CANDIDATES + 1
    dist = torch.zeros((1, C), device="cuda")
    ids = torch.zeros((1, C), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        graph_cuda.robust_prune(torch.zeros((1,), device="cuda"), dist, ids, None, 1.2, 32, 16)
    with pytest.raises(ValueError):  # the candidate ids as int64
        graph_cuda.robust_prune(torch.zeros((1, 4, 4), device="cuda"), dist[:, :4].contiguous(),
                                ids[:, :4].long(), None, 1.2, 2, 1)


@pytest.mark.cuda
def test_graph_built_with_the_kernel_equals_the_plain_prune(cuda, monkeypatch):
    """16,384 rows through SlotIndex.add in 256-row blocks, once with the
    prune kernel (one launch a block) and once with its plain version:
    the same adjacency and edge lengths, bit for bit."""
    x = chip_smoke.make_corpus(16_384, 128)
    kernel = graph_cuda.robust_prune
    states = []
    for prune in (kernel, graph_cuda.robust_prune_plain):
        monkeypatch.setattr(graph_cuda, "robust_prune", prune)
        idx = SlotIndex(IndexParams(dimensions=128, space="cosine", capacity=1 << 15),
                        initial_capacity=1 << 15, device="cuda")
        before = graph_cuda.LAUNCHES["robust_prune"]
        idx.add(x)
        launched = graph_cuda.LAUNCHES["robust_prune"] - before
        assert launched == (len(x) // idx.insert_block if prune is kernel else 0)
        states.append(idx.state)
    a, b = states
    assert torch.equal(a.neighbors, b.neighbors)
    assert torch.equal(a.nbr_dist.view(torch.int32), b.nbr_dist.view(torch.int32))

"""The insert's reverse-edge kernel (csrc/graph_reverse.cu) against its
plain rounds on the card, bit for bit: neighbors and nbr_dist, on
chip_smoke's REVERSE_CASES (the insert shape, hub targets far past
REVERSE_ROUNDS, degrees 16-256, empty rows, ties, SENTINEL targets, NaN
slots), and a graph built through SlotIndex.add with each: the same edges.

Needs a CUDA card, and skips without one.  This file imports no JAX, so it
runs on the card without the CPU harness's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_reverse_cuda.py
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
@pytest.mark.parametrize("name", list(chip_smoke.REVERSE_CASES))
def test_reverse_kernel_equals_plain_bit_for_bit(cuda, name):
    assert chip_smoke.reverse_check(torch, "cuda", [name]) == 1


@pytest.mark.cuda
def test_reverse_kernel_refuses_what_it_cannot_hold(cuda):
    E = 8
    tgt = torch.zeros((E,), dtype=torch.int32, device="cuda")
    d = torch.zeros((E,), device="cuda")
    live = torch.ones((E,), dtype=torch.bool, device="cuda")
    R = graph_cuda.REVERSE_MAX_DEGREE + 1
    with pytest.raises(ValueError):
        graph_cuda.reverse_edges(torch.zeros((4, R), dtype=torch.int32, device="cuda"),
                                 torch.zeros((4, R), device="cuda"), tgt, tgt, d, live, 16)
    with pytest.raises(ValueError):  # the edge lengths as f64
        graph_cuda.reverse_edges(torch.zeros((4, 8), dtype=torch.int32, device="cuda"),
                                 torch.zeros((4, 8), device="cuda"), tgt, tgt, d.double(), live, 16)


@pytest.mark.cuda
def test_graph_built_with_the_kernel_equals_the_plain_rounds(cuda, monkeypatch):
    """16,384 rows through SlotIndex.add in 256-row blocks, once with the
    reverse-edge kernel (one launch a block) and once with its plain
    rounds: the same adjacency and edge lengths, bit for bit."""
    x = chip_smoke.make_corpus(16_384, 128)
    kernel = graph_cuda.reverse_edges
    states = []
    for fn in (kernel, graph_cuda.reverse_edges_plain):
        monkeypatch.setattr(graph_cuda, "reverse_edges", fn)
        idx = SlotIndex(IndexParams(dimensions=128, space="cosine", capacity=1 << 15),
                        initial_capacity=1 << 15, device="cuda")
        before = graph_cuda.LAUNCHES["reverse_edges"]
        idx.add(x)
        launched = graph_cuda.LAUNCHES["reverse_edges"] - before
        assert launched == (len(x) // idx.insert_block if fn is kernel else 0)
        states.append(idx.state)
    a, b = states
    assert torch.equal(a.neighbors, b.neighbors)
    assert torch.equal(a.nbr_dist.view(torch.int32), b.nbr_dist.view(torch.int32))

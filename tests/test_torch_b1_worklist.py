"""B1's host side and algorithm on the CPU: the work list, the split top-k
and the query digits, held against the port's plain B1
(`search_fused_plain`, itself held against the Pallas kernel in
test_torch_ivf_kernels.py).

The CUDA kernels cannot run here; these tests pin what they compute:
  * the work list groups the (query, rank) pairs by bucket into tiles of
    at most TILE pairs of one bucket, every pair in exactly one tile, no
    more tiles than pairs (the scan's grid bound), nothing read back;
  * the split top-k (a top-k per (query, rank), then the merge of the p
    partial lists in (distance, pool position) order) equals the top-k of
    the whole pool bit for bit, ids and distances, ties included;
  * the f32 query's four int8 digits rebuild it to within 2^-22 of its
    largest element, and score int8 rows within 1e-6 of the f32 dots.
"""

import numpy as np
import pytest
import torch

from vector_store_tpu_torch.core import ivf_cuda
from vector_store_tpu_torch.core.quantize import quantize_rows
from vector_store_tpu_torch.core.topk import SENTINEL

K, B, D, Q = 24, 256, 64, 8


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bank(seed=3, dup=False):
    """An int8 bank of K buckets: a tenth of the rows tombstoned, bucket 1
    empty (nsb 0), bucket 2 with a 5-row live prefix, bucket 3 with 130.
    With `dup`, buckets 4..7 are copies of bucket 0: equal distances at
    different pool positions."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.nn.functional.normalize(torch.randn(K * B, D, generator=g), dim=1)
    codes, scales = quantize_rows(rows)
    vec, scl = codes.reshape(K, B, D), scales.reshape(K, B)
    rowid = torch.arange(K * B, dtype=torch.int32).reshape(K, B)
    dead = torch.rand(K, B, generator=g) < 0.1
    dead[1] = True
    dead[2] = torch.arange(B) >= 5
    dead[3, 130:] = True
    if dup:
        for c in range(4, 8):
            vec[c], scl[c], dead[c] = vec[0], scl[0], dead[0]
    rid = torch.where(dead, SENTINEL, rowid)
    nsb = ivf_cuda.live_prefix_blocks(rid != SENTINEL)
    q = torch.nn.functional.normalize(torch.randn(Q, D, generator=g), dim=1)
    return vec, scl, rid, nsb, q


def _cids(p, seed=5, dup=False):
    rng = np.random.default_rng(seed)
    cids = np.stack([rng.permutation(K)[:p] for _ in range(Q)]).astype(np.int32)
    if p >= 2:
        cids[:4, :2] = [[0, 1], [1, 2], [2, 3], [3, 0]]  # the edge-case buckets
    if dup and p >= 4:
        cids[:, :4] = [0, 4, 5, 6]  # the duplicated buckets, each probed by every query
    return torch.from_numpy(cids)


@pytest.mark.parametrize("p", [1, 2, 16])
@pytest.mark.parametrize("tile", [1, 3, ivf_cuda.TILE])
def test_worklist_tiles_every_pair_once(p, tile):
    cids = _cids(p)
    cids[:, 0] = 7  # one bucket probed by every query: several tiles of it
    order, start, n, n_tiles = ivf_cuda.worklist(cids, tile)
    N = Q * p
    nt = int(n_tiles[0])
    assert order.dtype == start.dtype == n.dtype == torch.int32
    assert order.shape == start.shape == n.shape == (N,)
    assert 0 < nt <= N  # the scan's grid bound
    flat = cids.reshape(-1)
    seen = []
    for t in range(nt):
        s, m = int(start[t]), int(n[t])
        assert 1 <= m <= tile
        pairs = order[s : s + m]
        assert len(set(flat[pairs.long()].tolist())) == 1  # one bucket per tile
        seen += pairs.tolist()
    assert sorted(seen) == list(range(N))  # every pair in exactly one tile
    assert (n[nt:] == 0).all()
    # as many tiles as the buckets' pair counts need, no more
    counts = torch.bincount(flat.long())
    assert nt == int(((counts + tile - 1) // tile).sum())


def test_worklist_takes_empty_buckets():
    """Pairs whose bucket has no live row (nsb 0) still get a tile: the scan
    writes their partials as INF."""
    vec, scl, rid, nsb, q = _bank()
    cids = torch.full((Q, 2), 1, dtype=torch.int32)
    cids[:, 1] = 2
    assert nsb[1] == 0 and nsb[2] == 1
    order, start, n, n_tiles = ivf_cuda.worklist(cids)
    assert int(n_tiles[0]) == 2 and n[:2].tolist() == [Q, Q]
    d, r = ivf_cuda.search_fused(vec, scl, rid, q, cids, "cosine", 10, nsb)
    assert torch.isinf(d[:, 5:]).all() and (r[:, 5:] == SENTINEL).all()
    assert torch.isfinite(d[:, :5]).all()


def _split(vec, scl, rid, nsb, q, cids, space, k, score="f32"):
    q_in, qscale = ivf_cuda.score_query(q, vec, space, score)
    pool = ivf_cuda._pool_plain(vec, scl, rid, q_in, cids, space, False, nsb, score, qscale)
    rids = rid[cids.long()].reshape(pool.shape)
    return ivf_cuda.split_topk_plain(pool, rids, cids.shape[1], k)


@pytest.mark.parametrize("space", ["cosine", "dot", "l2"])
@pytest.mark.parametrize("p", [1, 2, 16])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_split_topk_equals_plain_b1(k, p, space):
    vec, scl, rid, nsb, q = _bank()
    cids = _cids(p)
    want_d, want_r = ivf_cuda.search_fused_plain(vec, scl, rid, q, cids, space, k, nsb)
    got_d, got_r = _split(vec, scl, rid, nsb, q, cids, space, k)
    assert torch.equal(got_d, want_d) and torch.equal(got_r, want_r)


@pytest.mark.parametrize("score", ["f32", "qi8", "stub"])
def test_split_topk_breaks_exact_ties_as_plain_b1(score):
    """Four probed buckets hold the same rows: every distance comes four
    times at different pool positions, and both orders take the lowest."""
    vec, scl, rid, nsb, q = _bank(dup=True)
    cids = _cids(4, dup=True)
    want_d, want_r = ivf_cuda.search_fused_plain(vec, scl, rid, q, cids, "dot", 32, nsb, score)
    got_d, got_r = _split(vec, scl, rid, nsb, q, cids, "dot", 32, score)
    assert torch.equal(got_d, want_d) and torch.equal(got_r, want_r)
    d = want_d[:, :8]
    assert (d[:, 0] == d[:, 1]).all()  # the ties are there


def test_split_topk_pads_past_the_pool():
    """k beyond the live rows of the probed buckets: INF and SENTINEL."""
    vec, scl, rid, nsb, q = _bank()
    cids = torch.tensor([[2]] * Q, dtype=torch.int32)  # 5 live rows
    want = ivf_cuda.search_fused_plain(vec, scl, rid, q, cids, "cosine", 32, nsb)
    got = _split(vec, scl, rid, nsb, q, cids, "cosine", 32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isinf(got[0][:, 5:]).all()


def test_query_digits_rebuild_the_query():
    g = torch.Generator().manual_seed(9)
    q = torch.randn(16, 768, generator=g)
    q[1] *= 1e-20  # tiny and huge scales take the same cut
    q[2] *= 1e20
    q[3, 5] = 0.0
    q[4] = 0.0
    digits, fac = ivf_cuda.query_digits(q)
    assert digits.dtype == torch.int8 and digits.abs().max() <= 64
    w = torch.tensor([2.0**21, 2.0**14, 2.0**7, 1.0], dtype=torch.float64)
    back = (digits.double() * w[None, :, None]).sum(1) * fac.double()[:, None]
    m = q.abs().amax(1).double()
    err = (back - q.double()).abs().amax(1)
    assert (err <= m * 2.0**-22).all()
    assert (back[4] == 0).all()


def test_query_digits_score_int8_rows_as_f32():
    """Exact integer dots of the digits, combined in int64 and rounded once
    (the kernel's arithmetic), against the plain f32 dots of int8 rows."""
    vec, scl, rid, nsb, q = _bank()
    x = vec.reshape(-1, D).long()
    digits, fac = ivf_cuda.query_digits(q)
    acc = torch.einsum("nd,qgd->qgn", x, digits.long())  # [Q, 4, rows], exact
    S = ((acc[:, 0] * 128 + acc[:, 1]) * 128 + acc[:, 2]) * 128 + acc[:, 3]
    dots = S.float() * fac[:, None]
    want = q @ x.float().T
    assert (dots - want).abs().max() <= 1e-6 * want.abs().max()

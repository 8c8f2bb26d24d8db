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

B2 runs on the same work list: a scan of its tiles stores each pair's
scores straight into the pool.  Here the pool assembled tile by tile, in
the work list's order and the kernel's store pattern (128-row sub-blocks
up to the live prefix, INF past it), equals `pool_scan_plain` bit for bit,
packed and unpacked; and the packed bank's nibbles, unpacked as the kernel
does (word-wide, `__vsub4`), give the int4 codes and score with the query
digits within 1e-6 of the f32 dots.  Past FUSED_MAX_DIMS B2 takes the row
in chunks (`pool_chunk`), each adding its share of every distance to the
pool: the shares over the dims each chunk stages add up to
`pool_scan_plain`'s distances within 1e-5.
"""

import numpy as np
import pytest
import torch

from vector_store_tpu_torch.core import ivf_cuda
from vector_store_tpu_torch.core.quantize import (
    int4_scale,
    pack_int4_from_int8,
    quantize_rows,
    unpack_int4,
)
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


def _tiled_pool(vec, scl, rid, nsb, q, cids, space, packed):
    """B2's pool as its scan writes it: tile by tile in the work list's
    order, each tile's bucket scored once for its pairs, stored in 128-row
    sub-blocks up to the live prefix and INF past it.  NaN marks a pool
    entry no tile wrote."""
    Q, p = cids.shape
    B = vec.shape[1]
    order, start, n, n_tiles = ivf_cuda.worklist(cids)
    flat = cids.reshape(-1)
    out = torch.full((Q * p, B), float("nan"))
    for t in range(int(n_tiles[0])):
        pairs = order[int(start[t]) : int(start[t]) + int(n[t])].long()
        c = int(flat[pairs[0]])
        # the tile's queries against bucket c, scored once
        probe = torch.full((len(pairs), 1), c, dtype=torch.int32)
        block = ivf_cuda.pool_scan_plain(vec, scl, rid, q[pairs // p], probe, space, packed, nsb)
        live = min(int(nsb[c]) * ivf_cuda.SUB_BLOCK, B)
        for base in range(0, live, ivf_cuda.SUB_BLOCK):
            end = min(base + ivf_cuda.SUB_BLOCK, live)
            out[pairs, base:end] = block[:, base:end]
        out[pairs, live:] = float("inf")
    return out.reshape(Q, p * B)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("space", ["cosine", "dot", "l2"])
@pytest.mark.parametrize("p", [1, 4, 16])
def test_b2_tiled_pool_equals_plain(p, space, packed):
    """The query is rounded to multiples of 1/64, so every dot of int8 or
    int4 codes with it is exact in f32, whatever order the CPU's product
    sums in: what is held to the bit is where each score lands."""
    vec, scl, rid, nsb, q = _bank()
    q = torch.round(q * 64) / 64
    if packed:
        vec = pack_int4_from_int8(vec)
    cids = _cids(p)
    cids[:, 0] = 7  # a bucket probed by every query: one tile holds all of them
    got = _tiled_pool(vec, scl, rid, nsb, q, cids, space, packed)
    want = ivf_cuda.pool_scan_plain(vec, scl, rid, q, cids, space, packed, nsb)
    assert not torch.isnan(got).any()  # every pool entry written once
    assert torch.equal(got, want)
    assert torch.isinf(want).any() and torch.isfinite(want).any()


def _vsub4(a, b):
    """__vsub4: bytewise a - b of uint32 words, each byte wrapping."""
    out = np.zeros_like(a)
    for k in range(4):
        sh = np.uint32(8 * k)
        d = (((a >> sh) & np.uint32(0xFF)) - ((b >> sh) & np.uint32(0xFF))) & np.uint32(0xFF)
        out |= d << sh
    return out


def _nibbles_as_kernel(packed):
    """The kernel's unpack of packed rows [..., D/2] uint8 into int8 codes
    [..., D]: per 32-bit word, nib_lo(w) = __vsub4((w & 0x0f0f0f0f) ^
    0x08080808, 0x08080808) and nib_hi(w) = nib_lo(w >> 4)."""
    x = np.ascontiguousarray(packed.numpy())
    words = x.view(np.uint32)

    def nib_lo(w):
        return _vsub4((w & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808), np.uint32(0x08080808))

    lo = nib_lo(words).view(np.int8)
    hi = nib_lo(words >> np.uint32(4)).view(np.int8)
    return torch.from_numpy(np.concatenate([lo, hi], axis=-1))


def test_packed_nibbles_unpack_as_the_kernel_does():
    every = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(8, 32)
    assert torch.equal(_nibbles_as_kernel(every), unpack_int4(every))
    vec, *_ = _bank()
    packed = pack_int4_from_int8(vec)
    assert torch.equal(_nibbles_as_kernel(packed), unpack_int4(packed))


def test_query_digits_score_packed_rows_as_f32():
    """The packed rows' nibbles (the low half against dims j, the high half
    against dims j + D/2) times the query digits, exact integer sums
    combined in int64 and rounded once, against the f32 dots of the
    unpacked int4 codes."""
    vec, scl, rid, nsb, q = _bank()
    packed = pack_int4_from_int8(vec).reshape(-1, D // 2)
    codes = _nibbles_as_kernel(packed).long()
    digits, fac = ivf_cuda.query_digits(q)
    lo = torch.einsum("nd,qgd->qgn", codes[:, : D // 2], digits[:, :, : D // 2].long())
    hi = torch.einsum("nd,qgd->qgn", codes[:, D // 2 :], digits[:, :, D // 2 :].long())
    acc = lo + hi  # [Q, 4, rows], exact
    S = ((acc[:, 0] * 128 + acc[:, 1]) * 128 + acc[:, 2]) * 128 + acc[:, 3]
    dots = S.float() * fac[:, None]
    want = q @ unpack_int4(packed).float().T
    assert (dots - want).abs().max() <= 1e-6 * want.abs().max()


def _chunked_pool(vec, scl, rid, nsb, q, cids, space, packed):
    """B2's pool as its scan adds it up past FUSED_MAX_DIMS: for each chunk
    of pool_chunk(D, packed) row elements, each distance's share over the
    query dims the kernel stages for it (e0.. and, packed, dw + e0..), the
    shares added in chunk order, then the constant term (1 for cosine,
    |q|^2 for l2); INF where the row is dead or past the live prefix."""
    Qn, p = cids.shape
    Kn, Bn, dw = vec.shape
    ec = ivf_cuda.pool_chunk(q.shape[1], packed)
    x = (unpack_int4(vec) if packed else vec).float()
    s = (int4_scale(scl) if packed else scl)[cids.long()]
    total = 0.0
    for e0 in range(0, dw, ec):
        dims = torch.arange(e0, min(e0 + ec, dw))
        if packed:
            dims = torch.cat([dims, dims + dw])
        xc = x[..., dims][cids.long()]  # [Q, p, B, chunk]
        dot = torch.einsum("qpbd,qd->qpb", xc, q[:, dims]) * s
        share = (xc * xc).sum(-1) * s * s - 2.0 * dot if space == "l2" else -dot
        total = total + share
    konst = (q * q).sum(-1)[:, None, None] if space == "l2" else float(space == "cosine")
    d = total + konst
    live = torch.arange(Bn) < (nsb[cids.long()] * ivf_cuda.SUB_BLOCK)[..., None]
    dead = (rid[cids.long()] == SENTINEL) | ~live
    return d.masked_fill(dead, float("inf")).reshape(Qn, p * Bn)


@pytest.mark.parametrize("space", ["cosine", "dot", "l2"])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("dims", [4096, 5000])
def test_b2_chunks_add_up_to_plain(dims, packed, space):
    """Past FUSED_MAX_DIMS B2 scans the row in chunks whose staged queries
    fit shared memory, 16-byte aligned; the chunks' shares of each distance
    add up to pool_scan_plain's within 1e-5, INF exactly where it has INF."""
    Kn, Bn, Qn, p = 4, 160, 4, 2
    g = torch.Generator().manual_seed(7)
    rows = torch.nn.functional.normalize(torch.randn(Kn * Bn, dims, generator=g), dim=1)
    codes, scales = quantize_rows(rows)
    vec, scl = codes.reshape(Kn, Bn, dims), scales.reshape(Kn, Bn)
    dead = torch.rand(Kn, Bn, generator=g) < 0.1
    dead[1, 20:] = True  # a short live prefix
    rid = torch.where(dead, SENTINEL, torch.arange(Kn * Bn, dtype=torch.int32).reshape(Kn, Bn))
    nsb = ivf_cuda.live_prefix_blocks(rid != SENTINEL)
    q = torch.nn.functional.normalize(torch.randn(Qn, dims, generator=g), dim=1)
    cids = torch.tensor([[0, 1], [1, 2], [2, 3], [3, 0]], dtype=torch.int32)
    if packed:
        vec = pack_int4_from_int8(vec)
    dw = vec.shape[2]
    ec = ivf_cuda.pool_chunk(dims, packed)
    assert ec < dw and ec % 256 == 0  # several chunks, each starting 16-byte aligned
    assert (2 * ec if packed else ec) <= ivf_cuda.POOL_CHUNK_DIMS
    got = _chunked_pool(vec, scl, rid, nsb, q, cids, space, packed)
    want = ivf_cuda.pool_scan_plain(vec, scl, rid, q, cids, space, packed, nsb)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    assert fin.any() and (got[fin] - want[fin]).abs().max() <= 1e-5


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
def test_b2_one_chunk_up_to_fused_max_dims(packed):
    for dims in (64, 768, ivf_cuda.FUSED_MAX_DIMS):
        assert ivf_cuda.pool_chunk(dims, packed) == (dims // 2 if packed else dims)

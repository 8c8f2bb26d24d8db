"""The plain version of the CUDA gather-score kernel B3, and the pool-merge
primitives around it, against the JAX package on the CPU.

B3's plain version is held against the Pallas kernel `gather_score_fused`
in interpret mode: f32, bf16 and int8 banks, cosine/dot/l2, candidate ids
with repeats.  Distances agree to atol 1e-5 on unit-norm rows (float32
sums in another order); l2 adds |q|^2 + |x|^2 terms near 1 each, and is
held to the same bound.  On CPU tensors the wrapper takes the plain
version, so it is checked here too; the CUDA kernel itself is held against
the plain version on the card by chip_smoke.py.  The merges, the dedup and
the run ranks must equal the JAX package's outputs exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_store_tpu.core import cluster as jcluster
from vector_store_tpu.core import quantize as jquant
from vector_store_tpu.core import topk as jtopk
from vector_store_tpu.core.graph_pallas import gather_score_fused as j_gather_score
from vector_store_tpu_torch.core import cluster as tcluster
from vector_store_tpu_torch.core import graph_cuda
from vector_store_tpu_torch.core import topk as ttopk
from vector_store_tpu_torch.core.ivf import _from_numpy

C, D, Q, BR = 512, 128, 8, 64
ATOL = 1e-5
SENT = 2**31 - 1


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bank(dtype: str, rng):
    """(JAX bank, JAX scales, port bank, port scales) of unit-norm rows."""
    rows = rng.normal(size=(C, D)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    if dtype == "int8":
        codes, scl = jquant.quantize_rows(jnp.asarray(rows))
        vec, scl = np.asarray(codes), np.asarray(scl)
    else:
        vec = np.asarray(jnp.asarray(rows).astype(dtype))
        scl = np.ones((C,), np.float32)
    return jnp.asarray(vec), jnp.asarray(scl), _from_numpy(vec, "cpu"), torch.from_numpy(scl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("space", ["cosine", "dot", "l2"])
def test_gather_score_plain_matches_pallas(dtype, space):
    rng = np.random.default_rng(["float32", "bfloat16", "int8"].index(dtype))
    jv, js, tv, ts = _bank(dtype, rng)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cand = rng.integers(0, C, size=(Q, BR)).astype(np.int32)
    cand[:, 1] = cand[:, 0]  # repeated ids score alike
    want = np.asarray(
        j_gather_score(jv, js, jnp.asarray(q), jnp.asarray(cand), space, dtype == "int8", interpret=True)
    )
    plain = graph_cuda.gather_score_plain(tv, ts, torch.from_numpy(q), torch.from_numpy(cand), space)
    wrapped = graph_cuda.gather_score_fused(tv, ts, torch.from_numpy(q), torch.from_numpy(cand), space)
    assert plain.dtype == torch.float32 and plain.shape == (Q, BR)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=ATOL)
    assert torch.equal(wrapped, plain)
    assert torch.equal(plain[:, 0], plain[:, 1])


def _expand_case(rng, Qn=Q, B=4, R=16):
    """An adjacency [C, R] with SENTINEL padding (every 5th row holds only
    its first 3 neighbours, row 7 none), selected nodes [Qn, B] with dead
    beams (a dead beam's id may be SENTINEL or a stale node), and repeated
    neighbours (every row's last 4 entries repeat its first 4; beams 0 and 1
    of query 0 expand the same node)."""
    nbrs = rng.integers(0, C, size=(C, R)).astype(np.int32)
    nbrs[:, R - 4 :] = nbrs[:, :4]
    nbrs[::5, 3:] = SENT
    nbrs[7] = SENT
    sel = rng.integers(0, C, size=(Qn, B)).astype(np.int32)
    sel[0, 1] = sel[0, 0]
    sel[1, 0] = 7
    sel[2, 0] = 5
    live = rng.random((Qn, B)) < 0.8
    live[0, :2] = True
    live[1:3, 0] = True
    live[3] = False
    sel[3, :2] = SENT  # a query whose pool ran dry
    return nbrs, sel, live


def _jax_expand(jv, js, nbrs, q, sel, live, space, quantized):
    """The JAX expand round's steps 3-4 (vector_store_tpu/core/search.py)."""
    Qn, B = sel.shape
    cap = jv.shape[0]
    safe_sel = jnp.clip(jnp.asarray(sel), 0, cap - 1)
    nb = jnp.take(jnp.asarray(nbrs), safe_sel, axis=0)
    nb = jnp.where(jnp.asarray(live)[..., None], nb, SENT)
    cand = nb.reshape(Qn, -1)
    is_sent = cand >= cap
    dist = j_gather_score(jv, js, jnp.asarray(q), jnp.clip(cand, 0, cap - 1), space, quantized,
                          interpret=True)
    return np.asarray(jnp.where(is_sent, SENT, cand)), np.asarray(jnp.where(is_sent, jnp.inf, dist))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("space", ["cosine", "dot", "l2"])
def test_expand_score_plain_matches_jax_expand_round(dtype, space):
    rng = np.random.default_rng(10 + ["float32", "bfloat16", "int8"].index(dtype))
    jv, js, tv, ts = _bank(dtype, rng)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    nbrs, sel, live = _expand_case(rng)
    with jax.default_device(jax.devices("cpu")[0]):
        want_ids, want_d = _jax_expand(jv, js, nbrs, q, sel, live, space, dtype == "int8")
    args = (tv, ts, torch.from_numpy(nbrs), torch.from_numpy(q), torch.from_numpy(sel),
            torch.from_numpy(live), space)
    ids, dist = graph_cuda.expand_score_plain(*args)
    assert ids.dtype == torch.int32 and dist.dtype == torch.float32
    assert ids.shape == dist.shape == (Q, 4 * 16)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    assert np.array_equal(np.isinf(dist.numpy()), np.isinf(want_d))
    np.testing.assert_allclose(dist.numpy(), want_d, rtol=0, atol=ATOL)
    # the wrapper takes the plain version on CPU tensors
    w_ids, w_dist = graph_cuda.expand_score_fused(*args)
    assert torch.equal(w_ids, ids) and torch.equal(w_dist, dist)
    # the cases are there: dead beams, padding, repeats
    assert (ids[3] == SENT).all() and torch.isinf(dist[3]).all()
    assert (ids[1, :16] == SENT).all()  # node 7: no neighbours
    assert (ids[2, 3:16] == SENT).all() and (ids[2, :3] != SENT).all()  # node 5: 3
    assert torch.equal(ids[0, :16], ids[0, 16:32]) and torch.equal(dist[0, :16], dist[0, 16:32])


def test_expand_round_runs_b3_through_the_adjacency():
    """_expand_round hands the adjacency to B3's expand entry point: its
    candidates equal the plain composition (gather the rows, mask, score)."""
    from vector_store_tpu_torch.core import search

    rng = np.random.default_rng(4)
    _, _, tv, ts = _bank("bfloat16", rng)
    nbrs, sel, live = _expand_case(rng, B=2)
    calls = []
    orig = search.expand_score_fused

    def spy(*a):
        out = orig(*a)
        calls.append((a, out))
        return out

    class Cfg:
        beam_width, space, approx_topk = 2, "cosine", False

    class St:
        vectors, scales, neighbors = tv, ts, torch.from_numpy(nbrs)

    P = 8
    pool_ids = torch.from_numpy(rng.integers(0, C, size=(Q, P)).astype(np.int32))
    pool_d = torch.sort(torch.rand(Q, P, generator=torch.Generator().manual_seed(0)))[0]
    pool_d[:, P - 2 :] = float("inf")
    pool = (pool_d, pool_ids, torch.zeros((Q, P), dtype=torch.bool))
    q = torch.nn.functional.normalize(torch.randn(Q, D, generator=torch.Generator().manual_seed(1)))
    search.expand_score_fused = spy
    try:
        search._expand_round(St, q, Cfg, pool)
    finally:
        search.expand_score_fused = orig
    (args, (ids, dist)), = calls
    sel_ids, sel_live = args[4], args[5]
    assert torch.equal(sel_ids, pool_ids[:, :2]) and sel_live.all()
    want_ids, want_d = graph_cuda.expand_score_plain(tv, ts, St.neighbors, q, sel_ids, sel_live,
                                                     "cosine")
    assert torch.equal(ids, want_ids) and torch.equal(dist, want_d)


def test_gather_score_wrapper_counts_kernel_launches_only():
    rng = np.random.default_rng(3)
    _, _, tv, ts = _bank("float32", rng)
    before = dict(graph_cuda.LAUNCHES)
    cand = torch.zeros((2, 4), dtype=torch.int32)
    graph_cuda.gather_score_fused(tv, ts, torch.zeros((2, D)), cand, "cosine")
    assert graph_cuda.LAUNCHES == before  # the CPU takes the plain version
    with pytest.raises(ValueError):
        graph_cuda.gather_score_fused(tv.to("meta"), ts, torch.zeros((2, D)), cand, "cosine")
    nbrs = torch.zeros((C, 4), dtype=torch.int32)
    sel, live = torch.zeros((2, 3), dtype=torch.int32), torch.ones((2, 3), dtype=torch.bool)
    graph_cuda.expand_score_fused(tv, ts, nbrs, torch.zeros((2, D)), sel, live, "cosine")
    assert graph_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        graph_cuda.expand_score_fused(tv.to("meta"), ts, nbrs, torch.zeros((2, D)), sel, live, "l2")


def _pool_case(seed, Qn=6, P=16, Cn=24, id_range=40):
    """A sorted pool with some expanded entries and INF tails, and a block
    of new candidates whose ids repeat and overlap the pool's."""
    rng = np.random.default_rng(seed)
    pool_ids = np.stack([rng.permutation(id_range)[:P] for _ in range(Qn)]).astype(np.int32)
    pool_d = np.sort(rng.random((Qn, P)).astype(np.float32), axis=1)
    pool_d[:, P - 3 :] = np.inf
    pool_ids[:, P - 3 :] = SENT
    pool_e = rng.random((Qn, P)) < 0.4
    pool_e[:, P - 3 :] = False
    new_ids = rng.integers(0, id_range, size=(Qn, Cn)).astype(np.int32)
    # a repeated id carries one distance, whatever copy it is
    per_id = rng.random((Qn, id_range)).astype(np.float32)
    new_d = np.take_along_axis(per_id, new_ids, axis=1)
    for r in range(Qn):
        for j, i in enumerate(pool_ids[r]):
            if i != SENT:
                new_d[r][new_ids[r] == i] = pool_d[r, j]
    new_d[:, -2:] = np.inf
    new_ids[:, -2:] = SENT
    return pool_d, pool_ids, pool_e, new_d, new_ids


@pytest.mark.parametrize("fast", [True, False], ids=["merge_pool_fast", "merge_pool"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_pool_matches_jax(fast, seed):
    args = _pool_case(seed)
    jfn = jtopk.merge_pool_fast if fast else jtopk.merge_pool
    tfn = ttopk.merge_pool_fast if fast else ttopk.merge_pool
    want = [np.asarray(a) for a in jfn(*(jnp.asarray(a) for a in args))]
    got = [t.numpy() for t in tfn(*(torch.from_numpy(a) for a in args))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_dedup_by_id_matches_jax():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 30, size=(4, 50)).astype(np.int32)
    ids[:, :3] = SENT
    dist = rng.random((4, 50)).astype(np.float32)
    dist[:, :3] = np.inf
    want = [np.asarray(a) for a in jtopk.dedup_by_id(jnp.asarray(dist), jnp.asarray(ids))]
    got = [t.numpy() for t in ttopk.dedup_by_id(torch.from_numpy(dist), torch.from_numpy(ids))]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_rank_in_run_matches_jax():
    keys = np.sort(np.random.default_rng(6).integers(0, 12, size=200)).astype(np.int32)
    want = np.asarray(jtopk.rank_in_run(jnp.asarray(keys)))
    got = ttopk.rank_in_run(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)


def test_ring_assign_matches_jax():
    """Rows land at (cursor + rank) % Bm of their centroid's ring; a run
    that wraps the ring keeps its latest rows, as in the JAX package."""
    K, Bm = 8, 4
    rng = np.random.default_rng(7)
    members = np.full((K, Bm), SENT, np.int32)
    m_cnt = np.zeros((K,), np.int32)
    jm, jc = jnp.asarray(members), jnp.asarray(m_cnt)
    tm, tc = torch.from_numpy(members.copy()), torch.from_numpy(m_cnt.copy())
    for step in range(3):
        cids = rng.integers(0, K, size=20).astype(np.int32)
        cids[:7] = 2  # one cluster overflows its ring
        slots = (100 * step + np.arange(20)).astype(np.int32)
        live = rng.random(20) < 0.9
        jm, jc = jcluster.ring_assign(jm, jc, *(jnp.asarray(a) for a in (cids, slots, live)))
        tcluster.ring_assign(tm, tc, *(torch.from_numpy(a) for a in (cids, slots, live)))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

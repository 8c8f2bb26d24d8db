"""The plain version of the CUDA gather-score kernel B3, and the pool-merge
primitives around it, against the JAX package on the CPU.

The insert's robust prune (`build._robust_prune`, whose plain version is
`graph_cuda.robust_prune_plain`) is held against the JAX package's on
dyadic rows, whose distances both packages compute exactly: kept ids and
distances equal as sets per node (JAX's top-k may order ties otherwise).
The insert's reverse edges (`build._apply_reverse_edges`, plain rounds
`graph_cuda.reverse_edges_plain`) equal the JAX package's exactly, on hub
targets past REVERSE_ROUNDS edges, tied lengths, SENTINEL targets, dead
edges and INF-padded rows; the per-target walk that the CUDA kernel makes
(one warp a target, its edges in order) gives the same rows.

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

from vector_store_tpu.core import build as jbuild
from vector_store_tpu.core import cluster as jcluster
from vector_store_tpu.core import quantize as jquant
from vector_store_tpu.core import topk as jtopk
from vector_store_tpu.core.graph import GraphConfig as JGraphConfig
from vector_store_tpu.core.graph_pallas import gather_score_fused as j_gather_score
from vector_store_tpu_torch.core import build as tbuild
from vector_store_tpu_torch.core import cluster as tcluster
from vector_store_tpu_torch.core import graph_cuda
from vector_store_tpu_torch.core import topk as ttopk
from vector_store_tpu_torch.core.graph import GraphConfig
from vector_store_tpu_torch.core.ivf import from_numpy

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
    return jnp.asarray(vec), jnp.asarray(scl), from_numpy(vec, "cpu"), torch.from_numpy(scl)


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


def _prune_case(space, Cn, seed, M=24, Dn=16):
    """Per node a query and Cn candidates near it, in quarters of integers
    (every product and sum exact in f32), every 8th a repeat of the one
    before it (tied distances), sorted by distance as insert_impl sorts
    them; every 3rd node has an INF tail (SENTINEL ids), node 5 no finite
    candidate.  Returns (cand_dist, cand_ids, cand_vecs) as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-3, 4, size=(M, 1, Dn))
    x = (q + rng.integers(-2, 3, size=(M, Cn, Dn))) / 4.0
    x[:, 1::8] = x[:, 0::8][:, : x[:, 1::8].shape[1]]
    q = q / 4.0
    dots = np.einsum("mcd,md->mc", x, q[:, 0])
    dist = {"cosine": 1.0 - dots, "dot": -dots, "l2": np.sum((x - q) ** 2, axis=-1)}[space]
    order = np.argsort(dist, axis=1, kind="stable")
    dist = np.take_along_axis(dist, order, 1).astype(np.float32)
    x = np.take_along_axis(x, order[..., None], 1).astype(np.float32)
    ids = rng.permutation(1 << 20)[: M * Cn].reshape(M, Cn).astype(np.int32)
    for m in range(1, M, 3):
        tail = rng.integers(1, Cn // 2)
        dist[m, Cn - tail :] = np.inf
        ids[m, Cn - tail :] = SENT
    dist[5], ids[5] = np.inf, SENT
    return dist, ids, x


@pytest.mark.parametrize("space", ["cosine", "dot", "l2"])
@pytest.mark.parametrize("Cn,R", [(64, 4), (128, 32), (200, 32), (200, 4)])
def test_robust_prune_plain_matches_jax(space, Cn, R):
    dist, ids, x = _prune_case(space, Cn, seed=Cn * 7 + R)
    j_d, j_i = jbuild._robust_prune(jnp.asarray(dist), jnp.asarray(ids), jnp.asarray(x),
                                    JGraphConfig(dims=x.shape[-1], degree=R, space=space))
    t_d, t_i = tbuild._robust_prune(torch.from_numpy(dist), torch.from_numpy(ids),
                                    torch.from_numpy(x),
                                    GraphConfig(dims=x.shape[-1], degree=R, space=space))
    j_d, j_i, t_d, t_i = np.asarray(j_d), np.asarray(j_i), t_d.numpy(), t_i.numpy()
    assert t_d.shape == t_i.shape == j_d.shape == (len(dist), R)
    kept = 0
    for m in range(len(dist)):
        want = sorted(zip(j_i[m][j_i[m] != SENT].tolist(), j_d[m][j_i[m] != SENT].tolist()))
        got = sorted(zip(t_i[m][t_i[m] != SENT].tolist(), t_d[m][t_i[m] != SENT].tolist()))
        assert got == want, m
        assert np.all(np.isinf(t_d[m][t_i[m] == SENT]))
        kept += len(got)
    assert 0 < kept < R * len(dist)  # the rule removed some candidates, and kept some
    assert not np.any(t_i[5] != SENT)


def test_robust_prune_wrapper_takes_the_plain_version_on_the_cpu():
    dist, ids, x = (torch.from_numpy(a) for a in _prune_case("dot", 64, seed=11))
    pd = tbuild._pairwise_batched(x, "dot")
    args = (pd, dist, ids, tbuild._dot_shift(pd, dist), 1.2, 8, 4)
    before = dict(graph_cuda.LAUNCHES)
    got = graph_cuda.robust_prune(*args)
    assert graph_cuda.LAUNCHES == before  # the CPU takes the plain version
    want = graph_cuda.robust_prune_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (len(dist), 8)
    with pytest.raises(ValueError):
        graph_cuda.robust_prune(pd.to("meta"), *args[1:])
    assert graph_cuda.LAUNCHES == before


def _reverse_case(R, seed, C=300, M=64):
    """(neighbors [C, R], nbr_dist [C, R], tgt, src, d, e_live [M * R]) as
    numpy: rows of eighths (tied slots), every 7th row holding only its
    first R // 4 edges and row 3 none (INF / SENTINEL pads); edge lengths
    in eighths (tied edges), targets in the first two thirds of the rows,
    40 short edges into hub row 5 and 20 into the empty row 3 (past
    REVERSE_ROUNDS), a twentieth of the targets SENTINEL (some still marked
    live), a tenth of the edges dead, a few INF lengths (dead, as
    insert_impl marks them)."""
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, C, size=(C, R)).astype(np.int32)
    dist = (rng.integers(1, 40, size=(C, R)) / 8).astype(np.float32)
    pad = np.zeros((C, R), bool)
    pad[::7, R // 4 :] = True
    pad[3] = True
    nbrs[pad], dist[pad] = SENT, np.inf
    dist[5] = 100.0  # the hub's row: every short edge would enter
    E = M * R
    tgt = rng.integers(0, 2 * C // 3, size=E).astype(np.int32)  # the last third: no edge
    d = (rng.integers(0, 40, size=E) / 8).astype(np.float32)
    hub = rng.choice(E, 60, replace=False)
    tgt[hub[:40]], tgt[hub[40:]] = 5, 3
    d[hub] = (rng.integers(0, 8, size=60) / 8).astype(np.float32)
    src = (C + np.arange(E)).astype(np.int32)
    e_live = rng.random(E) < 0.9
    e_live[hub] = True
    sent = rng.random(E) < 0.05
    sent[hub] = False
    tgt[sent] = SENT
    inf = rng.random(E) < 0.02
    inf[hub] = False
    d[inf] = np.inf
    e_live &= ~inf
    return nbrs, dist, tgt, src, d, e_live


@pytest.mark.parametrize("R", [16, 32, 64])
def test_reverse_edges_plain_matches_jax(R):
    nbrs, dist, tgt, src, d, e_live = _reverse_case(R, seed=R)
    j_n, j_d = jbuild._apply_reverse_edges(*(jnp.asarray(a) for a in (nbrs, dist, tgt, src, d,
                                                                      e_live)))
    t_n, t_d = torch.from_numpy(nbrs.copy()), torch.from_numpy(dist.copy())
    graph_cuda.reverse_edges_plain(t_n, t_d, *(torch.from_numpy(a) for a in (tgt, src, d, e_live)),
                                   tbuild.REVERSE_ROUNDS)
    np.testing.assert_array_equal(t_n.numpy(), np.asarray(j_n))
    np.testing.assert_array_equal(t_d.numpy().view(np.int32), np.asarray(j_d).view(np.int32))
    # the cases are there: rows changed, ranks past REVERSE_ROUNDS dropped
    changed = (t_n.numpy() != nbrs).any(1)
    assert changed.sum() > 0 and not changed[2 * len(nbrs) // 3 :].any()
    cap = min(tbuild.REVERSE_ROUNDS, R)
    for row, n_edges in ((5, 40), (3, 20)):
        offered = src[(tgt == row) & e_live]
        assert len(offered) >= n_edges > tbuild.REVERSE_ROUNDS
        assert np.isin(t_n.numpy()[row], offered).sum() == cap
    # the build's entry point takes the same path
    b_n, b_d = torch.from_numpy(nbrs.copy()), torch.from_numpy(dist.copy())
    tbuild._apply_reverse_edges(b_n, b_d, *(torch.from_numpy(a) for a in (tgt, src, d, e_live)))
    assert torch.equal(b_n, t_n) and torch.equal(b_d, t_d)


def _walk_per_target(nbrs, dist, tgt, src, d, e_live, rounds):
    """The reverse-edge kernel's order of work in numpy: the edges sorted
    stably by target alone; per run, its first `rounds` edges by (length,
    index), NaN lengths last and -0.0 equal to 0.0, each in turn replacing
    the row's first largest slot when shorter."""
    nbrs, dist = nbrs.copy(), dist.copy()
    sort_tgt = np.where(e_live, tgt, SENT)
    order = np.argsort(sort_tgt, kind="stable")
    i = 0
    while i < len(order):
        t = sort_tgt[order[i]]
        j = i
        while j < len(order) and sort_tgt[order[j]] == t:
            j += 1
        run = sorted(order[i:j], key=lambda e: (bool(np.isnan(d[e])), np.nan_to_num(d[e]), e))
        for e in run[:rounds] if t != SENT else []:
            w = int(np.argmax(dist[t]))
            if d[e] < dist[t, w]:
                nbrs[t, w], dist[t, w] = src[e], d[e]
        i = j
    return nbrs, dist


@pytest.mark.parametrize("R", [16, 32, 64])
def test_reverse_edges_walk_per_target_equals_the_rounds(R):
    """One pass per target, its edges in order (the kernel's design), gives
    the rounds' rows bit for bit: NaN slots (argmax takes the first, and no
    edge is shorter than it), live NaN lengths (sorted last), -0.0 and 0.0
    lengths (equal: by index) in a run past REVERSE_ROUNDS."""
    nbrs, dist, tgt, src, d, e_live = _reverse_case(R, seed=100 + R)
    dist[11, 2] = np.nan
    tgt[:3], e_live[:3], d[:3] = 11, True, 0.0
    run = np.arange(3, 23)
    tgt[run], e_live[run] = 12, True
    d[run] = np.tile(np.array([-0.0, 0.0, np.nan, 0.5], np.float32), 5)
    for rounds in (1, tbuild.REVERSE_ROUNDS):
        want_n, want_d = _walk_per_target(nbrs, dist, tgt, src, d, e_live, rounds)
        t_n, t_d = torch.from_numpy(nbrs.copy()), torch.from_numpy(dist.copy())
        graph_cuda.reverse_edges_plain(t_n, t_d, *(torch.from_numpy(a) for a in
                                                   (tgt, src, d, e_live)), rounds)
        np.testing.assert_array_equal(t_n.numpy(), want_n)
        np.testing.assert_array_equal(t_d.numpy().view(np.int32), want_d.view(np.int32))
        assert np.isnan(t_d.numpy()[11, 2]) and t_n.numpy()[11, 2] == nbrs[11, 2]
    signs = np.signbit(t_d.numpy()[12][np.isin(t_n.numpy()[12], src[run])])
    assert signs.any() and not signs.all()  # both zeros entered row 12


def test_reverse_edges_wrapper_takes_the_plain_version_on_the_cpu():
    nbrs, dist, tgt, src, d, e_live = (torch.from_numpy(a) for a in _reverse_case(32, seed=9))
    w_n, w_d, p_n, p_d = nbrs.clone(), dist.clone(), nbrs.clone(), dist.clone()
    before = dict(graph_cuda.LAUNCHES)
    graph_cuda.reverse_edges(w_n, w_d, tgt, src, d, e_live, tbuild.REVERSE_ROUNDS)
    assert graph_cuda.LAUNCHES == before  # the CPU takes the plain version
    graph_cuda.reverse_edges_plain(p_n, p_d, tgt, src, d, e_live, tbuild.REVERSE_ROUNDS)
    assert torch.equal(w_n, p_n) and torch.equal(w_d, p_d)
    assert not torch.equal(w_n, nbrs)
    with pytest.raises(ValueError):
        graph_cuda.reverse_edges(nbrs.to("meta"), dist.to("meta"), tgt, src, d, e_live,
                                 tbuild.REVERSE_ROUNDS)
    assert graph_cuda.LAUNCHES == before


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

"""vector_store_tpu_torch ShardedSlotIndex (graph and exact) against the JAX
ShardedSlotIndex, on the CPU: the JAX class on four of the eight virtual
CPU devices, the port on device="cpu" with four logical shards.

Equal, since the host decides them: the gids `add` returns (bulk and
single-row adds), `count`, `decode`, the per-shard sizes and frontiers,
the capacity after a growth and the routing sample that follows it, what a
remove, a double remove and an unknown gid do to the sizes, the gid -> gid
remap of a compaction.  The graphs are not edge-for-edge equal (exact
top-k against approximate, other tie order), so searches are compared by
recall against an exact float64 oracle (both >= 0.90, within 0.02 of each
other) and by the distances of the ids both return (1e-4, f32 banks); the
exact backend must return the oracle's ids.  Snapshots load in both
directions.
"""

import numpy as np
import pytest
import torch

from vector_store_tpu.shard.sharded_index import ShardedSlotIndex as JSharded
from vector_store_tpu.types import IndexParams as JIndexParams
from vector_store_tpu_torch import IndexParams
from vector_store_tpu_torch.shard.sharded_index import ShardedSlotIndex as TSharded

S = 4
D = 16


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d)).astype(np.float32)
    return centers[rng.integers(0, 32, n)] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)


def _pair(dtype="float32", space="cosine", d=D, **kw):
    j = JSharded(JIndexParams(dimensions=d, space=space, dtype=dtype), n_devices=S, **kw)
    t = TSharded(IndexParams(dimensions=d, space=space, dtype=dtype), n_devices=S, device="cpu", **kw)
    return j, t


def _oracle(x, live, q, space, k):
    x, q = x.astype(np.float64), q.astype(np.float64)
    if space == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    if space == "l2":
        d = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2 * q @ x.T
    else:
        d = -q @ x.T
    d[:, ~live] = np.inf
    return np.argsort(d, axis=1)[:, :k]


def _recall(got, want):
    return np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)])


def _queries(x, n, seed):
    rng = np.random.default_rng(seed)
    at = rng.choice(len(x), n, replace=False)
    return x[at] + 0.05 * rng.normal(size=(n, x.shape[1])).astype(np.float32)


def _host_state_equal(j, t):
    assert j.count() == t.count()
    np.testing.assert_array_equal(j._sizes, t._sizes)
    np.testing.assert_array_equal(j._frontiers, t._frontiers)
    assert (j.capacity, j._rr, j._route_built_at) == (t.capacity, t._rr, t._route_built_at)
    assert j.cfg.routing_sample == t.cfg.routing_sample and j.cfg.route_k == t.cfg.route_k
    np.testing.assert_array_equal(np.asarray(j._state.size), [int(s.size) for s in t.states])
    np.testing.assert_array_equal(np.asarray(j._state.frontier), [int(s.frontier) for s in t.states])
    np.testing.assert_array_equal(
        np.asarray(j._state.valid), np.stack([s.valid.numpy() for s in t.states])
    )


@pytest.fixture(scope="module")
def built():
    """Both packages' graphs (f32, cosine) after bulk adds and removes."""
    x = _data(1500, D, seed=1)
    j, t = _pair(initial_capacity_per_shard=512)
    gids = []
    for lo, hi in ((0, 1), (1, 3), (3, 1100), (1100, 1500)):
        a, b = j.add(x[lo:hi]), t.add(x[lo:hi])
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
        gids.append(b)
    gids = np.concatenate(gids)
    return j, t, x, gids


def test_add_gids_sizes_and_decode_match_jax(built):
    j, t, x, gids = built
    np.testing.assert_array_equal(gids, np.arange(1500))  # balanced deal: gid = insertion order
    _host_state_equal(j, t)
    for gid in (0, 7, 1499):
        assert j.decode(gid) == t.decode(gid)
    # the banks hold the same rows at the same slots
    np.testing.assert_allclose(
        np.asarray(j._state.vectors), np.stack([s.vectors.numpy() for s in t.states]), atol=1e-6
    )


def test_growth_doubles_every_shard_and_keeps_the_gids(built):
    j, t, x, gids = built
    # 512 a shard at the start, 375 rows a shard now, a block of headroom: grown once
    assert t.capacity == j.capacity == 1024
    assert all(s.capacity == t.capacity for s in t.states)
    _, ids = t.search(x[:32], 1)
    np.testing.assert_array_equal(ids[:, 0], gids[:32])


def test_recall_and_distances_match_jax(built):
    j, t, x, gids = built
    q = _queries(x, 64, seed=2)
    want = _oracle(x, np.ones(len(x), bool), q, "cosine", 10)
    (jd, ji), (td, ti) = j.search(q, 10), t.search(q, 10)
    rj, rt = _recall(ji, want), _recall(ti, want)
    assert rj >= 0.90 and rt >= 0.90 and abs(rj - rt) <= 0.02, (rj, rt)
    hits = 0
    for a_d, a_i, b_d, b_i in zip(jd, ji, td, ti):
        both = {int(g): float(v) for g, v in zip(a_i, a_d) if g >= 0}
        for g, v in zip(b_i, b_d):
            if int(g) in both:
                hits += 1
                assert abs(both[int(g)] - float(v)) <= 1e-4
    assert hits >= 0.9 * ti.size
    assert ti.dtype == np.int64 and (np.diff(td, axis=1) >= 0).all()
    # one query, unbatched
    d1, i1 = t.search(q[0], 10)
    np.testing.assert_array_equal(i1, ti[0])


def test_remove_double_remove_and_unknown_gids_match_jax(built):
    j, t, x, gids = built
    dead = gids[5:400:3]
    for idx in (j, t):
        idx.remove(dead)
        idx.remove(dead[:20])  # a double remove drops nothing more
        idx.remove(np.asarray([gids[5], gids[5]]))  # duplicates of a dead row
        idx.remove(np.asarray([900 * S + 2]))  # a slot never written
    _host_state_equal(j, t)
    assert t.count() == 1500 - len(dead)
    _, ids = t.search(x[5:400:3][:32], 3)
    assert not set(ids.reshape(-1).tolist()) & set(dead.tolist())


def test_compaction_remap_matches_jax(built):
    """Runs after the removes above (file order): both packages rebuild the
    live rows in the same order, so the gid -> gid maps are equal."""
    j, t, x, gids = built
    live = np.ones(len(x), bool)
    live[5:400:3] = False
    rj, rt = j.compact(), t.compact()
    assert rt == rj
    assert set(rt) == set(gids[live].tolist())
    assert sorted(rt.values()) == list(range(int(live.sum())))
    _host_state_equal(j, t)
    rows = np.flatnonzero(live)[10:42]
    _, ids = t.search(x[rows], 1)
    np.testing.assert_array_equal(ids[:, 0], [rt[int(g)] for g in gids[rows]])
    q = _queries(x[live], 48, seed=3)
    want = np.asarray([[rt[int(g)] for g in row]
                       for row in gids[_oracle(x, live, q, "cosine", 10)]])
    assert _recall(t.search(q, 10)[1], want) >= 0.90


def test_single_row_adds_balance_like_jax():
    """The balance test of tests/test_shard.py: five single-row adds over
    four shards leave every shard one row and one shard two."""
    j, t = _pair(space="l2", d=8)
    rng = np.random.default_rng(3)
    for _ in range(5):
        row = rng.normal(size=(1, 8)).astype(np.float32)
        np.testing.assert_array_equal(j.add(row), t.add(row))
    _host_state_equal(j, t)
    assert t.count() == 5 and t._sizes.max() - t._sizes.min() <= 1
    q = rng.normal(size=(4, 8)).astype(np.float32)
    (jd, ji), (td, ti) = j.search(q, 10), t.search(q, 10)
    np.testing.assert_array_equal(ti, ji)  # five rows: every search is exhaustive
    np.testing.assert_allclose(td, jd, atol=1e-4)
    assert (ti[:, 5:] == -1).all() and np.isinf(td[:, 5:]).all()


@pytest.mark.parametrize("dtype,space", [("float32", "l2"), ("int8", "cosine"), ("bfloat16", "dot")])
def test_exact_backend_matches_jax(dtype, space):
    """exact=True: a degree-1 stub, rows uploaded, every shard scanned."""
    x = _data(900, D, seed=4)
    if space == "dot":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    j, t = _pair(dtype=dtype, space=space, exact=True)
    np.testing.assert_array_equal(j.add(x), t.add(x))
    assert t.cfg.degree == j.cfg.degree == 1
    _host_state_equal(j, t)
    q = _queries(x, 32, seed=5)
    want = _oracle(x, np.ones(len(x), bool), q, space, 10)
    (jd, ji), (td, ti) = j.search(q, 10), t.search(q, 10)
    if dtype == "float32":
        np.testing.assert_array_equal(ti, want)
        np.testing.assert_allclose(td, jd, atol=1e-4)
    rj, rt = _recall(ji, want), _recall(ti, want)
    assert rj >= 0.90 and rt >= 0.90 and abs(rj - rt) <= 0.02, (rj, rt)
    for idx in (j, t):
        idx.remove(np.arange(0, 900, 2))
    _host_state_equal(j, t)
    _, ids = t.search(q, 5)
    assert (ids % 2 == 1).all()


def test_int8_graph_recalls_like_jax():
    x = _data(1200, D, seed=6)
    j, t = _pair(dtype="int8")
    np.testing.assert_array_equal(j.add(x), t.add(x))
    q = _queries(x, 48, seed=7)
    want = _oracle(x, np.ones(len(x), bool), q, "cosine", 10)
    rj, rt = _recall(j.search(q, 10)[1], want), _recall(t.search(q, 10)[1], want)
    assert rj >= 0.90 and rt >= 0.90 and abs(rj - rt) <= 0.02, (rj, rt)
    assert t.states[0].vectors.dtype == torch.int8


def test_router_rebuild_takes_one_route_k():
    """A router forced at test scale: every shard is rebuilt with the one
    `route_k`, and searches through routed entries keep their recall."""
    x = _data(2000, D, seed=8)
    j, t = _pair()
    np.testing.assert_array_equal(j.add(x), t.add(x))
    for idx in (j, t):
        with idx._lock:
            idx._rebuild_router_locked(int(idx._frontiers.max()), k=128)
    _host_state_equal(j, t)
    assert t.cfg.route_k == 128
    assert all(s.route_centroids.shape == (128, D) for s in t.states)
    q = _queries(x, 48, seed=9)
    want = _oracle(x, np.ones(len(x), bool), q, "cosine", 10)
    rj, rt = _recall(j.search(q, 10)[1], want), _recall(t.search(q, 10)[1], want)
    assert rj >= 0.90 and rt >= 0.90 and abs(rj - rt) <= 0.03, (rj, rt)
    # a far-out row joins its centroid's ring and routes to itself
    new = (8.0 + np.random.default_rng(10).random((4, D))).astype(np.float32)
    nid = t.add(new)
    np.testing.assert_array_equal(nid, j.add(new))
    _, ids = t.search(new, 1)
    np.testing.assert_array_equal(ids[:, 0], nid)


@pytest.mark.parametrize("dtype,exact", [("float32", False), ("int8", False), ("bfloat16", True)])
def test_snapshots_load_in_both_directions(tmp_path, dtype, exact):
    x = _data(1000, D, seed=11)
    j, t = _pair(dtype=dtype, exact=exact)
    for idx in (j, t):
        gids = idx.add(x)
        idx.remove(gids[:7])
    q = _queries(x, 32, seed=12)
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    t.save(pt)
    j.save(pj)
    t_back = TSharded.load(pt, n_devices=S, device="cpu")
    t_from_j = TSharded.load(pj, n_devices=S, device="cpu")
    j_from_t = JSharded.load(pt, n_devices=S)
    _host_state_equal(j, t_from_j)
    _host_state_equal(j_from_t, t)
    assert t_from_j._exact == j_from_t._exact == exact
    # the same package reads its own file back to the same answers
    (td, ti), (bd, bi) = t.search(q, 5), t_back.search(q, 5)
    np.testing.assert_array_equal(bi, ti)
    np.testing.assert_array_equal(bd, td)
    # across packages the graph moves edge for edge: the reader's own
    # search over it recalls like the writer's
    want = _oracle(x, np.arange(len(x)) >= 7, q, "cosine", 5)
    for a, b in ((j_from_t, t), (t_from_j, j)):
        ra, rb = _recall(a.search(q, 5)[1], want), _recall(b.search(q, 5)[1], want)
        assert ra >= 0.90 and abs(ra - rb) <= 0.03, (ra, rb)
    for s in range(S):
        np.testing.assert_array_equal(
            t_from_j.states[s].neighbors.numpy(), np.asarray(j._state.neighbors[s])
        )
    # a loaded index keeps ingesting with the gids the other package gives
    np.testing.assert_array_equal(t_from_j.add(x[:9]), j.add(x[:9]))
    np.testing.assert_array_equal(j_from_t.add(x[:9]), t.add(x[:9]))


def test_snapshot_with_another_shard_count_is_refused_like_jax(tmp_path):
    _, t = _pair()
    t.add(_data(100, D, seed=13))
    p = str(tmp_path / "s.npz")
    t.save(p)
    msgs = []
    for load in (
        lambda: TSharded.load(p, n_devices=2, device="cpu"),
        lambda: JSharded.load(p, n_devices=2),
    ):
        with pytest.raises(ValueError) as exc:
            load()
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == "snapshot has 4 shards, mesh has 2 devices"
    from vector_store_tpu_torch.core import persist
    from vector_store_tpu_torch.core.index import SlotIndex

    single = SlotIndex(IndexParams(dimensions=D), device="cpu")
    single.add(_data(10, D))
    persist.save(p, single)
    with pytest.raises(ValueError, match="not a sharded snapshot"):
        TSharded.load(p, device="cpu")

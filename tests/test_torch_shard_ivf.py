"""vector_store_tpu_torch ShardedIvfIndex against the JAX ShardedIvfIndex, on
the CPU: the JAX class on four of the eight virtual CPU devices
(tests/conftest.py), the port on device="cpu" with four logical shards.

Everything the host decides is deterministic and must be equal: the gids
`add` returns (bulk and single-row adds), `count`, `decode`, the staging
books, which gids a `remove` drops, gids across a compact and a growth.
The k-means is not bit-equal between the packages (bf16 centroids) and
JAX's staging search is approximate where the port's is exact, so after a
recluster the layouts are compared by recall against an exact float64
oracle (both >= 0.90, within 0.02 of each other; two-stage >= 0.85) and
distances of the ids both return within 1e-4.  Snapshots load in both
directions.  The merge alone is held against the JAX `_gid_merge`.
"""

import types

import numpy as np
import pytest
import torch

from vector_store_tpu.shard.sharded_ivf import ShardedIvfIndex as JSharded
from vector_store_tpu.types import IndexParams as JIndexParams
from vector_store_tpu_torch import IndexParams
from vector_store_tpu_torch.core.topk import SENTINEL
from vector_store_tpu_torch.shard.mesh import gid_merge, make_mesh
from vector_store_tpu_torch.shard.sharded_ivf import ShardedIvfIndex as TSharded

S = 4
D = 32
CLUSTER_MIN = 32 * S * 16  # 2,048: staging below, clustered above


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
    kw.setdefault("cluster_min", CLUSTER_MIN)
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


def _books_equal(j, t):
    """Two indexes' host books; rowids are compared at live slots (a loaded
    index forgets the rowid of a tombstoned slot, in both packages)."""
    for a, b in zip(j._books, t._books):
        assert (a.next_rowid, a.n_live, a.free) == (b.next_rowid, b.n_live, b.free)
        np.testing.assert_array_equal(a.n_used, b.n_used)
        np.testing.assert_array_equal(a.loc[: a.next_rowid], b.loc[: b.next_rowid])
        np.testing.assert_array_equal(a.valid_h, b.valid_h)
        np.testing.assert_array_equal(a.rowid_h[a.valid_h], b.rowid_h[b.valid_h])


def _queries(x, n, seed):
    rng = np.random.default_rng(seed)
    at = rng.choice(len(x), n, replace=False)
    return x[at] + 0.05 * rng.normal(size=(n, x.shape[1])).astype(np.float32)


# -- the mesh ----------------------------------------------------------------


def test_make_mesh_devices():
    assert make_mesh(4, "cpu") == [torch.device("cpu")] * 4
    assert make_mesh(None, "cpu") == [torch.device("cpu")]
    assert make_mesh(2, ["cpu", "cpu", "cpu"]) == [torch.device("cpu")] * 3  # as given
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {have + 1} devices, have {have}"):
        make_mesh(have + 1, "cuda")


# -- the merge alone ----------------------------------------------------------


def _jax_merge(d, i, k, capacity):
    """The JAX `_gid_merge` under shard_map on four devices; d, i are [S, Q, k']."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from vector_store_tpu.shard.mesh import SHARD_AXIS
    from vector_store_tpu.shard.mesh import make_mesh as jmake_mesh
    from vector_store_tpu.shard.sharded_index import _gid_merge, _shard_map_fn

    mesh = jmake_mesh(S)
    local = types.SimpleNamespace(capacity=capacity)

    def fn(d_blk, i_blk):
        return _gid_merge(local, d_blk[0], i_blk[0], S, k)

    md, mi = _shard_map_fn(
        fn, mesh=mesh, in_specs=(P(SHARD_AXIS), P(SHARD_AXIS)), out_specs=(P(), P()),
        check_vma=False,
    )(jnp.asarray(d), jnp.asarray(i))
    return np.asarray(md), np.asarray(mi)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gid_merge_matches_jax(seed):
    """Random per-shard lists with SENTINEL lanes (distance inf) and exact
    ties within and across shards: distances and gids equal to JAX's, tie
    for tie."""
    rng = np.random.default_rng(seed)
    Q, kk, k, cap = 16, 8, 8, 50
    # few distinct values, so ties abound; sorted ascending per shard
    d = np.sort(rng.integers(0, 6, size=(S, Q, kk)).astype(np.float32) / 4, axis=-1)
    i = rng.integers(0, cap, size=(S, Q, kk)).astype(np.int32)
    dead = rng.random((S, Q, kk)) < 0.25
    d = np.sort(np.where(dead, np.inf, d), axis=-1)
    i = np.where(np.isinf(d), SENTINEL, i)
    jd, ji = _jax_merge(d, i, k, cap)
    parts = [(torch.from_numpy(d[s]), torch.from_numpy(i[s])) for s in range(S)]
    td, ti = gid_merge(parts, k, capacity=cap)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(ti.numpy(), ji)
    # without a capacity the ids are encoded unclipped (the IVF's merge)
    ud, ui = gid_merge(parts, k)
    np.testing.assert_array_equal(ui.numpy(), ji)


def test_gid_merge_descending_takes_the_shard_major_tie_order():
    s = torch.tensor([[3.0, 1.0]]), torch.tensor([[7, 2]], dtype=torch.int32)
    t = torch.tensor([[3.0, 3.0]]), torch.tensor([[5, 6]], dtype=torch.int32)
    sc, ids = gid_merge([s, t], 3, descending=True)
    assert sc.tolist() == [[3.0, 3.0, 3.0]]
    assert ids.tolist() == [[7 * 2, 5 * 2 + 1, 6 * 2 + 1]]  # shard 0's first, then shard 1's in order


# -- host decisions: equal ----------------------------------------------------


def test_add_gids_count_decode_and_staging_books_match_jax():
    x = _data(1500, D, seed=1)
    j, t = _pair()
    for lo, hi in ((0, 1), (1, 4), (4, 1000), (1000, 1003), (1003, 1500)):
        a, b = j.add(x[lo:hi]), t.add(x[lo:hi])
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    assert not j._clustered and not t._clustered
    assert j.count() == t.count() == 1500
    assert (j.n_clusters, j.bucket, j._rr) == (t.n_clusters, t.bucket, t._rr)
    _books_equal(j, t)
    for gid in (0, 5, 1499):
        assert j.decode(gid) == t.decode(gid)
    # the staging banks hold the same rows in the same slots
    for s in range(S):
        np.testing.assert_array_equal(np.asarray(j.state.rowid[s]), t.states[s].rowid.numpy())
        np.testing.assert_array_equal(np.asarray(j.state.valid[s]), t.states[s].valid.numpy())
        np.testing.assert_allclose(
            np.asarray(j.state.vectors[s]), t.states[s].vectors.numpy(), atol=1e-6
        )


def test_single_row_adds_balance_like_jax():
    """The balance test of tests/test_sharded_ivf.py: 17 single-row adds
    spread over the shards through the rotating cursor, gid for gid."""
    d = 8
    j, t = _pair(space="l2", d=d, cluster_min=10_000)
    rng = np.random.default_rng(3)
    for _ in range(17):
        row = rng.normal(size=(1, d)).astype(np.float32)
        np.testing.assert_array_equal(j.add(row), t.add(row))
    sizes = [b.n_live for b in t._books]
    assert sizes == [b.n_live for b in j._books]
    assert max(sizes) - min(sizes) <= 1 and t.count() == 17
    q = rng.normal(size=(2, d)).astype(np.float32)
    (jd, ji), (td, ti) = j.search(q, 5), t.search(q, 5)
    np.testing.assert_array_equal(ti, ji)  # 17 rows: the staging scan is exact in both
    np.testing.assert_allclose(td, jd, atol=1e-4)


def test_bucket_growth_keeps_one_geometry_and_the_gids():
    """Near-copies of one row overfill their SPILL nearest clusters on every
    shard: every shard's bucket doubles together (one geometry), in both
    packages alike, and gids given out before the growth still find their
    rows."""
    x = _data(2500, D, seed=2)
    j, t = _pair()
    first = t.add(x)
    np.testing.assert_array_equal(first, j.add(x))
    b0 = t.bucket
    assert t._clustered and j.bucket == b0
    rng = np.random.default_rng(3)
    # more than SPILL full buckets a shard, fewer than would double the count
    copies = x[7] + 0.001 * rng.normal(size=(S * (4 * b0 + 64), D)).astype(np.float32)
    np.testing.assert_array_equal(t.add(copies), j.add(copies))
    assert t.bucket == j.bucket and t.bucket >= 2 * b0
    assert all(s.vectors.shape[:2] == (t.n_clusters, t.bucket) for s in t.states)
    assert all(b.valid_h.shape == (t.n_clusters, t.bucket) for b in t._books)
    assert j.count() == t.count() == len(x) + len(copies)
    rows = np.arange(100, 132)
    _, ids = t.search(x[rows], 1)
    np.testing.assert_array_equal(ids[:, 0], first[rows])


@pytest.fixture(scope="module")
def built():
    """Both packages' indexes after staging, the first clustering,
    clustered adds, a remove and a double remove."""
    x = _data(4000, D, seed=4)
    j, t = _pair()
    gids = []
    for lo, hi in ((0, 1500), (1500, 3000), (3000, 4000)):
        a, b = j.add(x[lo:hi]), t.add(x[lo:hi])
        np.testing.assert_array_equal(a, b)
        gids.append(b)
    gids = np.concatenate(gids)
    assert j._clustered and t._clustered
    dead = gids[::9]
    for idx in (j, t):
        idx.remove(dead)
        idx.remove(dead[:50])  # a double remove drops nothing more
        idx.remove(np.asarray([10**7 + 1, -5]))  # never given out
    live = np.ones(len(x), bool)
    live[::9] = False
    return j, t, x, gids, live


def test_remove_drops_the_same_gids_as_jax(built):
    j, t, x, gids, live = built
    assert j.count() == t.count() == int(live.sum())
    assert (j.n_clusters, j._clustered_at) == (t.n_clusters, t._clustered_at)
    for a, b in zip(j._books, t._books):
        assert (a.next_rowid, a.n_live) == (b.next_rowid, b.n_live)
        # the same rowids are gone, wherever each package's k-means put them
        np.testing.assert_array_equal(a.loc[: a.next_rowid, 0] >= 0, b.loc[: b.next_rowid, 0] >= 0)
    _, ids = t.search(x[:64], 5)
    assert not set(ids.reshape(-1).tolist()) & set(gids[::9].tolist())


@pytest.mark.parametrize("k", [10, 50])
def test_recall_matches_jax(built, k):
    """k 10 takes B1's plain version per shard, k 50 B2's."""
    j, t, x, gids, live = built
    q = _queries(x, 64, seed=5)
    want = gids[_oracle(x, live, q, "cosine", k)]
    (jd, ji), (td, ti) = j.search(q, k), t.search(q, k)
    rj, rt = _recall(ji, want), _recall(ti, want)
    assert rj >= 0.90 and rt >= 0.90 and abs(rj - rt) <= 0.02, (rj, rt)
    # distances of the ids both return, within 1e-4
    for a_d, a_i, b_d, b_i in zip(jd, ji, td, ti):
        both = {int(g): float(v) for g, v in zip(a_i, a_d) if g >= 0}
        for g, v in zip(b_i, b_d):
            if int(g) in both:
                assert abs(both[int(g)] - float(v)) <= 1e-4
    # the exact oracle over all shards equals the float64 one (f32 bank)
    _, te = t.exact_search(q, k)
    assert _recall(te, want) >= 0.99


def test_gids_stable_across_compact_and_growth(built):
    j, t, x, gids, live = built
    rows = np.flatnonzero(live)[:48]
    b_before = t.bucket
    assert t.compact() == {} and j.compact() == {}
    assert j.count() == t.count() == int(live.sum())
    _, ids = t.search(x[rows], 1)
    np.testing.assert_array_equal(ids[:, 0], gids[rows])
    # tombstoned slots were dropped by the recluster; new rows get new gids
    more = _data(600, D, seed=6)
    a, b = j.add(more), t.add(more)
    np.testing.assert_array_equal(a, b)
    assert b.min() > gids.max() - S  # gids are never reused
    _, ids = t.search(x[rows], 1)
    np.testing.assert_array_equal(ids[:, 0], gids[rows])
    assert t.bucket >= 128 and b_before >= 128
    for idx in (j, t):  # leave the fixture as the other tests expect it
        idx.remove(a)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_quantized_banks_recall_like_jax(dtype):
    x = _data(3000, D, seed=7)
    j, t = _pair(dtype=dtype, space="l2" if dtype == "bfloat16" else "cosine")
    np.testing.assert_array_equal(j.add(x), t.add(x))
    space = t.space
    q = _queries(x, 48, seed=8)
    want = _oracle(x, np.ones(len(x), bool), q, space, 10)  # gid == row: one bulk add
    rj, rt = _recall(j.search(q, 10)[1], want), _recall(t.search(q, 10)[1], want)
    assert rj >= 0.90 and rt >= 0.90 and abs(rj - rt) <= 0.02, (rj, rt)
    assert t.states[0].vectors.dtype == {"int8": torch.int8, "bfloat16": torch.bfloat16}[dtype]


def test_two_stage_recall_and_staleness():
    d = 64
    x = _data(4000, d, seed=9)
    kw = dict(dtype="int8", d=d, rescore=16)
    j, t = _pair(coarse=True, **kw)
    _, base = _pair(coarse=False, **kw)
    gids = t.add(x)
    np.testing.assert_array_equal(gids, j.add(x))
    np.testing.assert_array_equal(gids, base.add(x))
    assert t.coarse and t._clustered and t._coarse_stale
    q = _queries(x, 64, seed=10)
    want = _oracle(x, np.ones(len(x), bool), q, "cosine", 10)
    rj = _recall(j.search(q, 10)[1], want)
    rt = _recall(t.search(q, 10)[1], want)
    rb = _recall(base.search(q, 10)[1], want)
    assert rt >= 0.85 and rj >= 0.85 and abs(rj - rt) <= 0.03, (rj, rt)
    assert rt >= rb - 0.10
    # any write makes every shard's derived bank stale
    assert not t._coarse_stale and len(t._coarse_banks) == S
    new = t.add(x[:8] + 0.001)
    assert t._coarse_stale
    _, ids = t.search(x[0] + 0.001, 1)
    assert ids[0] in (new[0], gids[0])
    t.remove(gids[:32])
    t.remove(new)
    _, ids = t.search(x[:16], 1)
    assert not set(ids[:, 0].tolist()) & set(gids[:32].tolist())


# -- snapshots ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_snapshots_load_in_both_directions(tmp_path, dtype):
    x = _data(3000, D, seed=11)
    j, t = _pair(dtype=dtype)
    for idx in (j, t):
        gids = idx.add(x)
        idx.remove(gids[:7])
    q = _queries(x, 32, seed=12)
    # port -> JAX and JAX -> port: the bank moves bit for bit, so the reader
    # must answer as a same-package reload of that file does, and count,
    # books and the deal's cursor carry over
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    t.save(pt)
    j.save(pj)
    t_from_j = TSharded.load(pj, n_devices=S, device="cpu")
    j_from_t = JSharded.load(pt, n_devices=S)
    t_back = TSharded.load(pt, n_devices=S, device="cpu")
    assert t_from_j.count() == j_from_t.count() == t.count() == j.count()
    assert t_from_j._rr == j._rr and j_from_t._rr == t._rr
    _books_equal(j, t_from_j)
    _books_equal(j_from_t, t)
    td, ti = t.search(q, 5)
    bd, bi = t_back.search(q, 5)
    np.testing.assert_array_equal(bi, ti)
    np.testing.assert_array_equal(bd, td)
    # across packages the scorers differ (XLA scan against B1's plain
    # version), so compare top-1 and distances
    xd, xi = j_from_t.search(q, 5)
    assert (xi[:, 0] == ti[:, 0]).mean() >= 0.95
    np.testing.assert_allclose(xd[:, 0], td[:, 0], atol=2e-2 if dtype != "float32" else 1e-4)
    yd, yi = t_from_j.search(q, 5)
    jd, ji = j.search(q, 5)
    assert (yi[:, 0] == ji[:, 0]).mean() >= 0.95
    # a loaded index keeps ingesting with the same gids as the other package
    np.testing.assert_array_equal(t_from_j.add(x[:16]), j.add(x[:16]))
    np.testing.assert_array_equal(j_from_t.add(x[:16]), t.add(x[:16]))


def test_snapshot_with_another_shard_count_is_refused_like_jax(tmp_path):
    _, t = _pair()
    t.add(_data(200, D, seed=13))
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
    from vector_store_tpu_torch.core.ivf import IvfIndex

    single = IvfIndex(IndexParams(dimensions=D), cluster_min=CLUSTER_MIN, device="cpu")
    single.add(_data(10, D))
    single.save(p)
    with pytest.raises(ValueError, match="not a sharded ivf snapshot"):
        TSharded.load(p, device="cpu")

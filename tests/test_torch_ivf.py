"""vector_store_tpu_torch IvfIndex against the JAX IvfIndex, on the CPU.

Both indexes take the same numpy data through staging, a recluster and
clustered adds.  Ids and counts must match exactly.  Search results are
compared by recall against a float64 numpy oracle: the JAX package serves
CPU queries from its XLA scan (bf16 scoring, approximate selection at
scale) while the port runs its kernels' plain versions (f32 scoring), so
the bar is recall within 0.02 of JAX, >= 0.9 mean overlap and the same
top-1 id.
"""

import copy
import functools

import numpy as np
import pytest
import torch

from vector_store_tpu.core import ivf as jivf
from vector_store_tpu.types import IndexParams as JIndexParams
from vector_store_tpu_torch import IndexParams
from vector_store_tpu_torch.core import ivf as tivf

D = 64


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _clustered(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, d)).astype(np.float32)
    return centers[rng.integers(0, 64, n)] + 0.3 * rng.normal(size=(n, d)).astype(
        np.float32
    )


def _oracle(x, live, q, space, k):
    """Exact top-k ids over the raw float64 rows; dead rows excluded."""
    x, q = x.astype(np.float64), q.astype(np.float64)
    if space == "cosine":
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = -q @ x.T
    elif space == "dot":
        d = -q @ x.T
    else:
        d = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2 * q @ x.T
    d[:, ~live] = np.inf
    return np.argsort(d, axis=1)[:, :k]


def _recall(got, want):
    return np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)])


@functools.lru_cache(maxsize=None)
def _built(dtype, space):
    """JAX and port indexes fed the same adds and removes."""
    x = _clustered(8000, D, seed=2)
    jx = jivf.IvfIndex(JIndexParams(dimensions=D, space=space, dtype=dtype), cluster_min=4000)
    tx = tivf.IvfIndex(IndexParams(dimensions=D, space=space, dtype=dtype), cluster_min=4000, device="cpu")
    ids = []
    for lo, hi in ((0, 6000), (6000, 8000)):  # staging + recluster, clustered
        a, b = jx.add(x[lo:hi]), tx.add(x[lo:hi])
        assert a.tolist() == b.tolist()
        ids.append(b)
    ids = np.concatenate(ids)
    dead = ids[::9]
    jx.remove(dead)
    tx.remove(dead)
    live = np.ones(len(x), bool)
    live[dead] = False
    return jx, tx, x, live


def test_plan_placement_matches_jax():
    rng = np.random.default_rng(0)
    cids = np.stack([rng.permutation(20)[:4] for _ in range(600)])
    used = rng.integers(0, 40, 20)
    free = {c: sorted(rng.choice(40, 3, replace=False).tolist()) for c in range(0, 20, 3)}
    used_j, used_t = used.copy(), used.copy()
    free_j, free_t = copy.deepcopy(free), copy.deepcopy(free)
    want = jivf.plan_placement(cids, used_j, 40, free_j)
    got = tivf.plan_placement(cids, used_t, 40, free_t)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(used_t, used_j)
    assert free_t == free_j
    assert got[2].any() and not got[2].all()  # the cascade and the overflow both ran


def test_add_remove_ids_and_count_match_jax():
    jx, tx, x, live = _built("int8", "cosine")
    assert tx._clustered and jx._clustered
    assert tx.count() == jx.count() == int(live.sum())
    assert tx.n_clusters == jx.n_clusters
    assert tx._next_rowid == jx._next_rowid
    # every live row sits in exactly one slot, and the device mirrors agree
    live_ids = np.sort(tx._rowid_h[tx._valid_h])
    np.testing.assert_array_equal(live_ids, np.flatnonzero(live))
    st = tx.state
    assert (st.valid.numpy() == tx._valid_h).all()
    assert (st.rowid.numpy()[tx._valid_h] == tx._rowid_h[tx._valid_h]).all()


@pytest.mark.parametrize(
    "dtype,space", [("int8", "cosine"), ("bfloat16", "l2"), ("float32", "dot")]
)
def test_recall_matches_jax(dtype, space):
    jx, tx, x, live = _built(dtype, space)
    rng = np.random.default_rng(5)
    qi = rng.choice(np.flatnonzero(live), 64, replace=False)
    q = x[qi] + 0.05 * rng.normal(size=(64, D)).astype(np.float32)
    gt = _oracle(x, live, q, space, 10)
    _, rj = jx.search(q, 10)
    dt, rt = tx.search(q, 10)
    assert dt.shape == (64, 10) and np.isfinite(dt).all()
    assert (np.diff(dt, axis=1) >= 0).all()
    rec_j, rec_t = _recall(rj, gt), _recall(rt, gt)
    assert rec_t >= rec_j - 0.02, (rec_t, rec_j)
    assert _recall(rt, rj) >= 0.9
    assert (rt[:, 0] == rj[:, 0]).all()


@pytest.mark.parametrize("k", [10, 50])
def test_tombstones_never_return(k):
    _, tx, x, live = _built("int8", "cosine")
    _, ids = tx.search(x[:40], k)
    got = ids[ids >= 0]
    assert len(got) and live[got].all()


def test_large_k_takes_the_pool_path(monkeypatch):
    """k <= FUSED_MAX_K goes through B1, larger k through B2 + top-k."""
    _, tx, x, _ = _built("int8", "cosine")
    calls = []
    for name in ("search_clustered_fused", "search_clustered_pool"):
        fn = getattr(tivf, name)
        monkeypatch.setattr(
            tivf, name, lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw)
        )
    d32, i32 = tx.search(x[:4], tivf.FUSED_MAX_K)
    d40, i40 = tx.search(x[:4], tivf.FUSED_MAX_K + 8)
    assert calls == ["search_clustered_fused", "search_clustered_pool"]
    np.testing.assert_array_equal(i40[:, :10], i32[:, :10])
    np.testing.assert_allclose(d40[:, : tivf.FUSED_MAX_K], d32, atol=1e-5)


def test_staging_search_matches_jax():
    """Before the first recluster both serve the exact full-bank scan.

    On one (JAX-built) bank, search_flat must agree to atol 1e-4, ids equal
    where distances are separated.  Index against index, the banks differ
    where normalisation rounded an int8 code the other way (ingest
    quantizes the same bf16 rows, but XLA fuses the normalisation), which
    moves a cosine distance by at most one code step, 1/127."""
    x = _clustered(1500, D, seed=4)
    jx = jivf.IvfIndex(JIndexParams(dimensions=D, space="cosine", dtype="int8"), cluster_min=4000)
    tx = tivf.IvfIndex(IndexParams(dimensions=D, space="cosine", dtype="int8"), cluster_min=4000, device="cpu")
    jx.add(x)
    tx.add(x)
    assert not tx._clustered
    q = x[:32] + 0.05 * np.random.default_rng(1).normal(size=(32, D)).astype(np.float32)

    dj, rj = (np.asarray(a) for a in jivf.search_flat(jx.state, q, "cosine", 10, approx=False))
    ds, rs = tivf.search_flat(
        tivf.state_from_numpy(jx.state, "cpu"), torch.from_numpy(q), "cosine", 10
    )
    np.testing.assert_allclose(ds.numpy(), dj, atol=1e-4)
    sep = np.ones(dj.shape, bool)
    sep[:, 1:] &= np.diff(dj, axis=1) > 1e-4
    sep[:, :-1] &= np.diff(dj, axis=1) > 1e-4
    np.testing.assert_array_equal(rs.numpy()[sep], rj[sep])

    dj, rj = jx.search(q, 10)
    dt, rt = tx.search(q, 10)
    np.testing.assert_allclose(dt, dj, atol=1 / 127)
    assert _recall(rt, rj) >= 0.9
    assert (rt[:, 0] == rj[:, 0]).all()


def test_compact_keeps_ids_and_results():
    x = _clustered(9000, D, seed=7)
    tx = tivf.IvfIndex(IndexParams(dimensions=D, dtype="int8"), cluster_min=4000, device="cpu")
    ids = tx.add(x[:5000])
    tx.remove(ids[:2500])  # churn: free slots, then spilled inserts refill
    more = tx.add(x[5000:])
    n = tx.count()
    assert tx.compact(full=False) == {}
    assert tx.count() == n
    _, got = tx.search(x[5000:5016], 1)
    assert (got[:, 0] == more[:16]).all()
    assert tx.compact(full=True) == {}
    assert tx.count() == n and not tx._free
    _, got = tx.search(x[5000:5016], 1)
    assert (got[:, 0] == more[:16]).all()


def test_scan_path_sends_pools_that_do_not_fit_to_b2():
    """B1 has no pool in shared memory: every k <= FUSED_MAX_K batch goes to
    it whatever the bucket size or probe count (a 4,096-row bucket at 16
    probes included); a larger k, or more dims than a B1 block's shared
    memory takes (ivf_cuda.FUSED_MAX_DIMS), goes to B2 + one top-k."""
    from vector_store_tpu_torch.core import ivf_cuda

    assert tivf.scan_path(10, 768) == "fused"
    assert tivf.scan_path(tivf.FUSED_MAX_K, 768) == "fused"
    assert tivf.scan_path(tivf.FUSED_MAX_K + 1, 768) == "pool"
    assert tivf.scan_path(10, ivf_cuda.FUSED_MAX_DIMS) == "fused"  # exactly the limit
    assert tivf.scan_path(10, ivf_cuda.FUSED_MAX_DIMS + 1) == "pool"


def test_search_takes_b2_when_b1_pool_does_not_fit(monkeypatch):
    """The IvfIndex asks scan_path: over B1's dims limit the same query
    batch is served by B2 with the same answers."""
    from vector_store_tpu_torch.core import ivf_cuda

    _, tx, x, _ = _built("int8", "cosine")
    d_b1, i_b1 = tx.search(x[:16], 10)
    calls = []
    for name in ("search_clustered_fused", "search_clustered_pool"):
        fn = getattr(tivf, name)
        monkeypatch.setattr(
            tivf, name, lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw)
        )
    monkeypatch.setattr(ivf_cuda, "FUSED_MAX_DIMS", D - 1)
    d_b2, i_b2 = tx.search(x[:16], 10)
    assert calls == ["search_clustered_pool"]
    np.testing.assert_allclose(d_b2, d_b1, atol=1e-6)
    assert (i_b2[:, 0] == i_b1[:, 0]).all()
    assert _recall(i_b2, i_b1) >= 0.95


def _fresh_ivf_module(package: str):
    """A second copy of `<package>.core.ivf`, executed now: its module-level
    constants read the environment as it stands, and the copy the other
    tests use is left alone."""
    import importlib
    import importlib.util
    import sys

    base = importlib.import_module(package + ".core.ivf")
    spec = importlib.util.spec_from_file_location(package + ".core._ivf_env_copy", base.__file__)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        del sys.modules[spec.name]
    return mod


def test_grow_cap_reads_the_environment_like_jax(monkeypatch):
    """VST_IVF_GROW_MAX_GB set low: both packages stop doubling the bank
    and send a hot cluster's overflow to the emptiest clusters, from the
    same row on (the JAX case: tests/test_ivf.py::
    test_overflow_places_instead_of_growing)."""
    monkeypatch.setenv("VST_IVF_GROW_MAX_GB", "1e-9")
    rng = np.random.default_rng(9)
    d = 16
    base = rng.normal(size=(256, d)).astype(np.float32)
    out = {}
    for package, params, kw in (
        ("vector_store_tpu_torch", IndexParams, {"device": "cpu"}),
        ("vector_store_tpu", JIndexParams, {}),
    ):
        mod = _fresh_ivf_module(package)
        assert mod.GROW_BYTES_MAX == int(1e-9 * (1 << 30))
        overflow = []  # per call: the rows of the add() chunk that found no room
        place = mod.IvfIndex._place_overflow

        def recording(ks, poss, unplaced, used, bucket, _place=place, _log=overflow):
            _log.append(np.flatnonzero(unplaced).tolist())
            return _place(ks, poss, unplaced, used, bucket)

        mod.IvfIndex._place_overflow = staticmethod(recording)
        idx = mod.IvfIndex(
            params(dimensions=d, space="cosine"),
            cluster_min=256,
            initial_capacity=256,
            reserve_rows=4096,  # no doubling recluster, which would re-home the overflow
            **kw,
        )
        idx.add(base)
        b0 = idx.state.bucket
        # every new row wants the same cluster; more than its SPILL choices hold
        hot = np.tile(base[:1], (b0 * 6, 1)) + 0.001 * np.random.default_rng(10).normal(
            size=(b0 * 6, d)
        ).astype(np.float32)
        idx.add(hot)
        assert idx.state.bucket == b0 and idx.count() == 256 + b0 * 6
        _, ids = idx.search(hot[-4:], 1, probes=idx.n_clusters)
        assert (ids[:, 0] >= 0).all()
        out[package] = (b0, overflow, len(idx._dirty))
    assert out["vector_store_tpu_torch"] == out["vector_store_tpu"]
    assert out["vector_store_tpu"][1] and out["vector_store_tpu"][1][0]
    # unset, the cap is the JAX package's default in both
    monkeypatch.delenv("VST_IVF_GROW_MAX_GB")
    assert _fresh_ivf_module("vector_store_tpu_torch").GROW_BYTES_MAX == jivf.GROW_BYTES_MAX == 4 << 30


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_skewed_ingest_recalls_like_jax(dtype):
    """The big-bucket case at a small scale: n corpus rows (one recluster),
    then m near-copies of one row (noise 0.01), which grow its bucket.
    Against the exact f64 oracle both packages recall the same (within
    0.02): the f32 banks lose nothing to spill or growth, and an int8 bank
    cannot rank rows that differ by less than its quantization step, in
    either package.  So the recall that chip_smoke's big bucket shows is a
    property of the data and the int8 codes, not of the port."""
    from vector_store_tpu_torch.probes import data

    n, m = 6000, 1500
    corpus = data.make_corpus(n, D, 42)
    skew = corpus[0] + 0.01 * np.random.default_rng([42, 3]).standard_normal((m, D), dtype=np.float32)
    x = np.concatenate([corpus, skew])
    q = np.concatenate([corpus[:128], skew[:128]])
    truth = _oracle(x, np.ones(len(x), bool), q, "cosine", 10)
    recall = {}
    for name, mod, params, kw in (
        ("jax", jivf, JIndexParams, {}),
        ("torch", tivf, IndexParams, {"device": "cpu"}),
    ):
        idx = mod.IvfIndex(params(dimensions=D, space="cosine", dtype=dtype), cluster_min=4000, **kw)
        idx.add(corpus)
        b0 = idx.state.bucket
        idx.add(skew)
        assert idx.state.bucket > b0 and idx.count() == n + m
        _, ids = idx.search(q, 10, probes=16)
        recall[name] = (_recall(ids[:128], truth[:128]), _recall(ids[128:], truth[128:]))
    for half in (0, 1):
        assert abs(recall["torch"][half] - recall["jax"][half]) <= 0.02, recall
    assert recall["torch"][0] >= 0.9
    if dtype == "float32":
        assert min(recall["torch"]) >= 0.98, recall
    else:
        assert recall["torch"][1] < 0.5 and recall["jax"][1] < 0.5, recall


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_recluster_through_host_equals_on_device(dtype, monkeypatch):
    """With the host-permute threshold forced low, a recluster pulls the old
    bank down, frees it, gathers on the host and uploads: the same state,
    tensor for tensor and mirror for mirror, as the on-device permute of
    the same rows (adds, removes, the first clustering and a compact)."""
    x = _clustered(5000, D, seed=11)
    params = IndexParams(dimensions=D, space="cosine", dtype=dtype)
    calls = []
    real = tivf.permute_via_host

    def spy(box, centroids, perm):
        calls.append(len(box))
        out = real(box, centroids, perm)
        assert box == []  # the old bank was dropped before the upload
        return out

    monkeypatch.setattr(tivf, "permute_via_host", spy)
    built = []
    for limit in (None, 0):
        monkeypatch.setattr(tivf, "HOST_PERMUTE_BYTES", limit)
        idx = tivf.IvfIndex(params, cluster_min=3000, device="cpu")
        ids = idx.add(x[:2500])
        idx.remove(ids[::7])
        idx.add(x[2500:])  # crosses cluster_min: the first clustering
        idx.remove(ids[1::11])
        idx.compact(full=True)  # a second recluster, with tombstones and free slots
        built.append(idx)
    on_device, via_host = built
    assert calls == [1, 1]  # only the forced index went through the host, twice
    assert via_host._clustered and via_host.count() == on_device.count()
    for f in tivf._FIELDS:
        a, b = getattr(on_device.state, f), getattr(via_host.state, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    for m in ("_n_used", "_valid_h", "_rowid_h", "_loc"):
        np.testing.assert_array_equal(getattr(on_device, m), getattr(via_host, m), err_msg=m)
    assert on_device._free == via_host._free and on_device._dirty == via_host._dirty
    q = x[:32] + 0.01
    (d0, i0), (d1, i1) = on_device.search(q, 10), via_host.search(q, 10)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)


def test_host_permute_rule_never_fires_on_the_cpu_unless_forced(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.setattr(tivf, "HOST_PERMUTE_BYTES", None)
    assert not tivf.permute_through_host(cpu, 1 << 40, 1 << 40, 1 << 30)
    monkeypatch.setattr(tivf, "HOST_PERMUTE_BYTES", 1000)
    assert tivf.permute_through_host(cpu, 600, 600, 10)
    assert not tivf.permute_through_host(cpu, 400, 600, 10)

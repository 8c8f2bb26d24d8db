"""The port's two-stage IVF scan (int4 coarse probe + int8 rescore) against
the JAX package's, on the CPU.

`derive_coarse`/`update_coarse` must give the JAX package's packed bank
bit for bit.  On one JAX-built index state carried over with
`state_from_numpy`, the port's `search_two_stage` must match JAX's
`fused=False` branch: distances within 1e-5 (cosine: the rescore's f32
sums of bf16 products, in another order; l2 subtracts norms of ~300, so
its bound is 2e-6 of |q|^2 + |x|^2, a few f32 ulps of those terms) and
top-10 ids equal where separated.
The port's coarse pool is B2's packed mode in f32 where the JAX XLA branch
rounds the dequantized int4 rows to bf16 first; cand is wide enough here
that the survivors' top-10 is the same.  The IvfIndex tests follow
tests/test_two_stage.py: recall through the coarse tier tracks the
single-stage scan, and the coarse cache follows add, remove, reassign,
recluster and bank growth.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_store_tpu.core import ivf as jivf
from vector_store_tpu.core import quantize as jquant
from vector_store_tpu.types import IndexParams as JIndexParams
from vector_store_tpu_torch import IndexParams
from vector_store_tpu_torch.core import ivf as tivf

D = 128
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _clustered(n, d, seed, n_clusters=64):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    return centers[rng.integers(0, n_clusters, n)] + 0.3 * rng.normal(size=(n, d)).astype(
        np.float32
    )


def _recall(ids, exact):
    return np.mean([len(set(i) & set(e)) / len(e) for i, e in zip(ids, exact)])


@functools.lru_cache(maxsize=None)
def _jax_index(space):
    x = _clustered(6000, D, seed=3)
    idx = jivf.IvfIndex(
        JIndexParams(dimensions=D, space=space, dtype="int8"), cluster_min=4000, coarse=True
    )
    ids = idx.add(x)
    idx.remove(ids[5:400:7])  # tombstones pool as INF
    return idx, x


def test_derive_and_update_coarse_match_jax():
    rng = np.random.default_rng(1)
    vec = rng.integers(-127, 128, size=(256, 8, D), dtype=np.int8)
    want = np.asarray(jivf.derive_coarse(jnp.asarray(vec)))
    got = tivf.derive_coarse(torch.from_numpy(vec))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (256, 8, D // 2)
    np.testing.assert_array_equal(got.numpy(), want)

    vec2 = vec.copy()
    ks = np.array([0, 7, 131, 255])
    vec2[ks] = rng.integers(-127, 128, size=(len(ks), 8, D), dtype=np.int8)
    tivf.update_coarse(got, torch.from_numpy(vec2), torch.from_numpy(ks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jquant.pack_int4_from_int8(vec2)))


@pytest.mark.parametrize("space,probes", [("cosine", 8), ("cosine", 3), ("l2", 4)])
def test_search_two_stage_matches_jax(space, probes):
    jx, x = _jax_index(space)
    st = jx.state
    coarse = jx._refresh_coarse_locked()
    rng = np.random.default_rng(4)
    q = x[rng.choice(len(x), 24, replace=False)] + 0.05 * rng.normal(size=(24, D)).astype(
        np.float32
    )
    cand = 160
    jd, jr = (
        np.asarray(a)
        for a in jivf.search_two_stage(
            st, coarse, jnp.asarray(q), space, 10, probes, cand, fused=False
        )
    )
    ts = tivf.state_from_numpy(st, "cpu")
    tc = tivf.from_numpy(coarse, "cpu")
    tq = torch.from_numpy(q)
    pd, pr = (t.numpy() for t in tivf.search_two_stage(ts, tc, tq, space, 10, probes, cand))
    assert np.isfinite(jd).all() and np.isfinite(pd).all()
    tol = ATOL
    if space == "l2":
        rows = np.asarray(st.vectors, np.float32) * np.asarray(st.scales)[..., None]
        tol = 2e-6 * float((q * q).sum(1).max() + (rows * rows).sum(-1).max())
    np.testing.assert_allclose(pd, jd, atol=tol, rtol=0)
    gap = np.diff(jd, axis=1)
    sep = np.ones(jd.shape, bool)
    sep[:, 1:] &= gap > tol
    sep[:, :-1] &= gap > tol
    sep[:, -1] = False
    assert sep.any()
    np.testing.assert_array_equal(pr[sep], jr[sep])
    live = set(np.asarray(st.rowid)[np.asarray(st.valid)].tolist())
    assert set(pr.reshape(-1).tolist()) <= live  # tombstones never surface


@pytest.mark.parametrize("space", ["cosine", "l2"])
def test_two_stage_recall_close_to_single_stage(space):
    """Recall through the coarse tier tracks the single-stage int8 scan."""
    x = _clustered(6000, D, seed=5)
    rng = np.random.default_rng(9)
    q = x[:64] + 0.05 * rng.normal(size=(64, D)).astype(np.float32)
    params = IndexParams(dimensions=D, space=space, dtype="int8")
    base = tivf.IvfIndex(params, cluster_min=4000, coarse=False, device="cpu")
    two = tivf.IvfIndex(params, cluster_min=4000, coarse=True, rescore=16, device="cpu")
    base.add(x)
    two.add(x)
    assert two.coarse and two._clustered and not base.coarse
    _, exact = base.exact_search(q, 10)
    _, ids_base = base.search(q, 10, probes=16)
    _, ids_two = two.search(q, 10, probes=16)
    r_base, r_two = _recall(ids_base, exact), _recall(ids_two, exact)
    assert r_two >= r_base - 0.02, (r_two, r_base)
    assert r_two >= 0.9


def test_coarse_cache_tracks_mutations():
    """After every kind of mutation the cached coarse bank equals a fresh
    derive: clustered adds and reassigns mark clusters dirty (repacked in
    place), removes need nothing, reclusters and bank growth re-derive."""
    x = _clustered(9000, D, seed=11)
    idx = tivf.IvfIndex(
        IndexParams(dimensions=D, space="cosine", dtype="int8"),
        cluster_min=4000,
        coarse=True,
        device="cpu",
    )

    def fresh():
        return tivf.derive_coarse(idx.state.vectors)

    ids = idx.add(x[:5000])
    idx._refresh_coarse_locked()  # derived now; later writes go dirty
    assert not idx._coarse_stale and not idx._coarse_dirty
    idx.add(x[5000:5200])  # clustered inserts
    assert idx._coarse_dirty
    assert torch.equal(idx._refresh_coarse_locked(), fresh())
    assert not idx._coarse_dirty
    _, got = idx.search(x[5100], 1, probes=16)
    assert got[0] == 5100

    idx.remove(ids[:2500])  # tombstones: validity is read live
    assert not idx._coarse_dirty
    # 300 near-copies of one row fill its first-choice cluster and spill;
    # freeing that cluster lets the reassign move the spilled rows back
    dup = idx.add(x[0] + 0.01 * np.random.default_rng(0).normal(size=(300, D)).astype(np.float32))
    idx._refresh_coarse_locked()
    k0 = idx._loc[dup, 0]
    idx.remove(dup[k0 == np.bincount(k0).argmax()])
    loc = idx._loc.copy()
    idx.compact(full=False)  # reassign spilled rows
    assert (idx._loc != loc).any() and idx._coarse_dirty
    assert torch.equal(idx._refresh_coarse_locked(), fresh())
    _, got = idx.search(x[5100:5116], 1)
    assert (got[:, 0] == np.arange(5100, 5116)).all()

    idx.compact(full=True)  # recluster: the whole bank permuted
    assert idx._coarse_stale and idx._coarse_bank is None
    assert torch.equal(idx._refresh_coarse_locked(), fresh())

    idx.grow_bucket()  # bank shape changed
    assert idx._coarse_stale and idx._coarse_bank is None
    assert tuple(idx._refresh_coarse_locked().shape) == (
        idx.n_clusters, idx.state.bucket, D // 2
    )


def test_coarse_switch_and_dispatch(monkeypatch):
    """VST_IVF_COARSE=1 opts in, =0 vetoes; int8 banks with even D only.
    A clustered coarse index serves through search_two_stage with
    cand = min(max(rescore * k, 64), min(probes, K) * bucket)."""
    p8 = IndexParams(dimensions=D, space="cosine", dtype="int8")
    monkeypatch.setenv("VST_IVF_COARSE", "1")
    assert tivf.IvfIndex(p8, device="cpu").coarse
    assert not tivf.IvfIndex(IndexParams(dimensions=D, dtype="float32"), device="cpu").coarse
    assert not tivf.IvfIndex(IndexParams(dimensions=D - 1, dtype="int8"), device="cpu").coarse
    monkeypatch.setenv("VST_IVF_COARSE", "0")
    assert not tivf.IvfIndex(p8, coarse=True, device="cpu").coarse
    monkeypatch.delenv("VST_IVF_COARSE")
    assert not tivf.IvfIndex(p8, device="cpu").coarse

    idx = tivf.IvfIndex(p8, cluster_min=4000, coarse=True, rescore=4, device="cpu")
    x = _clustered(4500, D, seed=2)
    idx.add(x)
    calls = []
    real = tivf.search_two_stage
    monkeypatch.setattr(
        tivf, "search_two_stage", lambda *a, **kw: calls.append(a[6]) or real(*a, **kw)
    )
    _, ids = idx.search(x[:3], 10, probes=2)
    _, big = idx.search(x[:3], 40, probes=2)
    assert calls == [64, min(160, 2 * idx.state.bucket)]
    assert (ids[:, 0] == np.arange(3)).all() and (big[:, 0] == np.arange(3)).all()

"""The port's graph backend against the JAX package on the CPU.

A JAX SlotIndex builds a 2,500 x 128 graph at capacity 4,096; its state is
carried into the port with `state_from_numpy` and both packages run the
same step on it:

  * search_impl: ids equal wherever neighbouring distances differ by more
    than 1e-5, distances within 1e-5 (f32), against the JAX fused path in
    Pallas interpret mode, which scores like kernel B3; and top-10 overlap
    >= 0.9 against the XLA path for int8 (it scores in bf16);
  * insert_impl, refine_block_impl, delete_impl: neighbour sets equal on
    >= 99% of rows (f32 sums in another order may swap a near tie);
  * the centroid router (build_router, ring_assign, routed entries) with
    ROUTE_MIN_ROWS lowered;
  * bruteforce.search: exact ids;
  * SlotIndex end to end: self-lookup, recall within 0.02 of JAX's, and
    compaction's remap.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_store_tpu.core import build as jbuild
from vector_store_tpu.core import bruteforce as jbrute
from vector_store_tpu.core import cluster as jcluster
from vector_store_tpu.core import index as jindex
from vector_store_tpu.core import search as jsearch
from vector_store_tpu.types import IndexParams as JIndexParams
from vector_store_tpu_torch import IndexParams
from vector_store_tpu_torch.core import build as tbuild
from vector_store_tpu_torch.core import bruteforce as tbrute
from vector_store_tpu_torch.core import cluster as tcluster
from vector_store_tpu_torch.core import graph as tgraph
from vector_store_tpu_torch.core import index as tindex
from vector_store_tpu_torch.core import search as tsearch
from vector_store_tpu_torch.core.graph import GraphConfig

N, D, CAP = 2500, 128, 4096
TOL = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(n=N, seed=4):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _queries(x, q=16, seed=9, noise=0.05):
    rng = np.random.default_rng(seed)
    qi = rng.choice(len(x), q, replace=False)
    return qi, x[qi] + noise * rng.normal(size=(q, D)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_index(dtype: str, space: str = "cosine"):
    idx = jindex.SlotIndex(
        JIndexParams(dimensions=D, space=space, dtype=dtype), initial_capacity=CAP
    )
    idx.add(_data())
    return idx


def _port_cfg(jcfg) -> GraphConfig:
    d = dataclasses.asdict(jcfg)
    d.pop("fused_gather")
    return GraphConfig(**d)


def _port_state(jstate):
    return tgraph.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")


def _separated_equal(d_ref, i_ref, i_got):
    """Share of positions with equal ids where the reference distance
    differs from both neighbours by more than TOL (the rest are near ties
    that f32 sums in another order may swap)."""
    left = np.full_like(d_ref, np.inf)
    right = np.full_like(d_ref, np.inf)
    with np.errstate(invalid="ignore"):  # inf - inf past the last hit
        left[:, 1:] = right[:, :-1] = np.diff(d_ref, axis=1)
    sep = (left > TOL) & (right > TOL) & np.isfinite(d_ref)
    assert sep.sum() > 0
    return float((i_ref[sep] == i_got[sep]).mean())


def _nbr_sets_equal(a, b, rows):
    return float(np.mean([set(a[r].tolist()) == set(b[r].tolist()) for r in range(rows)]))


def test_state_round_trip():
    j = _jax_index("bfloat16")
    ts = _port_state(j.state)
    back = tgraph.state_to_numpy(ts)
    for f in ("neighbors", "nbr_dist", "valid", "size", "frontier", "route_members"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(j.state, f)))
    np.testing.assert_array_equal(back["vectors"], np.asarray(j.state.vectors.astype(jnp.float32)))
    assert ts.vectors.dtype == torch.bfloat16 and ts.capacity == j.capacity


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_search_matches_jax_fused_path(monkeypatch, dtype):
    """The port's beam search equals the JAX fused-gather search (the path
    kernel B3 replaces) on the same graph."""
    monkeypatch.setenv("VST_PALLAS_INTERPRET", "1")
    j = _jax_index(dtype)
    _, q = _queries(_data())
    jd, ji = jsearch.search_impl(
        j.state, jnp.asarray(q), dataclasses.replace(j.cfg, fused_gather=True), 10
    )
    td, ti = tsearch.search_impl(_port_state(j.state), torch.from_numpy(q), _port_cfg(j.cfg), 10)
    jd, ji = np.asarray(jd), np.asarray(ji)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td.numpy()), fin)
    assert np.abs(td.numpy()[fin] - jd[fin]).max() <= TOL
    assert _separated_equal(jd, ji, ti.numpy()) == 1.0


def test_search_int8_tracks_jax_xla_path():
    """The XLA path scores int8 rows dequantised to bf16; B3 scores in f32.
    The neighbourhoods agree, and self-lookups hit."""
    j = _jax_index("int8")
    qi, q = _queries(_data(), q=32, noise=0.01)
    _, ji = jsearch.search_impl(j.state, jnp.asarray(q), j.cfg, 10)
    _, ti = tsearch.search_impl(_port_state(j.state), torch.from_numpy(q), _port_cfg(j.cfg), 10)
    ji, ti = np.asarray(ji), ti.numpy()
    overlap = np.mean([len(set(ji[r]) & set(ti[r])) / 10 for r in range(len(q))])
    assert overlap >= 0.9, overlap
    assert (ti[:, 0] == qi).all()


def test_insert_block_matches_jax():
    """One padded insert block (200 live lanes of 256) on the same graph."""
    j = _jax_index("float32")
    blk = _data(256, seed=12)
    live = np.arange(256) < 200
    js = jbuild.insert(
        jax.tree.map(jnp.array, j.state), jnp.int32(N), jnp.asarray(blk), jnp.asarray(live), j.cfg
    )
    ts = _port_state(j.state)
    out = tbuild.insert_impl(ts, N, torch.from_numpy(blk), torch.from_numpy(live), _port_cfg(j.cfg))
    assert out is ts
    assert int(ts.frontier) == int(js.frontier) == N + 200
    assert int(ts.size) == int(js.size) == N + 200
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_allclose(ts.vectors.numpy(), np.asarray(js.vectors), rtol=0, atol=1e-6)
    assert _nbr_sets_equal(np.asarray(js.neighbors), ts.neighbors.numpy(), N + 200) >= 0.99


def test_refine_block_matches_jax():
    j = _jax_index("float32")
    js = jbuild.refine_block(jax.tree.map(jnp.array, j.state), jnp.int32(256), 256, j.cfg)
    ts = _port_state(j.state)
    tbuild.refine_block_impl(ts, 256, 256, _port_cfg(j.cfg))
    assert _nbr_sets_equal(np.asarray(js.neighbors), ts.neighbors.numpy(), N) >= 0.99


def test_delete_matches_jax():
    j = _jax_index("float32")
    slots = np.array([3, 17, 17, 2499, 0, 40], np.int32)
    live = np.array([True, True, True, True, False, True])
    js = jbuild.delete(jax.tree.map(jnp.array, j.state), jnp.asarray(slots), jnp.asarray(live))
    ts = _port_state(j.state)
    tbuild.delete_impl(ts, torch.from_numpy(slots), torch.from_numpy(live))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert int(ts.size) == int(js.size)


def test_upload_matches_jax():
    cfg = dataclasses.replace(_jax_index("int8").cfg, degree=1)
    from vector_store_tpu.core import graph as jgraph

    blk = _data(64, seed=2)
    live = np.arange(64) < 50
    js = jbuild.upload(jgraph.init(cfg, 256), jnp.int32(0), jnp.asarray(blk), jnp.asarray(live), cfg)
    ts = tgraph.init(_port_cfg(cfg), 256, "cpu")
    tbuild.upload_impl(ts, 0, torch.from_numpy(blk), torch.from_numpy(live), _port_cfg(cfg))
    assert int(ts.size) == int(js.size) == int(ts.frontier) == 50
    assert np.mean(ts.vectors.numpy() == np.asarray(js.vectors)) > 0.999
    np.testing.assert_allclose(ts.scales.numpy(), np.asarray(js.scales), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_bruteforce_matches_jax(dtype):
    j = _jax_index(dtype)
    cfg = j.cfg
    _, q = _queries(_data(), q=8)
    qp = jnp.asarray(q / np.linalg.norm(q, axis=1, keepdims=True)).astype(cfg.compute_dtype)
    scales = j.state.scales if cfg.quantized else None
    jd, ji = jbrute.search(qp, j.state.vectors, j.state.valid, "cosine", 10, chunk=1024, scales=scales)
    ts = _port_state(j.state)
    qt = torch.from_numpy(np.array(qp.astype(jnp.float32))).to(_port_cfg(cfg).compute_dtype)
    td, ti = tbrute.search(
        qt, ts.vectors, ts.valid, "cosine", 10, chunk=1024, scales=ts.scales if cfg.quantized else None
    )
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_router_build_and_routed_search_match_jax():
    """build_router at a test-scale centroid count, then a search that
    enters through the router, on the same graph."""
    j = _jax_index("float32")
    cfg = dataclasses.replace(j.cfg, route_k=64)
    jc, jm, jn = jcluster.build_router(j.state, cfg, 64, cfg.route_members_per)
    ts = _port_state(j.state)
    tcfg = _port_cfg(cfg)
    tc, tm, tn = tcluster.build_router(ts, tcfg, 64, cfg.route_members_per)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert _nbr_sets_equal(np.asarray(jm), tm.numpy(), 64) >= 0.95

    # routed search on the JAX router, carried across
    jstate = j.state._replace(route_centroids=jc, route_members=jm, route_cnt=jn)
    _, q = _queries(_data())
    jd, ji = jsearch.search_impl(jstate, jnp.asarray(q), cfg, 10)
    td, ti = tsearch.search_impl(_port_state(jstate), torch.from_numpy(q), tcfg, 10)
    assert _separated_equal(np.asarray(jd), np.asarray(ji), ti.numpy()) == 1.0


def test_slot_index_router_schedule(monkeypatch):
    """With ROUTE_MIN_ROWS lowered, add() builds the router, rebuilds it at
    the end of a bulk call, inserts keep the rings current, and routed
    search finds every row (the JAX package's test_bulk_add_ends_with_fresh_router)."""
    monkeypatch.setattr(tindex, "ROUTE_MIN_ROWS", 1024)
    monkeypatch.setattr(tcluster, "route_k_for", lambda rows: 128)
    rng = np.random.default_rng(0)
    idx = tindex.SlotIndex(IndexParams(dimensions=16, space="cosine"), initial_capacity=8192, device="cpu")
    x = rng.normal(size=(1900, 16)).astype(np.float32)
    idx.add(x[:1500])
    assert idx._route_built_at == 1500 and idx.cfg.route_k == 128
    idx.add(x[1500:1600])
    assert idx._route_built_at == 1500
    assert int(idx.state.route_cnt.sum()) == 1600  # ring-assigned at insert
    idx.add(x[1600:])
    assert idx._route_built_at == 1900
    _, ids = idx.search(x[::50], 1)
    assert (ids[:, 0] == np.arange(0, 1900, 50)).all()


@functools.lru_cache(maxsize=None)
def _pair(dtype: str):
    """JAX and port SlotIndex over the same rows and the same queries."""
    x = _data()
    j = _jax_index(dtype)
    t = tindex.SlotIndex(IndexParams(dimensions=D, space="cosine", dtype=dtype), initial_capacity=CAP, device="cpu")
    t.add(x)
    return j, t, x


def _recall(a, b):
    return float(np.mean([len(set(a[r]) & set(b[r])) / a.shape[1] for r in range(len(a))]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_index_matches_jax(dtype):
    j, t, x = _pair(dtype)
    assert t.count() == j.count() == N and t.capacity == j.capacity
    qi, q = _queries(x, q=64, noise=0.3)
    _, ids = t.search(x[qi], 1)
    assert (ids[:, 0] == qi).all()  # self-lookup
    _, jt = j.exact_search(q, 10)
    _, tt = t.exact_search(q, 10)
    assert _recall(tt, jt) == 1.0
    _, ja = j.search(q, 10)
    _, ta = t.search(q, 10)
    assert _recall(ta, tt) >= _recall(ja, jt) - 0.02
    assert _recall(ta, ja) >= 0.95


def test_slot_index_compact_remaps():
    x = _data(600, seed=21)
    t = tindex.SlotIndex(IndexParams(dimensions=D, space="l2", dtype="int8"), initial_capacity=1024, device="cpu")
    slots = t.add(x)
    dead = slots[::3]
    t.remove(dead)
    t.remove(dead[:5])  # removing twice changes nothing
    assert t.count() == 400
    remap = t.compact()
    assert t.count() == 400 and len(remap) == 400
    assert set(remap) == set(slots.tolist()) - set(dead.tolist())
    assert sorted(remap.values()) == list(range(400))
    keep = np.array(sorted(remap))
    _, ids = t.search(x[keep], 1)
    assert (ids[:, 0] == np.array([remap[s] for s in keep])).all()

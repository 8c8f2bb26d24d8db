"""IVF snapshots across the two packages, on the CPU.

A snapshot the JAX package wrote loads into the port, and one the port
wrote loads into the JAX package (same npz keys and meta JSON, format 1).
The loaded index carries the bank bit for bit (bf16 vectors travel as f32),
the count, `coarse`, `rescore`, the free lists and the host mirrors, and
it answers queries as the index that was saved: a port index reloaded by
the port returns identical results, and across packages the top-1 ids are
equal and the top-10 overlap is >= 0.9 (the JAX package serves CPU queries
from its XLA scan in bf16, the port from its kernels' plain versions in
f32).  Model: tests/test_persist.py and tests/test_two_stage.py:208.
"""

import numpy as np
import pytest
import torch

from vector_store_tpu.core import ivf as jivf
from vector_store_tpu.types import IndexParams as JIndexParams
from vector_store_tpu_torch import IndexParams
from vector_store_tpu_torch.core import ivf as tivf

D = 128
FIELDS = ("centroids", "vectors", "scales", "valid", "rowid")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(seed=13):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(64, D)).astype(np.float32)
    x = centers[rng.integers(0, 64, 6000)] + 0.3 * rng.normal(size=(6000, D)).astype(np.float32)
    q = x[:32] + 0.05 * rng.normal(size=(32, D)).astype(np.float32)
    return x, q


def _fill(idx, x):
    """Staging, a recluster, clustered adds and removes (free lists)."""
    ids = np.concatenate([idx.add(x[:4500]), idx.add(x[4500:])])
    idx.remove(ids[::11])
    return idx


def _params(dtype, cls=IndexParams):
    return cls(dimensions=D, space="cosine", dtype=dtype)


def _jax_arrays(st):
    out = {}
    for f in FIELDS:
        a = np.asarray(getattr(st, f))
        out[f] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return out


def _assert_same_index(a, b):
    """Bookkeeping that decides future placement and search."""
    assert a.count() == b.count() and a.coarse == b.coarse and a.rescore == b.rescore
    assert a._free == b._free and a._free
    assert a._clustered == b._clustered and a._clustered_at == b._clustered_at
    assert a._next_rowid == b._next_rowid and a.probes == b.probes
    np.testing.assert_array_equal(a._n_used, b._n_used)
    np.testing.assert_array_equal(a._valid_h, b._valid_h)
    live = a._valid_h  # a load keeps no ids of dead slots
    np.testing.assert_array_equal(a._rowid_h[live], b._rowid_h[live])
    np.testing.assert_array_equal(a._loc[: a._next_rowid], b._loc[: b._next_rowid])


def _agree(got, want):
    assert (got[:, 0] == want[:, 0]).all()
    overlap = np.mean([len(set(g) & set(w)) / len(w) for g, w in zip(got, want)])
    assert overlap >= 0.9, overlap


@pytest.mark.parametrize("dtype,coarse", [("int8", True), ("bfloat16", False)])
def test_jax_snapshot_loads_into_the_port(tmp_path, dtype, coarse):
    x, q = _data()
    jx = _fill(jivf.IvfIndex(_params(dtype, JIndexParams), cluster_min=4000, coarse=coarse, rescore=16), x)
    path = str(tmp_path / "jax.npz")
    jx.save(path)
    tx = tivf.IvfIndex.load(path, device="cpu")
    assert tx.coarse == coarse and tx.rescore == 16 and tx._coarse_stale
    got = tivf.state_to_numpy(tx.state)
    for f, want in _jax_arrays(jx.state).items():
        np.testing.assert_array_equal(got[f], want)
    assert tx.state.vectors.dtype == tivf._storage_dtype(dtype)
    _assert_same_index(tx, jx)
    _, rj = jx.search(q, 10)
    _, rt = tx.search(q, 10)
    _agree(rt, rj)
    fresh = np.random.default_rng(3).normal(size=(40, D)).astype(np.float32)
    more = tx.add(fresh)  # a loaded index keeps ingesting
    _, got1 = tx.search(fresh, 1)
    assert (got1[:, 0] == more).all() and tx.count() == jx.count() + 40


@pytest.mark.parametrize("dtype,coarse", [("int8", True), ("bfloat16", False)])
def test_port_snapshot_loads_into_jax(tmp_path, dtype, coarse):
    x, q = _data(seed=17)
    tx = _fill(
        tivf.IvfIndex(_params(dtype), cluster_min=4000, coarse=coarse, rescore=16, device="cpu"),
        x,
    )
    path = str(tmp_path / "port.npz")
    tx.save(path)
    jx = jivf.IvfIndex.load(path)
    assert jx.coarse == coarse and jx.rescore == 16 and jx._coarse_stale
    want = tivf.state_to_numpy(tx.state)
    for f, got in _jax_arrays(jx.state).items():
        np.testing.assert_array_equal(got, want[f])
    assert np.asarray(jx.state.vectors).dtype.name == {"int8": "int8", "bfloat16": "bfloat16"}[dtype]
    _assert_same_index(jx, tx)
    _, rt = tx.search(q, 10)
    _, rj = jx.search(q, 10)
    _agree(rj, rt)


def test_port_round_trip_searches_identically(tmp_path):
    x, q = _data(seed=19)
    tx = _fill(tivf.IvfIndex(_params("int8"), cluster_min=4000, coarse=True, device="cpu"), x)
    d0, r0 = tx.search(q, 10, probes=8)
    path = str(tmp_path / "rt")  # the .npz suffix is added, as np.savez does
    tx.save(path)
    back = tivf.IvfIndex.load(path + ".npz", device="cpu")
    _assert_same_index(back, tx)
    d1, r1 = back.search(q, 10, probes=8)
    np.testing.assert_array_equal(r1, r0)
    np.testing.assert_array_equal(d1, d0)
    np.save(tmp_path / "not_ivf.npy", np.zeros(3))
    with pytest.raises(Exception):
        tivf.IvfIndex.load(str(tmp_path / "not_ivf.npy"), device="cpu")

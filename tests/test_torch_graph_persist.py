"""Graph snapshots of vector_store_tpu_torch (core/persist.py), on the CPU.

Modelled on tests/test_persist.py: round trips of f32, int8 and bf16 banks
and of an exact-mode index; the JAX package's snapshot loaded by the port
and the port's by the JAX package, with equal search answers (ids equal
where f32 distances stand more than 1e-5 apart; int8 and bf16 banks, whose
XLA path scores in bf16, by top-10 overlap >= 0.9); a cfg that carries the
JAX package's `fused_gather`; a snapshot from before the router; one from
before `insert_block`; and another format number.
"""

import json

import numpy as np
import pytest
import torch

from vector_store_tpu.core import SlotIndex as JaxSlotIndex
from vector_store_tpu.core import persist as jpersist
from vector_store_tpu.types import IndexParams as JIndexParams
from vector_store_tpu_torch import IndexParams
from vector_store_tpu_torch.core import persist
from vector_store_tpu_torch.core.index import SlotIndex

TOL = 1e-5
N, D, CAP = 600, 32, 2048


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(n=N, d=D, seed=7):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _queries(x, q=24, seed=8):
    rng = np.random.default_rng(seed)
    return x[rng.choice(len(x), q, replace=False)] + 0.05 * rng.normal(
        size=(q, x.shape[1])
    ).astype(np.float32)


def _port_index(dtype, space="cosine", **kw):
    idx = SlotIndex(
        IndexParams(dimensions=D, space=space, dtype=dtype), initial_capacity=CAP, device="cpu", **kw
    )
    slots = idx.add(_data())
    idx.remove(slots[:50])
    return idx


def _rewrite(src, dst, drop=(), meta_edit=None):
    """Copy a snapshot with some arrays dropped and its meta edited."""
    with np.load(src) as z:
        arrays = {k: z[k] for k in z.files if k not in drop}
    if meta_edit is not None:
        meta = json.loads(bytes(arrays["meta"]).decode())
        meta_edit(meta)
        arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(dst, **arrays)


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_round_trip(tmp_path, dtype):
    idx = _port_index(dtype, space="l2" if dtype == "float32" else "cosine")
    q = _queries(_data())
    d0, i0 = idx.search(q, 5)
    path = str(tmp_path / "snap.npz")
    persist.save(path, idx, keymap_blob={"hello": 1})
    restored, blob = persist.load(path, device="cpu")
    assert blob == {"hello": 1}
    assert restored.count() == N - 50 and restored.frontier == N
    assert restored.cfg == idx.cfg and restored.params == idx.params
    for f in ("vectors", "scales", "neighbors", "nbr_dist", "valid", "route_members"):
        assert torch.equal(getattr(restored.state, f), getattr(idx.state, f)), f
    assert restored.state.vectors.dtype == idx.state.vectors.dtype
    d1, i1 = restored.search(q, 5)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)
    with np.load(path) as z:
        # int8 at its native width, bf16 widened to f32
        assert z["vectors"].dtype == (np.int8 if dtype == "int8" else np.float32)
        assert "fused_gather" not in json.loads(bytes(z["meta"]).decode())["cfg"]
    # the restored index accepts further writes
    more = restored.add(_data(10, seed=9))
    assert restored.count() == N - 40 and more[0] == N


def test_exact_mode_keeps_its_block(tmp_path):
    idx = SlotIndex(
        IndexParams(dimensions=8, space="l2", dtype="float32"), exact=True, device="cpu"
    )
    x = _data(100, 8)
    idx.add(x)
    assert idx.insert_block >= 4096
    path = str(tmp_path / "exact.npz")
    persist.save(path, idx)
    restored, blob = persist.load(path, device="cpu")
    assert blob == {} and restored._exact is True
    assert restored.insert_block == idx.insert_block
    assert restored.search(x[7], 1)[1][0] == 7
    # a snapshot from before the insert_block field: re-derived by mode
    _rewrite(path, str(tmp_path / "old.npz"), meta_edit=lambda m: m.pop("insert_block"))
    assert persist.load(str(tmp_path / "old.npz"), device="cpu")[0].insert_block == 4096


def _overlap(a, b):
    return float(np.mean([len(set(r) & set(s)) / len(r) for r, s in zip(a.tolist(), b.tolist())]))


def _assert_same_answers(dtype, d_ref, i_ref, d_got, i_got):
    if dtype == "float32":
        np.testing.assert_allclose(d_got, d_ref, atol=TOL)
        gap = np.diff(d_ref, axis=1)
        sep = np.ones_like(d_ref, dtype=bool)
        sep[:, 1:] &= gap > TOL
        sep[:, :-1] &= gap > TOL
        assert sep.sum() > d_ref.size // 2
        np.testing.assert_array_equal(i_got[sep], i_ref[sep])
    else:
        assert _overlap(i_ref, i_got) >= 0.9


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_jax_snapshot_loads_in_the_port(tmp_path, dtype):
    j = JaxSlotIndex(JIndexParams(dimensions=D, space="cosine", dtype=dtype), initial_capacity=CAP)
    slots = j.add(_data())
    j.remove(slots[:50])
    q = _queries(_data())
    path = str(tmp_path / "jax.npz")
    jpersist.save(path, j, keymap_blob={"k": [1, 2]})
    with np.load(path) as z:  # the JAX cfg carries the field the port lacks
        assert "fused_gather" in json.loads(bytes(z["meta"]).decode())["cfg"]
    t, blob = persist.load(path, device="cpu")
    assert blob == {"k": [1, 2]}
    assert t.count() == j.count() and t.frontier == N and t.insert_block == j.insert_block
    assert t.state.vectors.dtype == {"float32": torch.float32, "int8": torch.int8,
                                     "bfloat16": torch.bfloat16}[dtype]
    np.testing.assert_array_equal(t.state.neighbors.numpy(), np.asarray(j.state.neighbors))
    jd, ji = j.search(q, 10)
    td, ti = t.search(q, 10)
    _assert_same_answers(dtype, jd, ji, td, ti)
    assert not set(ti.ravel().tolist()) & set(range(50))  # removed rows stay removed


@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
def test_port_snapshot_loads_in_jax(tmp_path, dtype):
    t = _port_index(dtype)
    q = _queries(_data())
    path = str(tmp_path / "torch.npz")
    persist.save(path, t, keymap_blob={"k": 3})
    j, blob = jpersist.load(path)
    assert blob == {"k": 3}
    assert j.count() == t.count() and j.insert_block == t.insert_block
    assert j.cfg.fused_gather is False  # set by the JAX loader for its backend
    assert j.state.vectors.dtype.name == dtype
    td, ti = t.search(q, 10)
    jd, ji = j.search(q, 10)
    _assert_same_answers(dtype, td, ti, jd, ji)
    # and the JAX index goes on from there
    assert j.add(_data(4, seed=3))[0] == N


def test_pre_router_snapshot_loads_with_flat_routing(tmp_path):
    idx = _port_index("float32")
    q = _queries(_data())
    path, old = str(tmp_path / "new.npz"), str(tmp_path / "old.npz")
    persist.save(path, idx)

    def with_router_cfg(meta):
        meta["cfg"]["route_k"] = 64  # whatever it said: no router arrays, flat routing

    _rewrite(path, old, drop=("route_centroids", "route_members", "route_cnt"),
             meta_edit=with_router_cfg)
    restored, _ = persist.load(old, device="cpu")
    assert restored.cfg.route_k == 0 and restored._route_built_at == 0
    assert restored.state.route_centroids.shape == (1, D)
    np.testing.assert_array_equal(restored.search(q, 5)[1], idx.search(q, 5)[1])


def test_cfg_with_fused_gather_and_other_format_numbers(tmp_path):
    idx = _port_index("bfloat16")
    path = str(tmp_path / "a.npz")
    persist.save(path, idx)
    fused = str(tmp_path / "fused.npz")
    _rewrite(path, fused, meta_edit=lambda m: m["cfg"].update(fused_gather=True))
    restored, _ = persist.load(fused, device="cpu")
    assert restored.cfg == idx.cfg and not hasattr(restored.cfg, "fused_gather")
    v2 = str(tmp_path / "v2.npz")
    _rewrite(path, v2, meta_edit=lambda m: m.update(format=2))
    with pytest.raises(ValueError, match="unsupported snapshot format 2"):
        persist.load(v2, device="cpu")


def test_routed_graph_round_trips_its_router(tmp_path):
    """A snapshot taken after a router build restores the router and the
    rebuild schedule (`_route_built_at`)."""
    idx = _port_index("float32")
    with idx._lock:
        idx._rebuild_router_locked(idx.frontier, 16)
    q = _queries(_data())
    path = str(tmp_path / "routed.npz")
    persist.save(path, idx)
    restored, _ = persist.load(path, device="cpu")
    assert restored.cfg.route_k == 16 and restored._route_built_at == idx.frontier
    assert torch.equal(restored.state.route_centroids, idx.state.route_centroids)
    assert torch.equal(restored.state.route_cnt, idx.state.route_cnt)
    np.testing.assert_array_equal(restored.search(q, 5)[1], idx.search(q, 5)[1])

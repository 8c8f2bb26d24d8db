"""The port's bindings of native/hnsw.cpp and native/io.cpp's key map
(vector_store_tpu_torch/utils/native.py) against the JAX package's
bindings of the same sources, on the inputs of tests/test_native.py."""

import numpy as np
import pytest

from vector_store_tpu.utils import native as jnative
from vector_store_tpu_torch.utils import native as tnative

pytestmark = pytest.mark.skipif(
    not jnative.available(), reason="the JAX package's native library is not built"
)


def test_hnsw_baseline_matches_jax_binding():
    """Same seeded rows and queries through both bindings: the same ids and
    distances (one algorithm, one source, no randomness between them beyond
    the level draw, which is seeded in the source), recall >= 0.9 against
    the exact scan, and a removed node is gone from both."""
    rng = np.random.default_rng(0)
    n, d, q, k = 3000, 32, 64, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    hs = []
    for mod in (jnative, tnative):
        h = mod.HnswBaseline(d, m=16, ef_construction=128, space="l2")
        h.add(x)
        assert len(h) == n
        hs.append(h)
    (jd, ji), (td, ti) = (h.search(queries, k, ef=128) for h in hs)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=1e-6)
    d2 = ((queries[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    exact = np.argsort(d2, axis=1)[:, :k]
    hits = sum(len(set(ti[i].tolist()) & set(exact[i].tolist())) for i in range(q))
    assert hits / (q * k) >= 0.9
    top = int(ti[0, 0])
    for h in hs:
        h.remove(top)
        assert len(h) == n - 1
        assert top not in h.search(queries[:1], k, ef=128)[1][0].tolist()


@pytest.mark.parametrize("space", ["cosine", "dot"])
def test_hnsw_baseline_spaces_match_jax_binding(space):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(800, 16)).astype(np.float32)
    out = []
    for mod in (jnative, tnative):
        h = mod.HnswBaseline(16, space=space)
        h.add(x)
        out.append(h.search(x[:16], 5))
    np.testing.assert_array_equal(out[1][1], out[0][1])
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)


def test_native_keymap_matches_jax_binding():
    """The script of tests/test_native.py::test_native_keymap through both
    bindings, step for step."""
    maps = [jnative.NativeKeyMap(), tnative.NativeKeyMap()]

    def both(fn):
        a, b = (fn(m) for m in maps)
        assert a == b
        return b

    assert both(lambda m: m.bind(100, 0)) == -1
    assert both(lambda m: m.bind(200, 1)) == -1
    assert both(lambda m: m.bind(100, 2)) == 0  # the displaced slot
    assert both(lambda m: m.slot_of(100)) == 2
    assert both(lambda m: m.key_of(1)) == 200
    assert both(lambda m: m.key_of(0)) is None
    assert both(len) == 2
    assert both(lambda m: m.unbind(200)) == 1
    assert both(lambda m: m.unbind(999)) == -1
    assert both(len) == 1
    keys = np.array([7, 8, 9], dtype=np.uint64)
    slots = np.array([10, 11, 12], dtype=np.int32)
    assert both(lambda m: m.bind_batch(keys, slots).tolist()) == [-1, -1, -1]
    assert both(lambda m: m.slot_of(8)) == 11


def test_native_keymap_random_script_matches_jax_binding():
    rng = np.random.default_rng(2)
    maps = [jnative.NativeKeyMap(), tnative.NativeKeyMap()]
    for _ in range(2000):
        key, slot = int(rng.integers(0, 300)), int(rng.integers(0, 500))
        op = rng.integers(0, 3)
        if op == 0:
            a, b = (m.bind(key, slot) for m in maps)
        elif op == 1:
            a, b = (m.unbind(key) for m in maps)
        else:
            a, b = (m.key_of(slot) for m in maps)
        assert a == b
    assert len(maps[0]) == len(maps[1])

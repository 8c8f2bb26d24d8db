"""vector_store_tpu_torch primitives against the JAX package, on the CPU.

The same numpy inputs go through the JAX function and its PyTorch port.
Tolerances: float32 distance math to rtol 1e-5 (the two libraries sum in
different orders); int8 codes may differ by one step where x/scale lands
within an ulp of a .5 boundary (at most 0.1% of entries); the int4
packing is integer arithmetic and must be bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_store_tpu.core import distance as jdist
from vector_store_tpu.core import quantize as jquant
from vector_store_tpu.core import topk as jtopk
from vector_store_tpu_torch.core import distance as tdist
from vector_store_tpu_torch.core import quantize as tquant
from vector_store_tpu_torch.core import topk as ttopk


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_normalize_and_preprocess():
    x = _data(0, 64, 128)
    x[3] = 0.0  # a zero row stays zero (eps clamp)
    want = np.asarray(jdist.normalize(jnp.asarray(x)))
    got = tdist.normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    for space in ("cosine", "l2", "dot"):
        w = np.asarray(jdist.preprocess(jnp.asarray(x), space))
        g = tdist.preprocess(torch.from_numpy(x), space).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("space", ["cosine", "l2", "dot"])
def test_pairwise_and_gathered(space):
    q = _data(1, 16, 128)
    bank = _data(2, 200, 128)
    if space == "cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    want = np.asarray(jdist.pairwise(jnp.asarray(q), jnp.asarray(bank), space))
    got = tdist.pairwise(torch.from_numpy(q), torch.from_numpy(bank), space).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    cand = bank[:160].reshape(16, 10, 128)
    want = np.asarray(jdist.gathered(jnp.asarray(q), jnp.asarray(cand), space))
    got = tdist.gathered(torch.from_numpy(q), torch.from_numpy(cand), space).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_pairwise_bf16_operands_match_preferred_f32():
    """bf16 operands multiplied in f32: the JAX route's numerics."""
    q = _data(3, 8, 128)
    c = _data(4, 300, 128)
    want = np.asarray(
        jdist.pairwise(
            jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(c).astype(jnp.bfloat16), "dot"
        )
    )
    got = tdist.pairwise(
        torch.from_numpy(q).to(torch.bfloat16),
        torch.from_numpy(c).to(torch.bfloat16),
        "dot",
    ).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_quantize_rows():
    x = _data(5, 2000, 128)
    x[7] = 0.0
    jq, js = jquant.quantize_rows(jnp.asarray(x))
    tq, ts = tquant.quantize_rows(torch.from_numpy(x))
    jq, js = np.array(jq), np.array(js)
    tq, ts = tq.numpy(), ts.numpy()
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    diff = np.abs(tq.astype(np.int32) - jq.astype(np.int32))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999
    np.testing.assert_allclose(
        tquant.dequantize_rows(torch.from_numpy(jq), torch.from_numpy(js)).numpy(),
        np.asarray(jquant.dequantize_rows(jnp.asarray(jq), jnp.asarray(js))),
        rtol=1e-6,
    )


def test_quantize_rounds_half_to_even():
    # x / scale = 127 * x / max: rows built so codes land exactly on .5
    x = np.array([[127.0, 0.5, 1.5, -2.5, 3.5]], dtype=np.float32)
    q, _ = tquant.quantize_rows(torch.from_numpy(x))
    jq, _ = jquant.quantize_rows(jnp.asarray(x))
    assert q.numpy().tolist() == np.asarray(jq).tolist() == [[127, 0, 2, -2, 4]]


def test_int4_pack_unpack_bit_exact():
    rng = np.random.default_rng(6)
    q8 = rng.integers(-127, 128, size=(3, 50, 128)).astype(np.int8)
    want = np.asarray(jquant.pack_int4_from_int8(jnp.asarray(q8)))
    got = tquant.pack_int4_from_int8(torch.from_numpy(q8)).numpy()
    assert got.dtype == np.uint8 and got.shape == (3, 50, 64)
    assert (got == want).all()
    w_codes = np.asarray(jquant.unpack_int4(jnp.asarray(want)))
    g_codes = tquant.unpack_int4(torch.from_numpy(got)).numpy()
    assert g_codes.dtype == np.int8 and (g_codes == w_codes).all()
    assert g_codes.min() >= -7 and g_codes.max() <= 7
    s = rng.random(10).astype(np.float32)
    np.testing.assert_array_equal(
        tquant.int4_scale(torch.from_numpy(s)).numpy(),
        np.asarray(jquant.int4_scale(jnp.asarray(s))),
    )


@pytest.mark.parametrize("stable", [False, True])
def test_topk_ascending(stable):
    d = _data(7, 32, 500)
    d[:, 100:120] = np.inf
    wd, wi = jtopk.topk_ascending(jnp.asarray(d), 20)
    fn = ttopk.topk_ascending_stable if stable else ttopk.topk_ascending
    gd, gi = fn(torch.from_numpy(d), 20)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    assert ttopk.SENTINEL == int(jtopk.SENTINEL)
    assert ttopk.INF == float(jtopk.INF)


def test_topk_stable_ties_to_lowest_position():
    d = torch.tensor([[3.0, 1.0, 1.0, 0.5, 1.0, np.inf]])
    _, idx = ttopk.topk_ascending_stable(d, 4)
    _, jidx = jtopk.topk_ascending(jnp.asarray(d.numpy()), 4)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[3, 1, 2, 4]]

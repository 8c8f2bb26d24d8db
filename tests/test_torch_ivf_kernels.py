"""Plain versions of the CUDA probe-scan kernels B1/B2 against the JAX
Pallas kernels, run in interpret mode on the CPU.

The bank is built by the JAX package (`init` + `place`, which normalise and
quantize) with dense, partly tombstoned buckets and some short live
prefixes, then carried into the port with `state_from_numpy`.  Distances
must agree to atol 1e-4 (float32 sums in another order); ids must be equal
wherever neighbouring distances differ by more than that.  On CPU tensors
the kernel wrappers take the plain versions, so they are checked here too;
the CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_store_tpu.core import ivf as jivf
from vector_store_tpu.core import ivf_pallas as jpl
from vector_store_tpu.core import quantize as jquant
from vector_store_tpu_torch.core import ivf as tivf
from vector_store_tpu_torch.core import ivf_cuda
from vector_store_tpu_torch.core.topk import SENTINEL

K, B, D, Q, P = 16, 256, 128, 8, 2
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _case(dtype: str):
    """(JAX state, port state, preprocessed queries, cids) for one bank."""
    rng = np.random.default_rng(11)
    fill = rng.integers(0, B + 1, K)
    fill[:4] = (B, 0, 5, 130)  # full, empty, short and odd live prefixes
    ks = np.concatenate([np.full(f, c) for c, f in enumerate(fill)])
    poss = np.concatenate([np.arange(f) for f in fill])
    rows = rng.normal(size=(len(ks), D)).astype(np.float32)
    st = jivf.init(D, K, B, dtype)
    st = jivf.place(
        st,
        jnp.asarray(rows),
        jnp.asarray(ks, dtype=jnp.int32),
        jnp.asarray(poss, dtype=jnp.int32),
        jnp.asarray(np.arange(len(ks)), dtype=jnp.int32),
        "cosine",
        dtype,
    )
    dead = rng.random(len(ks)) < 0.1
    dead[(ks == 3) & (poss >= 120)] = True  # bucket 3's prefix shrinks to 1 block
    st = jivf.unvalidate(
        st, jnp.asarray(ks[dead], dtype=jnp.int32), jnp.asarray(poss[dead], dtype=jnp.int32)
    )
    q = rng.normal(size=(Q, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    cids = np.stack([rng.permutation(K)[:P] for _ in range(Q)]).astype(np.int32)
    cids[:4, 0] = np.arange(4)  # every edge-case bucket is probed
    return st, tivf.state_from_numpy(st, "cpu"), q, cids


def _jax_inputs(st, q, cids):
    rm = jnp.where(st.valid, st.rowid, SENTINEL)
    return rm, jnp.asarray(q), jnp.asarray(cids), jpl.live_prefix_blocks(st.valid)


def _port_inputs(ts, q, cids):
    rm = torch.where(ts.valid, ts.rowid, SENTINEL)
    nsb = ivf_cuda.live_prefix_blocks(ts.valid)
    return rm, torch.from_numpy(q), torch.from_numpy(cids), nsb


def _ids_agree(d_ref, r_ref, r_got):
    """Ids equal wherever a distance is separated from its neighbours."""
    gap = np.diff(d_ref, axis=1)
    gap = np.where(np.isnan(gap), np.inf, gap)  # inf - inf
    sep = np.ones_like(d_ref, dtype=bool)
    sep[:, 1:] &= gap > ATOL
    sep[:, :-1] &= gap > ATOL
    sep[:, -1] = False  # its next neighbour is outside the list
    assert sep.any()
    np.testing.assert_array_equal(r_got[sep], r_ref[sep])


@pytest.mark.parametrize(
    "dtype,space", [("int8", "cosine"), ("bfloat16", "l2"), ("float32", "dot")]
)
def test_search_fused_matches_pallas(dtype, space):
    st, ts, q, cids = _case(dtype)
    rm, jq, jc, jnsb = _jax_inputs(st, q, cids)
    k = 12
    jd, jr = jpl.search_fused(
        st.vectors, st.scales, rm, jq, jc, space, k, P,
        quantized=dtype == "int8", interpret=True, nsb=jnsb,
    )
    jd, jr = np.asarray(jd), np.asarray(jr)
    trm, tq, tc, tnsb = _port_inputs(ts, q, cids)
    assert (tnsb.numpy() == np.asarray(jnsb)).all()
    pd, pr = ivf_cuda.search_fused_plain(
        ts.vectors, ts.scales, trm, tq, tc, space, k, tnsb
    )
    wd, wr = ivf_cuda.search_fused(ts.vectors, ts.scales, trm, tq, tc, space, k, tnsb)
    assert torch.equal(pd, wd) and torch.equal(pr, wr)  # CPU wrapper = plain
    pd, pr = pd.numpy(), pr.numpy()
    assert (np.isinf(pd) == np.isinf(jd)).all()
    fin = np.isfinite(jd)
    np.testing.assert_allclose(pd[fin], jd[fin], atol=ATOL, rtol=0)
    assert (pr[~fin] == SENTINEL).all()
    _ids_agree(jd, jr, pr)
    live = set(np.asarray(st.rowid)[np.asarray(st.valid)].tolist())
    assert set(pr[fin].tolist()) <= live  # tombstones never surface


@pytest.mark.parametrize(
    "score,space,atol",
    [
        ("qi8", "cosine", 1e-6),  # integer dots: one f32 rounding, as on the TPU
        ("qi8", "dot", 1e-6),
        ("bf16", "cosine", 1e-5),  # exact products, f32 sums in another order
        ("stub", "dot", 0.0),  # element 0 x scale: one product, equal
    ],
)
def test_search_fused_score_modes_match_pallas(score, space, atol):
    st, ts, q, cids = _case("int8")
    rm, jq, jc, jnsb = _jax_inputs(st, q, cids)
    k = 12
    jd, jr = jpl.search_fused(
        st.vectors, st.scales, rm, jq, jc, space, k, P,
        quantized=True, interpret=True, nsb=jnsb, score=score,
    )
    jd, jr = np.asarray(jd), np.asarray(jr)
    trm, tq, tc, tnsb = _port_inputs(ts, q, cids)
    pd, pr = ivf_cuda.search_fused_plain(
        ts.vectors, ts.scales, trm, tq, tc, space, k, tnsb, score
    )
    wd, wr = ivf_cuda.search_fused(
        ts.vectors, ts.scales, trm, tq, tc, space, k, tnsb, score
    )
    assert torch.equal(pd, wd) and torch.equal(pr, wr)  # CPU wrapper = plain
    pd, pr = pd.numpy(), pr.numpy()
    assert (np.isinf(pd) == np.isinf(jd)).all()
    fin = np.isfinite(jd)
    np.testing.assert_allclose(pd[fin], jd[fin], atol=atol, rtol=0)
    if score == "stub":  # ties go to the lowest pool position in both
        np.testing.assert_array_equal(pr, jr)
    else:
        _ids_agree(jd, jr, pr)


def test_qi8_query_codes_match_pallas_wrapper():
    """The wrapper's per-query int8 codes and scales are ivf_pallas's
    (ivf_pallas.py:454-459), half-to-even rounding included."""
    _, ts, q, _ = _case("int8")
    q = q.copy()
    q[0, :3] = (1.0, -0.5, 0.25)  # 127 * 0.5 = 63.5 rounds to 64, 31.75 to 32
    codes, qs = ivf_cuda.score_query(torch.from_numpy(q), ts.vectors, "cosine", "qi8")
    jqs = jnp.maximum(jnp.max(jnp.abs(jnp.asarray(q)), axis=1), 1e-30) / 127.0
    jcodes = jnp.clip(jnp.round(jnp.asarray(q) / jqs[:, None]), -127, 127)
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes).astype(np.int8))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs))


@pytest.mark.parametrize(
    "score,dtype,space",
    [("qi8", "int8", "l2"), ("bf16", "int8", "l2"), ("qi8", "float32", "cosine"),
     ("bf16", "bfloat16", "dot")],
)
def test_score_modes_refuse_what_the_kernel_does_not_take(score, dtype, space):
    """qi8 and bf16 need int8 rows and cosine or dot (ivf_pallas.py:450-451,
    461-462), on every device; an unknown mode is refused too."""
    _, ts, q, cids = _case(dtype)
    trm, tq, tc, tnsb = _port_inputs(ts, q, cids)
    with pytest.raises(ValueError, match="needs int8 rows"):
        ivf_cuda.search_fused(ts.vectors, ts.scales, trm, tq, tc, space, 10, tnsb, score)
    with pytest.raises(ValueError, match="unknown score"):
        ivf_cuda.search_fused(ts.vectors, ts.scales, trm, tq, tc, space, 10, tnsb, "int4")


def test_fused_smem_bound():
    """B1's limits: a scan block's shared memory depends on D alone (two
    [TILE, 128] f32 score blocks, then the tile's queries: four int8
    digits each on the tensor-core path, f32 on the CUDA-core path), so
    at FUSED_MAX_DIMS both paths fit the 232,448 bytes a block may have,
    whatever the bucket or probe count.  The wrapper's constants are the
    kernel's, and it refuses what lies past them."""
    src = (Path(ivf_cuda.__file__).parent.parent / "csrc" / "ivf_scan.cu").read_text()
    for name, value in (("kTile", ivf_cuda.TILE), ("kMaxPairs", ivf_cuda.MAX_PAIRS),
                        ("kMaxDims", ivf_cuda.FUSED_MAX_DIMS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    D = ivf_cuda.FUSED_MAX_DIMS
    scores = 2 * ivf_cuda.TILE * 128 * 4
    qstride = -(-D // 128) * 128 + 64
    assert scores + 4 * ivf_cuda.TILE * qstride <= 232_448  # int8 banks, f32 digits
    assert scores + ivf_cuda.TILE * D * 4 <= 232_448  # bf16 / f32 banks
    ivf_cuda._b1_limits(D, ivf_cuda.MAX_PAIRS, 32)
    for args in ((D + 1, 16, 10), (768, ivf_cuda.MAX_PAIRS + 1, 10), (768, 16, 33)):
        with pytest.raises(ValueError, match="B1 takes"):
            ivf_cuda._b1_limits(*args)


@pytest.mark.parametrize("packed,space", [(False, "l2"), (True, "cosine")])
def test_pool_scan_matches_pallas(packed, space):
    st, ts, q, cids = _case("int8")
    rm, jq, jc, jnsb = _jax_inputs(st, q, cids)
    vec = jquant.pack_int4_from_int8(st.vectors) if packed else st.vectors
    jpool = np.asarray(
        jpl.pool_scan_fused(
            vec, st.scales, rm, jq, jc, space, P,
            quantized=True, packed=packed, interpret=True, nsb=jnsb,
        )
    )
    trm, tq, tc, tnsb = _port_inputs(ts, q, cids)
    tvec = tivf._from_numpy(vec, "cpu")
    pool = ivf_cuda.pool_scan_plain(tvec, ts.scales, trm, tq, tc, space, packed, tnsb)
    wrapped = ivf_cuda.pool_scan_fused(tvec, ts.scales, trm, tq, tc, space, packed, tnsb)
    assert torch.equal(pool, wrapped)
    pool = pool.numpy()
    assert pool.shape == (Q, P * B)
    assert (np.isinf(pool) == np.isinf(jpool)).all()
    fin = np.isfinite(jpool)
    np.testing.assert_allclose(pool[fin], jpool[fin], atol=ATOL, rtol=0)


def test_live_prefix_blocks():
    valid = np.zeros((4, 512), bool)
    valid[0, :10] = True  # live prefix 10 -> 1 block of 128
    valid[1, 200] = True  # lone live row at 200 -> 2 blocks
    valid[2, :512] = True  # full bucket -> 4
    got = ivf_cuda.live_prefix_blocks(torch.from_numpy(valid))
    assert got.dtype == torch.int32 and got.tolist() == [1, 2, 4, 0]
    rand = np.random.default_rng(3).random((64, 384)) < 0.05
    np.testing.assert_array_equal(
        ivf_cuda.live_prefix_blocks(torch.from_numpy(rand)).numpy(),
        np.asarray(jpl.live_prefix_blocks(jnp.asarray(rand))),
    )


def test_state_round_trip():
    st, ts, _, _ = _case("bfloat16")
    assert ts.vectors.dtype == torch.bfloat16 and ts.centroids.dtype == torch.bfloat16
    back = tivf.state_to_numpy(ts)
    for f in ("centroids", "vectors", "scales", "valid", "rowid"):
        want = np.asarray(getattr(st, f))
        if want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
        np.testing.assert_array_equal(back[f], want)


def test_wrappers_refuse_devices_without_a_kernel():
    """No silent fallback: a tensor on neither the CPU nor a CUDA device
    raises instead of taking the plain version."""
    dev = torch.device("meta")
    v = torch.empty((K, B, D), dtype=torch.int8, device=dev)
    s = torch.empty((K, B), device=dev)
    r = torch.empty((K, B), dtype=torch.int32, device=dev)
    q = torch.empty((Q, D), device=dev)
    c = torch.empty((Q, P), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no kernel"):
        ivf_cuda.search_fused(v, s, r, q, c, "cosine", 10)
    with pytest.raises(ValueError, match="no kernel"):
        ivf_cuda.pool_scan_fused(v, s, r, q, c, "cosine")
    assert ivf_cuda.LAUNCHES == {"search_fused": 0, "pool_scan": 0}
    assert not any(ivf_cuda.SCORE_LAUNCHES.values())

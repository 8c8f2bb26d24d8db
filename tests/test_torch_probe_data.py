"""The port's copy of the bench corpus recipe equals bench.py's.

vector_store_tpu_torch/probes/data.py keeps its own `make_dataset` and
`recall_of` so that the port imports nothing of the JAX package's
benchmark script; the corpus and queries it makes must equal bench.py's bit
for bit, or the port's probes would measure other data than the JAX
records.  This test alone imports bench.py, at small n.  bench.py caches
its corpus under /tmp; here its `np.save` raises OSError, which it takes as
a cache it cannot write, so the test writes nothing outside its own
temporary directory (the port's copy caches there, through TMPDIR).
"""

import numpy as np
import pytest

import bench
from vector_store_tpu_torch.probes import data


class _NumpyNoSave:
    """numpy, but `save` fails as a full or read-only disk would."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def save(*args, **kwargs):
        raise OSError("cache not written")


@pytest.fixture(autouse=True)
def _own_tmpdir(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.delenv("VST_BENCH_FVECS", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", None)  # re-read TMPDIR
    monkeypatch.setattr(bench, "np", _NumpyNoSave())
    yield
    tempfile.tempdir = None


@pytest.mark.parametrize("n,d,q,seed", [(777, 48, 33, 42), (2048, 16, 64, 7), (40, 8, 5, 42)])
def test_make_dataset_equals_bench(n, d, q, seed):
    want_x, want_q = bench.make_dataset(n, d, q, seed)
    got_x, got_q = data.make_dataset(n, d, q, seed)
    assert got_x.dtype == want_x.dtype == np.float32
    assert got_q.dtype == want_q.dtype
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_q, want_q)
    # the second call reads the cache the first wrote, and agrees
    again_x, again_q = data.make_dataset(n, d, q, seed)
    np.testing.assert_array_equal(again_x, want_x)
    np.testing.assert_array_equal(again_q, want_q)


def test_make_dataset_regenerates_a_cache_of_another_shape(tmp_path):
    import os
    import tempfile

    path = os.path.join(tempfile.gettempdir(), "vst_bench_64x8_s42_v2.npy")
    np.save(path, np.zeros((3, 3), np.float32))
    x, _ = data.make_dataset(64, 8, 4)
    np.testing.assert_array_equal(x, data.make_corpus(64, 8))


def test_recall_of_equals_bench():
    rng = np.random.default_rng(1)
    exact = np.stack([rng.permutation(50)[:10] for _ in range(20)])
    ids = np.stack([rng.permutation(50)[:12] for _ in range(20)])
    ids[:5, :10] = exact[:5]
    assert data.recall_of(ids, exact) == bench.recall_of(ids, exact)
    assert data.recall_of(exact, exact) == 1.0

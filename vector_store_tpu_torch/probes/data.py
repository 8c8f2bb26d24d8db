"""The bench corpus recipe and recall@k, owned by the port.

The same numpy PCG64 recipe and seed as the repository's bench.py
`make_dataset`, so the port's probes and chip_smoke.py measure the corpus
and queries the JAX records were taken on, bit for bit
(tests/test_torch_probe_data.py holds the two against each other):

  * corpus: n rows around max(n // 50, 16) standard-normal centres, sigma
    0.35, drawn from default_rng([seed, 1]) in chunks of 2^17 rows;
  * queries: q distinct corpus rows plus sigma-0.25 noise, drawn from
    default_rng(seed), a stream of its own, so they do not depend on
    whether the corpus came from the cache.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

SEED = 42


def make_corpus(n: int, d: int, seed: int = SEED) -> np.ndarray:
    """[n, d] f32 clustered gaussian rows (bench.py's corpus)."""
    crng = np.random.default_rng([seed, 1])
    n_clusters = max(n // 50, 16)
    centers = crng.standard_normal((n_clusters, d), dtype=np.float32)
    step = min(n, 1 << 17)
    x = np.empty((n, d), dtype=np.float32)
    for off in range(0, n, step):
        m = min(step, n - off)
        blk = x[off : off + m]
        blk[:] = crng.standard_normal((m, d), dtype=np.float32)
        blk *= 0.35
        blk += centers[crng.integers(0, n_clusters, m)]
    return x


def make_queries(x: np.ndarray, q: int, seed: int = SEED) -> np.ndarray:
    """[q, d] in-distribution queries: distinct corpus rows plus noise."""
    rng = np.random.default_rng(seed)
    qi = rng.choice(len(x), q, replace=False)
    return x[qi] + 0.25 * rng.standard_normal((q, x.shape[1]), dtype=np.float32)


def make_dataset(n: int, d: int, q: int, seed: int = SEED) -> tuple[np.ndarray, np.ndarray]:
    """(corpus, queries).  The corpus is cached as .npy in the temporary
    directory (TMPDIR, else /tmp), written to a temporary name and renamed,
    so a second run of the same shape reads it back; a cache that does not
    load is regenerated."""
    cache = os.path.join(tempfile.gettempdir(), f"vst_bench_{n}x{d}_s{seed}_v2.npy")
    x = None
    if os.path.exists(cache):
        try:
            x = np.load(cache)
        except (OSError, ValueError):
            x = None
        if x is not None and x.shape != (n, d):
            x = None
    if x is None:
        x = make_corpus(n, d, seed)
        tmp = cache + ".tmp.npy"
        try:
            np.save(tmp, x)
            os.replace(tmp, cache)
        except OSError:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return x, make_queries(x, q, seed)


def recall_of(ids: np.ndarray, exact: np.ndarray) -> float:
    """Mean share of each row of `exact` [q, k] found in the first k
    entries of the same row of `ids`."""
    q, k = exact.shape
    return float(np.mean([len(set(ids[i][:k].tolist()) & set(exact[i].tolist())) / k
                          for i in range(q)]))

"""vsbench: the benchmark of vector_store_tpu_torch.

Run one cell with

    python3 -m vsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  BENCHMARK.json names the cells; each cell's
configuration, traffic mix and per-layer metrics are files of their own
under vsbench/configs, vsbench/traffic and vsbench/metrics, found by name.
A configuration names the rest of what its runs need, each a module found
by name: its driver (vsbench/drivers, the system under test), its corpus
(vsbench/corpora, the items and the query pool made from the seed) and its
reference (vsbench/references, the exact top-k and the numbers compared
that are its own).  Nothing here imports jax or the JAX package; the
corpora and the references import nothing of the port either.
"""

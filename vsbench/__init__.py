"""vsbench: the benchmark of vector_store_tpu_torch.

Run one cell with

    python3 -m vsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  BENCHMARK.json names the cells; each cell's
configuration, traffic mix and per-layer metrics are files of their own
under vsbench/configs, vsbench/traffic and vsbench/metrics, found by name.
Nothing here imports jax or the JAX package; the reference
(vsbench/references) imports nothing of the port either.
"""

"""vector_store_tpu_torch — vector_store_tpu on PyTorch and CUDA: kinds "ann"
(the graph, the default), "exact", "ivf" and "text" (BM25), the ingest
layer (`ingest/`) and the HTTP service.

A second package beside the JAX one.  It imports torch, never jax, and
nothing of the JAX package: the domain types (`types`), configuration
(`config`), metrics, atomic snapshot writes and the native JSON scanners
(`utils/`) are this package's own copies, as are the engine, API, ingest,
text, graph and IVF layers (tests/test_torch_imports.py pins it).  The kernels are hand-written CUDA for
sm_90a (csrc/: the IVF probe scans, the graph gather-score and the
copy-rate probe), built with nvcc at first use.  `probes/` holds the
measurement modules run on the card (python -m vector_store_tpu_torch.probes.*).

Public surface (mirrors vector_store_tpu):
    run(addr, factory)           start engine + HTTP server
    new_index_factory(device=, n_devices=)
                                 factory serving kinds "ann", "exact", "ivf",
                                 "text" (and "auto"), sharded over
                                 `n_devices` devices when > 1
    wait_for_shutdown()          SIGINT/SIGTERM latch
"""

__version__ = "0.1.0"

from .types import (  # noqa: F401
    AnnResult,
    DbEmbedding,
    IndexId,
    IndexMetadata,
    IndexParams,
    Limit,
    PrimaryKey,
    Timestamp,
    primary_key,
)


def new_index_factory(
    max_batch: int = 256, window_s: float = 0.002, device="cuda", n_devices: int = 1
):
    """Routing factory with the ported backends on `device`: "ann" (the
    graph, the default kind), "exact", "ivf" and "text" (BM25).  kind
    "auto" resolves to "ivf" at declared capacity >= 200k and to "ann"
    below.  `n_devices` > 1 shards every kind over that many devices
    (shard/, text/sharded_bm25.py): the first `n_devices` cards of "cuda",
    or the device list given as `device`, whose entries may repeat."""
    from .engine.ann_index import AnnIndexFactory
    from .engine.factory import RoutingFactory
    from .engine.text_index import TextIndexFactory

    by_kind = {
        kind: AnnIndexFactory(
            backend=backend,
            max_batch=max_batch,
            window_s=window_s,
            device=device,
            n_devices=n_devices,
        )
        for kind, backend in (("ann", "graph"), ("exact", "exact"), ("ivf", "ivf"))
    }
    by_kind["text"] = TextIndexFactory(window_s=window_s, device=device, n_devices=n_devices)
    return RoutingFactory(by_kind)


async def run(addr: str, index_factory=None):
    """Start engine + HTTP server; returns (HttpServer, EngineHandle).

    Turns TF32 matmuls off for the process: the IVF centroid route needs
    full float32 products of its bf16-rounded operands to probe the same
    clusters as the JAX package (core/ivf_cuda.route checks the flag), and
    the graph's routing and prune matmuls then match it too."""
    import torch

    from .api.server import serve
    from .engine.engine import new_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    engine = await new_engine(index_factory or new_index_factory())
    server = await serve(addr, engine)
    return server, engine


async def wait_for_shutdown() -> None:
    """SIGINT/SIGTERM latch."""
    from .api.server import wait_for_shutdown as _wait

    await _wait()

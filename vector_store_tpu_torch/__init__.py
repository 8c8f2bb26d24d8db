"""vector_store_tpu_torch — the IVF serving path of vector_store_tpu on
PyTorch and CUDA.

A second package beside the JAX one.  It imports torch and never jax: the
domain types, configuration and the metrics and native helpers come from
the jax-free modules `vector_store_tpu.types`, `.config`, `.utils.metrics`,
`.utils.native` and `.utils.persistio`; the engine, API and IVF layers are
this package's own.  The probe-scan kernels are hand-written CUDA for
sm_90a (csrc/ivf_scan.cu), built with nvcc at first use.

Public surface (mirrors vector_store_tpu):
    run(addr, factory)           start engine + HTTP server
    new_index_factory(device=)   factory serving kind "ivf" (and "auto")
    wait_for_shutdown()          SIGINT/SIGTERM latch
"""

__version__ = "0.1.0"

from vector_store_tpu.types import (  # noqa: F401
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
    max_batch: int = 256, window_s: float = 0.002, device: str = "cuda"
):
    """Routing factory with the one ported backend, "ivf", on `device`.
    kind "auto" resolves to "ivf" at the default 1M capacity."""
    from .engine.ann_index import AnnIndexFactory
    from .engine.factory import RoutingFactory

    return RoutingFactory(
        {
            "ivf": AnnIndexFactory(
                backend="ivf", max_batch=max_batch, window_s=window_s, device=device
            )
        },
        default="ivf",
    )


async def run(addr: str, index_factory=None):
    """Start engine + HTTP server; returns (HttpServer, EngineHandle).

    Turns TF32 matmuls off for the process: the IVF centroid route needs
    full float32 products of its bf16-rounded operands to probe the same
    clusters as the JAX package (core/ivf_cuda.route checks the flag)."""
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

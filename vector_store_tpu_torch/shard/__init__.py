"""Document sharding over several devices (counterpart of
vector_store_tpu/shard/)."""

from .mesh import make_mesh  # noqa: F401

"""Host runtime: actors, registry, factory seam, batching (copies of
vector_store_tpu/engine, whose package __init__ imports jax)."""

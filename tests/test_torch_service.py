"""vector_store_tpu_torch over HTTP, in-process on the CPU device.

The port's server, engine, actor and its graph, exact and IVF indexes
answer the ANN surface end to end; a kind the port does not serve answers
400 with the kind named (kind "text" is served: tests/test_torch_text.py
holds its routes); /swagger-ui answers; and importing the port leaves jax
out of the process.
"""

import asyncio
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from vector_store_tpu_torch import new_index_factory
from vector_store_tpu_torch.api.routes import build_app
from vector_store_tpu_torch.engine.engine import new_engine

ROOT = Path(__file__).resolve().parent.parent
IX = "/api/v1/indexes/ks/docs"


async def _make_client():
    engine = await new_engine(new_index_factory(device="cpu"))
    c = TestClient(TestServer(build_app(engine)))
    await c.start_server()
    return c, engine


async def _count(c, want):
    async with asyncio.timeout(60):
        while True:
            r = await c.get(IX + "/count")
            assert r.status == 200
            if await r.json() == want:
                return
            await asyncio.sleep(0.01)


@pytest.mark.asyncio
async def test_ivf_int8_round_trip():
    c, engine = await _make_client()
    try:
        r = await c.put(
            IX, json={"dimensions": 32, "space": "cosine", "dtype": "int8", "kind": "ivf"}
        )
        assert r.status == 200
        assert await (await c.get("/api/v1/indexes")).json() == ["ks.docs"]
        x = np.random.default_rng(0).normal(size=(40, 32)).astype(np.float32)
        for i, v in enumerate(x):
            r = await c.post(IX + "/add", json={"primary_key": [f"k{i}"], "embedding": v.tolist()})
            assert r.status == 200
        await _count(c, 40)

        r = await c.post(IX + "/ann", json={"embedding": x[7].tolist(), "limit": 3})
        assert r.status == 200
        body = await r.json()
        assert body["primary_keys"]["pk0"][0] == "k7"
        assert len(body["distances"]) == 3 and body["distances"][0] < 1e-2
        assert body["distances"] == sorted(body["distances"])

        r = await c.post(IX + "/remove", json={"primary_key": ["k7"]})
        assert r.status == 200
        await _count(c, 39)
        r = await c.post(IX + "/ann", json={"embedding": x[7].tolist(), "limit": 40})
        keys = (await r.json())["primary_keys"]["pk0"]
        assert len(keys) == 39 and "k7" not in keys

        r = await c.get(IX)
        info = await r.json()
        assert info["kind"] == "ivf" and info["params"]["dtype"] == "int8"
        assert info["count"] == 39
        r = await c.post(IX + "/ann", json={"embedding": [0.0] * 5, "limit": 1})
        assert r.status == 400  # dimension mismatch
    finally:
        await c.close()
        await engine.close()


@pytest.mark.asyncio
async def test_unported_kinds_answer_400():
    c, engine = await _make_client()
    try:
        r = await c.put(IX, json={"dimensions": 8, "kind": "hnsw"})
        assert r.status == 400 and "'hnsw'" in await r.text()
        r = await c.put(IX, json={"dimensions": 8, "capacity": 0})
        assert r.status == 400
        assert await (await c.get("/api/v1/indexes")).json() == []
        # kind "text" is ported: the ANN PUT takes it, and the ANN listing
        # leaves it out
        r = await c.put(IX, json={"dimensions": 8, "kind": "text"})
        assert r.status == 200, await r.text()
        assert await (await c.get("/api/v1/indexes")).json() == []
        assert await (await c.get("/api/v1/text-search")).json() == ["ks.docs"]
        # auto resolves to ivf at the default 1M capacity
        r = await c.put(IX, json={"dimensions": 8, "kind": "auto"})
        assert r.status == 200
        assert (await (await c.get(IX)).json())["kind"] == "auto"
        r = await c.get("/api-docs/openapi.json")
        spec = await r.json()
        put = spec["paths"]["/api/v1/indexes/{keyspace}/{index}"]["put"]
        kinds = put["requestBody"]["content"]["application/json"]["schema"]["properties"]["kind"]
        assert kinds["enum"] == ["ann", "exact", "ivf", "auto", "text"]
    finally:
        await c.close()
        await engine.close()


@pytest.mark.asyncio
async def test_swagger_ui_is_served():
    """GET /swagger-ui: an HTML page that points the browser at the spec,
    as the JAX service's does (vector_store_tpu/api/routes.py:446-447)."""
    c, engine = await _make_client()
    try:
        r = await c.get("/swagger-ui")
        assert r.status == 200 and r.content_type == "text/html"
        assert "/api-docs/openapi.json" in await r.text()
        spec = await (await c.get("/api-docs/openapi.json")).json()
        assert "/api/v1/text-search/{index}/search" in spec["paths"]
    finally:
        await c.close()
        await engine.close()


async def _serve_round_trip(c, body):
    """PUT with `body`, add 60 rows, check self-lookups over /ann."""
    r = await c.put(IX, json=body)
    assert r.status == 200, await r.text()
    x = np.random.default_rng(1).normal(size=(60, 16)).astype(np.float32)
    for i, v in enumerate(x):
        r = await c.post(IX + "/add", json={"primary_key": [i], "embedding": v.tolist()})
        assert r.status == 200
    await _count(c, 60)
    for i in (0, 31, 59):
        r = await c.post(IX + "/ann", json={"embedding": x[i].tolist(), "limit": 5})
        body = await r.json()
        assert body["primary_keys"]["pk0"][0] == i
        assert body["distances"] == sorted(body["distances"])
    info = await (await c.get(IX)).json()
    assert info["count"] == 60
    return info


@pytest.mark.asyncio
@pytest.mark.parametrize(
    "body, kind",
    [
        ({"dimensions": 16}, "ann"),
        ({"dimensions": 16, "kind": "exact", "dtype": "int8", "space": "l2"}, "exact"),
        ({"dimensions": 16, "kind": "auto", "capacity": 150_000}, "auto"),
    ],
    ids=["default-kind-graph", "exact", "auto-below-200k"],
)
async def test_graph_and_exact_kinds_serve(body, kind):
    c, engine = await _make_client()
    try:
        info = await _serve_round_trip(c, body)
        assert info["kind"] == kind
        handle = await engine.get_index(_ix_id())
        assert type(handle.backend.index).__name__ == "SlotIndex"
        assert handle.backend.index._exact == (kind == "exact")
    finally:
        await c.close()
        await engine.close()


def _ix_id():
    from vector_store_tpu_torch import IndexId

    return IndexId.from_parts("ks", "docs")


@pytest.mark.asyncio
async def test_graph_compact_remaps_keys():
    """Compaction moves slots: every key still answers for itself, removed
    keys never come back, and the count holds."""
    c, engine = await _make_client()
    try:
        await _serve_round_trip(c, {"dimensions": 16, "dtype": "float32"})
        x = np.random.default_rng(1).normal(size=(60, 16)).astype(np.float32)
        for i in range(0, 60, 4):
            r = await c.post(IX + "/remove", json={"primary_key": [i]})
            assert r.status == 200
        await _count(c, 45)
        r = await c.post(IX + "/compact")
        assert r.status == 200 and (await r.json())["count"] == 45
        handle = await engine.get_index(_ix_id())
        assert handle.backend.index.frontier == 45  # slots were renumbered
        for i in range(60):
            r = await c.post(IX + "/ann", json={"embedding": x[i].tolist(), "limit": 60})
            keys = (await r.json())["primary_keys"]["pk0"]
            assert len(keys) == 45 and not any(k % 4 == 0 for k in keys)
            if i % 4:
                assert keys[0] == i
    finally:
        await c.close()
        await engine.close()


def test_import_leaves_jax_out():
    code = (
        "import sys, vector_store_tpu_torch, vector_store_tpu_torch.api.server, "
        "vector_store_tpu_torch.core.ivf, vector_store_tpu_torch.core.index, "
        "vector_store_tpu_torch.core.cluster, vector_store_tpu_torch.kernels.build, "
        "vector_store_tpu_torch.core.persist, vector_store_tpu_torch.text.bm25, "
        "vector_store_tpu_torch.ingest, vector_store_tpu_torch.ingest.scylla, "
        "vector_store_tpu_torch.ingest.filesource, vector_store_tpu_torch.__main__; "
        "vector_store_tpu_torch.new_index_factory(device='cpu'); "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)

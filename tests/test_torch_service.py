"""vector_store_tpu_torch over HTTP, in-process on the CPU device.

The port's server, engine, actor and IVF index answer the ANN surface
end to end; kinds that are not ported yet answer 400 with the kind named;
and importing the port leaves jax out of the process.
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
        for kind in ("ann", "exact", "text"):
            r = await c.put(IX, json={"dimensions": 8, "kind": kind})
            assert r.status == 400
            assert repr(kind) in await r.text()
        r = await c.put(IX, json={"dimensions": 8})  # default kind is the graph
        assert r.status == 400 and "'ann'" in await r.text()
        r = await c.put("/api/v1/text-search/articles")
        assert r.status == 400 and "'text'" in await r.text()
        r = await c.post("/api/v1/text-search/articles/search", json={"text": "x"})
        assert r.status == 400
        assert await (await c.get("/api/v1/indexes")).json() == []
        # auto resolves to ivf at the default 1M capacity
        r = await c.put(IX, json={"dimensions": 8, "kind": "auto"})
        assert r.status == 200
        assert (await (await c.get(IX)).json())["kind"] == "auto"
        r = await c.get("/api-docs/openapi.json")
        assert (await r.json())["paths"]
    finally:
        await c.close()
        await engine.close()


def test_import_leaves_jax_out():
    code = (
        "import sys, vector_store_tpu_torch, vector_store_tpu_torch.api.server, "
        "vector_store_tpu_torch.core.ivf, vector_store_tpu_torch.kernels.build; "
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)

"""The sharded backends behind the port's engine, actors and HTTP server, on
device="cpu" with n_devices=4: kinds "ivf", "ann", "exact", "auto" and
"text" are served from the sharded classes (`new_index_factory(n_devices=)`,
`--n-devices`, VST_TPU_N_DEVICES), compaction over the engine follows the
sharded graph's gid remap, and the entry point refuses more devices than
the machine has with the JAX package's message.
"""

import asyncio
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from vector_store_tpu_torch import IndexId, IndexMetadata, IndexParams, Limit, new_index_factory
from vector_store_tpu_torch.api.routes import build_app
from vector_store_tpu_torch.config import Config
from vector_store_tpu_torch.engine.ann_index import AnnIndexFactory
from vector_store_tpu_torch.engine.engine import new_engine
from vector_store_tpu_torch.engine.text_index import TextIndexFactory
from vector_store_tpu_torch.shard.sharded_index import ShardedSlotIndex
from vector_store_tpu_torch.shard.sharded_ivf import ShardedIvfIndex
from vector_store_tpu_torch.text.sharded_bm25 import ShardedBM25Index

ROOT = Path(__file__).resolve().parent.parent
S = 4


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(32, d)).astype(np.float32)
    return centers[rng.integers(0, 32, n)] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)


async def _client(**kw):
    engine = await new_engine(new_index_factory(device="cpu", n_devices=S, **kw))
    c = TestClient(TestServer(build_app(engine)))
    await c.start_server()
    return c, engine


async def _count(c, path, want):
    async with asyncio.timeout(120):
        while True:
            r = await c.get(path + "/count")
            assert r.status == 200
            if await r.json() == want:
                return
            await asyncio.sleep(0.01)


def test_default_factory_routes_every_kind_to_the_sharded_backends():
    factory = new_index_factory(device="cpu", n_devices=S)
    for kind in ("ann", "exact", "ivf", "text"):
        assert factory._by_kind[kind].n_devices == S, kind
    one = new_index_factory(device="cpu")
    assert all(f.n_devices == 1 for f in one._by_kind.values())  # the default stays one device


@pytest.mark.parametrize(
    "kind,cls,exact",
    [
        ("ivf", ShardedIvfIndex, None),
        ("auto", ShardedIvfIndex, None),  # the default capacity (1M) resolves to ivf
        ("ann", ShardedSlotIndex, False),
        ("exact", ShardedSlotIndex, True),
    ],
)
@pytest.mark.asyncio
async def test_ann_kinds_over_http_on_four_shards(kind, cls, exact):
    path = f"/api/v1/indexes/ks/{kind}"
    c, engine = await _client()
    try:
        r = await c.put(path, json={"dimensions": 16, "space": "cosine", "kind": kind})
        assert r.status == 200, await r.text()
        handle = await engine.get_index(IndexId.from_parts("ks", kind))
        idx = handle.backend.index
        assert type(idx) is cls and idx.n_shards == S
        if exact is not None:
            assert idx._exact is exact
        x = _data(60, 16, seed=1)
        for i, v in enumerate(x):
            r = await c.post(path + "/add", json={"primary_key": [f"k{i}"], "embedding": v.tolist()})
            assert r.status == 200
        await _count(c, path, 60)
        r = await c.post(path + "/ann", json={"embedding": x[7].tolist(), "limit": 3})
        assert r.status == 200, await r.text()
        body = await r.json()
        assert body["primary_keys"]["pk0"][0] == "k7"
        assert len(body["distances"]) == 3 and body["distances"][0] < 1e-2
        assert body["distances"] == sorted(body["distances"])
        # a replace moves the key to a new gid and tombstones the old one
        r = await c.post(path + "/add", json={"primary_key": ["k7"], "embedding": x[8].tolist()})
        assert r.status == 200
        r = await c.post(path + "/remove", json={"primary_key": ["k9"]})
        assert r.status == 200
        await _count(c, path, 59)
        r = await c.post(path + "/ann", json={"embedding": x[8].tolist(), "limit": 60})
        keys = (await r.json())["primary_keys"]["pk0"]
        assert len(keys) == 59 and "k9" not in keys and set(keys[:2]) == {"k7", "k8"}
        r = await c.post(path + "/compact")
        assert r.status == 200 and (await r.json())["count"] == 59
        r = await c.post(path + "/ann", json={"embedding": x[30].tolist(), "limit": 1})
        assert (await r.json())["primary_keys"]["pk0"] == ["k30"]
        r = await c.post(path + "/ann", json={"embedding": [0.0] * 5, "limit": 1})
        assert r.status == 400  # dimension mismatch
    finally:
        await c.close()
        await engine.close()


@pytest.mark.asyncio
async def test_text_kind_over_http_on_four_shards():
    tx = "/api/v1/text-search"
    docs = {
        "a1": "the quick brown fox jumps over the lazy dog",
        "a2": "a quick brown cat sleeps all day",
        "a3": "the brown bear eats quick salmon",
        "a4": "foxtrot dancing lessons downtown",
        "a5": "tensor processing units score text",
    }
    c, engine = await _client()
    try:
        assert (await c.put(tx + "/articles")).status == 200
        handle = await engine.get_index(IndexId("articles"))
        assert type(handle.backend.index) is ShardedBM25Index
        assert handle.backend.index.n_shards == S
        for key, text in docs.items():
            r = await c.post(tx + "/articles/add", json={"id": key, "text": text})
            assert r.status == 200
        for query, want in (("fox", ["a1"]), ("quick -fox", {"a2", "a3"}), ('"brown cat"', ["a2"]),
                            ("fox*", {"a1", "a4"}), ("tensor units", ["a5"])):
            r = await c.post(tx + "/articles/search", json={"text": query, "limit": 5})
            assert r.status == 200, await r.text()
            got = await r.json()
            assert (set(got) if isinstance(want, set) else got) == want, query
    finally:
        await c.close()
        await engine.close()


@pytest.mark.asyncio
async def test_sharded_text_actor():
    """The text protocol (Add/Search/Remove) over the document-sharded BM25
    index, through the actor (tests/test_sharded_engine.py's script)."""
    engine = await new_engine(TextIndexFactory(n_devices=S, device="cpu"))
    await engine.add_index(IndexMetadata(index_id=IndexId("articles")))
    actor = await engine.get_index(IndexId("articles"))
    assert type(actor.backend.index) is ShardedBM25Index
    await actor.add("a1", "the quick brown fox")
    await actor.add("a2", "lazy dogs sleep all day")
    await actor.add("a3", "tensor processing units score text")
    keys = await actor.search("quick fox", Limit(2))
    assert keys and keys[0] == "a1"
    await actor.add("a2", "quick quick fox fox")  # a replace: a new slot on another shard
    keys = await actor.search("quick fox", Limit(2))
    assert keys[0] == "a2" and await actor.count() == 3
    await actor.remove("a1")
    async with asyncio.timeout(60):
        while "a1" in await actor.search("quick fox", Limit(2)):
            await asyncio.sleep(0)
    await engine.close()


@pytest.mark.asyncio
async def test_sharded_ann_actor_and_compaction_over_the_engine():
    """tests/test_shard_parity.py::test_sharded_compact_over_engine on the
    port: 300 upserts, 100 removes, a compaction whose gid remap the keymap
    follows, and answers before and after."""
    factory = AnnIndexFactory(n_devices=S, device="cpu")
    meta = IndexMetadata(
        index_id=IndexId("ks.sc"),
        params=IndexParams(dimensions=8, space="l2"),
        key_columns=("id",),
    )
    handle = factory.create_index(IndexId("ks.sc"), meta)
    handle.metadata = meta
    try:
        x = _data(300, 8, seed=9)
        await handle.add_or_replace_batch([((i,), row) for i, row in enumerate(x)])
        assert await handle.count() == 300
        keymap = handle.backend.keymap
        assert [keymap.slot_of((i,)) for i in range(8)] == list(range(8))  # gid = insertion order
        for i in range(100):
            await handle.remove((i,))
        async with asyncio.timeout(60):
            while await handle.count() != 200:
                await asyncio.sleep(0)
        assert await handle.compact() == 200
        new_keymap = handle.backend.keymap
        assert new_keymap is not keymap and len(new_keymap) == 200
        # the live rows were re-dealt in shard-major order: key 100 (old gid
        # 100 = slot 25 of shard 0) is the first live row of shard 0
        assert new_keymap.slot_of((100,)) == 0
        assert sorted(new_keymap.slot_of((i,)) for i in range(100, 300)) == list(range(200))
        for probe in (150, 299):
            keys, _ = await handle.ann(x[probe], Limit(1))
            assert keys[0] == (probe,)
        keys, _ = await handle.ann(x[5], Limit(200))
        assert len(keys) == 200 and not {(i,) for i in range(100)} & set(keys)
    finally:
        handle.close()
        await handle.join()


def test_config_reads_the_device_count_like_jax(monkeypatch):
    from vector_store_tpu.config import Config as JConfig

    monkeypatch.delenv("VST_TPU_N_DEVICES", raising=False)
    assert Config().n_devices == JConfig().n_devices == 1
    monkeypatch.setenv("VST_TPU_N_DEVICES", "4")
    assert Config().n_devices == JConfig().n_devices == 4


def _serve(args, env=None):
    """Start the entry point, wait for its listening line, return (process, base url)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "vector_store_tpu_torch", "--addr", "127.0.0.1:0", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, **(env or {})},
    )
    seen = ""
    while True:  # log lines may come first
        line = proc.stdout.readline()
        if line.startswith("listening on "):
            return proc, line.split()[2]
        seen += line
        if not line:
            proc.kill()
            raise AssertionError(seen)


@pytest.mark.parametrize("how", ["flag", "environment"])
def test_entry_point_serves_every_kind_sharded(how):
    import json
    import urllib.request

    args, env = (["--n-devices", "4"], None) if how == "flag" else ([], {"VST_TPU_N_DEVICES": "4"})
    proc, base = _serve(["--device", "cpu", *args], env)

    def call(method, path, body=None):
        req = urllib.request.Request(
            base + path, method=method, data=None if body is None else json.dumps(body).encode(),
            headers={"content-type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read() or b"null")

    try:
        x = _data(12, 8, seed=2)
        for kind in ("ann", "exact", "ivf", "auto"):
            path = f"/api/v1/indexes/ks/{kind}"
            call("PUT", path, {"dimensions": 8, "space": "l2", "kind": kind})
            for i, v in enumerate(x):
                call("POST", path + "/add", {"primary_key": [i], "embedding": v.tolist()})
            for _ in range(600):
                if call("GET", path + "/count") == 12:
                    break
            got = call("POST", path + "/ann", {"embedding": x[5].tolist(), "limit": 2})
            assert got["primary_keys"]["pk0"][0] == 5, kind
        call("PUT", "/api/v1/text-search/notes")
        call("POST", "/api/v1/text-search/notes/add", {"id": "n1", "text": "sharded text search"})
        call("POST", "/api/v1/text-search/notes/add", {"id": "n2", "text": "another note"})
        assert call("POST", "/api/v1/text-search/notes/search", {"text": "sharded", "limit": 3}) == ["n1"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_entry_point_refuses_more_devices_than_visible():
    import torch

    have = torch.cuda.device_count()
    proc = subprocess.run(
        [sys.executable, "-m", "vector_store_tpu_torch", "--addr", "127.0.0.1:0",
         "--device", "cuda", "--n-devices", str(have + 3)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert f"ValueError: requested {have + 3} devices, have {have}" in proc.stderr

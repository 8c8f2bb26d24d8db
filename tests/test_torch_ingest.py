"""The ingest layer of vector_store_tpu_torch, on the CPU.

Modelled on tests/test_ingest.py, test_filesource.py and test_scylla.py
(the wire-level fake session and the fake driver are theirs; never a live
cluster).  The same scripted event stream goes through both packages'
`monitor_items` into both packages' engines and must end in the same keys,
the same count and the same `ann` answers (as sets: the indexes hold a few
dozen f32 rows, so both searches are exhaustive); `MonitorIndexes` creates
and drops indexes as the source's schema changes; the jsonl and fvecs
sources yield the events the JAX package's do; and `python -m
vector_store_tpu_torch --demo` runs the monitors over its demo source.
"""

import asyncio
import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_scylla import FakeSession, _FakeDriverSession, _timeuuid
from vector_store_tpu import new_index_factory as jax_factory
from vector_store_tpu.engine.engine import new_engine as jax_new_engine
from vector_store_tpu.ingest import monitor_items as jax_monitor_items
from vector_store_tpu.ingest.filesource import FileSource as JaxFileSource
from vector_store_tpu.ingest.source import EmbeddingStream as JaxStream
from vector_store_tpu import types as jtypes
from vector_store_tpu_torch import (
    DbEmbedding,
    IndexId,
    IndexMetadata,
    IndexParams,
    Limit,
    Timestamp,
    new_index_factory,
)
from vector_store_tpu_torch.engine.actor import (
    AddOrReplace,
    AddOrReplaceBatch,
    Remove,
    RemoveBatch,
    spawn_index_actor,
)
from vector_store_tpu_torch.engine.engine import new_engine
from vector_store_tpu_torch.ingest import MemDb, MonitorIndexes, monitor_items, scylla
from vector_store_tpu_torch.ingest.filesource import FileSource
from vector_store_tpu_torch.ingest.scylla import DriverSession, ScyllaSource
from vector_store_tpu_torch.ingest.source import EmbeddingStream
from vector_store_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parent.parent
D = 8


def _script(seed: int, n_keys=40, steps=260):
    """(key, embedding | None, timestamp): upserts, tombstones, stale
    timestamps (which must lose) and equal timestamps (which win), in a
    random churn over `n_keys` keys."""
    rng = np.random.default_rng(seed)
    events, clock = [], 100
    for _ in range(steps):
        key = (int(rng.integers(0, n_keys)),)
        clock += 1
        r = rng.random()
        ts = clock
        if r < 0.15:
            ts = int(rng.integers(1, 50))  # stale: older than anything live
        elif r < 0.2:
            ts = clock - 1  # equal to the previous event's: applied (LWW uses <)
            clock -= 1
        emb = None if rng.random() < 0.25 else rng.normal(size=(D,)).astype(np.float32)
        events.append((key, emb, ts))
    return events


def _lww(events):
    """Per-key final state by the reference's rule: an event older than the
    newest one seen for its key is dropped."""
    seen, state = {}, {}
    for key, emb, ts in events:
        if key in seen and ts < seen[key]:
            continue
        seen[key] = ts
        state[key] = emb
    return {k: v for k, v in state.items() if v is not None}


async def _run_script(events, package: str, kind: str):
    """Feed `events` through one package's monitor_items into its engine's
    index; returns (count, key set, ann answers for 8 fixed queries)."""
    if package == "torch":
        engine = await new_engine(new_index_factory(device="cpu"))
        t, stream, bridge = sys.modules["vector_store_tpu_torch"], EmbeddingStream(("id",)), monitor_items
    else:
        engine = await jax_new_engine(jax_factory())
        t, stream, bridge = jtypes, JaxStream(("id",)), jax_monitor_items
    try:
        meta = t.IndexMetadata(
            index_id=t.IndexId("ks.script"),
            params=t.IndexParams(dimensions=D, space="l2", dtype="float32"),
            key_columns=("id",),
            kind=kind,
        )
        await engine.add_index(meta)
        handle = await engine.get_index(t.IndexId("ks.script"))
        task = bridge.spawn(stream, handle)
        for i, (key, emb, ts) in enumerate(events):
            await stream.put(t.DbEmbedding(key, emb, t.Timestamp(ts)))
            if i % 37 == 0:
                await asyncio.sleep(0)  # let the bridge take batches of several sizes
        await stream.close()
        await asyncio.wait_for(task, 120)
        want = len(_lww(events))
        async with asyncio.timeout(120):
            while await handle.count() != want:
                await asyncio.sleep(0.01)
        count = await handle.count()
        queries = np.random.default_rng(99).normal(size=(8, D)).astype(np.float32)
        # the key set: every key that answers for its own row (with the
        # count equal to the expected one, no other key can be live)
        found = set()
        for key, emb in _lww(events).items():
            keys, dists = await handle.ann(emb, t.Limit(1))
            if keys == [key] and dists[0] < 1e-4:
                found.add(key)
        answers = []
        for q in queries:
            keys, dists = await handle.ann(q, t.Limit(5))
            answers.append((frozenset(keys), np.asarray(dists)))
        return count, found, answers
    finally:
        await engine.close()


@pytest.mark.asyncio
@pytest.mark.parametrize("kind, seed", [("ann", 23), ("exact", 5), ("ivf", 31)])
async def test_same_event_script_ends_in_the_same_state(kind, seed):
    events = _script(seed)
    want = _lww(events)
    t_count, t_keys, t_ans = await _run_script(events, "torch", kind)
    j_count, j_keys, j_ans = await _run_script(events, "jax", kind)
    assert t_count == j_count == len(want)
    assert t_keys == j_keys == set(want)
    for (tk, td), (jk, jd) in zip(t_ans, j_ans):
        assert tk == jk
        np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)


@pytest.mark.asyncio
async def test_monitor_items_lww_flow_and_both_remove_branches():
    """Hand-fed events (monitor_items.rs:82-207): the stale write never
    reaches the index, None becomes a remove, the task ends with the
    stream.  A handle with `remove_batch` gets one RemoveBatch; a
    text-protocol handle without it gets one Remove per key."""
    for batched in (True, False):
        received = []

        async def recorder(msg):
            if isinstance(msg, (AddOrReplace, AddOrReplaceBatch)):
                items = msg.items if isinstance(msg, AddOrReplaceBatch) else [
                    (msg.primary_key, msg.embedding)]
                received.extend(("add", k, np.asarray(e).tolist()) for k, e in items)
            elif isinstance(msg, RemoveBatch):
                received.append(("remove_batch", tuple(msg.keys)))
            elif isinstance(msg, Remove):
                received.append(("remove", msg.key))

        handle = spawn_index_actor(recorder, name="recorder")
        if not batched:

            class TextOnly:  # the text protocol's surface: no remove_batch
                add_or_replace_batch = handle.add_or_replace_batch
                remove = handle.remove

            target = TextOnly()
        else:
            target = handle
        stream = EmbeddingStream(("pk",))
        task = monitor_items.spawn(stream, target)
        e = lambda k, v, t: DbEmbedding(  # noqa: E731
            (k,), None if v is None else np.array(v, np.float32), Timestamp(t))
        await stream.put(e(1, [1.0], 10))
        await stream.put(e(1, [2.0], 5))  # stale: dropped
        await stream.put(e(1, [3.0], 20))
        await stream.put(e(2, None, 7))  # tombstone
        await stream.put(e(3, None, 8))
        await stream.put(e(2, [9.0], 7))  # equal timestamp: applied
        await stream.close()
        await asyncio.wait_for(task, 10)
        handle.close()
        await handle.join()
        assert ("add", (1,), [2.0]) not in received
        state = {}
        for op, key, *rest in received:
            if op == "add":
                state[key] = rest[0]
            elif op == "remove":
                state[key] = None
            else:
                state.update({k: None for k in key})
        assert state[(1,)] == [3.0] and state[(2,)] == [9.0] and state.get((3,)) is None
        ops = {op for op, *_ in received}
        assert ("remove_batch" in ops) == batched and ("remove" in ops) == (not batched)


@pytest.mark.asyncio
async def test_text_backend_takes_remove_batch():
    engine = await new_engine(new_index_factory(device="cpu"))
    try:
        await engine.add_index(IndexMetadata(index_id=IndexId("articles"), kind="text"))
        handle = await engine.get_index(IndexId("articles"))
        for i in range(4):
            await handle.add((f"a{i}",), f"common word{i}")
        assert await handle.count() == 4
        await handle.remove_batch([("a0",), ("a2",), ("nope",)])
        await handle.remove(("a3",))
        assert await handle.count() == 1
        assert await handle.search("common", Limit(5)) == [("a1",)]
    finally:
        await engine.close()


@pytest.mark.asyncio
async def test_monitor_indexes_follows_the_schema():
    """Indexes appear and go as the source's schema changes; rows reach
    them through the scan and then through live events."""
    db = MemDb()
    engine = await new_engine(new_index_factory(device="cpu"))
    mon = MonitorIndexes(db, engine, tick_s=0.01)
    mon.spawn()
    try:
        db.add_table("vectors", ("id",), 3)
        await db.insert_values("vectors", (1,), [1.0, 1.0, 1.0])
        await db.insert_values("vectors", (2,), [2.0, -2.0, 2.0])
        await db.insert_values("vectors", (3,), [3.0, 3.0, 3.0])
        db.add_index("ks.idx", "vectors", IndexParams(dimensions=3, space="l2"))
        async with asyncio.timeout(30):
            while (await engine.get_index_ids()) == []:
                await asyncio.sleep(0)
            actor = await engine.get_index(IndexId("ks.idx"))
            while await actor.count() != 3:
                await asyncio.sleep(0)
        keys, _ = await actor.ann(np.array([2.2, -2.2, 2.2]), Limit(1))
        assert keys == [(2,)]
        # live events after the scan
        await db.insert_values("vectors", (4,), [2.2, -2.2, 2.2])
        async with asyncio.timeout(30):
            while await actor.count() != 4:
                await asyncio.sleep(0)
        assert (await actor.ann(np.array([2.2, -2.2, 2.2]), Limit(1)))[0] == [(4,)]
        await db.delete_values("vectors", (4,))
        async with asyncio.timeout(30):
            while await actor.count() != 3:
                await asyncio.sleep(0)
        # a second index over the same table, then the first one dropped
        db.add_index("ks.second", "vectors", IndexParams(dimensions=3, space="cosine", dtype="int8"))
        async with asyncio.timeout(30):
            while len(await engine.get_index_ids()) != 2:
                await asyncio.sleep(0)
        db.del_index("ks.idx")
        async with asyncio.timeout(30):
            while [i.value for i in await engine.get_index_ids()] != ["ks.second"]:
                await asyncio.sleep(0)
            second = await engine.get_index(IndexId("ks.second"))
            while await second.count() != 3:
                await asyncio.sleep(0)
        assert actor.closed
        db.del_index("ks.second")
        async with asyncio.timeout(30):
            while (await engine.get_index_ids()) != []:
                await asyncio.sleep(0)
    finally:
        await mon.stop()
        await db.close_streams()
        await engine.close()


@pytest.mark.asyncio
async def test_preload_then_pipeline_into_ivf():
    """The bulk path: preloaded rows reach an int8 IVF index through the
    scan in coalesced batches, then overwrites and tombstones apply."""
    rng = np.random.default_rng(2)
    rows = rng.normal(size=(3000, 16)).astype(np.float32)
    db = MemDb()
    db.add_table("t", ("id",), 16)
    db.preload("t", [(i,) for i in range(len(rows))], rows)
    db.add_index("ks.bulk", "t", IndexParams(dimensions=16, space="cosine", dtype="int8"))
    # every index of this engine is an IVF index sized for the load up front,
    # as a deployment that knows its table's row count would make it
    from vector_store_tpu_torch.engine.ann_index import AnnIndexFactory

    engine = await new_engine(AnnIndexFactory(backend="ivf", reserve_rows=3000, device="cpu"))
    mon = MonitorIndexes(db, engine, tick_s=0.01)
    mon.spawn()
    try:
        async with asyncio.timeout(120):
            while (await engine.get_index_ids()) == []:
                await asyncio.sleep(0.01)
            actor = await engine.get_index(IndexId("ks.bulk"))
            while await actor.count() != 3000:
                await asyncio.sleep(0.01)
        assert type(actor.backend.index).__name__ == "IvfIndex"
        for i in range(0, 40):
            await db.delete_values("t", (i,))
        await db.insert_values("t", (100,), rows[5])  # overwrite: key 100 now sits at row 5
        async with asyncio.timeout(60):
            while await actor.count() != 2960:
                await asyncio.sleep(0.01)
            while (await actor.ann(rows[5], Limit(1)))[0] != [(100,)]:
                await asyncio.sleep(0.01)
        keys, _ = await actor.ann(rows[7], Limit(3))
        assert (7,) not in keys
    finally:
        await mon.stop()
        await db.close_streams()
        await engine.close()


# --------------------------------------------------------------------------
# file sources


async def _drain(stream, n):
    got = {}
    async with asyncio.timeout(30):
        while len(got) < n:
            ev = await stream.get()
            got.setdefault(ev.primary_key, []).append(ev)
    return got


@pytest.mark.asyncio
async def test_jsonl_source_yields_the_jax_events_and_feeds_the_engine(tmp_path):
    rows = np.random.default_rng(3).normal(size=(20, 8)).astype(np.float32)
    path = str(tmp_path / "rows.jsonl")
    with open(path, "w") as fh:
        for i, row in enumerate(rows):
            fh.write(json.dumps({"key": i, "embedding": row.tolist()}) + "\n")
        fh.write(json.dumps({"key": 5, "embedding": None, "timestamp": 10**9}) + "\n")
        fh.write(json.dumps({"key": ["a", 2], "embedding": rows[0].tolist()}) + "\n")
    src, jsrc = FileSource(path, "files.vecs"), JaxFileSource(path, "files.vecs")
    meta, jmeta = (await src.get_indexes())[0], (await jsrc.get_indexes())[0]
    assert meta.params.dimensions == jmeta.params.dimensions == 8
    assert meta.key_columns == jmeta.key_columns and meta.id.value == jmeta.id.value
    got = await _drain(await src.get_db_index(meta), 21)
    jgot = await _drain(await jsrc.get_db_index(jmeta), 21)
    assert set(got) == set(jgot) and ("a", 2) in got

    def flat(g):
        return sorted(
            (repr(k), e.timestamp.micros, None if e.embedding is None else e.embedding.tolist())
            for k, evs in g.items() for e in evs)

    assert flat(got) == flat(jgot)

    src = FileSource(path, "files.vecs", IndexParams(dimensions=8, space="l2"))
    engine = await new_engine(new_index_factory(device="cpu"))
    mon = MonitorIndexes(src, engine, tick_s=0.01)
    mon.spawn()
    try:
        async with asyncio.timeout(60):
            while (await engine.get_index_ids()) == []:
                await asyncio.sleep(0)
            actor = await engine.get_index(IndexId("files.vecs"))
            while await actor.count() != 20:  # 20 + the list key - the tombstone
                await asyncio.sleep(0)
        assert (await actor.ann(rows[7], Limit(1)))[0] == [(7,)]
        assert (5,) not in (await actor.ann(rows[5], Limit(20)))[0]
    finally:
        await mon.stop()
        await engine.close()


def _write_fvecs(path, rows):
    with open(path, "wb") as fh:
        for row in rows:
            fh.write(np.int32(rows.shape[1]).tobytes())
            fh.write(row.tobytes())


@pytest.mark.asyncio
async def test_fvecs_source(tmp_path):
    rows = np.random.default_rng(4).normal(size=(10, 4)).astype(np.float32)
    path = str(tmp_path / "rows.fvecs")
    _write_fvecs(path, rows)
    np.testing.assert_array_equal(native.read_fvecs(path, 100), rows)
    np.testing.assert_array_equal(native.read_fvecs(path, 3), rows[:3])
    ids = np.arange(12, dtype=np.int32).reshape(3, 4)
    with open(tmp_path / "gt.ivecs", "wb") as fh:
        for row in ids:
            fh.write(np.int32(4).tobytes() + row.tobytes())
    np.testing.assert_array_equal(native.read_ivecs(str(tmp_path / "gt.ivecs"), 10), ids)

    src = FileSource(path, "files.f", fmt="fvecs")
    metas = await src.get_indexes()
    assert metas[0].params.dimensions == 4
    got = await _drain(await src.get_db_index(metas[0]), 10)
    assert set(got) == {(i,) for i in range(10)}
    for i in range(10):
        np.testing.assert_array_equal(got[(i,)][0].embedding, rows[i])
        assert got[(i,)][0].timestamp.micros == i + 1
    # the repo's own dataset parses
    real = native.read_fvecs(str(ROOT / "bench_data" / "text10k.fvecs"), 50)
    assert real.shape == (50, 128) and np.isfinite(real).all()


@pytest.mark.asyncio
async def test_fvecs_without_a_compiler_raises(tmp_path, monkeypatch):
    """No C++ compiler: a fvecs source raises when it is first read; it
    does not pretend."""
    path = str(tmp_path / "rows.fvecs")
    _write_fvecs(path, np.ones((2, 4), dtype=np.float32))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "nobuild")
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="native/io.cpp could not be built"):
        await FileSource(path, "files.f", fmt="fvecs").get_indexes()
    assert native.parse_json_int(b'{"limit": 3}', b"limit", 1) is None  # callers fall back


# --------------------------------------------------------------------------
# the ScyllaDB adapter over the fake session


@pytest.mark.asyncio
async def test_scylla_control_plane_and_validity():
    sess = FakeSession(dims=6)
    src = ScyllaSource(sess)
    assert await src.latest_schema_version() == "v1"
    (m,) = await src.get_indexes()
    assert m.index_id.value == "ks.vecidx" and m.params.dimensions == 6
    assert m.key_columns == ("id", "sub")
    assert m.version == "11111111-2222-3333-4444-555555555555"
    assert await src.is_valid_index("ks", "items")
    assert not await src.is_valid_index("nope", "items")
    sess.agreement_ok = False
    assert not await src.is_valid_index("ks", "items")
    assert await src.get_indexes() == []
    assert scylla.fullscan_ranges([]) == [(scylla.TOKEN_MIN, scylla.TOKEN_MAX)]
    micros = 1_700_000_000_000_000
    assert scylla.timeuuid_to_timestamp(_timeuuid(micros)).micros == micros


@pytest.mark.asyncio
async def test_scylla_scan_and_cdc():
    sess = FakeSession(dims=4)
    rng = np.random.default_rng(0)
    for i in range(40):
        sess.rows[(i, f"s{i}")] = (rng.normal(size=4).astype(np.float32).tolist(), 1_000_000 + i)
    sess.rows[(99, None)] = ([0.0] * 4, 2_000_000)  # missing pk column
    sess.rows[(98, "s98")] = (None, 2_000_000)  # missing embedding
    src = ScyllaSource(sess)
    stream = await src.get_db_index(IndexMetadata(index_id=IndexId("ks.vecidx")))
    assert await stream.primary_key_columns() == ("id", "sub")
    got = await _drain(stream, 40)
    assert len(got) == 40 and got[(3, "s3")][0].timestamp.micros == 1_000_003
    assert len(sess.scanned_ranges) == len(scylla.fullscan_ranges(sess.ring))
    assert sess.max_concurrent > 1
    t1 = 1_700_000_000_000_000
    sess.cdc_rows.append((_timeuuid(t1), 1, (7, "a"), [1.0, 2.0, 3.0, 4.0]))
    async with asyncio.timeout(30):
        e = await stream.get()
    assert e.primary_key == (7, "a") and e.timestamp.micros == t1
    sess.cdc_rows.append((_timeuuid(t1 + 5), 2, (7, "a"), None))
    async with asyncio.timeout(30):
        e = await stream.get()
    assert e.embedding is None and e.timestamp.micros == t1 + 5
    stream.stop()
    async with asyncio.timeout(30):
        assert await stream.get() is None


@pytest.mark.asyncio
async def test_scylla_full_pipeline_on_fake_session():
    sess = FakeSession(dims=4)
    vecs = np.random.default_rng(1).normal(size=(10, 4)).astype(np.float32)
    for i in range(10):
        sess.rows[(i, f"s{i}")] = (vecs[i].tolist(), 1_000 + i)
    engine = await new_engine(new_index_factory(device="cpu"))
    monitor = MonitorIndexes(ScyllaSource(sess), engine, tick_s=0.05)
    mon = monitor.spawn()
    try:
        async with asyncio.timeout(60):
            while True:
                handle = await engine.get_index(IndexId("ks.vecidx"))
                if handle is not None and await handle.count() == 10:
                    break
                await asyncio.sleep(0.05)
        keys, _ = await handle.ann(vecs[4], Limit(1))
        assert keys[0] == (4, "s4")
    finally:
        mon.cancel()
        try:
            await mon
        except asyncio.CancelledError:
            pass
        await engine.close()


@pytest.mark.asyncio
async def test_scylla_driver_session_adapter():
    fake = _FakeDriverSession()
    s = DriverSession(fake)
    assert await s.execute("SELECT x FROM t") == [(1, "a"), (2, "b")]
    await s.execute("SELECT x FROM t WHERE id = ?", (1,))
    await s.execute("SELECT x FROM t WHERE id = ?", (2,))
    assert fake.prepared == ["SELECT x FROM t WHERE id = ?"]
    assert await s.execute("SELECT paged FROM t") == [(1, "a"), (2, "b"), (3, "c")]
    with pytest.raises(RuntimeError, match="boom"):
        await s.execute("boom")
    assert s.ring_tokens() == [-100, 0, 100] and s.nr_shards() == 8
    assert await s.await_schema_agreement() == "v42"
    assert s.keyspace_tables("ks")["items"] == {"partition_key": ["id"], "clustering_key": ["ts"]}
    assert s.keyspace_tables("nope") is None
    src = ScyllaSource(DriverSession(_FakeDriverSession()))
    assert await src.is_valid_index("ks", "items")


def test_scylla_connect_keeps_its_driver_import_lazy():
    """Importing the adapter needs no driver; connect() says what is missing."""
    assert "cassandra" not in sys.modules
    try:
        import cassandra  # noqa: F401
    except ImportError:
        with pytest.raises(RuntimeError, match="cassandra/scylla driver"):
            ScyllaSource.connect("127.0.0.1:9042")
    else:
        pytest.skip("a driver is installed: connect() would dial a cluster")


# --------------------------------------------------------------------------
# the entry point


def test_demo_entry_point_runs_the_monitors():
    """`python -m vector_store_tpu_torch --demo --device cpu --addr
    127.0.0.1:0` starts, the monitors create the demo index and fill it,
    and SIGINT stops the monitors before the server."""
    import urllib.request

    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "vector_store_tpu_torch", "--demo", "--device", "cpu",
         "--addr", "127.0.0.1:0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        addr = None
        for line in proc.stdout:
            m = re.search(r"listening on http://(127\.0\.0\.1:\d+)", line)
            if m:
                addr = m.group(1)
                break
        assert addr, "the service never said where it listens"

        def get(path):
            with urllib.request.urlopen(f"http://{addr}{path}", timeout=10) as r:
                return json.loads(r.read())

        import time

        deadline = time.time() + 60
        while time.time() < deadline:
            if get("/api/v1/indexes") == ["demo.items"] and get(
                    "/api/v1/indexes/demo/items/count") == 64:
                break
            time.sleep(0.1)
        assert get("/api/v1/indexes") == ["demo.items"]
        assert get("/api/v1/indexes/demo/items/count") == 64
        assert get("/api/v1/text-search") == []
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

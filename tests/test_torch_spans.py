"""The port's span primitive and the spans and counters of its load and
serving paths (vector_store_tpu_torch/utils/metrics.py and its callers),
on the CPU: what each series counts, not how long anything takes."""

import asyncio
import math
import re
import time

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from torch.profiler import ProfilerActivity, profile

from vector_store_tpu_torch import IndexId, IndexMetadata, IndexParams, Limit, new_index_factory
from vector_store_tpu_torch.api.routes import build_app
from vector_store_tpu_torch.core import cluster, index as graph_index, ivf
from vector_store_tpu_torch.core.index import SlotIndex
from vector_store_tpu_torch.core.ivf import IvfIndex
from vector_store_tpu_torch.engine.actor import spawn_index_actor
from vector_store_tpu_torch.engine.batcher import MicroBatcher
from vector_store_tpu_torch.engine.engine import new_engine
from vector_store_tpu_torch.utils import metrics

# label values may hold braces (an HTTP route's "{index}")
_LINE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{.*\})? (\S+)$")


def series(name: str, **labels) -> float:
    """The registry's value of `name` (a histogram's as <name>_count or
    <name>_sum), summed over the series whose labels include `labels`."""
    total = 0.0
    want = [f'{k}="{v}"' for k, v in labels.items()]
    for line in metrics.render().splitlines():
        m = _LINE.match(line)
        if m and m.group(1) == name and all(w in (m.group(2) or "") for w in want):
            total += float(m.group(3))
    return total


@pytest.fixture(autouse=True)
def fresh_registry():
    metrics.reset()
    yield
    metrics.reset()


# -- the primitive -----------------------------------------------------------


def test_span_times_on_the_monotonic_clock(monkeypatch):
    ticks = iter([5_000_000, 8_500_000])
    monkeypatch.setattr(metrics.time, "perf_counter_ns", lambda: next(ticks))
    # a wall clock stepping back must not matter
    monkeypatch.setattr(metrics.time, "time", lambda: pytest.fail("span read the wall clock"))
    with metrics.span("vst_t_seconds", phase="x"):
        pass
    assert series("vst_t_seconds_count", phase="x") == 1
    assert series("vst_t_seconds_sum", phase="x") == pytest.approx(0.0035)
    text = metrics.render()
    assert 'vst_t_seconds_bucket{phase="x",le="0.002"} 0' in text
    assert 'vst_t_seconds_bucket{phase="x",le="0.004"} 1' in text


def test_buckets_keep_every_old_bound_and_reach_down_to_a_microsecond():
    for i in range(15):
        assert 0.001 * 2**i in metrics.BUCKETS
    assert list(metrics.BUCKETS) == sorted(metrics.BUCKETS)
    assert 0.5e-6 < metrics.BUCKETS[0] <= 1e-6
    metrics.histogram("vst_b_seconds").observe(3e-6)
    metrics.histogram("vst_b_seconds").observe(0.0005)
    metrics.histogram("vst_b_seconds").observe(3.0)
    text = metrics.render()
    assert 'vst_b_seconds_bucket{le="3.90625e-06"} 1' in text
    assert 'vst_b_seconds_bucket{le="0.001"} 2' in text
    assert 'vst_b_seconds_bucket{le="+Inf"} 3' in text
    assert series("vst_b_seconds_count") == 3


def test_observe_many_is_one_observation_per_value():
    values = [1e-6, 2e-4, 0.003, 0.003, 20.0]
    metrics.histogram("vst_m_seconds", a="1").observe_many(values)
    metrics.histogram("vst_m_seconds", a="1").observe_many([])
    assert series("vst_m_seconds_count") == len(values)
    assert series("vst_m_seconds_sum") == pytest.approx(sum(values))
    one_by_one = metrics.render()
    metrics.reset()
    for v in values:
        metrics.histogram("vst_m_seconds", a="1").observe(v)
    assert metrics.render() == one_by_one


def test_spans_nest_and_a_late_label_is_observed():
    with metrics.span("vst_outer_seconds"):
        with metrics.span("vst_inner_seconds", via="device") as labels:
            time.sleep(0.002)
            labels["via"] = "host"
    assert series("vst_inner_seconds_count", via="host") == 1
    assert series("vst_inner_seconds_count", via="device") == 0
    assert series("vst_outer_seconds_sum") >= series("vst_inner_seconds_sum") >= 0.002


def test_a_trace_only_span_observes_no_series():
    with metrics.span("index.search_dispatch", series=False):
        pass
    assert metrics.render().strip() == ""


def test_a_span_is_a_profiler_range_only_while_a_profiler_runs(monkeypatch):
    made = []
    real = metrics._torch_profiler.record_function

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(metrics._torch_profiler, "record_function", counting)
    with metrics.span("vst_off_seconds"):
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("vst_outer_seconds"):
            with metrics.span("kernel.inner", series=False):
                torch.ones(4).sum()
    with metrics.span("vst_off_seconds"):
        pass
    assert made == ["vst_outer_seconds", "kernel.inner"]
    events = {e.name: e for e in prof.events()}
    outer, inner = events["vst_outer_seconds"], events["kernel.inner"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert series("vst_off_seconds_count") == 2 and series("vst_outer_seconds_count") == 1


# -- the load path -------------------------------------------------------------


def _rows(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_graph_load_spans(monkeypatch):
    # a router above 600 rows, of 8 centroids, so the add path rebuilds it
    # at a test's size
    monkeypatch.setattr(graph_index, "ROUTE_MIN_ROWS", 600)
    monkeypatch.setattr(cluster, "route_k_for", lambda rows: 8)
    params = IndexParams(dimensions=16, space="cosine", connectivity=8,
                         expansion_add=32, expansion_search=32)
    idx = SlotIndex(params, initial_capacity=128, insert_block=32, device="cpu")
    blocks = 0
    for n in (100, 64, 500):
        idx.add(_rows(n, 16, seed=n))
        blocks += math.ceil(n / 32)
        assert series("vst_graph_insert_block_seconds_count") == blocks
    assert idx.count() == 664
    # the capacity grew from 128 to 1,024: three doublings in two grows
    assert series("vst_graph_grow_seconds_count") == 2
    assert idx.capacity == 1024
    # built when the frontier first passed 600 rows, and again at the end
    # of that add only if it grew past 1.25x since
    assert series("vst_graph_router_rebuild_seconds_count") == 1
    assert series("vst_graph_insert_block_seconds_sum") > 0


@pytest.mark.parametrize("through_host", [False, True])
def test_ivf_load_spans(monkeypatch, through_host):
    monkeypatch.setattr(ivf, "ADD_CHUNK", 64)
    if through_host:
        monkeypatch.setattr(ivf, "HOST_PERMUTE_BYTES", 0)
    params = IndexParams(dimensions=16, space="cosine", dtype="int8")
    idx = IvfIndex(params, cluster_min=256, rows_per_bucket=32, device="cpu")
    idx.add(_rows(200, 16))
    assert series("vst_ivf_place_seconds_count") == math.ceil(200 / 64)
    assert series("vst_ivf_recluster_seconds_count") == 0  # below cluster_min
    idx.add(_rows(100, 16, seed=1))  # the live count crosses cluster_min
    assert series("vst_ivf_place_seconds_count") == math.ceil(200 / 64) + math.ceil(100 / 64)
    via = "host" if through_host else "device"
    assert series("vst_ivf_recluster_seconds_count", via=via) == 1
    assert series("vst_ivf_recluster_seconds_count") == 1
    idx.add(_rows(400, 16, seed=2))  # doubled: a second recluster
    assert series("vst_ivf_recluster_seconds_count", via=via) == 2
    assert series("vst_ivf_grow_bucket_seconds_count") == 0
    # 700 rows about one point fill its nearest clusters' buckets: the
    # bucket doubles inside a place
    bucket = idx.state.bucket
    near = np.repeat(_rows(1, 16, seed=3), 700, axis=0) + 1e-3 * _rows(700, 16, seed=4)
    idx.add(near)
    assert idx.state.bucket == 2 * bucket
    assert series("vst_ivf_grow_bucket_seconds_count") == 1
    assert idx.count() == 1400


# -- the engine: load and serving ------------------------------------------------


@pytest.mark.asyncio
@pytest.mark.parametrize("kind", ["ivf", "ann"])
async def test_engine_load_and_serving_series(kind):
    engine = await new_engine(new_index_factory(device="cpu"))
    try:
        index_id = IndexId.from_parts("ks", "spans")
        params = IndexParams(dimensions=16, space="cosine")
        await engine.add_index(IndexMetadata(index_id, params, kind=kind))
        handle = await engine.get_index(index_id)
        x = _rows(300, 16)
        for off in (0, 100, 200):
            await handle.add_or_replace_batch([((i,), x[i]) for i in range(off, off + 100)])
            assert await handle.count() == off + 100
        assert series("vst_engine_apply_upserts_seconds_count") == 3
        assert series("vst_index_add_seconds_count") == 3
        assert series("vst_engine_keymap_bind_seconds_count") == 3
        apply_s = series("vst_engine_apply_upserts_seconds_sum")
        assert apply_s >= series("vst_index_add_seconds_sum") > 0
        assert apply_s >= series("vst_engine_keymap_bind_seconds_sum")

        n = 150
        answers = await asyncio.gather(*(handle.ann(x[i], Limit(5)) for i in range(n)))
        assert all(keys[0] == (i,) for i, (keys, _) in enumerate(answers))
        batches = series("vst_ann_batch_seconds_count")
        assert 1 <= batches < n
        assert series("vst_ann_queries_total") == n
        # waits of each request once, observed once per batch
        assert series("vst_actor_mailbox_wait_seconds_count") == n
        assert series("vst_batcher_wait_seconds_count") == n
        for name in ("vst_ann_lock_wait_seconds", "vst_ann_fetch_seconds",
                     "vst_ann_keymap_seconds", "vst_batcher_executor_wait_seconds"):
            assert series(name + "_count") == batches, name
        assert series("vst_batcher_depth_wait_seconds_count") == batches
        assert series("vst_batcher_window_seconds_count") <= batches
        actor = str(index_id)
        turns = series("vst_actor_turns_total", actor=actor)
        assert series("vst_actor_messages_total", actor=actor) >= turns >= 1
        # 3 loads, 3 counts and the queries
        assert series("vst_actor_messages_total", actor=actor) == 6 + n
    finally:
        await engine.close()


@pytest.mark.asyncio
async def test_a_real_batcher_observes_each_wait_once_per_item():
    flushed = []

    def flush(items):
        flushed.append(len(items))
        return items

    b = MicroBatcher(flush, max_batch=8, window_s=0.002, depth=2)
    results = await asyncio.gather(*(b.submit(i) for i in range(20)))
    await b.close()
    assert results == list(range(20))
    assert series("vst_batcher_wait_seconds_count") == 20
    assert series("vst_batcher_executor_wait_seconds_count") == len(flushed)
    assert series("vst_batcher_depth_wait_seconds_count") == len(flushed)


@pytest.mark.asyncio
async def test_actor_counts_turns_and_messages():
    seen = []

    class Backend:
        async def __call__(self, msg):
            seen.append(msg)

        def coalesce(self, msgs):
            return msgs

    handle = spawn_index_actor(Backend(), name="probe")
    for i in range(7):
        await handle.remove(i)  # queued before the actor's first turn
    handle.close()
    await asyncio.wait_for(handle.join(), 10)
    assert len(seen) == 7
    assert series("vst_actor_messages_total", actor="probe") == 7
    turns = series("vst_actor_turns_total", actor="probe")
    assert 1 <= turns < 7


@pytest.mark.asyncio
async def test_http_requests_are_timed_by_the_span_under_their_old_names():
    engine = await new_engine(new_index_factory(device="cpu"))
    c = TestClient(TestServer(build_app(engine)))
    await c.start_server()
    try:
        r = await c.put("/api/v1/indexes/ks/h", json={"dimensions": 8, "space": "cosine"})
        assert r.status == 200
        v = _rows(1, 8)[0].tolist()
        assert (await c.post("/api/v1/indexes/ks/h/add", json={"primary_key": 1, "embedding": v})).status == 200
        assert (await c.post("/api/v1/indexes/ks/h/ann", json={"embedding": v, "limit": 1})).status == 200
        assert (await c.post("/api/v1/indexes/ks/absent/ann", json={"embedding": v, "limit": 1})).status == 404
        assert (await c.get("/no/such/route")).status == 404
        assert (await c.get("/healthz")).status == 200
        text = await (await c.get("/metrics")).text()
        ann = 'method="POST",route="/api/v1/indexes/{keyspace}/{index}/ann"'
        assert f'vst_http_requests_total{{{ann},status="200"}} 1' in text
        assert f'vst_http_requests_total{{{ann},status="404"}} 1' in text
        assert f"vst_http_request_seconds_count{{{ann}}} 2" in text
        assert 'vst_http_requests_total{method="GET",route="unmatched",status="404"} 1' in text
        assert series("vst_http_request_seconds_count") == 5
        assert 'route="/metrics"' not in text and 'route="/healthz"' not in text
    finally:
        await c.close()
        await engine.close()


# -- the text index: load and serving ----------------------------------------------


@pytest.mark.asyncio
async def test_text_load_and_serving_series():
    engine = await new_engine(new_index_factory(device="cpu"))
    try:
        index_id = IndexId.from_parts("ks", "text")
        await engine.add_index(IndexMetadata(index_id=index_id, kind="text"))
        handle = await engine.get_index(index_id)
        docs = [f"doc {i} about w{i % 7} and w{i % 11}" for i in range(300)]
        for off in (0, 100, 200):
            await handle.add_batch([((i,), docs[i]) for i in range(off, off + 100)])
        assert series("vst_text_apply_adds_seconds_count") == 3
        assert series("vst_text_add_seconds_count") == 3
        assert series("vst_text_analyze_seconds_count") == 3
        apply_s = series("vst_text_apply_adds_seconds_sum")
        assert apply_s >= series("vst_text_add_seconds_sum") >= series("vst_text_analyze_seconds_sum") > 0
        assert series("vst_text_docs_total", index=str(index_id)) == 300
        await handle.add((0,), "one doc alone")  # the per-document Add counts too
        assert series("vst_text_docs_total", index=str(index_id)) == 301
        assert series("vst_text_upload_seconds_count") == 0  # no query yet

        n = 90
        answers = await asyncio.gather(*(handle.search(f"w{i % 7}", Limit(5)) for i in range(n)))
        assert all(len(keys) == 5 for keys in answers)
        batches = series("vst_text_batch_seconds_count")
        assert 1 <= batches < n
        assert series("vst_text_queries_total", index=str(index_id)) == n
        for name in ("vst_text_lock_wait_seconds", "vst_text_fetch_seconds"):
            assert series(name + "_count") == batches, name
        # the first query uploads the rows, whole; later adds flush dirty rows
        assert series("vst_text_upload_seconds_count") == 1
        assert series("vst_text_flush_seconds_count") == 0
        await handle.add_batch([((1000,), "a new doc about w3")])
        assert await handle.search("new", Limit(3)) == [(1000,)]
        assert series("vst_text_upload_seconds_count") == 1
        assert series("vst_text_flush_seconds_count") == 1
        assert series("vst_text_dropped_terms_total") == 0
        await handle.add_batch([((2000,), " ".join(f"u{i}" for i in range(300)))])
        assert series("vst_text_dropped_terms_total") == 44
    finally:
        await engine.close()


def test_the_text_scorer_is_a_trace_range_under_the_batch_span():
    from vector_store_tpu_torch.text.bm25 import BM25Index

    idx = BM25Index(device="cpu")
    idx.add_batch(["alpha beta", "beta gamma"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert [s for s, _ in idx.search(["beta"], 2)[0]] == [0, 1]
    events = {e.name: e for e in prof.events()}
    outer, inner = events["vst_text_batch_seconds"], events["text.score"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert "text.score" not in metrics.render()
    assert series("vst_text_batch_seconds_count") == 1

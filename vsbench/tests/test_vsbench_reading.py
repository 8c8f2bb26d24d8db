"""The per-layer readers and the trace's reductions on made-up events."""

import json
from pathlib import Path

import pytest

from vsbench import judge, loop, trace
from vsbench.reading import Reading
from vsbench.run import HERE, load_file

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


class FakeSlice:
    def __init__(self, events, start_ns, stop_ns):
        self.events, self.start_ns, self.stop_ns = events, start_ns, stop_ns
        self.seconds = (stop_ns - start_ns) / 1e9


def reading(events, on_device=True, load=(3_000, 1.5)):
    window = ({"vst_ann_queries_total": 100.0, "vst_ann_batch_seconds_count": 10.0},
              {"vst_ann_queries_total": 2100.0, "vst_ann_batch_seconds_count": 20.0})
    in_slice = ({"vst_ann_batch_seconds_count": 12.0}, {"vst_ann_batch_seconds_count": 14.0})
    return Reading(window, in_slice, FakeSlice(events, 1_000, 11_000), on_device, load=load,
                   batches="vst_ann_batch_seconds_count")


EVENTS = [
    ("void tile_scan_kernel<signed char, false>(int, float*)", 1_500, 2_500, True),
    ("b1_merge_kernel", 2_000, 3_000, True),       # overlaps the first
    ("void graph_score_kernel<__nv_bfloat16, 8, false, true>(...)", 5_000, 6_000, True),
    ("Memcpy DtoH (Device -> Pageable)", 10_500, 12_000, True),  # runs past the stop
    ("cudaStreamSynchronize", 3_000, 4_900, False),
    ("cudaLaunchKernel", 100, 200, False),
]


def test_the_reductions():
    r = reading(EVENTS)
    assert r.busy_s == pytest.approx((1_500 + 1_000 + 500) / 1e9)
    assert r.slice_s == pytest.approx(10_000 / 1e9)
    gaps = trace.idle_gaps(r.ops, EVENTS, 1_000, 11_000, n=2)
    assert gaps[0] == ["host outside CUDA calls, then Memcpy DtoH", pytest.approx(4_500 / 1e9)]
    assert gaps[1] == ["host in cudaStreamSynchronize, then graph_score_kernel",
                       pytest.approx(2_000 / 1e9)]
    assert trace.top_ops(r.ops)[0] == ["tile_scan_kernel", pytest.approx(1e-6)]
    assert trace.short_name(EVENTS[2][0]) == "graph_score_kernel"


def _read(name, r):
    return load_file(HERE / "metrics" / f"{name}.py").read(r)


def test_every_metric_has_a_reader_that_reads_the_made_up_run():
    r = reading(EVENTS)
    got = {m["name"]: _read(m["name"], r) for m in BENCH["per_layer"]}
    assert got["load.rows_per_s"] == pytest.approx(2_000.0)


def test_what_a_later_reader_can_read():
    """Counters at the window's and the slice's edges and device time by
    kernel name, for metrics that later cells bring as files of their own."""
    r = reading(EVENTS)
    assert r.delta("vst_ann_queries_total") == 2000.0
    assert r.per_slice_batch(r.delta("vst_ann_queries_total")) == 1000.0
    assert r.device_seconds("tile_scan_kernel", "b1_merge_kernel") == pytest.approx(2e-6)
    assert r.device_seconds("graph_score_kernel") == pytest.approx(1e-6)
    assert reading([e for e in EVENTS if "graph" not in e[0]]).device_seconds("graph") is None
    assert reading([]).per_slice_batch(1.0) == 0.5 and r.busy_s > 0


def test_a_reader_that_finds_nothing_returns_nothing():
    assert _read("load.rows_per_s", reading(EVENTS, load=(0, 0.0))) is None


def test_slice_edges_are_bounded_and_centred():
    assert trace.slice_edges(10) == (4.0, 2.0)
    assert trace.slice_edges(40) == (19.0, 2.0)
    assert trace.slice_edges(1) == pytest.approx((0.4, 0.2))


def test_the_verdict_holds_every_number_to_its_limit():
    ok, checks = judge.verdict({"a": 0.0, "b": 0.5, "c": 9.0}, {"a": 0, "b": 0.5})
    assert ok and list(checks) == ["a", "b"]
    assert not judge.verdict({"a": 1.0}, {"a": 0})[0]


def test_a_loop_kind_is_found_by_the_name_the_traffic_gives():
    traffic = json.loads((HERE / "traffic" / "search.json").read_text())
    assert loop.kind(traffic).__name__ == "vsbench.loops.closed"
    for name in ("open_poisson", "../run", ""):
        with pytest.raises(ValueError):
            loop.kind(dict(traffic, loop=name))
    with pytest.raises(ValueError):
        loop.kind(dict(traffic, clients=0))


def test_a_pad_is_neither_found_nor_missed():
    """A short answer of a driver that gives keys only, against an exact list
    that holds fewer than k items; an answer to a query that matches nothing
    counts in neither recall nor its miss."""
    records = loop.Records(3, lambda answer: (answer, None))
    for qi, answer in [(0, [5, 2]), (1, [7]), (2, []), (0, [1, 2, 3, 4])]:
        records.close(records.open(0.0, qi), answer, 1.0)
    judged = judge.collect(records, scores=False)
    assert judged.bad == 1 and judged.ids.tolist() == [[5, 2, -1], [7, -1, -1], [-1, -1, -1]]
    exact = [[2, 5, -1], [7, 8, 9], [-1, -1, -1]]
    got = judge.numbers(judged, exact)
    assert got["recall"] == pytest.approx((1.0 + 1 / 3) / 2)
    assert got["miss_share"] == pytest.approx(1.0 - got["recall"])
    # a reference that reads scores judges a keys-only answer bad (the empty
    # one names nothing that lacks a score)
    assert judge.collect(records, scores=True).bad == 3

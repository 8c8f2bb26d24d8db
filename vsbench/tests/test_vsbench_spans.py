"""The readers of the program's load spans, against a made-up run."""

import json

import pytest

from vsbench.reading import Reading
from vsbench.run import HERE, load_file

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
BOTH = ["ivf768-1m.search", "graph768-1m.search"]
GRAPH, IVF = ["graph768-1m.search"], ["ivf768-1m.search"]

# what the program's registry holds at the window's start after a load of
# 2,000,000 rows (the graph's and the IVF's series side by side)
LOADED = {
    "vst_engine_apply_upserts_seconds_sum": 130.0,
    "vst_engine_apply_upserts_seconds_count": 31.0,
    "vst_index_add_seconds_sum": 120.0,
    "vst_index_add_seconds_count": 31.0,
    "vst_graph_insert_block_seconds_sum": 97.5,
    "vst_graph_insert_block_seconds_count": 3_900.0,
    "vst_graph_router_rebuild_seconds_sum": 6.25,
    "vst_graph_router_rebuild_seconds_count": 3.0,
    "vst_ivf_place_seconds_sum": 9.0,
    "vst_ivf_place_seconds_count": 245.0,
    "vst_ivf_recluster_seconds_sum": 4.5,
    "vst_ivf_recluster_seconds_count": 5.0,
}


class NoSlice:
    events, start_ns, stop_ns, seconds = [], 0, 0, 0.0


def reading(at_start, load_rows=2_000_000):
    window = (dict(at_start), dict(at_start, vst_ann_queries_total=5.0))
    return Reading(window, ({}, {}), NoSlice(), True, load=(load_rows, 150.0))


CASES = {
    # name: (unit, layer, workloads, value from LOADED)
    "load.index_s_per_mrow": ("s/Mrow", "index add path", BOTH, 60.0),
    "load.engine_s_per_mrow": ("s/Mrow", "engine", BOTH, 5.0),
    "load.insert_block_ms": ("ms", "graph insert", GRAPH, 25.0),
    "load.router_s": ("s", "graph router", GRAPH, 6.25),
    "load.recluster_s": ("s", "IVF clustering", IVF, 4.5),
}


def _read(name, r):
    return load_file(HERE / "metrics" / f"{name}.py").read(r)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_load_span_reader_reads_the_window_start(name):
    assert _read(name, reading(LOADED)) == pytest.approx(CASES[name][3])


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_load_span_reader_returns_nothing_where_its_series_is_absent(name):
    # the parent commit's program has none of these series
    parent = {"vst_ann_queries_total": 10.0, "vst_ann_upserts_total": 2e6}
    assert _read(name, reading(parent)) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_load_span_metric_is_declared_for_its_cells(name):
    unit, layer, workloads, _ = CASES[name]
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry == {"name": name, "unit": unit, "better": "lower", "source": "program_span",
                     "layer": layer, "moves": "setup_s", "workloads": workloads}


@pytest.mark.parametrize("name,ran", [("load.router_s", "vst_graph_insert_block_seconds_count"),
                                      ("load.recluster_s", "vst_ivf_place_seconds_count")])
def test_a_load_with_no_rebuild_reads_zero(name, ran):
    """A load too small to rebuild reads 0 s, where the index's add path
    ran; the parent, which has no such series at all, reads nothing."""
    small = {k: v for k, v in LOADED.items() if "router" not in k and "recluster" not in k}
    assert _read(name, reading(small)) == 0.0
    assert _read(name, reading({k: v for k, v in small.items() if k != ran})) is None


def test_the_split_is_at_most_the_load():
    r = reading(LOADED)
    split = _read("load.index_s_per_mrow", r) + _read("load.engine_s_per_mrow", r)
    assert split == pytest.approx(130.0 / 2.0)
    assert split <= 1e6 / _read("load.rows_per_s", r)


def test_the_per_row_readers_need_rows():
    for name in ("load.index_s_per_mrow", "load.engine_s_per_mrow"):
        assert _read(name, reading(LOADED, load_rows=0)) is None

"""The text cell (bm25-msmarco.search) beside the harness's tests that
assume a vector cell: the readers of the text load's spans against a
made-up run, the corpus and the exact reference held to pinned numbers, and
whole runs with the text path broken underneath, which must not be
correct."""

import hashlib
import json

import numpy as np
import pytest

from vsbench import run
from vsbench.reading import Reading

from test_vsbench_runs import TINY

CELL = "bm25-msmarco.search"
BENCH = json.loads((run.HERE.parent / "BENCHMARK.json").read_text())

# what the program's registry holds at the window's start after a load of
# 2,000,000 passages and the warm-up's first query
LOADED = {
    "vst_text_apply_adds_seconds_sum": 30.0,
    "vst_text_apply_adds_seconds_count": 31.0,
    "vst_text_add_seconds_sum": 24.0,
    "vst_text_add_seconds_count": 31.0,
    "vst_text_analyze_seconds_sum": 12.0,
    "vst_text_upload_seconds_sum": 3.5,
    "vst_text_upload_seconds_count": 1.0,
}

CASES = {
    # name: (unit, layer, value from LOADED)
    "load.text_add_s_per_mdoc": ("s/Mdoc", "text add path", 12.0),
    "load.text_engine_s_per_mdoc": ("s/Mdoc", "text engine", 3.0),
    "load.text_upload_s": ("s", "text device upload", 3.5),
}


class NoSlice:
    events, start_ns, stop_ns, seconds = [], 0, 0, 0.0


def reading(at_start, load_rows=2_000_000):
    window = (dict(at_start), dict(at_start, vst_text_queries_total=5.0))
    return Reading(window, ({}, {}), NoSlice(), True, load=(load_rows, 60.0))


def _read(name, r):
    return run.load_file(run.HERE / "metrics" / f"{name}.py").read(r)


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_text_load_reader_reads_the_window_start(name):
    assert _read(name, reading(LOADED)) == pytest.approx(CASES[name][2])


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_text_load_reader_returns_nothing_where_its_series_is_absent(name):
    # the parent commit's program has none of these series
    parent = {"vst_ann_queries_total": 10.0, "vst_engine_apply_upserts_seconds_sum": 3.0}
    assert _read(name, reading(parent)) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_text_load_metric_is_declared_for_the_text_cell(name):
    unit, layer, _ = CASES[name]
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry == {"name": name, "unit": unit, "better": "lower", "source": "program_span",
                     "layer": layer, "moves": "setup_s", "workloads": [CELL]}


def test_the_per_passage_readers_need_passages():
    for name in ("load.text_add_s_per_mdoc", "load.text_engine_s_per_mdoc"):
        assert _read(name, reading(LOADED, load_rows=0)) is None


def sha(x) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def _made(seed):
    spec = run.resolve(CELL, str(TINY))
    config, traffic = spec["config"], spec["traffic"]
    corpus = run.load_file(run.HERE / "corpora" / f"{config['corpus']}.py")
    reference = run.load_file(run.HERE / "references" / f"{config['reference']}.py")
    passages, pool = corpus.for_driver(config, traffic, seed, "cpu")
    items, ref_pool = corpus.for_reference(config, traffic, seed, "cpu")
    exact = reference.exact(items, ref_pool, int(traffic["limit"]))
    return passages, pool, items, ref_pool, exact


# seed: SHA-256 of the passages' and the queries' text (UTF-8, joined by
# "\n"), of the reference's word ids and of the exact top-10 ids (int64),
# at the rehearsal size on the CPU
PINNED = {
    7: ("3100562e9d0ae60eb2bc3ea72bba4b930101ff3386594eda656b2b4cf00bca18",
        "8adfffc46022ca23f9e88f07a36ad82abc9e2dc1a120793c7cc39cae23028776",
        "76a9ec63cd9588864366e5bd73aa689106da371571c26fdef7a497e6e2c9812e",
        "d0f9153d0d7b58db1a84d7f26ee54733628db025eb69aa6a53bcd2b86d8579ac"),
    2**31 + 17: ("d35dce93e9fe669303d5e8d92a60404ff6176c905bd029edd4d4e5fa9b08bf6e",
                 "6392cda6cc8021dd5e9ae11fa57fc94d27e1d75fac79493b840e2c55dc3bfbb3",
                 "fc66259d32e51e28510840f589d4351fe3388e2c963f9110ac9029aa635b523d",
                 "4fe32f7d85ce921fb3d7533f1fa5885fe5ba42bc00d758519b31ee6b7010924e"),
}


@pytest.mark.parametrize("seed", sorted(PINNED))
def test_a_seed_makes_the_pinned_passages_pool_and_exact_ids(seed):
    passages, pool, items, _, exact = _made(seed)
    got = (hashlib.sha256("\n".join(passages[0 : len(passages)]).encode()).hexdigest(),
           hashlib.sha256("\n".join(pool).encode()).hexdigest(),
           sha(items["words"].numpy()), sha(exact.numpy().astype(np.int64)))
    assert got == PINNED[seed]


def fault_state_unchanged(monkeypatch):
    """The load returns slots but leaves the index as it was."""
    from vector_store_tpu_torch.text.bm25 import BM25Index

    monkeypatch.setattr(BM25Index, "add_batch", lambda self, texts: list(range(len(texts))))


def fault_half_the_batch(monkeypatch):
    """A query batch is searched for its first half only; the rest get the
    first half's answers."""
    from vector_store_tpu_torch.engine.text_index import TextIndexBackend

    whole = TextIndexBackend._run_query_batch

    def half(self, items):
        h = max(1, len(items) // 2)
        out = whole(self, items[:h])
        return out + [out[j % h] for j in range(len(items) - h)]

    monkeypatch.setattr(TextIndexBackend, "_run_query_batch", half)


def fault_answer_altered(monkeypatch):
    """The index's search answers the next slot in place of its best one."""
    from vector_store_tpu_torch.text.bm25 import BM25Index

    search = BM25Index.search

    def altered(self, texts, k):
        out = search(self, texts, k)
        return [[((s + 1) % self._frontier, v) if j == 0 else (s, v)
                 for j, (s, v) in enumerate(hits)] for hits in out]

    monkeypatch.setattr(BM25Index, "search", altered)


FAULTS = [fault_state_unchanged, fault_half_the_batch, fault_answer_altered]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_text_run_with_a_fault_underneath_is_not_correct(fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc = run.main(["--workload", CELL, "--seed", "4242", "--seconds", "1", "--trace", "0",
                   "--rehearse", str(TINY)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["correct"] is False, out["checks"]

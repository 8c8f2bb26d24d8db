"""A configuration that is not a vector one runs through the same harness
as files of its own: a copy of BENCHMARK.json and vsbench/ gains a
keyword configuration and cell, whose corpus makes short strings from the
seed, whose driver answers keys only (fewer than k where fewer items match)
and whose reference is an exact keyword match in plain Python.  Nothing of
it is in the repository's BENCHMARK.json."""

import json
import shutil
import textwrap

import pytest

from test_vsbench_runs import BENCH, ROOT, TINY, last_line, run

CELL = "keywords-tiny.match"

CORPUS = '''
"""Items of 1-4 words and one-word queries, drawn by weight 1/(rank+1) from
a vocabulary of `words` words: common words match many items, rare ones
few or none."""

import random


def _make(config, traffic, seed):
    rng = random.Random(seed)
    words = [f"w{i}" for i in range(int(config["words"]))]
    weights = [1.0 / (i + 1) for i in range(len(words))]
    items = [" ".join(rng.choices(words, weights, k=rng.randint(1, 4)))
             for _ in range(int(config["rows"]))]
    pool = [rng.choice(words) for _ in range(int(traffic["pool"]))]
    return items, pool


def for_driver(config, traffic, seed, device):
    return _make(config, traffic, seed)


def for_reference(config, traffic, seed, device):
    return _make(config, traffic, seed)
'''

DRIVER = '''
"""An inverted index in a dict: a query's answer is the ids of the first k
items holding its word, keys only."""

import asyncio
import time

BATCH_COUNTERS = None
DROP_BEST = {drop}


class System:
    def __init__(self, config, device):
        self.loaded, self.load_s, self.posting = 0, 0.0, {{}}

    async def start(self, items):
        t0 = time.perf_counter()
        for i, item in enumerate(items):
            for word in set(item.split()):
                self.posting.setdefault(word, []).append(i)
            self.loaded += 1
        self.load_s = time.perf_counter() - t0

    async def ask(self, query, k):
        await asyncio.sleep(0)
        return self.posting.get(query, [])[DROP_BEST:k]

    @staticmethod
    def answer_rows(answer, k, n):
        ids = [int(i) for i in answer]
        if len(ids) > k or len(set(ids)) != len(ids) or any(not 0 <= i < n for i in ids):
            return None
        return ids, None

    def counters(self):
        return {{}}

    async def close(self):
        self.posting = {{}}
'''

REFERENCE = '''
"""Exact keyword match in plain Python: a query's top-k is the first k items,
by id, that hold its word."""

SCORES = False


def exact(items, pool, k):
    words = [set(item.split()) for item in items]
    out = []
    for query in pool:
        hits = [i for i, w in enumerate(words) if query in w][:k]
        out.append(hits + [-1] * (k - len(hits)))
    return out


def compared(items, pool, judged, exact_ids):
    """unmatched_keys: answered keys whose item does not hold the word."""
    bad = sum(1 for qi, ids in zip(judged.qidx, judged.ids) for i in ids
              if i >= 0 and pool[qi] not in items[i].split())
    return {"unmatched_keys": float(bad)}
'''

CONFIG = {"name": "keywords-tiny", "driver": "keywords", "corpus": "keywords",
          "reference": "keyword_match", "rows": 500, "words": 400,
          "limits": {"missing_rows": 0, "bad_answers": 0, "miss_share": 0, "unmatched_keys": 0}}
TRAFFIC = {"loop": "closed", "clients": 8, "limit": 10, "pool": 64, "warmup_rounds": 2}


def keyword_tree(tmp_path, drop: int):
    """A copy of the benchmark's files with the keyword configuration and
    cell added."""
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": CONFIG["name"], "source": "test fixture",
                             "file": "vsbench/configs/keywords-tiny.json", "reduced": [],
                             "why": "keys-only answers, fewer than k"})
    bench["workloads"].append({"name": CELL, "config": CONFIG["name"], "traffic": "keywords",
                               "chips": 1, "why": "test fixture"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    tree = tmp_path / "vsbench"
    shutil.copytree(ROOT / "vsbench", tree, ignore=shutil.ignore_patterns("__pycache__"))
    (tree / "configs" / "keywords-tiny.json").write_text(json.dumps(CONFIG))
    (tree / "traffic" / "keywords.json").write_text(json.dumps(TRAFFIC))
    (tree / "corpora" / "keywords.py").write_text(textwrap.dedent(CORPUS))
    (tree / "drivers" / "keywords.py").write_text(DRIVER.format(drop=drop))
    (tree / "references" / "keyword_match.py").write_text(REFERENCE)
    return tmp_path


@pytest.mark.parametrize("drop,correct", [(0, True), (1, False)],
                         ids=["exact", "best-key-dropped"])
def test_a_keyword_cell_runs_as_files_of_its_own(tmp_path, drop, correct):
    root = keyword_tree(tmp_path, drop)
    proc = run(["--workload", CELL, "--seed", str(2**31 + 23), "--seconds", "1", "--trace", "0",
                "--rehearse", str(TINY)], cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sum(1 for ln in proc.stdout.splitlines() if ln.startswith("{")) == 1
    out = last_line(proc)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert out["correct"] is correct, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0, out
    assert list(out["checks"]) == list(CONFIG["limits"])
    assert set(out["metrics"]) == {"recall", "setup_s"}
    assert out["window"]["batch_size"] is None
    if correct:
        assert out["metrics"]["recall"]["value"] == 1.0
    else:
        assert out["checks"]["miss_share"]["value"] > 0


def test_the_keyword_corpus_has_queries_with_fewer_than_k_matches(tmp_path):
    """Else the fixture would not test short answers and -1 pads."""
    import importlib.util

    root = keyword_tree(tmp_path, 0)
    mods = {}
    for kind, name in (("corpora", "keywords"), ("references", "keyword_match")):
        spec = importlib.util.spec_from_file_location(f"kw_{kind}", root / "vsbench" / kind / f"{name}.py")
        mods[kind] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[kind])
    tiny = json.loads(TINY.read_text())
    items, pool = mods["corpora"].for_reference(dict(CONFIG, **tiny["config"]),
                                                dict(TRAFFIC, **tiny["traffic"]), 2**31 + 23, "cpu")
    exact = mods["references"].exact(items, pool, TRAFFIC["limit"])
    short = sum(1 for ids in exact if -1 in ids)
    full = sum(1 for ids in exact if -1 not in ids)
    assert short > 0 and full > 0

"""The benchmark's plain BM25 reference (vsbench/references/exact_bm25.py,
loaded by path as the harness loads it) against a brute force in numpy and
against the port through the text cell's own driver and corpus, on the CPU
at 3,000 passages; and the control, the reference with its scores rounded
to bfloat16, which has to fail the cell's limits."""

import asyncio
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from vector_store_tpu_torch.text import tokenizer

ROOT = Path(__file__).resolve().parent.parent
CELL = "bm25-msmarco.search"
SEED = 2**31 + 41


def _load(kind, name):
    from vsbench.run import load_file

    return load_file(ROOT / "vsbench" / kind / f"{name}.py")


def _spec(rows=3000, pool=256):
    from vsbench.run import resolve

    spec = resolve(CELL, None)
    spec["config"].update(rows=rows, load_batch=1024)
    spec["traffic"].update(pool=pool)
    return spec


@pytest.fixture(scope="module")
def reference():
    return _load("references", "exact_bm25")


@pytest.fixture(scope="module")
def corpus():
    return _load("corpora", "msmarco_like")


def test_the_corpus_strings_analyse_to_the_references_word_ids(corpus, reference):
    spec = _spec(rows=70_000)  # past one chunk of passages
    config, traffic = spec["config"], spec["traffic"]
    passages, pool = corpus.for_driver(config, traffic, SEED, "cpu")
    items, ref_pool = corpus.for_reference(config, traffic, SEED, "cpu")
    terms = reference.term_ids(items["letters"], items["lengths"])
    texts = passages[0:70_000]
    assert len(passages) == len(texts) == 70_000 and passages[65_537] == texts[65_537]
    got = tokenizer.analyze(texts, "cpu")
    assert torch.equal(got.ids, terms[items["words"]])
    assert np.array_equal(got.per_doc, torch.diff(items["offsets"]).numpy())
    queries = tokenizer.analyze(pool, "cpu")
    assert torch.equal(queries.ids, terms[ref_pool[ref_pool >= 0]])
    assert np.array_equal(queries.per_doc, (ref_pool >= 0).sum(dim=1).numpy())
    lengths = np.diff(items["offsets"].numpy())
    assert lengths.min() >= 8 and lengths.max() <= 200 and 50 < lengths.mean() < 65
    assert texts[0][0].isupper() and texts[0].endswith(".") and pool[0].islower()


def _brute(items, pool, terms_of, k):
    """numpy float64 BM25 of every passage for every query, then the top-k
    by (score desc, id asc) over scores above 0."""
    words = items["words"].numpy()
    off = items["offsets"].numpy()
    n = len(off) - 1
    docs = [terms_of[words[off[i] : off[i + 1]]] for i in range(n)]
    lengths = np.array([len(d) for d in docs], dtype=np.float64)
    avgdl = lengths.sum() / n
    df = {}
    for d in docs:
        for t in set(d.tolist()):
            df[t] = df.get(t, 0) + 1
    out = []
    for row in pool.numpy():
        qt = list(dict.fromkeys(terms_of[row[row >= 0]].tolist()))
        scores = np.zeros(n)
        for i, d in enumerate(docs):
            for t in qt:
                tf = float((d == t).sum())
                if tf:
                    idf = np.log(1.0 + (n - df[t] + 0.5) / (df[t] + 0.5))
                    scores[i] += idf * tf * 2.2 / (tf + 1.2 * (0.25 + 0.75 * lengths[i] / avgdl))
        order = np.lexsort((np.arange(n), -scores))
        best = [int(i) for i in order[:k] if scores[i] > 0]
        out.append(best + [-1] * (k - len(best)))
    return np.array(out), scores


def test_the_reference_equals_a_brute_force(corpus, reference, monkeypatch):
    spec = _spec(rows=400, pool=48)
    items, pool = corpus.for_reference(spec["config"], spec["traffic"], SEED, "cpu")
    terms_of = reference.term_ids(items["letters"], items["lengths"]).numpy()
    # ties in the brute force's float64 sums can differ in the last bit
    # from the reference's order of terms: compare where they are apart
    want, _ = _brute(items, pool, terms_of, 10)
    monkeypatch.setattr(reference, "POSTINGS", 5_000)  # several query groups
    got = reference.exact(items, pool, 10).numpy()
    index = reference.index_of(items)
    terms = index.query_terms(pool)
    got_s = index.pair_scores(terms, torch.as_tensor(got))
    want_s = index.pair_scores(terms, torch.as_tensor(want))
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), rtol=1e-12, atol=0)
    assert np.array_equal(got >= 0, want >= 0)
    assert (got == want).mean() > 0.97
    # fewer than k above 0: a query of words in no passage
    lonely = torch.full((1, pool.shape[1]), -1, dtype=torch.long)
    absent = torch.nonzero(torch.bincount(items["words"], minlength=len(items["lengths"])) == 0)
    lonely[0, 0] = absent[0, 0]
    assert reference.exact(items, lonely, 10).tolist() == [[-1] * 10]


def test_the_top_k_breaks_ties_to_the_lower_id(reference):
    scores = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0], [0.0, 0.0, 5.0, 0.0, 0.0, 0.0]],
                          dtype=torch.float64)
    assert reference.top(scores, 3).tolist() == [[1, 2, 4], [2, -1, -1]]
    assert reference.top(scores, 5).tolist() == [[1, 2, 4, 5, 0], [2, -1, -1, -1, -1]]


def _program_answers(spec, seed):
    """Every pool query asked through the cell's driver (the engine, kind
    text, the batched load) on the CPU: (the passages loaded, each answer's
    (keys, None) in pool order)."""
    driver = _load("drivers", "text_engine")
    corpus = _load("corpora", "msmarco_like")
    config, traffic = spec["config"], spec["traffic"]
    passages, pool = corpus.for_driver(config, traffic, seed, "cpu")
    k = int(traffic["limit"])

    async def main():
        system = driver.System(config, "cpu")
        await system.start(passages)
        try:
            answers = await asyncio.gather(*(system.ask(q, k) for q in pool))
        finally:
            await system.close()
        return system.loaded, answers

    loaded, answers = asyncio.run(main())
    rows = [driver.System.answer_rows(a, k, len(passages)) for a in answers]
    return loaded, rows


def test_the_program_answers_as_the_reference(corpus, reference):
    from vsbench import judge

    spec = _spec()
    k = int(spec["traffic"]["limit"])
    limits = spec["config"]["limits"]
    loaded, rows = _program_answers(spec, SEED)
    assert loaded == 3000 and all(r is not None for r in rows)
    ids = np.full((len(rows), k), -1, dtype=np.int64)
    for i, (keys, _) in enumerate(rows):
        ids[i, : len(keys)] = keys
    items, pool = corpus.for_reference(spec["config"], spec["traffic"], SEED, "cpu")
    exact = reference.exact(items, pool, k)
    assert np.array_equal(ids, exact.numpy())
    judged = judge.Judged(np.arange(len(rows)), ids, np.full(ids.shape, np.nan, np.float32), 0)
    values = judge.numbers(judged, exact)
    values.update(reference.compared(items, pool, judged, exact))
    assert values["miss_share"] == 0.0 and values["bad_answers"] == 0.0
    assert values["score_gap"] <= limits["score_gap"]
    # some queries have fewer than k passages above 0, and some a full list
    assert (exact.numpy() == -1).any(axis=1).any() and (exact.numpy() >= 0).all(axis=1).any()


def test_the_score_gap_reads_a_wrong_key_and_not_a_tie(corpus, reference):
    from vsbench import judge

    spec = _spec(rows=500, pool=64)
    items, pool = corpus.for_reference(spec["config"], spec["traffic"], SEED, "cpu")
    exact = reference.exact(items, pool, 10)
    index = reference.index_of(items)
    due = index.pair_scores(index.query_terms(pool), exact)
    # a pair of tied passages at ranks 3 and 4 of a full list
    row = next(i for i in range(len(exact))
               if (exact[i] >= 0).all() and due[i, 3] == due[i, 4] and exact[i, 3] != exact[i, 4])
    swapped = exact.clone().numpy()
    swapped[row, [3, 4]] = swapped[row, [4, 3]]
    nan = np.full(swapped.shape, np.nan, np.float32)
    judged = judge.Judged(np.arange(len(pool)), swapped, nan, 0)
    assert reference.compared(items, pool, judged, exact)["score_gap"] == 0.0
    wrong = exact.clone().numpy()
    wrong[row, 0] = wrong[row, 9]
    wrong[row, 9] = -1
    judged = judge.Judged(np.arange(len(pool)), wrong, nan, 0)
    gap = reference.compared(items, pool, judged, exact)["score_gap"]
    assert gap == pytest.approx(float((due[row, 0] - due[row, 9]) / due[row, 0]))


def test_the_bf16_control_fails_the_cells_limits():
    from vsbench import control

    spec = _spec()
    got = control.readings(spec, SEED, "bf16", "cpu")
    assert got["correct"] is False
    assert got["checks"]["score_gap"]["value"] > 10 * got["checks"]["score_gap"]["limit"]


def test_the_configuration_names_its_files():
    config = json.loads((ROOT / "vsbench" / "configs" / "bm25-msmarco.json").read_text())
    for kind, key in (("drivers", "driver"), ("corpora", "corpus"), ("references", "reference")):
        assert (ROOT / "vsbench" / kind / f"{config[key]}.py").is_file()
    assert config["rows"] == 8_841_823 and config["index"] == {"kind": "text"}

"""Text search of vector_store_tpu_torch against the JAX package, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its counterpart in the port: the tokenizer and the simple_query_string
parser (equal outputs), the scorer `_score_topk` (scores within rtol 1e-5 /
atol 1e-6, as the f32 sum over a query's terms is taken in another order;
ids equal wherever a score differs from both neighbours by more than that;
SENTINEL where JAX has it), `BM25Index` after churn (the same hits for
plain, operator, phrase, prefix, fuzzy and long queries), snapshots in both
directions, and the text routes over the port's server on device="cpu".
"""

import asyncio

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from vector_store_tpu.text import query as jquery
from vector_store_tpu.text import tokenizer as jtok
from vector_store_tpu.text.bm25 import BM25Index as JaxBM25
from vector_store_tpu.text.bm25 import _score_topk as jax_score_topk
from vector_store_tpu_torch import new_index_factory
from vector_store_tpu_torch.api.routes import build_app
from vector_store_tpu_torch.engine.engine import new_engine
from vector_store_tpu_torch.text import bm25 as tbm25
from vector_store_tpu_torch.text import query as tquery
from vector_store_tpu_torch.text import tokenizer as ttok
from vector_store_tpu_torch.text.bm25 import BM25Index as TorchBM25

RTOL, ATOL = 1e-5, 1e-6
SENTINEL = 2**31 - 1

# covers the grammar of tests/test_bm25.py::test_simple_query_string_full_grammar
# and test_parser_flat_vs_ast
QUERIES = [
    "quick fox",
    "The QUICK, brown fox!",
    "quick -fox +brown",
    '-fox "brown dog"',
    'brown -"quick brown"',
    "-cat",
    "quick fox -lazy",
    "hello ab-cd",
    "-ab-cd",
    "ab-cd + x",
    "word " + " ".join(f"-neg{i}" for i in range(9)),
    " + ".join(f"req{i}" for i in range(9)),
    "(cat | salmon) + brown",
    "brown -(cat | salmon)",
    '"quick fox"~1',
    '"quick fox"',
    "bear + salmon | foxtrot",
    "((quick brown",
    "quick + ,,*",
    "",
    "naïve café 42nd",
]


@pytest.mark.parametrize("text", QUERIES + ["fox*", "cet~1"])
def test_tokenizer_and_parser_equal_jax(text):
    assert ttok.tokenize(text) == jtok.tokenize(text)
    assert ttok.term_ids(text) == jtok.term_ids(text)
    assert ttok.normalize(text) == jtok.normalize(text)
    for w in ttok.tokenize(text):
        assert ttok.term_id(w) == jtok.term_id(w)
    # dataclass reprs carry every field and no module name
    assert repr(tquery.parse(text)) == repr(jquery.parse(text))
    assert tquery.parse(text).has_operators == jquery.parse(text).has_operators


def test_phrase_in_and_matches_equal_jax():
    rng = np.random.default_rng(5)
    seqs = [rng.integers(1, 6, size=int(n)).astype(np.int32) for n in rng.integers(0, 12, 40)]
    phrases = [[1, 2], [3], [2, 2, 1], [5, 1, 4]]
    for seq in seqs:
        for ph in phrases:
            for slop in (0, 1, 3):
                assert tquery.phrase_in(seq, ph, slop) == jquery.phrase_in(seq, ph, slop)
    for text in ("(a | b) + c", "a -(b | c)", '"a b"~1 | d', "a + b + -c"):
        t_ast, j_ast = tquery.parse(text).ast, jquery.parse(text).ast
        assert (t_ast is None) == (j_ast is None)
        if t_ast is None:
            continue
        ids = {w: ttok.term_id(w) for w in "abcd"}
        for seq_words in ("a c", "b c d", "a b", "a x b", "d", "a b c", ""):
            seq = np.asarray([ids.get(w, 9) for w in seq_words.split()], dtype=np.int32)
            have = set(int(t) for t in seq)
            assert tquery.matches(t_ast, have, seq) == jquery.matches(j_ast, have, seq)


# --------------------------------------------------------------------------
# the scorer


def _scorer_case(seed=3, C=700, U=32, Q=5, T=8, n_vocab=60):
    """Documents over a small vocabulary, so that scores tie and operator
    masks bite: unique terms per row, PAD-filled tails, a fifth of the rows
    invalid; queries with PAD slots, required and forbidden ids."""
    rng = np.random.default_rng(seed)
    terms = np.zeros((C, U), dtype=np.int32)
    tf = np.zeros((C, U), dtype=np.int32)
    for c in range(C):
        u = int(rng.integers(0, U + 1))
        terms[c, :u] = rng.choice(np.arange(1, n_vocab + 1), size=u, replace=False)
        tf[c, :u] = rng.integers(1, 5, size=u)
    length = tf.sum(1).astype(np.int32)
    valid = rng.random(C) > 0.2
    q_terms = np.zeros((Q, T), dtype=np.int32)
    q_idf = np.zeros((Q, T), dtype=np.float32)
    q_req = np.zeros((Q, 8), dtype=np.int32)
    q_neg = np.zeros((Q, 8), dtype=np.int32)
    for q in range(Q):
        t = int(rng.integers(0 if q == 0 else 1, T + 1))  # query 0 may score nothing
        q_terms[q, :t] = rng.choice(np.arange(1, n_vocab + 1), size=t, replace=False)
        q_idf[q, :t] = rng.random(t).astype(np.float32) * 3 + 0.1
        if q % 2:
            q_req[q, :1] = rng.integers(1, n_vocab + 1, 1)
        if q % 3 == 0:
            q_neg[q, :2] = rng.integers(1, n_vocab + 1, 2)
    avg = np.float32(max(length[valid].mean(), 1.0))
    return terms, tf, length, valid, q_terms, q_idf, q_req, q_neg, avg


def _assert_topk_matches(ts, ti, js, ji):
    ts, ti = ts.numpy(), ti.numpy()
    js, ji = np.asarray(js), np.asarray(ji)
    assert ts.shape == js.shape and ti.dtype == np.int32
    np.testing.assert_array_equal(np.isinf(ts), np.isinf(js))
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ti == SENTINEL, ji == SENTINEL)
    np.testing.assert_array_equal(ji == SENTINEL, ~fin)
    # ids where the score stands apart from both neighbours
    tol = ATOL + RTOL * np.abs(js)
    gap_r = np.full(js.shape, np.inf)
    gap_r[:, :-1] = np.abs(js[:, :-1] - js[:, 1:])
    gap_l = np.full(js.shape, np.inf)
    gap_l[:, 1:] = gap_r[:, :-1]
    apart = fin & (np.nan_to_num(gap_r, nan=np.inf) > 4 * tol) & (
        np.nan_to_num(gap_l, nan=np.inf) > 4 * tol
    )
    np.testing.assert_array_equal(ti[apart], ji[apart])
    return int(apart.sum())


@pytest.mark.parametrize("use_ops", [False, True], ids=["plain", "ops"])
@pytest.mark.parametrize("k", [1, 10, 900])
def test_score_topk_matches_jax(k, use_ops):
    """C = 700 is no multiple of either chunk; k = 900 is more than the
    live rows (and than the chunk), so the tail is -INF / SENTINEL."""
    import jax.numpy as jnp

    case = _scorer_case()
    t_args = [torch.from_numpy(np.asarray(a)) for a in case]
    compared = 0
    outs = []
    for chunk in (256, 512):
        ts, ti = tbm25._score_topk(*t_args, k, chunk=chunk, use_ops=use_ops)
        js, ji = jax_score_topk(*(jnp.asarray(a) for a in case), k, chunk=chunk, use_ops=use_ops)
        compared += _assert_topk_matches(ts, ti, js, ji)
        outs.append((ts, ti))
    assert compared > 0
    # the port's answer does not depend on the chunk: bit-equal scores and
    # ids (ties go to the lower id under every chunking)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_score_topk_ties_go_to_the_lower_id():
    """Equal scores are common (same tf, same length): the lower id first,
    as jax.lax.top_k orders them, also across a chunk boundary."""
    C, U = 64, 4
    terms = np.zeros((C, U), dtype=np.int32)
    terms[:, 0] = 7
    tf = np.zeros((C, U), dtype=np.int32)
    tf[:, 0] = 2
    length = np.full((C,), 5, dtype=np.int32)
    valid = np.ones((C,), dtype=bool)
    valid[3] = False
    q = (np.array([[7, 0]], np.int32), np.array([[1.5, 0]], np.float32),
         np.zeros((1, 8), np.int32), np.zeros((1, 8), np.int32), np.float32(5.0))
    args = [torch.from_numpy(np.asarray(a)) for a in (terms, tf, length, valid, *q)]
    for chunk in (8, 24, 64):
        s, i = tbm25._score_topk(*args, 20, chunk=chunk)
        assert i[0].tolist() == [x for x in range(21) if x != 3]
        assert float(s[0].max()) == float(s[0].min())


def test_score_step_fits_its_byte_budget(monkeypatch):
    """The chunk shrinks with the batch: at 128 queries of 64 terms a step
    stays under SCORE_BYTES, and a tiny budget still gives the same answer."""
    rows = tbm25._chunk_rows(None, 128, 64, 128 * 64, 256)
    assert rows < 1 << 13 and tbm25._chunk_rows(64, 128, 64, 128 * 64, 256) == 64
    assert rows * (4 * (128 * 64 + 1) + 12 * 128 * 64) <= tbm25.SCORE_BYTES
    case = [torch.from_numpy(np.asarray(a)) for a in _scorer_case(seed=9, C=300)]
    want = tbm25._score_topk(*case, 10, use_ops=True)
    monkeypatch.setattr(tbm25, "SCORE_BYTES", 1 << 16)
    got = tbm25._score_topk(*case, 10, use_ops=True)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


# --------------------------------------------------------------------------
# BM25Index after churn


N_DOCS, VOCAB, WORDS = 2000, 3000, 24


def _zipf_docs(n=N_DOCS, seed=11):
    """The JAX bench's text recipe (bench.py::bench_text) at a small size."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1)
    p /= p.sum()
    return [" ".join(f"w{t}" for t in row) for row in rng.choice(VOCAB, size=(n, WORDS), p=p)], rng, p


@pytest.fixture(scope="module")
def churned():
    """Both packages' indexes fed the same documents, with removes and
    re-adds; (torch index, jax index, docs)."""
    docs, rng, _ = _zipf_docs()
    t, j = TorchBM25(device="cpu"), JaxBM25()
    for d in docs[:1500]:
        assert t.add(d) == j.add(d)
    # a search in between makes the later changes go through the dirty-row flush
    assert _slots(t.search(["w1 w2"], 5)) == _slots(j.search(["w1 w2"], 5))
    gone = rng.choice(1500, size=200, replace=False)
    for s in gone:
        t.remove(int(s))
        j.remove(int(s))
    for d in docs[1500:]:
        assert t.add(d) == j.add(d)
    for s in gone[:50]:
        assert t.add(docs[int(s)]) == j.add(docs[int(s)])
    return t, j, docs


def _slots(results):
    return [[s for s, _ in hits] for hits in results]


def _assert_same_hits(t_res, j_res):
    """The same (slot, score) lists; slots compared as sets over each run
    of scores that tie within the tolerance."""
    assert len(t_res) == len(j_res)
    for th, jh in zip(t_res, j_res):
        assert len(th) == len(jh)
        ts, js = np.array([v for _, v in th]), np.array([v for _, v in jh])
        np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
        start = 0
        for i in range(1, len(jh) + 1):
            if i == len(jh) or abs(js[i] - js[i - 1]) > 4 * (ATOL + RTOL * abs(js[i])):
                if i < len(jh) or start == 0:  # a run cut by position k may differ
                    assert {s for s, _ in th[start:i]} == {s for s, _ in jh[start:i]}
                start = i


def test_bookkeeping_equal_after_churn(churned):
    t, j, _ = churned
    assert t.count() == j.count() == 1850
    assert {k: v for k, v in t._df.items() if v} == {k: v for k, v in j._df.items() if v}
    assert t._total_len == j._total_len and t._frontier == j._frontier
    assert t._vocab == j._vocab


@pytest.mark.parametrize(
    "kind, queries",
    [
        ("plain", ["w1 w5 w9", "w2", "w40 w41 w700", "w2999 w3 w3", "nosuchword", "w17 w230"]),
        ("operators", ["+w3 w7 -w1", "w2 -w1 -w3", "w10 +w11", "-w1", "w5 w6 -w2", "w1 + w2"]),
        ("phrase", ['"w1 w2"', '"w2 w1" w5', 'w3 -"w1 w1"', '"w1 w3"~2', '"w4 w1"', "w9"]),
        ("prefix", ["w19*", "w2* w5", "w299* + w1", "zz*", "w1*", "(w12* | w7) + w2"]),
        ("fuzzy", ["w12~1", "w123~1 w4", "w1~1", "x5~1", "w2999~2", "w77~1 -w1"]),
    ],
)
def test_search_matches_jax_after_churn(churned, kind, queries):
    t, j, _ = churned
    _assert_same_hits(t.search(queries, 10), j.search(queries, 10))


def test_long_queries_score_all_terms_like_jax(churned):
    """More than 16 unique terms: all are scored (T 32 and 64 in the JAX
    package); more than 64: the 64 of highest idf."""
    t, j, _ = churned
    q20 = " ".join(f"w{i}" for i in range(1, 21))
    q40 = " ".join(f"w{i}" for i in range(100, 140))
    q70 = " ".join(f"w{i}" for i in range(1, 71))
    for q in (q20, q40, q70):
        _assert_same_hits(t.search([q], 10), j.search([q], 10))


def test_search_on_empty_index_and_k_past_live_rows():
    t, j = TorchBM25(device="cpu"), JaxBM25()
    assert t.search(["anything"], 3) == j.search(["anything"], 3) == [[]]
    for d in ("red fox", "red dog", "blue fox"):
        t.add(d)
        j.add(d)
    _assert_same_hits(t.search(["red fox"], 50), j.search(["red fox"], 50))
    assert len(t.search(["red fox"], 50)[0]) == 3


def test_document_past_256_distinct_terms_keeps_the_same_terms():
    words = [f"t{i}" for i in range(300)]
    doc = " ".join(words + words[:100] + words[:10])  # tf 3, 2, 1: the kept set is decided by tf
    t, j = TorchBM25(device="cpu"), JaxBM25()
    st, sj = t.add(doc), j.add(doc)
    t.add("t299 other")
    j.add("t299 other")
    assert st == sj
    assert set(t._terms[st].tolist()) == set(j._terms[sj].tolist())
    assert sorted(zip(t._terms[st].tolist(), t._tf[st].tolist())) == sorted(
        zip(j._terms[sj].tolist(), j._tf[sj].tolist()))
    assert t._length[st] == j._length[sj] == 410
    _assert_same_hits(t.search(["t5 t150 t299"], 2), j.search(["t5 t150 t299"], 2))


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshots_load_in_both_directions(churned, tmp_path, direction):
    t, j, _ = churned
    path = str(tmp_path / "text.npz")
    if direction == "jax_to_torch":
        j.save(path)
        loaded, other = TorchBM25.load(path, device="cpu"), j
    else:
        t.save(path)
        loaded, other = JaxBM25.load(path), t
    with np.load(path) as z:
        assert int(z["version"]) == 1
        want = {"version": "int64", "terms": "int32", "tf": "int32", "length": "int32",
                "valid": "bool", "seq_data": "int32", "seq_off": "int64", "vocab_ids": "int64"}
        assert {k: str(z[k].dtype) for k in want} == want and z["vocab_words"].dtype.kind == "U"
    assert loaded.count() == other.count()
    queries = ["w1 w5 w9", "+w3 w7 -w1", '"w1 w2"', "w19*", "w12~1"]
    a, b = loaded.search(queries, 10), other.search(queries, 10)
    if direction == "jax_to_torch":
        _assert_same_hits(a, b)
    else:
        _assert_same_hits(b, a)
    # a loaded index goes on taking documents
    assert loaded.add("w1 w1 w1 brandnewword") == other._frontier


def test_snapshot_round_trip_and_version_check(churned, tmp_path):
    t, _, _ = churned
    path = str(tmp_path / "t.npz")
    t.save(path)
    back = TorchBM25.load(path, device="cpu")
    qs = ["w1 w5 w9", '"w1 w2"', "w2 -w1"]
    assert back.search(qs, 10) == t.search(qs, 10)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["version"] = np.int64(2)
    np.savez(str(tmp_path / "v2.npz"), **arrays)
    with pytest.raises(ValueError, match="unsupported snapshot version"):
        TorchBM25.load(str(tmp_path / "v2.npz"), device="cpu")


def test_searches_never_see_half_a_flush():
    """Adds on one thread, searches on others: every answer holds only
    documents whose row was whole (the index lock orders flush and scorer)."""
    import sys
    import threading

    t = TorchBM25(device="cpu")
    for i in range(50):
        t.add(f"seed common w{i}")
    t.search(["common"], 5)
    stop, errors = threading.Event(), []

    def searcher():
        while not stop.is_set():
            for slot, score in t.search(["common"], 400)[0]:
                if not (score > 0 and t._length[slot] == 3):
                    errors.append((slot, score))

    threads = [threading.Thread(target=searcher) for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for i in range(300):
            s = t.add(f"later common x{i}")
            if i % 3 == 0:
                t.remove(s)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=60)
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    assert t.count() == 50 + 200 and len(t.search(["common"], 400)[0]) == 250


# --------------------------------------------------------------------------
# the routes


async def _client():
    engine = await new_engine(new_index_factory(device="cpu"))
    c = TestClient(TestServer(build_app(engine)))
    await c.start_server()
    return c, engine


TX = "/api/v1/text-search"


@pytest.mark.asyncio
async def test_text_routes_over_the_server():
    docs = {
        "a1": "the quick brown fox jumps over the lazy dog",
        "a2": "a quick brown cat sleeps all day",
        "a3": "the brown bear eats quick salmon",
        "a4": "foxtrot dancing lessons downtown",
    }
    c, engine = await _client()
    try:
        assert await (await c.get(TX)).json() == []
        r = await c.post(TX + "/articles/search", json={"text": "fox"})
        assert r.status == 404  # unknown index
        r = await c.post(TX + "/articles/add", json={"id": "x", "text": "y"})
        assert r.status == 404
        assert (await c.put(TX + "/articles")).status == 200
        for key, text in docs.items():
            r = await c.post(TX + "/articles/add", json={"id": key, "text": text})
            assert r.status == 200
        assert await (await c.get(TX)).json() == ["articles"]
        for query, want in (
            ("fox", ["a1"]),
            ("fox*", {"a1", "a4"}),
            ("brown +cat", ["a2"]),
            ('"quick brown"', {"a1", "a2"}),
            ("brown -(cat | salmon)", ["a1"]),
            ("cet~1", ["a2"]),
        ):
            r = await c.post(TX + "/articles/search", json={"text": query, "limit": 5})
            assert r.status == 200
            got = await r.json()
            assert (set(got) if isinstance(want, set) else got) == want, query
        r = await c.post(TX + "/articles/search", json={"text": "quick"})
        assert len(await r.json()) == 1  # limit defaults to 1
        # an upsert of the same id replaces the document
        await c.post(TX + "/articles/add", json={"id": "a1", "text": "nothing of the kind"})
        r = await c.post(TX + "/articles/search", json={"text": "fox", "limit": 5})
        assert await r.json() == []
        # malformed bodies
        r = await c.post(TX + "/articles/search", data=b"{nope")
        assert r.status == 400
        r = await c.post(TX + "/articles/search", json={"limit": 2})
        assert r.status == 500 and "index.search request error" in await r.text()

        # a text index is absent from the ANN listing, and the reverse
        r = await c.put("/api/v1/indexes/ks/vecs", json={"dimensions": 4})
        assert r.status == 200
        assert await (await c.get(TX)).json() == ["articles"]
        assert await (await c.get("/api/v1/indexes")).json() == ["ks.vecs"]
        info = await (await c.get("/api/v1/indexes/ks/vecs")).json()
        assert info["kind"] == "ann"

        # re-PUT recreates: the documents are gone
        assert (await c.put(TX + "/articles")).status == 200
        r = await c.post(TX + "/articles/search", json={"text": "quick", "limit": 5})
        assert r.status == 200 and await r.json() == []
    finally:
        await c.close()
        await engine.close()


@pytest.mark.asyncio
async def test_text_routes_answer_as_the_jax_service():
    """The same requests to both packages' servers: equal statuses and bodies."""
    from vector_store_tpu import new_index_factory as jax_factory
    from vector_store_tpu.api.routes import build_app as jax_app
    from vector_store_tpu.engine.engine import new_engine as jax_engine

    docs, _, _ = _zipf_docs(n=120, seed=4)
    c, engine = await _client()
    je = await jax_engine(jax_factory())
    jc = TestClient(TestServer(jax_app(je)))
    await jc.start_server()
    try:
        for cl in (c, jc):
            assert (await cl.put(TX + "/zipf")).status == 200
            for i, d in enumerate(docs):
                r = await cl.post(TX + "/zipf/add", json={"id": f"d{i}", "text": d})
                assert r.status == 200
        jidx = JaxBM25()  # the scores behind the JAX service's answers
        for d in docs:
            jidx.add(d)
        compared = 0
        for body in (
            {"text": "w1 w2 w3", "limit": 3},
            {"text": "w5 -w1", "limit": 4},
            {"text": '"w1 w2"', "limit": 5},
            {"text": "w1*", "limit": 2},
            {"text": "qqqq"},
        ):
            a = await c.post(TX + "/zipf/search", json=body)
            b = await jc.post(TX + "/zipf/search", json=body)
            assert a.status == b.status == 200
            got, want = await a.json(), await b.json()
            # scores tie often on so small a corpus: equal lengths always,
            # equal keys in order when the scores down to position k + 1
            # stand apart
            assert len(got) == len(want)
            limit = body.get("limit", 1)
            vals = [v for _, v in jidx.search([body["text"]], limit + 1)[0]]
            if all(abs(x - y) > 1e-4 for x, y in zip(vals, vals[1:])):
                assert got == want, body
                compared += 1
        assert compared >= 2
        assert (await c.get(TX)).status == (await jc.get(TX)).status == 200
        assert await (await c.get(TX)).json() == await (await jc.get(TX)).json() == ["zipf"]
        a = await c.post(TX + "/none/search", json={"text": "x"})
        b = await jc.post(TX + "/none/search", json={"text": "x"})
        assert a.status == b.status == 404
    finally:
        await c.close()
        await jc.close()
        await engine.close()
        await je.close()

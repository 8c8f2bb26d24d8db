"""vector_store_tpu_torch ShardedBM25Index against the JAX ShardedBM25Index
(four of the eight virtual CPU devices) and against both packages' single
BM25Index, on the CPU with four logical shards.

The flat slot a document gets, the host bookkeeping and the row a slot
lives in (shard `s % S`, row `s // S`) must be equal.  Scores agree to
rtol 1e-4 (f32, another summation order); the order of the hits is
compared wherever scores are distinct, as sets over each run of tied
scores: the sharded merge breaks ties by position in the shard-major
concatenation, the single index by lower slot.
"""

import numpy as np
import pytest
import torch

from vector_store_tpu.text.sharded_bm25 import ShardedBM25Index as JSharded
from vector_store_tpu_torch.text.bm25 import BM25Index as TSingle
from vector_store_tpu_torch.text.sharded_bm25 import ShardedBM25Index as TSharded

S = 4
RTOL, ATOL = 1e-4, 1e-6
N_DOCS, VOCAB, WORDS = 1200, 2000, 24

QUERIES = {
    "plain": ["w1 w5 w9", "w2", "w40 w41 w700", "nosuchword", "w17 w230"],
    "operators": ["+w3 w7 -w1", "w2 -w1 -w3", "w10 +w11", "-w1", "w1 + w2"],
    "phrase": ['"w1 w2"', '"w2 w1" w5', 'w3 -"w1 w1"', '"w1 w3"~2'],
    "prefix": ["w19*", "w2* w5", "zz*", "(w12* | w7) + w2"],
    "fuzzy": ["w12~1", "w123~1 w4", "w77~1 -w1"],
}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _zipf_docs(n=N_DOCS, seed=11):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, VOCAB + 1)
    p /= p.sum()
    rows = rng.choice(VOCAB, size=(n, WORDS), p=p)
    return [" ".join(f"w{t}" for t in row) for row in rows], rng


def _assert_same_hits(a_res, b_res, single=False):
    """The same (slot, score) lists; slots compared as sets over each run
    of scores that tie within the tolerance.  Against the single index
    (`single`) a run that reaches the end of the list is not compared: the
    two break ties differently, so they cut such a run at other documents."""
    assert len(a_res) == len(b_res)
    for ah, bh in zip(a_res, b_res):
        assert len(ah) == len(bh)
        sa, sb = np.array([v for _, v in ah]), np.array([v for _, v in bh])
        np.testing.assert_allclose(sa, sb, rtol=RTOL, atol=ATOL)
        start = 0
        for i in range(1, len(bh) + 1):
            if i == len(bh) or abs(sb[i] - sb[i - 1]) > 4 * (ATOL + RTOL * abs(sb[i])):
                if i < len(bh) or (start == 0 and not single):  # a run cut by k may differ
                    assert {s for s, _ in ah[start:i]} == {s for s, _ in bh[start:i]}
                start = i


def _rows_match_host(idx):
    """Every shard's device rows are the host rows of its slots."""
    arrays = idx._device_arrays()
    R = idx._dev_rows
    assert len(arrays) == S
    for s, (terms, tf, length, valid) in enumerate(arrays):
        assert terms.shape == (R, idx._terms.shape[1])
        slots = np.arange(R) * S + s
        ok = slots < idx._terms.shape[0]
        np.testing.assert_array_equal(terms.numpy()[ok], idx._terms[slots[ok]])
        np.testing.assert_array_equal(tf.numpy()[ok], idx._tf[slots[ok]])
        np.testing.assert_array_equal(length.numpy()[ok], idx._length[slots[ok]])
        np.testing.assert_array_equal(valid.numpy()[ok], idx._valid[slots[ok]])
        assert not valid.numpy()[~ok].any()


@pytest.fixture(scope="module")
def churned():
    """The port's sharded and single indexes and the JAX sharded index, fed
    the same documents with searches, removes and re-adds in between."""
    docs, rng = _zipf_docs()
    t, one, j = TSharded(n_devices=S, device="cpu"), TSingle(device="cpu"), JSharded(n_devices=S)
    for d in docs[:900]:
        assert t.add(d) == one.add(d) == j.add(d)
    # a search in between: the later changes go through the dirty-row writes
    for idx in (t, one, j):
        idx.search(["w1 w2"], 5)
    gone = rng.choice(900, size=150, replace=False)
    for s in gone:
        for idx in (t, one, j):
            idx.remove(int(s))
    for d in docs[900:]:
        assert t.add(d) == one.add(d) == j.add(d)
    for s in gone[:40]:
        assert t.add(docs[int(s)]) == one.add(docs[int(s)]) == j.add(docs[int(s)])
    return t, one, j


def test_slots_and_bookkeeping_equal_after_churn(churned):
    t, one, j = churned
    assert t.count() == one.count() == j.count() == N_DOCS - 150 + 40
    assert t._frontier == j._frontier and t._total_len == j._total_len
    assert {k: v for k, v in t._df.items() if v} == {k: v for k, v in j._df.items() if v}
    assert t._vocab == j._vocab
    assert t.n_shards == j.n_shards == S


@pytest.mark.parametrize("kind", list(QUERIES))
def test_search_matches_jax_and_the_single_index_after_churn(churned, kind):
    t, one, j = churned
    got = t.search(QUERIES[kind], 10)
    _assert_same_hits(got, j.search(QUERIES[kind], 10))
    if kind != "phrase":  # the phrase filter runs over the overfetched ties
        _assert_same_hits(got, one.search(QUERIES[kind], 10), single=True)


def test_device_rows_follow_the_deal_and_the_dirty_writes(churned):
    t, _, j = churned
    t.search(["w1"], 3)  # flushes the dirty rows
    assert not t._dirty_slots and t._dev_rows == j._dev_rows
    _rows_match_host(t)
    s = t.add("w1 w1 w1 w1 zzznew")
    assert t._dirty_slots == {s}
    hits = t.search(["zzznew"], 3)[0]
    assert [h[0] for h in hits] == [s]
    _rows_match_host(t)
    t.remove(s)
    assert t.search(["zzznew"], 3)[0] == []
    _rows_match_host(t)


def test_bank_resize_reuploads_every_shard(monkeypatch):
    """MIN_SHARD_ROWS shrunk: the per-shard banks double as documents come
    in, in the same steps as the JAX package's, and the answers do not
    change with the size."""
    monkeypatch.setattr(TSharded, "MIN_SHARD_ROWS", 4)
    monkeypatch.setattr(JSharded, "MIN_SHARD_ROWS", 4)
    docs, _ = _zipf_docs(300, seed=5)
    t, j, one = TSharded(n_devices=S, device="cpu"), JSharded(n_devices=S), TSingle(device="cpu")
    sizes = []
    for i, d in enumerate(docs):
        assert t.add(d) == j.add(d) == one.add(d)
        if i % 37 == 0 or i == len(docs) - 1:
            q = ["w1 w3", "w2 -w1", '"w1 w2"']
            got = t.search(q, 8)
            _assert_same_hits(got, j.search(q, 8))
            _assert_same_hits(got[:2], one.search(q[:2], 8), single=True)
            assert t._dev_rows == j._dev_rows
            _rows_match_host(t)
            sizes.append(t._dev_rows)
    assert len(set(sizes)) >= 3 and sizes == sorted(sizes)  # it grew, by doubling


def test_avg_len_is_global_and_ties_take_the_shard_major_order():
    t = TSharded(n_devices=S, device="cpu")
    one = TSingle(device="cpu")
    # eight documents of equal score for "fox": slots 0..7, two a shard
    for i in range(8):
        text = "fox " + " ".join(f"pad{i}x{k}" for k in range(i % 2 + 1))
        assert t.add(text) == one.add(text)
    same = [t.add("fox cat") for _ in range(4)]  # slots 8..11: one a shard, all tied
    for _ in same:
        one.add("fox cat")
    a, b = t.search(["fox"], 12)[0], one.search(["fox"], 12)[0]
    np.testing.assert_allclose(sorted(v for _, v in a), sorted(v for _, v in b), rtol=RTOL)
    assert {s for s, _ in a} == {s for s, _ in b} == set(range(12))
    # among the four tied copies the shard-major order is slot order here
    # (row 2 of shards 0..3); the single index orders them by slot too
    tied = [s for s, _ in a if s in same]
    assert tied == same


def test_empty_index_and_k_past_the_live_rows():
    t, j = TSharded(n_devices=S, device="cpu"), JSharded(n_devices=S)
    assert t.search(["anything"], 3) == j.search(["anything"], 3) == [[]]
    for d in ("red fox", "red dog", "blue fox"):
        assert t.add(d) == j.add(d)
    _assert_same_hits(t.search(["red fox"], 50), j.search(["red fox"], 50))


@pytest.mark.parametrize("direction", ["port->jax", "jax->port", "single->sharded"])
def test_snapshots_load_in_both_directions(churned, tmp_path, direction):
    """The snapshot is the base class's (host rows only): it carries no
    shard count, so any of the classes reads any of the files."""
    t, one, j = churned
    path = str(tmp_path / "bm25.npz")
    if direction == "port->jax":
        src, back = t, lambda: JSharded.load(path, n_devices=S)
    elif direction == "jax->port":
        src, back = j, lambda: TSharded.load(path, n_devices=S, device="cpu")
    else:
        src, back = one, lambda: TSharded.load(path, n_devices=S, device="cpu")
    src.save(path)
    back = back()
    assert back.count() == src.count() and back._frontier == src._frontier
    for kind in ("plain", "operators", "prefix"):
        _assert_same_hits(back.search(QUERIES[kind], 10), src.search(QUERIES[kind], 10),
                          single=src is one)
    assert back.add("a new document") == src._frontier

"""The batched text load of vector_store_tpu_torch, on the CPU: the vectorised
analysis (`tokenizer.analyze`) against `tokenize` + `term_id` token by
token, `BM25Index.add_batch` against the same documents added one by one
(every field, the expanders, the answers), the sharded index's flat slots,
the JAX package's rows, and `AddBatch` through the engine against `Add`
messages in order."""

import asyncio
import random

import numpy as np
import pytest
import torch

from vector_store_tpu.text.bm25 import BM25Index as JaxBM25
from vector_store_tpu_torch import IndexId, IndexMetadata, IndexParams, Limit, new_index_factory
from vector_store_tpu_torch.engine.engine import new_engine
from vector_store_tpu_torch.text import bm25 as tbm25
from vector_store_tpu_torch.text import tokenizer as ttok
from vector_store_tpu_torch.text.bm25 import BM25Index
from vector_store_tpu_torch.text.sharded_bm25 import ShardedBM25Index

KELVIN, DOTTED_I = "\u212a", "\u0130"  # lower() maps them to ASCII letters

FIELDS = ("_terms", "_tf", "_length", "_valid", "_frontier", "_size", "_total_len",
          "_dirty_slots", "_vocab_dirty")


def _random_texts(n, seed, ascii_only=False):
    """Documents with repeats, digits, punctuation, empty ones, long tokens,
    upper case, non-ASCII letters and some past 256 distinct terms."""
    rng = random.Random(seed)
    words = ["quick", "Brown", "FOX", "42", "x9y", "the", "a", "zz", "naïve", "café", "Ωmega",
             KELVIN + "elvin", DOTTED_I + "stanbul", "straße"] + [f"w{i}" for i in range(400)]
    if ascii_only:
        words = [w for w in words if w.isascii()]
    punct = [" ", " ", " ", ", ", ". ", "-", "!", "\n", "\t", "...", "\x00", "'"]
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.05:
            out.append("")
        elif r < 0.1:
            out.append(rng.choice(["...", " ,;! ", "\n\n", "-- --"]))
        elif r < 0.15:
            out.append(" ".join(f"t{rng.randint(0, 10**6)}" for _ in range(rng.randint(257, 320))))
        elif r < 0.2:
            out.append("A" * rng.randint(15, 90) + " " + "b" * rng.randint(1, 20) + "Q" * 70)
        else:
            toks = [rng.choice(words) for _ in range(rng.randint(1, 60))]
            out.append("".join(t + rng.choice(punct) for t in toks))
    return out


TEXT_SETS = {
    "mixed": _random_texts(400, 1),
    "ascii": _random_texts(400, 2, ascii_only=True),
    "one": ["The quick brown fox, the QUICK one."],
    "empty": ["", "", "..."],
    "non-ascii-alone": [KELVIN + " " + DOTTED_I + "ii", "naïve café 42nd"],
}


@pytest.mark.parametrize("name", sorted(TEXT_SETS))
def test_the_vectorised_analysis_is_tokenize_and_term_id(name):
    texts = TEXT_SETS[name]
    got = ttok.analyze(texts, "cpu")
    assert got.ids.tolist() == [ttok.term_id(w) for t in texts for w in ttok.tokenize(t)]
    assert got.per_doc.tolist() == [len(ttok.tokenize(t)) for t in texts]
    first = {}
    for t in texts:
        for w in ttok.tokenize(t):
            first.setdefault(w, ttok.term_id(w))
    assert list(got.words.items()) == list(first.items())
    # the packed words: every distinct ASCII-analysed word of at most 16 bytes
    packed = {w: t for w, t in first.items() if w.isascii() and len(w) <= ttok.PACK_BYTES}
    assert sorted(got.packed_ids.tolist()) <= sorted(packed.values())
    for t, (k0, k1) in zip(got.packed_ids.tolist(), got.packed.tolist()):
        w = (k0.to_bytes(8, "little", signed=True) + k1.to_bytes(8, "little", signed=True))
        assert packed[w.rstrip(b"\0").decode()] == t


def test_the_analysis_hashes_tokens_past_the_devices_bytes(monkeypatch):
    monkeypatch.setattr(ttok, "HASH_BYTES", 8)
    texts = ["abcdefghijklmnop q " + "x" * 40, "abcdefghijklmnop"]
    got = ttok.analyze(texts, "cpu")
    assert got.ids.tolist() == [ttok.term_id(w) for t in texts for w in ttok.tokenize(t)]
    assert list(got.words) == ["abcdefghijklmnop", "q", "x" * 40]


# two words of one term id (FNV-1a folded to 2^22 - 1)
COLLIDING = ("w8250", "w12204")


def test_known_words_are_left_out_and_a_colliding_word_is_not():
    a, b = COLLIDING
    assert ttok.term_id(a) == ttok.term_id(b)
    known = torch.zeros((ttok.TERM_SPACE, 2), dtype=torch.int64)
    first = ttok.analyze([f"{a} zz", "Zz top"], "cpu", known)
    assert list(first.words) == [a, "zz", "top"]
    known[first.packed_ids] = first.packed
    again = ttok.analyze([f"top {b} new {a} ZZ"], "cpu", known)
    assert list(again.words) == [b, "new"]  # b shares a's id, not its bytes
    assert again.ids.tolist() == [ttok.term_id(w) for w in ("top", b, "new", a, "zz")]


def test_add_batch_keeps_both_words_of_one_id_in_the_vocabulary():
    a, b = COLLIDING
    texts = [[f"{a} one"], [f"{b} two {a}"], [f"{a} {b} three"]]
    one, batch = BM25Index(device="cpu"), BM25Index(device="cpu")
    for group in texts:
        for t in group:
            one.add(t)
        batch.add_batch(group)
    assert [w for w in batch._vocab if w in COLLIDING] == [a, b]
    _same_index(one, batch)


def _same_index(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        else:
            assert x == y, f
    assert dict(a._df) == dict(b._df)
    assert list(a._vocab.items()) == list(b._vocab.items())
    assert list(a._vocab_by_len) == list(b._vocab_by_len)
    assert a._vocab_by_len == b._vocab_by_len
    assert len(a._seqs) == len(b._seqs)
    for x, y in zip(a._seqs, b._seqs):
        assert (x is None and y is None) or (x.dtype == y.dtype and np.array_equal(x, y))


QUERIES = ["quick fox", "w1 w2 w3", "+quick -fox", '"quick brown"', "w1*", "w12~1 brown",
           "kelvin", "istanbul", "42 x9y", "(w5 | w6) + the", "t1*", "aaaaaaaaaaaaaaa"]


@pytest.mark.parametrize("name", ["mixed", "ascii"])
def test_add_batch_leaves_the_index_that_adds_one_by_one_leave(name):
    texts = TEXT_SETS[name]
    one, batch = BM25Index(initial_capacity=16, device="cpu"), BM25Index(initial_capacity=16, device="cpu")
    # a search in between: the later batches go through the dirty-row flush
    slots = [one.add(t) for t in texts[:150]]
    assert batch.add_batch(texts[:150]) == slots
    assert one.search(QUERIES, 10) == batch.search(QUERIES, 10)
    for s in (0, 3, 77, 149):
        one.remove(s)
        batch.remove(s)
    slots = [one.add(t) for t in texts[150:]]
    assert batch.add_batch(texts[150:170]) + batch.add_batch(texts[170:]) == slots
    assert batch.add_batch([]) == []
    _same_index(one, batch)
    assert one._terms.shape == batch._terms.shape == (1024, tbm25.MAX_DOC_TERMS)
    for prefix in ("w1", "t", "qu", "ka", "x"):
        assert one.expand_prefix(prefix, 8) == batch.expand_prefix(prefix, 8)
    for word, dist in (("w12", 1), ("quik", 1), ("brwn", 2), ("kelvim", 1)):
        assert one.expand_fuzzy(word, dist, 8) == batch.expand_fuzzy(word, dist, 8)
    assert one.search(QUERIES, 10) == batch.search(QUERIES, 10)
    _same_index(one, batch)


def test_add_batch_drops_rare_terms_past_256_as_add_does():
    texts = [" ".join(f"u{i % 300}" for i in range(900)) + " u7 u7", "short doc"]
    one, batch = BM25Index(device="cpu"), BM25Index(device="cpu")
    for t in texts:
        one.add(t)
    batch.add_batch(texts)
    _same_index(one, batch)
    assert (batch._terms[0] != tbm25.PAD).sum() == tbm25.MAX_DOC_TERMS


def test_add_batch_grows_once_to_the_capacity_adds_reach():
    texts = ["doc %d words" % i for i in range(3000)]
    one, batch = BM25Index(initial_capacity=1024, device="cpu"), BM25Index(initial_capacity=1024, device="cpu")
    for t in texts:
        one.add(t)
    grows = []
    real = batch._grow
    batch._grow = lambda need: (grows.append(need), real(need))
    batch.add_batch(texts)
    assert grows == [3000] and batch._terms.shape == one._terms.shape == (4096, tbm25.MAX_DOC_TERMS)
    _same_index(one, batch)


def test_sharded_add_batch_gives_the_flat_slots_of_adds_one_by_one():
    texts = TEXT_SETS["mixed"][:120]
    one = ShardedBM25Index(n_devices=4, device="cpu")
    batch = ShardedBM25Index(n_devices=4, device="cpu")
    single = BM25Index(device="cpu")
    slots = [one.add(t) for t in texts]
    assert batch.add_batch(texts) == slots == single.add_batch(texts)
    _same_index(one, batch)
    assert one.search(QUERIES, 10) == batch.search(QUERIES, 10)


@pytest.mark.parametrize("name", ["mixed", "ascii"])
def test_add_batch_rows_equal_the_jax_packages_add(name):
    texts = TEXT_SETS[name]
    jax_idx, batch = JaxBM25(), BM25Index(device="cpu")
    slots = [jax_idx.add(t) for t in texts]
    assert batch.add_batch(texts) == slots
    f = batch._frontier
    for field in ("_terms", "_tf", "_length", "_valid"):
        assert np.array_equal(np.asarray(getattr(jax_idx, field))[:f], getattr(batch, field)[:f]), field
    assert {k: v for k, v in jax_idx._df.items() if v} == {k: v for k, v in batch._df.items() if v}
    assert jax_idx._vocab == batch._vocab and jax_idx._total_len == batch._total_len


def _run(coro):
    return asyncio.run(coro)


async def _text_index(n_devices=1):
    engine = await new_engine(new_index_factory(device="cpu", n_devices=n_devices))
    index_id = IndexId.from_parts("ks", "docs")
    await engine.add_index(IndexMetadata(index_id=index_id, kind="text"))
    return engine, await engine.get_index(index_id)


@pytest.mark.parametrize("n_devices", [1, 4])
def test_add_batch_through_the_engine_replaces_keys_as_adds_in_order_do(n_devices):
    texts = TEXT_SETS["ascii"][:90]
    # keys repeat within a batch and across batches
    keys = [(i % 37,) for i in range(len(texts))]
    batches = [list(zip(keys[a:b], texts[a:b])) for a, b in ((0, 40), (40, 41), (41, 90))]

    async def main():
        e1, one = await _text_index(n_devices)
        e2, batch = await _text_index(n_devices)
        try:
            for items in batches:
                for key, text in items:
                    await one.add(key, text)
                await batch.add_batch(items)
                assert await one.count() == await batch.count()
            assert await batch.count() == 37
            b1, b2 = one.backend, batch.backend
            assert b1.keymap._by_key == b2.keymap._by_key and b1.keymap._by_slot == b2.keymap._by_slot
            _same_index(b1.index, b2.index)
            for q in QUERIES:
                assert await one.search(q, Limit(10)) == await batch.search(q, Limit(10))
        finally:
            await e1.close()
            await e2.close()

    _run(main())


def test_add_batch_with_an_unusable_key_fails_before_the_add():
    async def main():
        engine, handle = await _text_index()
        try:
            with pytest.raises(ValueError, match="unusable primary key"):
                await handle.add_batch([((1,), "one"), (([2],), "two")])
            assert await handle.count() == 0
            await handle.add_batch([((1,), "one")])
            assert await handle.search("one", Limit(3)) == [(1,)]
        finally:
            await engine.close()

    _run(main())


@pytest.mark.parametrize("kind", ["ann", "ivf"])
def test_an_ann_index_answers_add_batch_with_a_type_error(kind):
    async def main():
        engine = await new_engine(new_index_factory(device="cpu"))
        index_id = IndexId.from_parts("ks", "vec")
        await engine.add_index(IndexMetadata(index_id, IndexParams(dimensions=4), kind=kind))
        handle = await engine.get_index(index_id)
        try:
            with pytest.raises(TypeError, match="text protocol"):
                await handle.add_batch([((1,), "text")])
        finally:
            await engine.close()

    _run(main())

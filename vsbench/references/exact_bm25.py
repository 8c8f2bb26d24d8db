"""Plain reference for BM25 text search: an exact search over an inverted
index, in float64.

Imports torch alone (nothing of the program): the passages it is
given are the benchmark's own word ids (vsbench/corpora/msmarco_like.py),
made again from the seed, and the analysis is written here again:

  term(word)  FNV-1a 32 of the word's UTF-8 bytes, folded to
              h % (2^22 - 1) + 1, so two words may share a term
  tf          a term's count in a passage; the passage's length is its exact
              number of words, avgdl the words over the passages
  idf(t)      ln(1 + (N - df + 0.5) / (df + 0.5)), df the passages holding t
  score(q, p) sum over q's distinct terms t of
              idf(t) * tf * (k1 + 1) / (tf + k1 * (1 - b + b * len / avgdl)),
              k1 1.2, b 0.75 (OpenSearch's defaults)

A passage qualifies for a query where its score is above 0; the top-k are
the best scores, ties to the lower passage id, padded with -1 where fewer
than k qualify.  The postings come from one sort of the (term, passage)
pairs; a query's scores are summed into an [N] buffer one query term at a
time (one add per passage and term, in the query's order, so equal inputs
give equal sums), then a top-k with its ties broken by id.

As a reference module (see vsbench/judge.py) it gives every pool query's
exact top-k and one number compared of its own:

  score_gap   the widest gap, over every rank of every judged answer,
              between the reference's score of the key named at that rank
              and its score of the exact list's key at that rank (a pad
              scores 0), over the exact list's top score: a swap of tied
              passages reads 0, a wrong key or a wrong order does not.

Answers carry keys alone, so no score of the program is read (`SCORES`).
Its control (`lower`) is the same search with the scores rounded to
bfloat16 before the top-k.
"""

from __future__ import annotations

import torch

K1 = 1.2
B = 0.75
TERM_SPACE = 1 << 22
FNV_OFFSET = 0x811C9DC5
FNV_PRIME = 0x01000193

# the keys alone are compared: no score is read from an answer
SCORES = False

# a group of queries scored at once: at most POSTINGS postings (each ~40
# bytes of indices and values while its term is added) and a [queries, N]
# float64 score buffer of at most BUFFER_BYTES
POSTINGS = 1 << 28
BUFFER_BYTES = 1 << 30


def term_ids(letters: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[V] int64 term of each vocabulary word (letters [V, L] uint8)."""
    h = torch.full((len(lengths),), FNV_OFFSET, dtype=torch.int64, device=letters.device)
    for j in range(letters.shape[1]):
        step = ((h ^ letters[:, j].long()) * FNV_PRIME) & 0xFFFFFFFF
        h = torch.where(lengths > j, step, h)
    return h % (TERM_SPACE - 1) + 1


def weight(tf: torch.Tensor, length: torch.Tensor, avgdl: float) -> torch.Tensor:
    """A term's BM25 weight before its idf, in float64."""
    tf = tf.double()
    return tf * (K1 + 1.0) / (tf + K1 * (1.0 - B + B * length.double() / avgdl))


class Index:
    """The inverted index of the passages: postings sorted by (term,
    passage), each with its tf and weight; df and idf by term."""

    def __init__(self, items: dict) -> None:
        offsets = items["offsets"]
        dev = offsets.device
        self.n = len(offsets) - 1
        self.term_of_word = term_ids(items["letters"], items["lengths"])
        self.length = torch.diff(offsets)
        self.avgdl = float(self.length.sum()) / self.n
        passage = torch.repeat_interleave(torch.arange(self.n, device=dev), self.length)
        key = self.term_of_word[items["words"]] * self.n + passage
        del passage
        self.key, tf = torch.unique_consecutive(torch.sort(key).values, return_counts=True)
        del key
        self.passage = self.key % self.n
        df = torch.bincount(self.key // self.n, minlength=TERM_SPACE)
        self.ptr = torch.zeros(TERM_SPACE + 1, dtype=torch.int64, device=dev)
        torch.cumsum(df, 0, out=self.ptr[1:])
        self.idf = torch.log(1.0 + (self.n - df.double() + 0.5) / (df.double() + 0.5))
        self.weight = weight(tf, self.length[self.passage], self.avgdl)

    def query_terms(self, pool: torch.Tensor) -> torch.Tensor:
        """[P, W] distinct terms of each query in order of first word, -1
        past them (pool: word ids, -1 padded)."""
        terms = torch.where(pool >= 0, self.term_of_word[pool.clamp(min=0)], -1)
        for j in range(1, terms.shape[1]):
            seen = (terms[:, j : j + 1] == terms[:, :j]).any(dim=1)
            terms[:, j] = torch.where(seen, -1, terms[:, j])
        return terms

    def scores(self, terms: torch.Tensor) -> torch.Tensor:
        """[G, N] float64 scores of the G queries' terms [G, W]."""
        out = torch.zeros((len(terms), self.n), dtype=torch.float64, device=terms.device)
        flat = out.view(-1)
        for j in range(terms.shape[1]):
            t = terms[:, j]
            q = torch.nonzero(t > 0).flatten()
            if len(q) == 0:
                continue
            t = t[q]
            lo, hi = self.ptr[t], self.ptr[t + 1]
            count = hi - lo
            owner = torch.repeat_interleave(torch.arange(len(q), device=t.device), count)
            at = torch.arange(int(count.sum()), device=t.device) - (torch.cumsum(count, 0) - count)[owner]
            post = lo[owner] + at
            flat.index_add_(0, q[owner] * self.n + self.passage[post],
                            self.weight[post] * self.idf[t][owner])
        return out

    def pair_scores(self, terms: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """[m, k] float64 score of query terms[i] for passage ids[i, j]; 0
        where ids is -1.  Summed term by term in the query's order, as
        `scores` sums."""
        out = torch.zeros(ids.shape, dtype=torch.float64, device=ids.device)
        p = ids.clamp(min=0)
        for j in range(terms.shape[1]):
            t = terms[:, j : j + 1].expand_as(ids)
            want = t.clamp(min=0) * self.n + p
            at = torch.searchsorted(self.key, want.reshape(-1)).clamp_(max=len(self.key) - 1)
            hit = ((self.key[at] == want.reshape(-1)) & (t.reshape(-1) > 0)).reshape(ids.shape)
            w = torch.where(hit, self.weight[at].reshape(ids.shape) * self.idf[t.clamp(min=0)], 0.0)
            out = torch.where(hit, out + w, out)
        return torch.where(ids >= 0, out, 0.0)


def top(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[G, k] ids of each row's k best scores above 0, ties to the lower
    id, -1 padded."""
    G, N = scores.shape
    kth = torch.topk(scores, min(k, N), dim=1).values[:, -1:]
    rows, cols = torch.nonzero((scores >= kth) & (scores > 0), as_tuple=True)  # row-major
    vals = scores[rows, cols]
    order = torch.sort(vals, descending=True, stable=True).indices
    order = order[torch.sort(rows[order], stable=True).indices]
    rows, cols = rows[order], cols[order]
    rank = torch.arange(len(rows), device=rows.device) - torch.searchsorted(rows, rows)
    keep = rank < k
    out = torch.full((G, k), -1, dtype=torch.long, device=scores.device)
    out[rows[keep], rank[keep]] = cols[keep]
    return out


def index_of(items: dict) -> Index:
    """The items' inverted index, built once and kept with them."""
    if "index" not in items:
        items["index"] = Index(items)
    return items["index"]


def search(items: dict, pool: torch.Tensor, k: int, rounding=None) -> torch.Tensor:
    """[P, k] exact top-k of every query; `rounding` maps the [G, N] scores
    before the top-k."""
    index = index_of(items)
    terms = index.query_terms(pool)
    postings = (index.ptr[terms.clamp(min=0) + 1] - index.ptr[terms.clamp(min=0)]) * (terms > 0)
    postings = postings.sum(dim=1).tolist()
    out = []
    start = 0
    most = max(1, BUFFER_BYTES // (8 * index.n))
    while start < len(terms):
        end, total = start, 0
        while end < len(terms) and end - start < most and (end == start or total + postings[end] <= POSTINGS):
            total += postings[end]
            end += 1
        scores = index.scores(terms[start:end])
        if rounding is not None:
            scores = rounding(scores)
        out.append(top(scores, k))
        start = end
    return torch.cat(out)


def exact(items: dict, pool: torch.Tensor, k: int) -> torch.Tensor:
    """[P, k] passage ids of every query's exact top-k, best first, -1
    padded."""
    return search(items, pool, k)


def compared(items: dict, pool: torch.Tensor, judged, exact_ids: torch.Tensor) -> dict[str, float]:
    """score_gap over the judged answers (vsbench/judge.py's Judged); 1,
    the widest a relative gap can be, where nothing was answered."""
    if len(judged.qidx) == 0:
        return {"score_gap": 1.0}
    index = index_of(items)
    dev = exact_ids.device
    qidx = torch.as_tensor(judged.qidx, device=dev)
    terms = index.query_terms(pool)[qidx]
    named = index.pair_scores(terms, torch.as_tensor(judged.ids, device=dev))
    due = index.pair_scores(terms, exact_ids[qidx])
    best = due[:, :1]
    gap = (named - due).abs() / torch.where(best > 0, best, 1.0)
    return {"score_gap": float(gap.max())}


def lower(items: dict, pool: torch.Tensor, k: int, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The control's answers: (passage ids [P, k], NaN scores [P, k]), the
    top-k of every query with its scores rounded to `precision` ("bf16")
    before the top-k."""
    if precision != "bf16":
        raise ValueError(f"no control precision {precision!r} for BM25 (bf16)")
    ids = search(items, pool, k, lambda s: s.to(torch.bfloat16).double())
    return ids, torch.full(ids.shape, float("nan"), device=ids.device)

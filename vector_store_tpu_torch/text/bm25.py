"""Device-scored BM25 text index (counterpart of
vector_store_tpu/text/bm25.py).

Replaces the OpenSearch/Lucene backend of the reference (src/index/
opensearch.rs:157-210) with a device-resident scorer: documents live on
the device as fixed-shape *unique-term count* tensors and a whole query
batch is scored against every document, chunk by chunk, like the
brute-force vector scan.

    terms   [C, U]  int32 unique hashed term ids per doc, 0-padded (PAD)
    tf      [C, U]  int32 occurrence count of each term
    length  [C]     int32 true total token count (BM25 length norm)
    valid   [C]     bool

The count representation makes scoring exact for any document length as
long as the doc has <= U distinct terms (U = 256).  Docs with > U distinct
terms keep the U highest-tf terms; the drop is logged and df bookkeeping
uses exactly the kept set, so idf can never drift under add/remove churn.

Scoring is standard BM25 (k1=1.2, b=0.75) with idf from live document
frequencies tracked host-side.  The hash only folds the vocabulary
(collisions merge rare terms, the standard hashed-vocabulary trade).

Queries go through the full simple_query_string parser (query.py):
flat queries (words, +/- operators, adjacency phrases) are enforced
on-device via presence masks; structured ones (parens, prefix ``*``,
fuzziness ``~N``, phrase slop) score their positive terms on-device and
verify the boolean AST host-side over the overfetched top candidates.
Prefix/fuzzy leaves expand against the host-side term vocabulary
(most-frequent-first, capped).

Differences from the JAX package, by design:
  * the scorer never forms the [Q, c, U, T] equality tensor that XLA fuses
    away: it looks each stored term up in the batch's sorted query
    vocabulary once (`_score_topk`);
  * the query batch is not padded to fixed sizes (those bounded XLA
    compiles); the T semantics stay: every term up to 64 is scored, past
    64 the 64 of highest idf;
  * the device is explicit (`device=`) and nothing falls back to the CPU;
  * the dirty-row flush updates the device tensors in place, under the
    index lock (see `BM25Index`).
The snapshot format is the JAX package's, key for key and dtype for dtype:
a snapshot written by either package loads in the other.
"""

from __future__ import annotations

import bisect
import itertools
import logging
import operator
import threading
from collections import Counter

import numpy as np
import torch

from ..core.topk import INF, SENTINEL
from ..utils import metrics
from ..utils.persistio import atomic_savez_compressed
from . import query as query_mod
from . import tokenizer

log = logging.getLogger("vst.bm25")

K1 = 1.2
B = 0.75
PAD = 0

MAX_DOC_TERMS = 256  # U: distinct terms kept per document
MAX_QUERY_TERMS = 16  # T: scored query terms of a short query
MAX_SCORED_TERMS = 64  # past this many, the highest-idf terms are scored
# TR/TN: required / forbidden term slots per query.  The parser falls
# back to the host-AST path when a flat query would overflow these, so
# the [:MAX_OP_TERMS] packing below never truncates real operator ids.
MAX_OP_TERMS = query_mod.MAX_OP_TERMS

# phrase queries fetch extra candidates to survive the host-side
# positional filter
PHRASE_OVERFETCH = 4

# The bytes one scoring step's transients may take, which sizes the step:
# a step holds a [V + 1, c] f32 count matrix (V: the batch's distinct
# query, required and forbidden ids), [c, U] lookups of the stored terms and
# [Q, T, c] gathers of the counts, and the chunk shrinks until they fit.
# The answer does not depend on the chunk.  A step is some forty eager
# operations whatever its size, so the chunk is as large as the budget
# allows (all rows, where they fit): the JAX package's 8,192 rows made the
# pass launch-bound.
SCORE_BYTES = 1 << 30


def _edit_distance_le(a: str, b: str, n: int) -> bool:
    """Levenshtein(a, b) <= n, banded DP with early exit."""
    if a == b:
        return True
    la, lb = len(a), len(b)
    if abs(la - lb) > n:
        return False
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        lo = max(1, i - n)
        hi = min(lb, i + n)
        if lo > 1:
            cur[lo - 1] = n + 1
        for j in range(lo, hi + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        if hi < lb:
            cur[hi + 1 :] = [n + 1] * (lb - hi)
        if min(cur[lo - 1 : hi + 1]) > n:
            return False
        prev = cur
    return prev[lb] <= n


def _chunk_rows(chunk: int | None, Q: int, T: int, V: int, U: int) -> int:
    """Rows per step so that the step's transients stay under SCORE_BYTES."""
    per_row = 4 * (V + 1) + 24 * U + 16 * Q * T + 16 * Q
    rows = max(SCORE_BYTES // per_row, 1)
    return rows if chunk is None else min(chunk, rows)


def _score_topk(
    terms: torch.Tensor,  # [C, U] int32 unique term ids
    tf: torch.Tensor,  # [C, U] int32 counts
    length: torch.Tensor,  # [C] int32
    valid: torch.Tensor,  # [C] bool
    q_terms: torch.Tensor,  # [Q, T] int32, PAD-padded
    q_idf: torch.Tensor,  # [Q, T] f32 (0 for PAD)
    q_req: torch.Tensor,  # [Q, TR] int32 required ids (PAD = unused)
    q_neg: torch.Tensor,  # [Q, TN] int32 forbidden ids (PAD = unused)
    avg_len: torch.Tensor,  # [] f32
    k: int,
    chunk: int | None = None,  # a cap on the rows of a step, for tests
    use_ops: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """BM25 top-k: returns (score[Q, k] descending, ids[Q, k] int32).

    Rows that fail (invalid, a required term missing, a forbidden one
    present) score -INF and come back with id SENTINEL.  Among equal
    scores the lower id comes first, whatever the chunk size and on
    either device (stable sorts), which is the order `jax.lax.top_k`
    gives the JAX package; scores agree with it to f32 rounding, as the
    sum over the query's terms is taken in another order.

    A document row holds each term once, so the count of query term t in
    document c is found by looking the row's terms up in the sorted
    distinct ids of the whole batch (`searchsorted`) and scattering their
    counts into a [V + 1, c] matrix (row V takes the misses and is
    zeroed); the per-query counts are then a gather of its rows.  PAD
    is never in that vocabulary, so padded document slots match nothing,
    and padded query slots read the zero row."""
    C, U = terms.shape
    Q, T = q_terms.shape
    dev = terms.device
    ops = [q_terms] + ([q_req, q_neg] if use_ops else [])
    flat = torch.cat([o.reshape(-1) for o in ops])
    vocab = torch.unique(flat[flat != PAD])  # sorted
    V = int(vocab.numel())

    def columns(ids: torch.Tensor) -> torch.Tensor:
        """Row of each id in the count matrix; PAD and misses -> the zero row."""
        if V == 0:
            return torch.full_like(ids, V, dtype=torch.long)
        pos = torch.searchsorted(vocab, ids.contiguous()).clamp_(max=V - 1)
        return torch.where(vocab[pos] == ids, pos, V)

    qt_col = columns(q_terms)  # [Q, T]
    if use_ops:
        req_col, neg_col = columns(q_req), columns(q_neg)
        req_unused = (q_req == PAD)[:, :, None]
    w = q_idf[:, :, None]  # [Q, T, 1]

    best_s = torch.full((Q, k), -INF, dtype=torch.float32, device=dev)
    best_i = torch.full((Q, k), SENTINEL, dtype=torch.int32, device=dev)
    step = _chunk_rows(chunk, Q, T + (2 * q_req.shape[1] if use_ops else 0), V, U)
    for base in range(0, C, step):
        toks = terms[base : base + step]
        c = toks.shape[0]
        by_col = torch.zeros((V + 1, c), dtype=torch.float32, device=dev)
        by_col.scatter_(0, columns(toks).T, tf[base : base + step].float().T)
        by_col[V] = 0.0
        tfq = by_col[qt_col]  # [Q, T, c]
        norm = 1.0 - B + B * (length[base : base + step].float() / avg_len)  # [c]
        denom = tfq + (K1 * norm)[None, None, :]
        parts = w * tfq * (K1 + 1.0) / denom
        # summed term by term, in order: a library reduction may split the
        # sum differently for another chunk size, and the answer must not
        # depend on the chunk
        s = parts[:, 0]  # [Q, c]
        for t in range(1, T):
            s = s + parts[:, t]
        ok = valid[base : base + step][None, :]
        if use_ops:
            # presence masks: required terms must all appear, forbidden none
            req_ok = ((by_col[req_col] > 0) | req_unused).all(dim=1)
            neg_hit = (by_col[neg_col] > 0).any(dim=1)
            ok = ok & req_ok & ~neg_hit
        s = s.masked_fill(~ok, -INF)
        cs, ci = torch.sort(s, dim=-1, descending=True, stable=True)
        cs, ci = cs[:, :k], (ci[:, :k] + base).to(torch.int32)
        ci = ci.masked_fill(torch.isinf(cs), SENTINEL)
        # earlier chunks hold the lower ids and stand first, so the stable
        # sort keeps the lower id among equal scores
        ms, pos = torch.sort(
            torch.cat([best_s, cs], dim=-1), dim=-1, descending=True, stable=True
        )
        best_s = ms[:, :k]
        best_i = torch.gather(torch.cat([best_i, ci], dim=-1), 1, pos[:, :k])
    return best_s, best_i


def _kept(counts: Counter) -> list[tuple[int, int]]:
    """A document's stored (term, count) pairs: every distinct term in
    order of first occurrence, or past U of them the U most frequent (ties
    to the earlier), the drop logged and counted."""
    if len(counts) <= MAX_DOC_TERMS:
        return list(counts.items())
    dropped = len(counts) - MAX_DOC_TERMS
    log.warning(
        "document exceeds %d distinct terms (%d); dropping %d rare terms",
        MAX_DOC_TERMS,
        len(counts),
        dropped,
    )
    metrics.counter("vst_text_dropped_terms_total").inc(dropped)
    return counts.most_common(MAX_DOC_TERMS)


def _count_rows(ids: torch.Tensor, per_doc: np.ndarray) -> tuple[torch.Tensor, ...]:
    """The rows `add` stores, for documents whose term ids `ids` (int64, one
    document after another) come `per_doc` [n] to a document: (terms
    [n, U], tf [n, U]) int32 with each document's distinct terms in order of
    first occurrence, 0-padded; the distinct terms a document has [n]; and
    the documents each stored term is in (terms [m], counts [m]).  A
    document with more than U distinct terms gets an empty row here and
    counts in no document frequency.

    One sort over (document, term) pairs groups the pairs; the groups in
    order of their first token are each document's Counter in order."""
    dev = ids.device
    n = len(per_doc)
    doc = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.from_numpy(per_doc).to(dev)
    )
    key, pos = torch.sort(doc * tokenizer.TERM_SPACE + ids, stable=True)
    head = torch.ones_like(key, dtype=torch.bool)
    head[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(head).flatten()
    count = torch.diff(starts, append=starts.new_tensor([len(key)]))
    by_first = torch.argsort(pos[starts])  # first tokens are distinct
    key, count = key[starts][by_first], count[by_first]
    g_doc = key // tokenizer.TERM_SPACE
    distinct = torch.bincount(g_doc, minlength=n)
    col = torch.arange(len(key), device=dev) - (torch.cumsum(distinct, 0) - distinct)[g_doc]
    keep = distinct[g_doc] <= MAX_DOC_TERMS
    terms = torch.zeros((n, MAX_DOC_TERMS), dtype=torch.int32, device=dev)
    tf = torch.zeros((n, MAX_DOC_TERMS), dtype=torch.int32, device=dev)
    at = (g_doc[keep], col[keep])
    kept = key[keep] % tokenizer.TERM_SPACE
    terms[at] = kept.to(torch.int32)
    tf[at] = count[keep].to(torch.int32)
    return (terms, tf, distinct) + torch.unique(kept, return_counts=True)


class BM25Index:
    """Slot-addressed text index (the SlotIndex analogue for text).

    Host keeps tokenisation, document frequencies and slot allocation;
    the device keeps term/count tensors and does all scoring.

    One lock orders every mutation against every search: `add`,
    `add_batch` (one hold a batch) and `remove` change the host rows and the
    dirty set under it, and `search`
    holds it while it parses (the expanders read the vocabulary), flushes
    the dirty rows into the device tensors in place and enqueues the
    scorer.  A search on another thread therefore never sees half of a
    flush, and the scorer's kernels are enqueued on the stream before any
    later flush's.  The host readback and the phrase/AST filter run
    outside the lock, as in the JAX package."""

    def __init__(
        self, initial_capacity: int = 1 << 14, device: str | torch.device = "cuda"
    ) -> None:
        cap = max(initial_capacity, 1024)
        self.device = torch.device(device)
        self._terms = np.zeros((cap, MAX_DOC_TERMS), dtype=np.int32)
        self._tf = np.zeros((cap, MAX_DOC_TERMS), dtype=np.int32)
        self._length = np.zeros((cap,), dtype=np.int32)
        self._valid = np.zeros((cap,), dtype=bool)
        self._frontier = 0
        self._size = 0
        self._df: Counter = Counter()  # term id -> doc frequency (kept terms)
        self._vocab: dict[str, int] = {}  # term string -> id (for prefix/fuzzy)
        # expansion side-indexes: fuzzy scans only the +-dist length
        # buckets; prefix bisects a lazily re-sorted word list, so both
        # bound per-leaf host work far below O(vocabulary)
        self._vocab_by_len: dict[int, list[tuple[str, int]]] = {}
        self._vocab_sorted: list[tuple[str, int]] = []
        self._vocab_dirty = False
        self._total_len = 0
        # full token sequences (host only) for phrase verification
        self._seqs: list[np.ndarray | None] = []
        # device tensors are the scoring source of truth; host mutations
        # accumulate in `_dirty_slots` and flush as one row scatter per
        # query (not a full re-upload: documents are long-lived)
        self._dirty_slots: set[int] = set()
        self._dev = None  # (terms, tf, length, valid) device tensors
        self._dev_rows = 0  # device row count (grows with the frontier)
        # add_batch's [TERM_SPACE, 2] table on the device: under a term id the
        # packed bytes of one word of the vocabulary with that id, so that a
        # batch looks up only the words it cannot vouch for
        self._known = None
        self._lock = threading.Lock()

    # -- mutation ---------------------------------------------------------

    def _grow(self, need: int) -> None:
        cap = self._terms.shape[0]
        if need <= cap:
            return
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        for name in ("_terms", "_tf", "_length", "_valid"):
            old = getattr(self, name)
            # zeros from the allocator: the pages past the frontier are not
            # written until a document lands there
            new = np.zeros((new_cap,) + old.shape[1:], dtype=old.dtype)
            new[:cap] = old
            setattr(self, name, new)

    def add(self, text: str) -> int:
        """Insert a document, returns its slot."""
        words = tokenizer.tokenize(text)
        ids = [tokenizer.term_id(w) for w in words]
        counts = Counter(ids)
        kept_pairs = _kept(counts)
        with self._lock:
            for w, t in zip(words, ids):
                if w not in self._vocab:
                    self._vocab[w] = t
                    self._vocab_by_len.setdefault(len(w), []).append((w, t))
                    self._vocab_dirty = True
            slot = self._frontier
            self._grow(slot + 1)
            u = len(kept_pairs)
            self._terms[slot, :u] = [t for t, _ in kept_pairs]
            self._terms[slot, u:] = PAD
            self._tf[slot, :u] = [c for _, c in kept_pairs]
            self._tf[slot, u:] = 0
            self._length[slot] = len(ids)
            self._valid[slot] = True
            self._frontier += 1
            self._size += 1
            # df over exactly the stored term set: remove() subtracts the
            # same set, so idf cannot drift under churn
            self._df.update(t for t, _ in kept_pairs)
            self._total_len += len(ids)
            while len(self._seqs) <= slot:
                self._seqs.append(None)
            self._seqs[slot] = np.asarray(ids, dtype=np.int32)
            self._dirty_slots.add(slot)
        return slot

    def add_batch(self, texts: list[str]) -> list[int]:
        """Insert documents, returns their slots: the index is then what
        `add` of each in turn leaves, field for field (rows, df, lengths,
        vocabulary and its order, sequences, dirty slots), in one pass of
        vectorised analysis (`tokenizer.analyze`, on the index's device),
        one lock hold and at most one growth."""
        texts = list(texts)
        n = len(texts)
        if n == 0:
            return []
        with metrics.span("vst_text_analyze_seconds"):
            if self._known is None:
                self._known = torch.zeros(
                    (tokenizer.TERM_SPACE, 2), dtype=torch.int64, device=self.device
                )
            batch = tokenizer.analyze(texts, self.device, self._known)
            per_doc, words = batch.per_doc, batch.words
            terms, tf, distinct, df_terms, df_counts = (
                a.cpu().numpy() for a in _count_rows(batch.ids, per_doc)
            )
            host_ids = batch.ids.to(torch.int32).cpu().numpy()
            ends = np.cumsum(per_doc).tolist()
            seqs = [host_ids[a:b] for a, b in zip([0] + ends[:-1], ends)]
            df_terms, df_counts = df_terms.tolist(), df_counts.tolist()
            overflow = Counter()
            for d in np.flatnonzero(distinct > MAX_DOC_TERMS).tolist():
                kept = _kept(Counter(seqs[d].tolist()))
                terms[d, : len(kept)] = [t for t, _ in kept]
                tf[d, : len(kept)] = [c for _, c in kept]
                overflow.update(t for t, _ in kept)
        with self._lock:
            vocab = self._vocab
            for w in [w for w in words if w not in vocab]:
                t = vocab[w] = words[w]
                self._vocab_by_len.setdefault(len(w), []).append((w, t))
                self._vocab_dirty = True
            # every packed word of the batch is in the vocabulary now
            self._known[batch.packed_ids] = batch.packed
            f = self._frontier
            self._grow(f + n)
            self._terms[f : f + n] = terms
            self._tf[f : f + n] = tf
            self._length[f : f + n] = per_doc
            self._valid[f : f + n] = True
            self._frontier += n
            self._size += n
            # df over exactly the stored term sets, as add() counts it
            had = list(map(self._df.get, df_terms, itertools.repeat(0)))
            dict.update(self._df, zip(df_terms, map(operator.add, had, df_counts)))
            self._df.update(overflow)
            self._total_len += int(per_doc.sum())
            if len(self._seqs) < f:
                self._seqs.extend([None] * (f - len(self._seqs)))
            self._seqs[f : f + n] = seqs
            self._dirty_slots.update(range(f, f + n))
        return list(range(f, f + n))

    def remove(self, slot: int) -> None:
        with self._lock:
            if not (0 <= slot < self._frontier) or not self._valid[slot]:
                return
            stored = self._terms[slot]
            self._df.subtract(int(t) for t in stored if t != PAD)
            self._total_len -= int(self._length[slot])
            self._valid[slot] = False
            self._size -= 1
            self._seqs[slot] = None
            self._dirty_slots.add(slot)

    def count(self) -> int:
        return self._size

    # -- persistence -------------------------------------------------------

    FORMAT_VERSION = 1

    def save(self, path: str) -> None:
        """Snapshot the host source-of-truth to one ``.npz``, in the JAX
        package's format (vector_store_tpu/text/bm25.py::save).

        The reference has no text-index persistence (indexes rebuild from
        source, opensearch.rs:99-105).  Device tensors are derived state
        and are not saved: the first query after load uploads them."""
        with self._lock:
            f = self._frontier
            seqs = [
                self._seqs[s] if s < len(self._seqs) and self._seqs[s] is not None
                else np.empty((0,), dtype=np.int32)
                for s in range(f)
            ]
            off = np.zeros((f + 1,), dtype=np.int64)
            if f:
                off[1:] = np.cumsum([len(s) for s in seqs])
            words = sorted(self._vocab)
            atomic_savez_compressed(
                path,
                version=np.int64(self.FORMAT_VERSION),
                terms=self._terms[:f],
                tf=self._tf[:f],
                length=self._length[:f],
                valid=self._valid[:f],
                seq_data=(
                    np.concatenate(seqs) if f else np.empty((0,), dtype=np.int32)
                ),
                seq_off=off,
                vocab_words=np.asarray(words, dtype=np.str_),
                vocab_ids=np.asarray(
                    [self._vocab[w] for w in words], dtype=np.int64
                ),
            )

    @classmethod
    def load(cls, path: str, **kwargs) -> "BM25Index":
        """Restore a snapshot; df / avg-length bookkeeping is rebuilt
        from the stored rows (they are its exact definition: add()
        updates df over the kept term set only)."""
        with np.load(path) as z:
            if int(z["version"]) != cls.FORMAT_VERSION:
                raise ValueError(f"unsupported snapshot version {z['version']}")
            f = int(z["terms"].shape[0])
            idx = cls(initial_capacity=max(f, 1), **kwargs)
            idx._grow(f)
            idx._terms[:f] = z["terms"]
            idx._tf[:f] = z["tf"]
            idx._length[:f] = z["length"]
            idx._valid[:f] = z["valid"]
            idx._frontier = f
            idx._size = int(idx._valid[:f].sum())
            off = z["seq_off"]
            data = z["seq_data"]
            idx._seqs = [
                np.asarray(data[off[s] : off[s + 1]], dtype=np.int32)
                if idx._valid[s]
                else None
                for s in range(f)
            ]
            # rows store unique terms, so the flattened live rows count doc
            # frequency directly
            live = idx._terms[:f][idx._valid[:f]].ravel()
            live = live[live != PAD]
            uniq, cnt = np.unique(live, return_counts=True)
            idx._df.update(dict(zip(uniq.tolist(), cnt.tolist())))
            idx._total_len = int(idx._length[:f][idx._valid[:f]].sum())
            for w, t in zip(z["vocab_words"], z["vocab_ids"]):
                w, t = str(w), int(t)
                idx._vocab[w] = t
                idx._vocab_by_len.setdefault(len(w), []).append((w, t))
            idx._vocab_dirty = True
        return idx

    # -- query ------------------------------------------------------------

    def _device_arrays(self):
        """The device tensors, brought up to date (under the lock)."""
        # device rows are padded to a power-of-two bucket so growth (full
        # upload) is a doubling event, not a per-add one; padded rows score
        # as invalid (host _valid is False beyond the frontier)
        rows = 1 << max(self._frontier, 1024).bit_length()
        rows = min(rows, self._terms.shape[0])
        if self._dev is None or self._dev_rows != rows:
            # (re)size: full upload, on the first query after growth
            with metrics.span("vst_text_upload_seconds"):
                self._dev = None  # the old tensors go before the new arrive
                self._dev = tuple(
                    torch.from_numpy(a[:rows]).to(self.device, copy=True)
                    for a in (self._terms, self._tf, self._length, self._valid)
                )
            self._dev_rows = rows
            self._dirty_slots.clear()
        elif self._dirty_slots:
            # incremental: scatter only the mutated rows, in place
            with metrics.span("vst_text_flush_seconds"):
                slots = np.fromiter(self._dirty_slots, dtype=np.int64)
                slots = slots[slots < rows]
                at = torch.from_numpy(slots).to(self.device)
                for dev, host in zip(
                    self._dev, (self._terms, self._tf, self._length, self._valid)
                ):
                    dev[at] = torch.from_numpy(host[slots]).to(self.device)
            self._dirty_slots.clear()
        return self._dev

    def _score(self, arrays, packed, avg, k: int, use_ops: bool):
        """Enqueue the scorer over the device tensors `arrays` for the packed
        query batch (numpy) -> (score [Q, k] descending, slot [Q, k])."""
        dev = self.device
        return _score_topk(
            *arrays,
            *(torch.from_numpy(a).to(dev) for a in packed),
            torch.tensor(avg, dtype=torch.float32, device=dev),
            k,
            use_ops=use_ops,
        )

    def _idf(self, term: int) -> float:
        n, df = max(self._size, 1), self._df.get(term, 0)
        return float(np.log(1.0 + (n - df + 0.5) / (df + 0.5)))

    # -- vocabulary expansion (query.Expander seam) -------------------------

    def expand_prefix(self, prefix: str, limit: int) -> list[int]:
        """Live term ids whose stored string starts with `prefix`,
        most-frequent first (simple_query_string `word*`).  Bisects a
        lazily re-sorted vocab list: O(log V + matches) per leaf."""
        if not prefix:
            return []
        if self._vocab_dirty:
            self._vocab_sorted = sorted(self._vocab.items())
            self._vocab_dirty = False
        lo = bisect.bisect_left(self._vocab_sorted, (prefix,))
        hi = bisect.bisect_left(
            self._vocab_sorted, (prefix[:-1] + chr(ord(prefix[-1]) + 1),)
        )
        hits = [
            (self._df.get(t, 0), t)
            for w, t in self._vocab_sorted[lo:hi]
            if self._df.get(t, 0) > 0
        ]
        hits.sort(key=lambda x: -x[0])
        return [t for _, t in hits[:limit]]

    def expand_fuzzy(self, word: str, dist: int, limit: int) -> list[int]:
        """Live term ids within edit distance `dist` of `word`
        (simple_query_string `word~N`).  Scans only the length buckets
        within +-dist of len(word), never the whole vocabulary."""
        if not word:
            return []
        hits = []
        for length in range(max(1, len(word) - dist), len(word) + dist + 1):
            for w, t in self._vocab_by_len.get(length, ()):
                if self._df.get(t, 0) <= 0:
                    continue
                if _edit_distance_le(word, w, dist):
                    hits.append((self._df.get(t, 0), t))
        hits.sort(key=lambda x: -x[0])
        return [t for _, t in hits[:limit]]

    def _pack_queries(self, parsed: list) -> tuple[np.ndarray, ...]:
        """(q_terms, q_idf, q_req, q_neg) of a parsed batch.  T is the
        longest query's term count within [16, 64]: long bag-of-words
        queries score ALL their terms (OpenSearch does), not a head-16
        truncation; past 64, the highest-idf terms, which carry BM25."""
        t_max = max((len(p.terms) for p in parsed), default=0)
        T = min(max(t_max, MAX_QUERY_TERMS), MAX_SCORED_TERMS)
        if t_max > MAX_SCORED_TERMS:
            log.warning(
                "query with %d unique terms; scoring the %d highest-idf",
                t_max,
                MAX_SCORED_TERMS,
            )
        Q = len(parsed)
        q_terms = np.zeros((Q, T), dtype=np.int32)
        q_idf = np.zeros((Q, T), dtype=np.float32)
        q_req = np.zeros((Q, MAX_OP_TERMS), dtype=np.int32)
        q_neg = np.zeros((Q, MAX_OP_TERMS), dtype=np.int32)
        for j, p in enumerate(parsed):
            uniq = p.terms
            if len(uniq) > T:
                uniq = sorted(uniq, key=self._idf, reverse=True)[:T]
            q_terms[j, : len(uniq)] = uniq
            q_idf[j, : len(uniq)] = [self._idf(t) for t in uniq]
            req = p.required[:MAX_OP_TERMS]
            q_req[j, : len(req)] = req
            neg = p.forbidden[:MAX_OP_TERMS]
            q_neg[j, : len(neg)] = neg
        return q_terms, q_idf, q_req, q_neg

    def search(self, texts: list[str], k: int) -> list[list[tuple[int, float]]]:
        """Batch of query strings -> per query [(slot, score) descending].

        Supports the simple_query_string operator subset (query.py):
        +required, -forbidden, "phrases" (positional, host-verified)."""
        # parse, flush and enqueue the scorer under the lock
        with metrics.span("vst_text_lock_wait_seconds"):
            self._lock.acquire()
        try:
            with metrics.span("vst_text_batch_seconds"):
                if self._size == 0:
                    return [[] for _ in texts]
                parsed = [query_mod.parse(t, expander=self) for t in texts]
                use_ops = any(
                    p.required or p.forbidden or p.phrases or p.neg_phrases
                    for p in parsed
                )
                # structured (AST) queries and phrases are verified host-side
                # over an overfetched candidate set
                any_host = any(
                    p.phrases or p.neg_phrases or p.ast is not None for p in parsed
                )
                packed = self._pack_queries(parsed)
                k_fetch = min(PHRASE_OVERFETCH * k, self._frontier) if any_host else k
                k_fetch = max(k_fetch, k)
                arrays = self._device_arrays()
                avg = np.float32(max(self._total_len / max(self._size, 1), 1.0))
                with metrics.span("text.score", series=False):
                    scores, ids = self._score(arrays, packed, avg, k_fetch, use_ops)
        finally:
            self._lock.release()
        with metrics.span("vst_text_fetch_seconds"):
            scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
            return self._filter(parsed, scores, ids, k)

    def _filter(self, parsed: list, scores: np.ndarray, ids: np.ndarray, k: int):
        """Each query's hits of the scorer's candidates: a score above 0 (or
        any score of a pure-operator query), the phrases and the boolean
        AST verified over the host's rows."""
        out = []
        for j, p in enumerate(parsed):
            # a pure-operator query ("-word") scores 0 on every surviving
            # doc; accept zero scores in that case, otherwise require > 0
            min_ok = -0.5 if (not p.terms and p.has_operators) else 0.0
            hits = []
            for s, sc in zip(ids[j], scores[j]):
                if s == SENTINEL or not np.isfinite(sc) or sc <= min_ok:
                    continue
                slot = int(s)
                if p.phrases or p.neg_phrases:
                    seq = self._seqs[slot] if slot < len(self._seqs) else None
                    if seq is None:
                        continue
                    if any(not query_mod.phrase_in(seq, ph) for ph in p.phrases):
                        continue
                    if any(query_mod.phrase_in(seq, ph) for ph in p.neg_phrases):
                        continue
                if p.ast is not None:
                    seq = self._seqs[slot] if slot < len(self._seqs) else None
                    row = self._terms[slot]
                    term_set = set(int(t) for t in row[row != PAD])
                    if not query_mod.matches(p.ast, term_set, seq):
                        continue
                hits.append((slot, float(sc)))
                if len(hits) == k:
                    break
            out.append(hits)
        return out

"""Deterministic tokenizer + term hashing for the text index (the port's
own copy of vector_store_tpu/text/tokenizer.py).

The reference delegates analysis to OpenSearch's Lucene analyzers
(simple_query_string over `article_content`, src/index/opensearch.rs:
181-194).  Here analysis is host-side and minimal — lowercase, split on
non-alphanumerics — and terms are FNV-1a-hashed into a fixed id space so
the device never sees strings.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

_TOKEN_RE = re.compile(r"[a-z0-9]+")

# FNV-1a 32-bit
_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193

# Hashed term-id space.  Ids are folded into [1, TERM_SPACE); 0 is PAD.
TERM_SPACE = 1 << 22


def fnv1a(term: str) -> int:
    h = _FNV_OFFSET
    for b in term.encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFF
    return h


def term_id(term: str) -> int:
    return (fnv1a(term) % (TERM_SPACE - 1)) + 1


def tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


def normalize(word: str) -> str:
    """One query word through the same analysis as stored tokens (the
    prefix/fuzzy expanders compare against stored vocabulary strings)."""
    toks = tokenize(word)
    return toks[0] if toks else ""


def term_ids(text: str) -> list[int]:
    return [term_id(t) for t in tokenize(text)]


# -- a batch of documents at once ----------------------------------------------
#
# `analyze` gives what `tokenize` + `term_id` give, for many documents in a
# few vectorised passes.  A document of ASCII characters alone is analysed
# as bytes: lowercase through a byte table, `[a-z0-9]` runs, FNV-1a 32 per
# token by byte position.  Any other document goes through `tokenize`,
# because `str.lower()` maps some non-ASCII characters to ASCII ones (KELVIN
# SIGN to "k", "İ" to "i" and a combining dot).

# bytes hashed per token on the device; a longer token hashes on the host
HASH_BYTES = 64
# a token of at most this many bytes is told apart from others by its bytes
# packed into two int64, little-endian (token bytes are never 0)
PACK_BYTES = 16

_LOWER = np.arange(256, dtype=np.uint8)
_LOWER[ord("A") : ord("Z") + 1] += 32
_IN_TOKEN = np.zeros(256, dtype=bool)  # [A-Za-z0-9]: a token's byte, either case
for _lo, _hi in (("a", "z"), ("A", "Z"), ("0", "9")):
    _IN_TOKEN[ord(_lo) : ord(_hi) + 1] = True


@dataclass
class Analysis:
    """A batch of documents analysed (`analyze`)."""

    ids: torch.Tensor  # [tokens] int64 term ids, one document after another
    per_doc: np.ndarray  # [n] int64 tokens of each document
    # the distinct words -> their ids, in order of first occurrence, less
    # those `known` vouched for
    words: dict[str, int]
    # the batch's distinct words of at most PACK_BYTES bytes: ids [m] and
    # packed bytes [m, 2] (to record in a `known` table once they are in a
    # vocabulary)
    packed_ids: torch.Tensor
    packed: torch.Tensor


def _analyze_ascii(texts: list[str], device, known: torch.Tensor | None) -> Analysis:
    """`analyze` of documents that are all ASCII."""
    n = len(texts)
    joined = "\n".join(texts)  # "\n" is no token byte: no token spans two documents
    nothing = torch.zeros(0, dtype=torch.int64, device=device)
    if not joined:
        return Analysis(nothing, np.zeros(n, dtype=np.int64), {}, nothing, nothing.view(0, 2))
    chars = np.fromiter(map(len, texts), dtype=np.int64, count=n)
    doc_start = np.zeros(n, dtype=np.int64)
    np.cumsum(chars[:-1] + 1, out=doc_start[1:])
    raw = torch.frombuffer(bytearray(joined, "ascii"), dtype=torch.uint8).to(device).long()
    low = torch.from_numpy(_LOWER).to(device)[raw]
    in_tok = torch.from_numpy(_IN_TOKEN).to(device)[raw].to(torch.int8)
    # +1 where a run of token bytes starts, -1 one past where it ends
    edge = torch.diff(in_tok, prepend=in_tok.new_zeros(1), append=in_tok.new_zeros(1))
    pos = torch.nonzero(edge).flatten()
    starts, ends = pos[0::2], pos[1::2]
    ntok = int(starts.numel())
    if ntok == 0:
        return Analysis(nothing, np.zeros(n, dtype=np.int64), {}, nothing, nothing.view(0, 2))
    lengths = ends - starts
    doc = torch.searchsorted(torch.from_numpy(doc_start).to(device), starts.contiguous(), right=True) - 1
    per_doc = torch.bincount(doc, minlength=n).cpu().numpy()

    # longest first: the tokens longer than j are a prefix at every byte j
    order = torch.argsort(lengths, descending=True, stable=True)
    at = starts[order]
    longest = int(lengths[order[0]])
    span = min(longest, HASH_BYTES)
    longer = torch.bincount(lengths.clamp(max=span), minlength=span + 1).cpu().numpy()
    longer = np.cumsum(longer[::-1])[::-1]  # longer[j]: tokens of at least j bytes
    h = torch.full((ntok,), _FNV_OFFSET, dtype=torch.int64, device=device)
    packed = torch.zeros((2, ntok), dtype=torch.int64, device=device)
    for j in range(span):
        m = int(longer[j + 1])
        b = low[at[:m] + j].long()
        h[:m] = ((h[:m] ^ b) * _FNV_PRIME) & 0xFFFFFFFF
        if j < PACK_BYTES:
            packed[j // 8, :m] |= b << (8 * (j % 8))
    # back to text order
    ids = torch.empty_like(h)
    ids[order] = h % (TERM_SPACE - 1) + 1
    packed[:, order] = packed.clone()
    if longest > HASH_BYTES:
        # the bytes past HASH_BYTES were not hashed: such tokens hash here
        over = torch.nonzero(lengths > HASH_BYTES).flatten()
        ids[over] = torch.tensor(
            [term_id(joined[a:b].lower()) for a, b in zip(starts[over].tolist(), ends[over].tolist())],
            dtype=torch.int64, device=device)

    # the distinct words in order of first occurrence: every token too long
    # to pack, and the first token of each run of equal packed bytes (stable
    # sorts of the tokens in text order keep the first one first)
    n_long = int(longer[PACK_BYTES + 1]) if span > PACK_BYTES else 0
    short = torch.sort(order[n_long:]).values
    for row in (1, 0):
        short = short[torch.argsort(packed[row][short], stable=True)]
    k0, k1 = packed[0][short], packed[1][short]
    head = torch.ones_like(short, dtype=torch.bool)
    head[1:] = (k0[1:] != k0[:-1]) | (k1[1:] != k1[:-1])
    short = short[head]
    short_ids, short_packed = ids[short], packed[:, short].T
    if known is not None:
        # a word whose bytes `known` holds under its id needs no look-up
        short = short[(known[short_ids] != short_packed).any(dim=1)]
    first = torch.sort(torch.cat([order[:n_long], short])).values
    words = dict(zip(
        [joined[a:b].lower() for a, b in zip(starts[first].tolist(), ends[first].tolist())],
        ids[first].tolist()))
    return Analysis(ids, per_doc, words, short_ids, short_packed)


def analyze(texts: list[str], device="cpu", known: torch.Tensor | None = None) -> Analysis:
    """What `tokenize` and `term_id` give each document of `texts` in turn,
    analysed on `device`.  `known` ([TERM_SPACE, 2] int64 on `device`),
    where given, holds under a term id the packed bytes of a word already
    in the caller's vocabulary (zeros: none); such words are left out of
    `words`."""
    flags = [t.isascii() for t in texts]
    if all(flags):
        return _analyze_ascii(texts, device, known)
    parts, words = [], {}
    i = 0
    while i < len(texts):
        j = i
        while j < len(texts) and flags[j] == flags[i]:
            j += 1
        if flags[i]:
            part = _analyze_ascii(texts[i:j], device, known)
        else:
            toks = [tokenize(t) for t in texts[i:j]]
            ids = torch.tensor([term_id(w) for doc in toks for w in doc], dtype=torch.int64,
                               device=device)
            none = torch.zeros(0, dtype=torch.int64, device=device)
            part = Analysis(ids, np.asarray([len(doc) for doc in toks], dtype=np.int64),
                            {w: term_id(w) for doc in toks for w in doc}, none, none.view(0, 2))
        parts.append(part)
        for w, t in part.words.items():
            words.setdefault(w, t)
        i = j
    return Analysis(torch.cat([p.ids for p in parts]), np.concatenate([p.per_doc for p in parts]),
                    words, torch.cat([p.packed_ids for p in parts]),
                    torch.cat([p.packed for p in parts]))

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

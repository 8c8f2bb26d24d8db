"""Text search: tokenizer, simple_query_string parser and the BM25 index."""

from .bm25 import BM25Index  # noqa: F401
from .tokenizer import term_ids, tokenize  # noqa: F401

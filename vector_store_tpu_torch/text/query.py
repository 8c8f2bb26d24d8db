"""simple_query_string parser (full grammar).

The reference's search surface is Lucene ``simple_query_string`` over
``article_content`` (reference: src/index/opensearch.rs:181-194).  This
parser implements the full operator grammar:

  word            scored term (OR is the default combinator)
  +               AND between adjacent clauses (left-associative)
  |               OR between adjacent clauses
  -clause         negated clause (term, phrase or group)
  "a b c"         phrase: in-order adjacency, verified host-side
  "a b c"~N       phrase with slop: in-order with ≤ N extra gap
  word*           prefix query: expands over the index vocabulary
  word~N          fuzzy query: edit distance ≤ N over the vocabulary
  ( ... )         precedence grouping

Semantics follow Lucene's SimpleQueryParser boolean model: within each
group the positive clauses fold left-to-right through the explicit
operators (default OR), and every negated clause becomes a MUST_NOT on
the whole group — so ``quick -fox`` matches quick-docs without fox, not
"quick OR not-fox".  Unknown/broken syntax degrades to plain terms, the
same lenient posture simple_query_string takes on invalid input.

Structured queries (parens / prefix / fuzzy / slop) are matched
host-side over the device top-k candidates via :func:`matches`; flat
queries keep the on-device required/forbidden mask fast path (bm25.py).
One documented divergence: Lucene's phrase slop is unordered with
transposition costs; here slop is in-order with at most N interleaved
tokens.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from . import tokenizer

# one token of the query language
_TOKEN = re.compile(
    r'(?P<lparen>\()|(?P<rparen>\))|(?P<and>\+)|(?P<or>\|)|(?P<not>-)'
    r'|(?P<phrase>"(?P<body>[^"]*)")(~(?P<slop>\d+))?'
    r'|(?P<word>[^\s()+|"-][^\s()+|"]*)'
)
# trailing operators on a bare word: prefix `*` or fuzziness `~N`
_SUFFIX = re.compile(r"^(?P<body>.*?)(?:(?P<star>\*)|~(?P<fuzz>\d+))$")

MAX_EXPAND = 8  # vocabulary expansions kept per prefix/fuzzy leaf
# device mask slots per query (the bm25 kernel's TR/TN widths): flat
# queries needing more required/forbidden ids than this fall back to the
# host-verified AST path instead of silently truncating the masks
MAX_OP_TERMS = 8


# -- AST ----------------------------------------------------------------------


@dataclass
class Term:
    """Leaf: matches when ANY of `ids` is present (multi-id after
    prefix/fuzzy vocabulary expansion; a plain word has one id)."""

    ids: list[int]


@dataclass
class Phrase:
    """Leaf: `ids` in order with at most `slop` interleaved tokens."""

    ids: list[int]
    slop: int = 0


@dataclass
class And:
    children: list


@dataclass
class Or:
    children: list


@dataclass
class Not:
    child: object


class Expander:
    """Vocabulary expansion seam (implemented by BM25Index)."""

    def expand_prefix(self, prefix: str, limit: int) -> list[int]:
        raise NotImplementedError

    def expand_fuzzy(self, word: str, dist: int, limit: int) -> list[int]:
        raise NotImplementedError


@dataclass
class ParsedQuery:
    """Normalised query: everything the scorer and filters need.

    `flat` queries are fully expressible by the device masks (scored
    terms + required + forbidden + adjacency phrases); structured ones
    carry `ast` for the host-side verifier."""

    terms: list[int] = field(default_factory=list)  # scored term ids (unique)
    required: list[int] = field(default_factory=list)  # must be present
    forbidden: list[int] = field(default_factory=list)  # must be absent
    phrases: list[list[int]] = field(default_factory=list)  # in-order runs
    neg_phrases: list[list[int]] = field(default_factory=list)
    ast: object | None = None  # set only for structured queries

    @property
    def has_operators(self) -> bool:
        return bool(
            self.required
            or self.forbidden
            or self.phrases
            or self.neg_phrases
            or self.ast is not None
        )


# -- lexer / parser -----------------------------------------------------------


def _lex(text: str) -> list:
    toks = []
    for m in _TOKEN.finditer(text):
        if m.group("lparen"):
            toks.append(("(",))
        elif m.group("rparen"):
            toks.append((")",))
        elif m.group("and"):
            toks.append(("+",))
        elif m.group("or"):
            toks.append(("|",))
        elif m.group("not"):
            toks.append(("-",))
        elif m.group("phrase") is not None:
            toks.append(("phrase", m.group("body"), int(m.group("slop") or 0)))
        elif m.group("word") is not None:
            toks.append(("word", m.group("word")))
    return toks


class _Parser:
    def __init__(self, toks: list, expander: Expander | None):
        self.toks = toks
        self.i = 0
        self.expander = expander
        self.structured = False  # parens / prefix / fuzzy / slop seen

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def _leaf_word(self, word: str):
        sfx = _SUFFIX.match(word)
        if sfx and sfx.group("star") and sfx.group("body"):
            self.structured = True
            body = sfx.group("body")
            ids = []
            if self.expander is not None:
                ids = self.expander.expand_prefix(
                    tokenizer.normalize(body), MAX_EXPAND
                )
            if not ids:
                # fall back to an exact term; if the body itself is
                # unanalyzable, drop the leaf (lenient, like fuzzy below)
                # instead of producing a never-matching empty Term.
                ids = tokenizer.term_ids(body)
            return Term(ids) if ids else None
        if sfx and sfx.group("fuzz") is not None and sfx.group("body"):
            self.structured = True
            body, dist = sfx.group("body"), int(sfx.group("fuzz"))
            ids = list(tokenizer.term_ids(body))
            if self.expander is not None and dist > 0:
                for t in self.expander.expand_fuzzy(
                    tokenizer.normalize(body), dist, MAX_EXPAND
                ):
                    if t not in ids:
                        ids.append(t)
            return Term(ids) if ids else None
        ids = tokenizer.term_ids(word)
        return Term(ids) if ids else None

    def clause(self):
        """clause := '-'? (word | phrase | '(' group ')')"""
        t = self.peek()
        if t is None or t[0] in (")", "+", "|"):
            return None, False
        if t[0] == "-":
            self.next()
            node, _ = self.clause()
            return node, True
        self.next()
        if t[0] == "(":
            self.structured = True
            node = self.group()
            if self.peek() and self.peek()[0] == ")":
                self.next()
            return node, False
        if t[0] == "phrase":
            ids = tokenizer.term_ids(t[1])
            if t[2] > 0:
                self.structured = True
            if not ids:
                return None, False
            if len(ids) == 1:
                return Term(ids), False
            return Phrase(ids, t[2]), False
        return self._leaf_word(t[1]), False


    def group(self, top: bool = False):
        """group := (op? clause)* — positives fold through the explicit
        operators (default OR); negations become group-level MUST_NOT."""
        pos = None
        negs = []
        pending_op = None
        while True:
            t = self.peek()
            if t is None:
                break
            if t[0] == ")":
                if not top:
                    break
                self.next()  # stray ')' at top level: lenient skip
                continue
            if t[0] in ("+", "|"):
                self.next()
                pending_op = t[0]
                continue
            node, negated = self.clause()
            if node is None:
                pending_op = None
                continue
            if negated:
                negs.append(node)
            elif pos is None:
                pos = node
            elif pending_op == "+":
                if isinstance(pos, And):
                    pos.children.append(node)
                else:
                    pos = And([pos, node])
            else:  # '|' or default
                if isinstance(pos, Or):
                    pos.children.append(node)
                else:
                    pos = Or([pos, node])
            pending_op = None
        if negs:
            parts = ([pos] if pos is not None else []) + [Not(n) for n in negs]
            return And(parts) if len(parts) > 1 else parts[0]
        return pos


def parse(text: str, expander: Expander | None = None) -> ParsedQuery:
    p = _Parser(_lex(text), expander)
    root = p.group(top=True)
    q = ParsedQuery()
    if root is None:
        return q
    _collect_scored(root, q.terms, set())
    if (
        p.structured
        or not _flatten(root, q, top=True)
        or len(q.required) > MAX_OP_TERMS
        or len(q.forbidden) > MAX_OP_TERMS
    ):
        # host-verified boolean query; device path scores + overfetches
        q.required.clear()
        q.forbidden.clear()
        q.phrases.clear()
        q.neg_phrases.clear()
        q.ast = root
    return q


def _collect_scored(node, out: list[int], seen: set[int]) -> None:
    """Scored term ids = every id in a positive (non-negated) leaf."""
    if isinstance(node, (Term, Phrase)):
        for t in node.ids:
            if t not in seen:
                seen.add(t)
                out.append(t)
    elif isinstance(node, (And, Or)):
        for c in node.children:
            _collect_scored(c, out, seen)
    # Not: negated subtrees are never scored


def _scored_bag(node) -> bool:
    """A positive subtree expressible purely by the scored bag — "doc
    matches ≥1 scored term": a Term (multi-id = OR of its ids after
    tokenizer splitting / vocabulary expansion) or an Or of Terms."""
    if isinstance(node, Term):
        return True
    if isinstance(node, Or):
        return all(isinstance(c, Term) for c in node.children)
    return False


def _flatten(node, q: ParsedQuery, top: bool = False) -> bool:
    """Try to express `node` with the flat device masks.  Handles the
    grammar the round-2 parser accepted: And/Or of words, adjacency
    phrases and negated words/phrases — including the default scored
    bag with group-level negations (``quick fox -lazy`` parses to
    ``And([Or(quick,fox), Not(lazy)])`` and stays flat).  Returns False
    when the shape needs the host verifier (e.g. OR containing an
    And/phrase mix that masks cannot express)."""
    if isinstance(node, Term):
        # at top level "any of ids" IS the implied ≥1-scored-term match;
        # inside an And a multi-id Term is a disjunctive requirement the
        # conjunctive `required` mask cannot express
        return top or len(node.ids) == 1
    if isinstance(node, Phrase):
        if node.slop:
            return False
        q.phrases.append(node.ids)
        for t in node.ids:
            if t not in q.required:
                q.required.append(t)
        return True
    if isinstance(node, Not):
        c = node.child
        if isinstance(c, Term):
            # NOT(any of ids) = none may be present
            for t in c.ids:
                if t not in q.forbidden:
                    q.forbidden.append(t)
            return True
        if isinstance(c, Phrase) and not c.slop:
            q.neg_phrases.append(c.ids)
            return True
        return False
    if isinstance(node, And):
        positives = [c for c in node.children if not isinstance(c, Not)]
        # a sole positive that is the scored bag (Or of words, or one
        # multi-id word) keeps OR semantics via the implied match; a
        # single plain word stays on the stricter `required` mask
        bag = None
        if top and len(positives) == 1 and _scored_bag(positives[0]):
            p = positives[0]
            if not (isinstance(p, Term) and len(p.ids) == 1):
                bag = p
        for c in node.children:
            if c is bag:
                continue
            if isinstance(c, Term) and len(c.ids) == 1:
                if c.ids[0] not in q.required:
                    q.required.append(c.ids[0])
            elif not _flatten(c, q):
                return False
        return True
    if isinstance(node, Or):
        # a top-level OR of plain words (multi-id ok: OR of ORs) is the
        # default scored bag; any structure inside an OR branch exceeds
        # the masks
        return top and all(isinstance(c, Term) for c in node.children)
    return False


# -- host-side evaluation ------------------------------------------------------


def matches(node, term_set: set[int], seq) -> bool:
    """Evaluate an AST against one document (its term-id set + token
    sequence).  Used on the device top-k candidates for structured
    queries."""
    if isinstance(node, Term):
        return any(t in term_set for t in node.ids)
    if isinstance(node, Phrase):
        if seq is None:
            return False
        return phrase_in(seq, node.ids, node.slop)
    if isinstance(node, Not):
        return not matches(node.child, term_set, seq)
    if isinstance(node, And):
        return all(matches(c, term_set, seq) for c in node.children)
    if isinstance(node, Or):
        return any(matches(c, term_set, seq) for c in node.children)
    return False


def phrase_in(seq, phrase: list[int], slop: int = 0) -> bool:
    """True if `phrase` occurs in-order in `seq` with at most `slop`
    extra tokens interleaved (slop=0: contiguous run)."""
    n, m = len(seq), len(phrase)
    if m == 0 or n < m:
        return False
    first = phrase[0]
    if slop == 0:
        for i in range(n - m + 1):
            if seq[i] == first and list(seq[i : i + m]) == phrase:
                return True
        return False
    budget = m + slop  # max window covering the match
    for i in range(n - m + 1):
        if seq[i] != first:
            continue
        j, need = i + 1, 1
        while j < n and need < m and j - i < budget:
            if seq[j] == phrase[need]:
                need += 1
            j += 1
        if need == m:
            return True
    return False

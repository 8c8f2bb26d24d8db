"""Passages and short keyword queries, made from the seed, shaped as the MS
MARCO passage collection: a vocabulary of distinct lowercase words, drawn
by Zipf weights 1/rank, passages of log-normal length.

Sized by the configuration's "rows" and "data" and the traffic's "pool":

  * vocabulary: `data.vocabulary` distinct words of 2-11 lowercase letters
    (each length equally likely, letters uniform; a repeated word is drawn
    again), in the order first drawn; word r (from 0) has weight 1/(r + 1);
  * passages: round(exp(ln(median) + sigma * z)) words, z standard normal,
    clipped to [min_words, max_words]; each word drawn by weight, so a word
    may repeat; the text is the words joined by spaces, the first word
    capitalised and a full stop at the end ("Word word word.");
  * queries: `pool` queries of 1 + Poisson(query_words - 1) distinct words,
    clipped to [2, 12], drawn by the same weights (a word drawn twice is
    drawn again), joined by spaces, in lower case.

Passages are made a chunk of CHUNK at a time, each chunk from a generator
of its own (the seed and the chunk's number), so any passage is made
without the others before it.  The driver gets the passages as a sequence
whose slices are made when asked for (one byte buffer a chunk, one decode,
slices), so the strings of the whole collection never exist at once; the
reference gets the word ids alone.  The same seed on the same device gives
the same words, whichever side asks.
"""

from __future__ import annotations

import numpy as np
import torch

# passages a chunk
CHUNK = 1 << 16
WORD_BYTES = 11  # the longest word
MAX_QUERY_WORDS = 12
# draws a query takes its distinct words from
QUERY_DRAWS = 64

_MIX = 0x9E3779B97F4A7C15
_VOCAB_STREAM, _POOL_STREAM, _CHUNK_STREAM = 1, 2, 16


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * _MIX + stream) % (1 << 64))
    return g


def vocabulary(recipe: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(letters [V, WORD_BYTES] uint8, 0 past a word's end; lengths [V]
    int64) of the V distinct words, in the order first drawn."""
    g = _generator(seed, _VOCAB_STREAM, device)
    size = int(recipe["vocabulary"])
    letters = torch.zeros((0, WORD_BYTES), dtype=torch.uint8, device=device)
    lengths = torch.zeros((0,), dtype=torch.int64, device=device)
    codes = torch.zeros((0,), dtype=torch.int64, device=device)
    place = 27 ** torch.arange(WORD_BYTES, device=device)
    while len(lengths) < size:
        m = size + size // 2
        ln = torch.randint(2, WORD_BYTES + 1, (m,), generator=g, device=device)
        lt = torch.randint(ord("a"), ord("z") + 1, (m, WORD_BYTES), generator=g, device=device)
        lt = torch.where(torch.arange(WORD_BYTES, device=device) < ln[:, None], lt, 0)
        letters = torch.cat([letters, lt.to(torch.uint8)])
        lengths = torch.cat([lengths, ln])
        # a word's letters as one number in base 27 (11 letters < 2^63)
        codes = torch.cat([codes, ((lt - ord("a") + 1).clamp(min=0) * place).sum(dim=1)])
        order = torch.argsort(codes, stable=True)
        head = torch.ones(len(codes), dtype=torch.bool, device=device)
        head[1:] = codes[order][1:] != codes[order][:-1]
        keep = torch.sort(order[head]).values  # the first of each word
        letters, lengths, codes = letters[keep], lengths[keep], codes[keep]
    return letters[:size], lengths[:size]


def _cdf(size: int, device) -> torch.Tensor:
    return torch.cumsum(1.0 / torch.arange(1, size + 1, dtype=torch.float64, device=device), 0)


def _draw(cdf: torch.Tensor, shape, g: torch.Generator) -> torch.Tensor:
    """Word ids by weight 1/(rank + 1)."""
    u = torch.rand(shape, generator=g, dtype=torch.float64, device=cdf.device) * cdf[-1]
    return torch.searchsorted(cdf, u, right=True).clamp_(max=len(cdf) - 1)


def _chunk_words(recipe: dict, cdf: torch.Tensor, seed: int, c: int, m: int):
    """(word ids [tokens] int64, words per passage [m] int64) of the m
    passages of chunk c."""
    g = _generator(seed, _CHUNK_STREAM + c, cdf.device)
    z = torch.randn((m,), generator=g, dtype=torch.float64, device=cdf.device)
    mu = float(np.log(float(recipe["median_words"])))
    n_words = torch.round(torch.exp(mu + float(recipe["sigma"]) * z)).to(torch.int64)
    n_words = n_words.clamp_(int(recipe["min_words"]), int(recipe["max_words"]))
    return _draw(cdf, (int(n_words.sum()),), g), n_words


def _chunks(n: int):
    """Yield (chunk number, passages in it) over n passages."""
    for c, off in enumerate(range(0, n, CHUNK)):
        yield c, min(CHUNK, n - off)


class Passages:
    """The collection's texts as a sequence: len() is the number of
    passages, a slice (step 1) makes its chunks' texts."""

    def __init__(self, config: dict, seed: int, device) -> None:
        self._recipe = config["data"]
        self._n = int(config["rows"])
        self._seed = seed
        letters, self._lengths = vocabulary(self._recipe, seed, device)
        # a word and the byte after it: a space, or the full stop
        self._bytes = torch.cat([letters, torch.zeros_like(letters[:, :1])], 1)
        self._cdf = _cdf(len(self._lengths), device)
        self._cached = (-1, [])

    def __len__(self) -> int:
        return self._n

    def _chunk(self, c: int) -> list[str]:
        if self._cached[0] == c:
            return self._cached[1]
        m = min(CHUNK, self._n - c * CHUNK)
        ids, n_words = _chunk_words(self._recipe, self._cdf, self._seed, c, m)
        mat = self._bytes[ids]  # [tokens, WORD_BYTES + 1]
        ln = self._lengths[ids]
        last = torch.cumsum(n_words, 0) - 1  # each passage's last word
        first = last - n_words + 1
        sep = torch.full_like(ln, ord(" "))
        sep[last] = ord(".")
        mat.scatter_(1, ln[:, None], sep[:, None].to(torch.uint8))
        mat[first, 0] -= ord("a") - ord("A")
        keep = torch.arange(WORD_BYTES + 1, device=ids.device) <= ln[:, None]
        text = mat[keep].cpu().numpy().tobytes().decode("ascii")
        # a passage ends after its last word's separator
        ends = torch.cumsum(ln + 1, 0)[last].tolist()
        texts = [text[a:b] for a, b in zip([0] + ends[:-1], ends)]
        self._cached = (c, texts)
        return texts

    def __getitem__(self, index):
        if not isinstance(index, slice):
            return self[index : index + 1][0] if index >= 0 else self[self._n + index]
        start, stop, step = index.indices(self._n)
        if step != 1:
            raise ValueError("passages are sliced with step 1")
        out = []
        for c in range(start // CHUNK, (stop - 1) // CHUNK + 1 if stop > start else 0):
            texts = self._chunk(c)
            base = c * CHUNK
            out.extend(texts[max(start - base, 0) : stop - base])
        return out


def query_words(recipe: dict, cdf: torch.Tensor, pool: int, seed: int) -> torch.Tensor:
    """[pool, MAX_QUERY_WORDS] word ids of the queries, -1 past each one's
    words."""
    g = _generator(seed, _POOL_STREAM, cdf.device)
    rate = torch.full((pool,), float(recipe["query_words"]) - 1.0, dtype=torch.float64,
                      device=cdf.device)
    n_words = (1 + torch.poisson(rate, generator=g)).clamp_(2, MAX_QUERY_WORDS).to(torch.int64)
    draws = _draw(cdf, (pool, QUERY_DRAWS), g).cpu().numpy()
    out = np.full((pool, MAX_QUERY_WORDS), -1, dtype=np.int64)
    for q, (row, want) in enumerate(zip(draws, n_words.tolist())):
        words = list(dict.fromkeys(row.tolist()))[:want]
        out[q, : len(words)] = words
    return torch.from_numpy(out).to(cdf.device)


def for_driver(config: dict, traffic: dict, seed: int, device) -> tuple[Passages, list[str]]:
    """(the passages as a sequence of strings, the query strings)."""
    items = Passages(config, seed, device)
    ids = query_words(config["data"], items._cdf, int(traffic["pool"]), seed).cpu().numpy()
    letters = items._bytes[:, :WORD_BYTES].cpu().numpy()
    lengths = items._lengths.cpu().numpy()
    word = {}
    for w in np.unique(ids[ids >= 0]).tolist():
        word[w] = letters[w, : lengths[w]].tobytes().decode("ascii")
    pool = [" ".join(word[w] for w in row if w >= 0) for row in ids.tolist()]
    return items, pool


def for_reference(config: dict, traffic: dict, seed: int, device) -> tuple[dict, torch.Tensor]:
    """({"words": every passage's word ids [tokens] int64, one passage
    after another; "offsets": [n + 1] int64, passage i's words at
    offsets[i]:offsets[i + 1]; "letters", "lengths": the vocabulary, as
    `vocabulary` gives it}, the queries' word ids [pool, 12], -1 padded),
    on `device`."""
    recipe = config["data"]
    letters, lengths = vocabulary(recipe, seed, device)
    cdf = _cdf(len(lengths), device)
    words, counts = [], []
    for c, m in _chunks(int(config["rows"])):
        w, n_words = _chunk_words(recipe, cdf, seed, c, m)
        words.append(w)
        counts.append(n_words)
    counts = torch.cat(counts)
    offsets = torch.zeros(len(counts) + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=offsets[1:])
    items = {"words": torch.cat(words), "offsets": offsets, "letters": letters, "lengths": lengths}
    return items, query_words(recipe, cdf, int(traffic["pool"]), seed)

"""The benchmark's traffic generators. Every text is drawn from the fixed
synthetic language in ``data/`` (``make_language.py``), every vector from
``bench.py``'s recipe, all from the run's seed. Sizes come from the traffic
file; a seed changes which words and rows are drawn and their order, never
the set of lengths, so every seed does the same amount of work."""

from __future__ import annotations

import os
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORDS = os.path.join(HERE, "data", "words.txt")
VOCAB = os.path.join(HERE, "data", "vocab.txt")


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream ``stream`` of the run's seed."""
    return np.random.default_rng([int(seed) % (1 << 63), int(stream)])


def torch_seed(seed: int, stream: int) -> int:
    return int(rng_for(seed, stream).integers(0, 1 << 62))


@lru_cache(maxsize=None)
def words() -> Tuple[str, ...]:
    with open(WORDS, encoding="ascii") as f:
        return tuple(line.strip() for line in f if line.strip())


@lru_cache(maxsize=None)
def tokenizer():
    from .reference.wordpiece import WordPiece

    return WordPiece.from_file(VOCAB)


@lru_cache(maxsize=None)
def word_tokens() -> np.ndarray:
    """WordPiece ids each word of the language takes."""
    tok = tokenizer()
    return np.asarray([len(tok.word_ids(w)) for w in words()], np.int64)


def spread_lengths(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths spread evenly over [lo, hi]: the same multiset for every
    seed."""
    return np.round(np.linspace(lo, hi, n)).astype(np.int64)


class Texts:
    """Texts as word-index arrays, joined on demand; token counts without
    tokenizing (a word is split by white space alone)."""

    def __init__(self, lengths: np.ndarray, rng: np.random.Generator):
        self.lengths = np.asarray(lengths, np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.lengths)])
        self.picks = rng.integers(0, len(words()), int(self.offsets[-1]))

    def __len__(self) -> int:
        return len(self.lengths)

    def text(self, i: int) -> str:
        w = words()
        return " ".join(w[j] for j in self.picks[self.offsets[i]:self.offsets[i + 1]])

    def all(self) -> List[str]:
        return [self.text(i) for i in range(len(self))]

    def tokens(self) -> np.ndarray:
        """Each text's row length: [CLS] + its words' WordPiece ids + [SEP]."""
        per = word_tokens()[self.picks]
        return np.add.reduceat(per, self.offsets[:-1]) + 2


def sentence_texts(n: int, lo: int, hi: int, rng: np.random.Generator) -> Texts:
    """n sentences of lo-hi words (the spread lengths in a seeded order)."""
    return Texts(rng.permutation(spread_lengths(lo, hi, n)), rng)


def documents(n: int, lo: int, hi: int, rng: np.random.Generator,
              sentence_words: Tuple[int, int] = (8, 40)) -> Tuple[List[str], np.ndarray]:
    """n documents whose rows are lo-hi tokens long ([CLS] and [SEP]
    counted; the spread targets in a seeded order): sentences of 8-40 words
    joined until the target is reached, the last cut at its word. → (texts,
    row lengths)."""
    targets = rng.permutation(spread_lengths(lo, hi, n))
    per_word = word_tokens()
    w = words()
    texts, lens = [], []
    for target in targets:
        body = int(target) - 2
        picks = rng.integers(0, len(w), body)          # at least enough words
        toks = np.cumsum(per_word[picks])
        n_words = int(np.searchsorted(toks, body, side="right"))
        n_words = max(n_words, 1)
        picks = picks[:n_words]
        # sentence breaks every 8-40 words (a period ends each sentence)
        cuts = np.cumsum(rng.integers(sentence_words[0], sentence_words[1] + 1,
                                      n_words // sentence_words[0] + 1))
        parts, st = [], 0
        for c in cuts:
            if st >= n_words:
                break
            parts.append(" ".join(w[j] for j in picks[st:min(c, n_words)]))
            st = int(c)
        texts.append(" ".join(parts))
        lens.append(int(toks[n_words - 1]) + 2)
    return texts, np.asarray(lens, np.int64)


def document_pairs(n: int, lo: int, hi: int, rng: np.random.Generator):
    """n pairs (a document of lo-hi tokens, the same words in another order,
    a reordering that keeps its length)."""
    docs, lens = documents(n, lo, hi, rng)
    pairs = []
    for d in docs:
        toks = d.split(" ")
        pairs.append((d, " ".join(toks[j] for j in rng.permutation(len(toks)))))
    return pairs, lens


def pair_batches(pairs: Sequence[Tuple[str, str]], batch: int, width: int, max_len: int):
    """Pairs → bi-encoder batches of ``batch`` pairs padded to ``width``:
    {ids_a, mask_a, ids_b, mask_b, target, valid}, as a trainer reads them."""
    tok = tokenizer()
    out = []
    for st in range(0, len(pairs), batch):
        group = pairs[st:st + batch]
        ids_a, mask_a = tok.batch([a for a, _ in group], max_len, width)
        ids_b, mask_b = tok.batch([b for _, b in group], max_len, width)
        out.append({"ids_a": ids_a, "mask_a": mask_a, "ids_b": ids_b, "mask_b": mask_b,
                    "target": np.zeros((len(group),), np.float32),
                    "valid": np.ones((len(group),), np.int32)})
    return out


def vector_centres(n_centres: int, dim: int, seed: int, device):
    import torch

    g = torch.Generator(device=device).manual_seed(torch_seed(seed, 10))
    return torch.randn(n_centres, dim, generator=g, device=device)


def vector_rows(centres, n: int, scale: float, seed: int, stream: int):
    """bench.py's recipe on the device: rows = a centre × ``scale`` + unit
    noise, L2-normalised (f32), in chunks of 2^18 rows."""
    import torch

    dev = centres.device
    g = torch.Generator(device=dev).manual_seed(torch_seed(seed, stream))
    assign = torch.randint(0, centres.shape[0], (n,), generator=g, device=dev)
    out = torch.empty((n, centres.shape[1]), device=dev)
    for i in range(0, n, 1 << 18):
        j = min(i + (1 << 18), n)
        x = centres[assign[i:j]] * scale + torch.randn(j - i, centres.shape[1], generator=g,
                                                       device=dev)
        out[i:j] = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return out


def vector_queries(corpus, n: int, noise: float, seed: int, stream: int):
    """Queries of the recipe: corpus rows drawn by the seed + ``noise`` ×
    unit noise, L2-normalised → (queries (n, D), the rows drawn)."""
    import torch

    dev = corpus.device
    g = torch.Generator(device=dev).manual_seed(torch_seed(seed, stream))
    rows = torch.randint(0, corpus.shape[0], (n,), generator=g, device=dev)
    x = corpus[rows] + noise * torch.randn(n, corpus.shape[1], generator=g, device=dev)
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12), rows

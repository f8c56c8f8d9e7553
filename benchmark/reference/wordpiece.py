"""A plain WordPiece tokenizer, the benchmark's own frozen copy of BERT's
rule: lower-case, NFKC, split on white space and punctuation, then greedy
longest-match-first subwords (``##`` continuations), ``[UNK]`` for a word
that does not match or is over 100 characters. A row is ``[CLS] body
[SEP]``, the body cut to ``max_len - 2`` ids."""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Sequence

import numpy as np

_PUNCT_RE = re.compile(r"([\W_])", re.UNICODE)


class WordPiece:
    def __init__(self, vocab: Sequence[str], max_word_chars: int = 100):
        self.vocab: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.pad_id = self.vocab["[PAD]"]
        self.unk_id = self.vocab["[UNK]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.max_word_chars = max_word_chars
        self._cache: Dict[str, List[int]] = {}

    @classmethod
    def from_file(cls, path: str) -> "WordPiece":
        with open(path, encoding="utf-8") as f:
            return cls([line.rstrip("\r\n") for line in f])

    def _match(self, word: str) -> List[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        ids, start, n = [], 0, len(word)
        while start < n:
            end, cur = n, None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def word_ids(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._cache[word] = self._match(word)
        return ids

    def body(self, text: str) -> List[int]:
        text = unicodedata.normalize("NFKC", text.lower())
        out: List[int] = []
        for chunk in text.split():
            for piece in _PUNCT_RE.split(chunk):
                piece = piece.strip()
                if piece:
                    out.extend(self.word_ids(piece))
        return out

    def row(self, text: str, max_len: int) -> List[int]:
        return [self.cls_id] + self.body(text)[: max_len - 2] + [self.sep_id]

    def batch(self, texts: Sequence[str], max_len: int, width: int = 0):
        """→ (ids, mask) int32 (B, W): rows padded with ``[PAD]`` to
        ``width``, or to the longest row."""
        rows = [self.row(t, max_len) for t in texts]
        w = width or max(len(r) for r in rows)
        ids = np.full((len(rows), w), self.pad_id, np.int32)
        mask = np.zeros((len(rows), w), np.int32)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return ids, mask

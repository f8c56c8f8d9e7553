"""Host-side WordPiece tokenization (pure Python).

The port's own copy of the pure-Python path of
``text_similarity_tpu.data.tokenization``: BERT-style basic pre-split plus
greedy longest-match subwords, a frequency-based vocab builder so tests and
smoke runs need no network, and ``load_tokenizer`` for a ``vocab.txt``.
The reference's native C matcher is byte-exact with this path and is not
ported yet; neither is loading a HuggingFace ``tokenizer.json``.
"""

from __future__ import annotations

import collections
import json
import os
import re
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]

_PUNCT_RE = re.compile(r"([\W_])", re.UNICODE)


def _basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    if lowercase:
        text = text.lower()
    text = unicodedata.normalize("NFKC", text)
    out = []
    for chunk in text.split():
        for piece in _PUNCT_RE.split(chunk):
            piece = piece.strip()
            if piece:
                out.append(piece)
    return out


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece (BERT semantics)."""

    def __init__(
        self,
        vocab: Dict[str, int],
        lowercase: bool = True,
        max_word_chars: int = 100,
    ):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.max_word_chars = max_word_chars
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]
        self.mask_id = self.vocab.get(MASK, self.unk_id)
        # word → ids memo: corpora repeat words heavily, and the greedy
        # matcher is the host hot path of encode()
        self._word_cache: Dict[str, List[int]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = True):
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                # strip \r too: a CRLF vocab.txt would key every token as
                # 'token\r' and tokenize everything to [UNK]
                vocab[line.rstrip("\r\n")] = i
        return cls(vocab, lowercase=lowercase)

    def save_vocab(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for tok, _ in sorted(self.vocab.items(), key=lambda kv: kv[1]):
                f.write(tok + "\n")

    def _wordpiece(self, word: str) -> List[int]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        ids = self._match(word)
        if len(self._word_cache) < 1_000_000:
            self._word_cache[word] = ids
        return ids

    def _match(self, word: str) -> List[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        ids, start = [], 0
        n = len(word)
        while start < n:
            end, cur = n, None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def tokenize_to_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for w in _basic_tokenize(text, self.lowercase):
            ids.extend(self._wordpiece(w))
        return ids

    def tokenize_many(self, texts: Sequence[str]) -> List[List[int]]:
        return [self.tokenize_to_ids(t) for t in texts]

    def encode_batch(
        self, texts: Sequence[str], max_len: int = 128, pad_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids, mask), shape (B, L): [CLS] tokens [SEP], truncated to
        ``max_len`` and padded to the longest row (or ``pad_to``)."""
        rows = []
        for t in texts:
            ids = [self.cls_id] + self.tokenize_to_ids(t)[: max_len - 2] + [self.sep_id]
            rows.append(ids)
        longest = max((len(r) for r in rows), default=2)
        if pad_to and pad_to < longest:
            raise ValueError(
                f"pad_to={pad_to} < longest row ({longest}): would "
                "truncate mid-sequence; raise pad_to or lower max_len"
            )
        L = pad_to or longest
        out = np.full((len(rows), L), self.pad_id, np.int32)
        mask = np.zeros((len(rows), L), np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return out, mask


def train_wordpiece_vocab(
    texts: Iterable[str],
    vocab_size: int = 8192,
    lowercase: bool = True,
    min_freq: int = 2,
) -> Dict[str, int]:
    """Build a WordPiece vocab: all single chars (+ '##' continuations) for
    full coverage, then the most frequent whole words and suffixes."""
    word_freq: collections.Counter = collections.Counter()
    for t in texts:
        word_freq.update(_basic_tokenize(t, lowercase))

    char_set, cont_set = set(), set()
    for w in word_freq:
        for i, ch in enumerate(w):
            (char_set if i == 0 else cont_set).add(ch)

    cand: collections.Counter = collections.Counter()
    for w, f in word_freq.items():
        if f >= min_freq:
            cand[w] += f
            for i in range(1, min(len(w), 8)):
                cand["##" + w[i:]] += f

    vocab: Dict[str, int] = {}
    for s in SPECIALS:
        vocab[s] = len(vocab)
    for ch in sorted(char_set):
        if ch not in vocab:
            vocab[ch] = len(vocab)
    for ch in sorted(cont_set):
        tok = "##" + ch
        if tok not in vocab:
            vocab[tok] = len(vocab)
    for tok, _ in cand.most_common():
        if len(vocab) >= vocab_size:
            break
        if tok not in vocab:
            vocab[tok] = len(vocab)
    return vocab


def load_tokenizer(path: str) -> WordPieceTokenizer:
    """Load ``vocab.txt`` (+ ``tokenizer_config.json``'s ``do_lower_case``)
    from a model directory."""
    if os.path.exists(os.path.join(path, "tokenizer.json")):
        raise NotImplementedError(
            f"{path}/tokenizer.json: HuggingFace tokenizer loading is not "
            "ported yet; provide a vocab.txt"
        )
    vt = os.path.join(path, "vocab.txt")
    if os.path.exists(vt):
        lowercase = True
        cfgp = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfgp):
            with open(cfgp) as f:
                lowercase = json.load(f).get("do_lower_case", True)
        return WordPieceTokenizer.from_vocab_file(vt, lowercase=lowercase)
    raise FileNotFoundError(f"no vocab.txt under {path}")

"""Host-side tokenization (port of ``text_similarity_tpu.data.tokenization``).

- ``WordPieceTokenizer``: BERT-style basic pre-split plus greedy
  longest-match subwords. By default ``encode_batch`` and ``tokenize_many``
  run in C (``native.NativeWordPiece``, built at first use): one
  pthread-parallel call splits, matches and pads a whole batch. A row the C
  batch does not take (any non-ASCII byte, including a text that does not
  encode as UTF-8) goes through the full-Unicode Python pre-split, on the
  input's own test: no error falls back to Python. ``tokenize_to_ids`` (one
  text) is the Python matcher with its word cache. The C and Python paths
  give equal ids (``use_native=False`` selects the Python one).
- the pair methods of a cross-encoder: ``encode_pair_batch`` (padded),
  ``encode_pair_rows`` (ragged rows for packing) and ``encode_bodies``
  (bodies without specials for ``data.packing.pack_pair_arrays``), with
  HF's ``longest_first`` truncation;
- ``train_wordpiece_vocab``: a frequency-based vocab builder, so tests and
  smoke runs need no network;
- ``HFTokenizerAdapter``: a HuggingFace ``tokenizer.json`` (through the
  ``tokenizers`` package, imported when one is loaded) behind the same
  batch API;
- ``load_tokenizer``: a model directory's ``tokenizer.json``, else its
  ``vocab.txt``.
"""

from __future__ import annotations

import collections
import json
import os
import re
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..native import NativeWordPiece

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]

_PUNCT_RE = re.compile(r"([\W_])", re.UNICODE)

# a C call of tokenize_many takes at most this many texts and id cells
# (ids and mask of 8 Mi cells: 64 MiB)
_MANY_ROWS = 16384
_MANY_CELLS = 1 << 23


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
    """Greedy longest-match-first WordPiece (BERT semantics); the matcher
    runs in C unless ``use_native=False``."""

    def __init__(
        self,
        vocab: Dict[str, int],
        lowercase: bool = True,
        max_word_chars: int = 100,
        use_native: bool = True,
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
        # word → ids memo of the Python matcher: corpora repeat words
        # heavily, and the greedy matcher is the host hot path of encode()
        self._word_cache: Dict[str, List[int]] = {}
        self._native = None
        if use_native:
            # the C batch takes ASCII rows only, where bytes are characters
            self._native = NativeWordPiece(self.vocab, self.unk_id, max_word_chars)

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
        """Token ids of many texts, untruncated. Natively the texts go
        through the C batch of ``encode_batch`` in chunks of similar length,
        each as wide as its longest text (an ASCII row has no more ids than
        characters); the rows it flags take the Python path whole."""
        texts = list(texts)
        if self._native is None:
            return [self.tokenize_to_ids(t) for t in texts]
        lens = np.fromiter(map(len, texts), np.int64, len(texts))
        order = np.argsort(lens, kind="stable")
        out: List[List[int]] = [[] for _ in texts]
        st = 0
        while st < len(order):
            en = min(st + _MANY_ROWS, len(order))
            while en - st > 1 and (en - st) * (int(lens[order[en - 1]]) + 2) > _MANY_CELLS:
                en = st + (en - st) // 2
            idx = order[st:en]
            ids, _, n, needs_py = self._native.encode_batch_padded(
                [texts[i] for i in idx], int(lens[idx[-1]]) + 2, self.cls_id, self.sep_id,
                self.pad_id, lowercase=self.lowercase, max_word_chars=self.max_word_chars,
            )
            for j, i in enumerate(idx):
                out[i] = (self.tokenize_to_ids(texts[i]) if needs_py[j]
                          else ids[j, 1:n[j] - 1].tolist())
            st = en
        return out

    def encode_batch(
        self, texts: Sequence[str], max_len: int = 128, pad_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids, mask), shape (B, L): [CLS] tokens [SEP], truncated to
        ``max_len`` and padded to the longest row (or ``pad_to``).

        Natively the whole batch (split + WordPiece + specials + padding)
        runs in one pthread-parallel C call; each row with a non-ASCII byte,
        which that call flags, then goes through the full-Unicode Python
        pre-split."""
        texts = list(texts)
        if self._native is None or not texts or max_len < 2:
            rows = [
                [self.cls_id] + self.tokenize_to_ids(t)[: max_len - 2] + [self.sep_id]
                for t in texts
            ]
            return _pad_rows(rows, self.pad_id, pad_to)
        ids, mask, lens, needs_py = self._native.encode_batch_padded(
            texts, max_len, self.cls_id, self.sep_id, self.pad_id,
            lowercase=self.lowercase, max_word_chars=self.max_word_chars,
        )
        for i in np.nonzero(needs_py)[0]:
            row = [self.cls_id] + self.tokenize_to_ids(texts[i])[: max_len - 2] + [self.sep_id]
            ids[i, : len(row)] = row
            ids[i, len(row):] = self.pad_id
            mask[i, : len(row)] = 1
            mask[i, len(row):] = 0
            lens[i] = len(row)
        longest = int(lens.max())
        _check_pad_to(pad_to, longest)
        L = pad_to or longest
        if L > max_len:
            # the C buffers are (B, max_len); honour pad_to > max_len as the
            # Python path does
            ids = np.pad(ids, ((0, 0), (0, L - max_len)), constant_values=self.pad_id)
            mask = np.pad(mask, ((0, 0), (0, L - max_len)))
        return ids[:, :L], mask[:, :L]

    def encode_pair_batch(
        self,
        texts_a: Sequence[str],
        texts_b: Sequence[str],
        max_len: int = 128,
        pad_to: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Cross-encoder input [CLS] a [SEP] b [SEP] → (ids, mask, token
        types), padded; HF's ``longest_first`` truncation (pop from the
        longer side, ties from a)."""
        rows, types = self.encode_pair_rows(texts_a, texts_b, max_len)
        return _pad_rows(rows, self.pad_id, pad_to, types)

    def encode_pair_rows(
        self,
        texts_a: Sequence[str],
        texts_b: Sequence[str],
        max_len: int = 128,
    ) -> Tuple[List[List[int]], List[List[int]]]:
        """Ragged form of ``encode_pair_batch`` (the packing input): token
        rows and type rows, no padding. One batched tokenize a side and the
        ``longest_first`` truncation in closed form."""
        ra = self.tokenize_many(texts_a)
        rb = self.tokenize_many(texts_b)
        budget = max_len - 3
        half = budget // 2
        rows, types = [], []
        for ia, ib in zip(ra, rb):
            la, lb = len(ia), len(ib)
            if la + lb > budget:
                if lb <= half:
                    la = budget - lb
                elif la <= half:
                    lb = budget - la
                else:
                    la, lb = half, budget - half
                ia, ib = ia[:la], ib[:lb]
            rows.append([self.cls_id] + ia + [self.sep_id] + ib + [self.sep_id])
            types.append([0] * (la + 2) + [1] * (lb + 1))
        return rows, types

    def encode_bodies(self, texts: Sequence[str], max_body: int) -> Tuple[np.ndarray, np.ndarray]:
        """→ (body ids (N, ≤ max_body + 1) int32 left-aligned, body lens):
        the tokens without [CLS]/[SEP], truncated to ``max_body``, through
        ``encode_batch`` — the array input of
        ``data.packing.pack_pair_arrays``."""
        ids, mask = self.encode_batch(texts, max_len=max_body + 2)
        lens = mask.sum(axis=1).astype(np.int64) - 2
        return ids[:, 1:], lens

    def token_spans(self, text: str) -> List[Tuple[str, List[int]]]:
        """Each basic token of ``text`` → the positions of its wordpieces in
        the encoded row (position 0 is [CLS]): the word ↔ sub-token
        alignment of the word models."""
        spans, pos = [], 1
        for w in _basic_tokenize(text, self.lowercase):
            n = len(self._wordpiece(w))
            spans.append((w, list(range(pos, pos + n))))
            pos += n
        return spans


def _check_pad_to(pad_to: Optional[int], longest: int) -> None:
    if pad_to and pad_to < longest:
        raise ValueError(
            f"pad_to={pad_to} < longest row ({longest}): would "
            "truncate mid-sequence; raise pad_to or lower max_len"
        )


def _pad_rows(rows, pad_id: int, pad_to: Optional[int], types=None):
    """Ragged rows (and type rows) → (ids, mask[, types]) int32, padded to
    the longest row or ``pad_to``."""
    longest = max((len(r) for r in rows), default=2)
    _check_pad_to(pad_to, longest)
    L = pad_to or longest
    out = np.full((len(rows), L), pad_id, np.int32)
    mask = np.zeros((len(rows), L), np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
        mask[i, : len(r)] = 1
    if types is None:
        return out, mask
    tts = np.zeros((len(rows), L), np.int32)
    for i, tt in enumerate(types):
        tts[i, : len(tt)] = tt
    return out, mask, tts


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


class HFTokenizerAdapter:
    """A HuggingFace ``tokenizers.Tokenizer`` (a ``tokenizer.json``) behind
    the batch API of ``WordPieceTokenizer``. The HF tokenizer adds its own
    specials and normalises; a truncated row keeps its final [SEP]."""

    def __init__(self, tok, pad_id: int, cls_id: int, sep_id: int,
                 unk_id: int = 0, mask_id: Optional[int] = None):
        self._tok = tok
        self.pad_id, self.cls_id, self.sep_id = pad_id, cls_id, sep_id
        self.unk_id = unk_id
        self.mask_id = mask_id if mask_id is not None else unk_id
        # the HF tokenizer normalises itself: the word helpers below must
        # not lowercase again
        self.lowercase = False
        self.vocab_size = tok.get_vocab_size()

    @classmethod
    def from_file(cls, path: str) -> "HFTokenizerAdapter":
        from tokenizers import Tokenizer

        tok = Tokenizer.from_file(path)
        vocab = tok.get_vocab()
        return cls(
            tok,
            pad_id=vocab.get(PAD, 0),
            cls_id=vocab.get(CLS, vocab.get("<s>", 0)),
            sep_id=vocab.get(SEP, vocab.get("</s>", 0)),
            unk_id=vocab.get(UNK, vocab.get("<unk>", 0)),
            mask_id=vocab.get(MASK, vocab.get("<mask>")),
        )

    def _wordpiece(self, word: str) -> List[int]:
        """One word's sub-token ids without specials (the surface the word
        batch builders read)."""
        return list(self._tok.encode(word, add_special_tokens=False).ids) or [self.unk_id]

    def token_spans(self, text: str) -> List[Tuple[str, List[int]]]:
        """[(basic token, its sub-token ids)], as the JAX package's adapter
        returns them (ids, where ``WordPieceTokenizer.token_spans`` gives
        positions; the word batch builders read only their count)."""
        return [(w, self._wordpiece(w)) for w in _basic_tokenize(text, lowercase=False)]

    def _truncate(self, ids, max_len: int) -> List[int]:
        """Truncate to ``max_len`` keeping the terminal [SEP]: BERT-class
        models never saw a row end mid-sequence in training."""
        if len(ids) <= max_len:
            return list(ids)
        return list(ids[: max_len - 1]) + [self.sep_id]

    def encode_batch(self, texts, max_len: int = 128, pad_to: Optional[int] = None):
        encs = self._tok.encode_batch(list(texts))
        return _pad_rows([self._truncate(e.ids, max_len) for e in encs], self.pad_id, pad_to)

    def encode_pair_batch(self, texts_a, texts_b, max_len: int = 128, pad_to: Optional[int] = None):
        encs = self._tok.encode_batch(list(zip(texts_a, texts_b)))
        rows = [self._truncate(e.ids, max_len) for e in encs]
        types = [list(e.type_ids[: len(r)]) for e, r in zip(encs, rows)]
        return _pad_rows(rows, self.pad_id, pad_to, types)


def load_tokenizer(path: str):
    """A model directory's tokenizer: ``tokenizer.json`` (HF fast-tokenizer
    format) when present, else ``vocab.txt`` (+ ``tokenizer_config.json``'s
    ``do_lower_case``)."""
    tj = os.path.join(path, "tokenizer.json")
    if os.path.exists(tj):
        return HFTokenizerAdapter.from_file(tj)
    vt = os.path.join(path, "vocab.txt")
    if os.path.exists(vt):
        lowercase = True
        cfgp = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(cfgp):
            with open(cfgp) as f:
                lowercase = json.load(f).get("do_lower_case", True)
        return WordPieceTokenizer.from_vocab_file(vt, lowercase=lowercase)
    raise FileNotFoundError(f"no tokenizer.json or vocab.txt under {path}")

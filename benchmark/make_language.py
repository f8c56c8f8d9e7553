"""Make the benchmark's fixed synthetic language: ``data/words.txt`` (the
20,000 words every text is drawn from) and ``data/vocab.txt`` (a
30,522-entry WordPiece vocabulary over a 120,000-sentence corpus of them).

Run once from the repository root; the two files are committed, so no run
of the benchmark trains a vocabulary:

    python3 -m benchmark.make_language

The words are syllable strings (2-4 of 90 consonant-vowel syllables); the
vocabulary takes the specials, every first and continuation character, then
the most frequent whole words and suffixes (at most 7 characters) that
occur at least twice: a frequency-based WordPiece vocabulary.
"""

from __future__ import annotations

import collections
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORDS = os.path.join(HERE, "data", "words.txt")
VOCAB = os.path.join(HERE, "data", "vocab.txt")
N_WORDS = 20_000
N_SENTENCES = 120_000
VOCAB_SIZE = 30_522
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def make_words(seed: int = 0, n_words: int = N_WORDS) -> list:
    rng = np.random.default_rng(seed)
    syll = [a + b for a in "bcdfghjklmnprstvwz" for b in "aeiou"]
    words = set()
    while len(words) < n_words:
        words.add("".join(rng.choice(syll, rng.integers(2, 5))))
    return sorted(words)


def make_vocab(words: list, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 41, N_SENTENCES)
    picks = rng.integers(0, len(words), int(lens.sum()))
    freq = collections.Counter(words[j] for j in picks)
    first, cont = set(), set()
    for w in freq:
        first.add(w[0])
        cont.update(w[1:])
    cand = collections.Counter()
    for w, f in freq.items():
        if f >= 2:
            cand[w] += f
            for i in range(1, min(len(w), 8)):
                cand["##" + w[i:]] += f
    vocab = list(SPECIALS)
    seen = set(vocab)
    for tok in sorted(first) + ["##" + c for c in sorted(cont)]:
        if tok not in seen:
            vocab.append(tok)
            seen.add(tok)
    for tok, _ in sorted(cand.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(vocab) >= VOCAB_SIZE:
            break
        if tok not in seen:
            vocab.append(tok)
            seen.add(tok)
    return vocab


def main() -> None:
    words = make_words()
    vocab = make_vocab(words)
    os.makedirs(os.path.dirname(WORDS), exist_ok=True)
    with open(WORDS, "w", encoding="ascii") as f:
        f.write("\n".join(words) + "\n")
    with open(VOCAB, "w", encoding="ascii") as f:
        f.write("\n".join(vocab) + "\n")
    print(f"{len(words)} words, {len(vocab)} vocabulary entries")


if __name__ == "__main__":
    main()

"""The generators are deterministic by seed, and a seed changes which
words and rows are drawn, never the amount of work."""

import numpy as np
import torch

from benchmark import gen
from benchmark.make_language import make_vocab, make_words


def test_language_files_are_the_script_output():
    words = make_words()
    assert list(gen.words()) == words
    with open(gen.VOCAB, encoding="ascii") as f:
        assert [line.rstrip("\n") for line in f] == make_vocab(words)


def test_sentences_same_seed_same_texts():
    a = gen.sentence_texts(50, 8, 40, gen.rng_for(2**31 + 17, 1))
    b = gen.sentence_texts(50, 8, 40, gen.rng_for(2**31 + 17, 1))
    c = gen.sentence_texts(50, 8, 40, gen.rng_for(2**31 + 18, 1))
    assert a.all() == b.all() and a.all() != c.all()
    assert sorted(a.lengths) == sorted(c.lengths)        # the same work
    assert all(8 <= len(t.split()) <= 40 for t in a.all())


def test_token_counts_match_the_tokenizer():
    tok = gen.tokenizer()
    texts = gen.sentence_texts(40, 8, 40, gen.rng_for(5, 1))
    assert list(texts.tokens()) == [len(tok.row(t, 10_000)) for t in texts.all()]


def test_documents_hit_their_lengths():
    tok = gen.tokenizer()
    docs, lens = gen.documents(6, 300, 500, gen.rng_for(9, 1))
    again, _ = gen.documents(6, 300, 500, gen.rng_for(9, 1))
    assert docs == again
    for d, n in zip(docs, lens):
        assert len(tok.row(d, 10_000)) == n
        assert 300 - 8 <= n <= 500           # the last word may not fit


def test_pairs_keep_the_length():
    tok = gen.tokenizer()
    pairs, _ = gen.document_pairs(3, 200, 260, gen.rng_for(3, 1))
    for a, b in pairs:
        assert len(tok.body(a)) == len(tok.body(b)) and a != b
    batches = gen.pair_batches(pairs, 2, 512, 512)
    assert [b["ids_a"].shape for b in batches] == [(2, 512), (1, 512)]
    assert batches[0]["mask_a"].sum() == sum(len(tok.row(a, 512)) for a, _ in pairs[:2])


def test_vector_recipe_is_seeded():
    c1 = gen.vector_centres(16, 8, 2**31 + 5, "cpu")
    r1 = gen.vector_rows(c1, 100, 3.0, 2**31 + 5, 11)
    r2 = gen.vector_rows(gen.vector_centres(16, 8, 2**31 + 5, "cpu"), 100, 3.0, 2**31 + 5, 11)
    assert torch.equal(r1, r2)
    assert torch.allclose(r1.norm(dim=1), torch.ones(100), atol=1e-5)
    q, rows = gen.vector_queries(r1, 10, 0.1, 7, 20)
    assert torch.allclose(q.norm(dim=1), torch.ones(10), atol=1e-5)
    assert float((q * r1[rows]).sum(1).min()) > 0.9      # a query lies near its row
    q2, _ = gen.vector_queries(r1, 10, 0.1, 8, 20)
    assert not torch.equal(q, q2)


def test_spread_lengths_cover_the_range():
    s = gen.spread_lengths(8, 40, 512)
    assert s.min() == 8 and s.max() == 40 and len(s) == 512
    assert np.all(np.diff(s) >= 0)

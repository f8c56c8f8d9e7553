"""The port's dataset loaders and batch builders against the JAX package's,
on the files and cases of ``tests/test_datasets.py``: the same rows from
each loader, the same splits, and the same arrays from the pair (bi and
cross), packed and sequence builders."""

import gzip
import json

import numpy as np
import pytest

from text_similarity_tpu.data import datasets as JD
from text_similarity_tpu.data import pairs as JP
from text_similarity_tpu_torch.data import datasets as TD
from text_similarity_tpu_torch.data import pairs as TP
from text_similarity_tpu_torch.data.tokenization import WordPieceTokenizer, train_wordpiece_vocab


@pytest.fixture(scope="module")
def tok():
    corpus = [
        "the quick brown fox jumps over the lazy dog",
        "a bank can be a river bank or a money bank",
        "machine learning is fun and fast",
    ]
    return WordPieceTokenizer(train_wordpiece_vocab(corpus, 512, min_freq=1))


def _write(tmp_path, name, text):
    p = tmp_path / name
    if name.endswith(".gz"):
        with gzip.open(p, "wt", encoding="utf-8") as f:
            f.write(text)
    else:
        p.write_text(text)
    return str(p)


FILES = {
    "sts": ("sts.tsv", "main-captions\tMSRvid\t2012\t0001\t4.25\ta man is singing\ta man sings\n"
                       "one\ttwo\na dog runs\ta dog is running\t5.0\nx\ty\tnot-a-score\n"),
    "nli": ("nli.tsv", "premise\thypothesis\tlabel\na man eats\ta person eats\tentailment\n"
                       "a man eats\ta man sleeps\tcontradiction\na man eats\ta man eats pasta\t"
                       "neutral\nx\ty\t2\nshort\n"),
    "paws": ("paws.tsv", "id\tsentence1\tsentence2\tlabel\n1\tfoo bar\tbar foo\t1\n2\tx\ty\t0\n"),
    "quora": ("quora.tsv", "1\t2\t3\thow to cook rice\tcooking rice how\t1\nbad\trow\n"),
    "parallel": ("par.tsv.gz", "hello world\thallo welt\ngood day\tguten tag\n\tempty\n"),
    "sentence_pool": ("pool.txt", "one sentence\n\n  two sentence  \nthree\n"),
    "conll_ner": ("ner.txt", "-DOCSTART- O\n\nJohn B-PER\nworks O\n\nParis B-LOC\n"),
    "gwsc": ("gwsc.tsv", "bank\t1\t3\tthe bank closed early\tmoney in the bank\t3.5\n"
                         "fox\tthe quick fox runs\ta fox slept today\t1.25\nbad\trow\n"),
}


@pytest.mark.parametrize("name", sorted(FILES))
def test_loaders_match_jax(tmp_path, name):
    path = _write(tmp_path, *FILES[name])
    fn = f"load_{name}"
    assert getattr(TD, fn)(path) == getattr(JD, fn)(path)


def test_load_parallel_and_pool_limits_match_jax(tmp_path):
    par = _write(tmp_path, *FILES["parallel"])
    pool = _write(tmp_path, *FILES["sentence_pool"])
    assert TD.load_parallel(par, max_pairs=1) == JD.load_parallel(par, max_pairs=1)
    assert TD.load_sentence_pool(pool, max_sentences=2) == JD.load_sentence_pool(pool, 2)


def test_load_wic_and_gold_match_jax(tmp_path):
    d = _write(tmp_path, "wic.tsv", "bank\tN\t1-2\tthe bank closed\tthe river bank\n"
                                    "fox\tN\t2-1\ta quick fox runs\tthe fox sleeps\nshort\n")
    g = _write(tmp_path, "gold.txt", "F\nT\n")
    assert TD.load_wic(d, g) == JD.load_wic(d, g)
    assert TD.load_wic(d) == JD.load_wic(d)
    bad = _write(tmp_path, "gold1.txt", "F\n")
    with pytest.raises(ValueError):
        TD.load_wic(d, bad)


@pytest.mark.parametrize("words", [0, 30])
def test_load_documents_json_matches_jax(tmp_path, words):
    recs = [{"text": "w " * 100, "label": "news"}, {"text": "a b\nc d e", "label": "sport"}]
    jsonl = _write(tmp_path, "docs.jsonl", "\n".join(json.dumps(r) for r in recs))
    arr = _write(tmp_path, "docs.json", json.dumps(recs))
    for p in (jsonl, arr):
        assert (TD.load_documents_json(p, max_paragraph_words=words)
                == JD.load_documents_json(p, max_paragraph_words=words))
    assert TD.split_paragraphs("a b c\n\nd e", 2) == JD.split_paragraphs("a b c\n\nd e", 2)


def test_stratified_split_and_kfold_match_jax():
    examples = list(range(100))
    labels = [i % 4 for i in examples]
    assert (TD.stratified_split(examples, labels, 0.2, seed=1)
            == JD.stratified_split(examples, labels, 0.2, seed=1))
    assert (list(TD.stratified_kfold(examples, labels, k=5, seed=2))
            == list(JD.stratified_kfold(examples, labels, k=5, seed=2)))


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


PAIRS = [("the quick fox", "a lazy dog"), ("bank of the river", "money bank"),
         ("machine learning is fun", "fast"), ("a", "the quick brown fox jumps over the dog")]


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, shuffle=False),
    dict(batch_size=3, max_len=8, seed=3),
    dict(batch_size=2, max_len=40, buckets=(4, 8)),
])
@pytest.mark.parametrize("mode", ["bi", "cross"])
def test_build_pair_batches_matches_jax(tok, mode, kw):
    pairs, targets = PAIRS * 3, [1, 0, 1, 0] * 3
    dt = np.int32 if mode == "cross" else np.float32
    _same_batches(TP.build_pair_batches(tok, pairs, targets, mode=mode, target_dtype=dt, **kw),
                  JP.build_pair_batches(tok, pairs, targets, mode=mode, target_dtype=dt, **kw))


@pytest.mark.parametrize("mode,rows,width", [("bi", 2, 16), ("bi", 4, 32), ("cross", 3, 24)])
def test_build_packed_pair_batches_matches_jax(tok, mode, rows, width):
    pairs = PAIRS * 6
    targets = np.arange(len(pairs), dtype=np.float32) / 10
    kw = dict(rows_per_side=rows, width=width, mode=mode, seed=5)
    got = TP.build_packed_pair_batches(tok, pairs, targets, **kw)
    _same_batches(got, JP.build_packed_pair_batches(tok, pairs, targets, **kw))
    # every pair lands in exactly one slot
    assert sorted(float(t) for b in got for t, v in zip(b.get("target", b.get("labels")),
                                                         b["valid"]) if v) == sorted(targets)


@pytest.mark.parametrize("rows,width", [(4, 32), (2, 40)])
def test_packed_pair_batches_from_rows_matches_jax(rows, width):
    """Groups that overflow their rows pass members on (many at 2 rows of
    40): the same groups as the JAX package's drop-and-repack loop."""
    rng = np.random.default_rng(0)
    rows_a = [list(rng.integers(5, 99, rng.integers(3, 30))) for _ in range(60)]
    rows_b = [list(rng.integers(5, 99, rng.integers(3, 30))) for _ in range(60)]
    targets = rng.random(60).astype(np.float32)
    kw = dict(rows_per_side=rows, width=width, seed=1)
    _same_batches(TP.packed_pair_batches_from_rows(rows_a, rows_b, targets, **kw),
                  JP.packed_pair_batches_from_rows(rows_a, rows_b, targets, **kw))
    assert TP.packed_pair_batches_from_rows([], [], []) == []


@pytest.mark.parametrize("kw", [dict(batch_size=4), dict(batch_size=3, max_len=6, shuffle=False)])
def test_build_sequence_batches_matches_jax(tok, kw):
    texts = ["the fox runs fast", "a bank", "machine learning is fun and fast ok"] * 3
    labels = [1, 0, 2] * 3
    _same_batches(TP.build_sequence_batches(tok, texts, labels, **kw),
                  JP.build_sequence_batches(tok, texts, labels, **kw))


def test_builders_take_a_tokenizer_json_model(tmp_path):
    """A ``tokenizer.json`` model (the HF adapter: its own padded batch and
    specials, no ``tokenize_many``): bi, cross, packed and sequence batches
    equal the JAX package's with its adapter."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors

    from text_similarity_tpu.data.tokenization import HFTokenizerAdapter as JaxAdapter
    from text_similarity_tpu_torch.data.tokenization import HFTokenizerAdapter

    vocab = train_wordpiece_vocab([a + " " + b for a, b in PAIRS], 200, min_freq=1)
    hf = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]"))
    hf.normalizer = normalizers.BertNormalizer(lowercase=True)
    hf.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    hf.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])],
    )
    path = str(tmp_path / "tokenizer.json")
    hf.save(path)
    tok, jtok = HFTokenizerAdapter.from_file(path), JaxAdapter.from_file(path)
    pairs, targets = PAIRS * 3, np.arange(12, dtype=np.float32)
    for mode in ("bi", "cross"):
        _same_batches(TP.build_pair_batches(tok, pairs, targets, batch_size=4, mode=mode),
                      JP.build_pair_batches(jtok, pairs, targets, batch_size=4, mode=mode))
        kw = dict(rows_per_side=3, width=24, mode=mode)
        _same_batches(TP.build_packed_pair_batches(tok, pairs, targets, **kw),
                      JP.build_packed_pair_batches(jtok, pairs, targets, **kw))
    texts = [a for a, _ in pairs]
    _same_batches(TP.build_sequence_batches(tok, texts, [1] * 12, batch_size=5),
                  JP.build_sequence_batches(jtok, texts, [1] * 12, batch_size=5))

"""Dataset loaders and splits (the port's copy of
``text_similarity_tpu.data.datasets``): plain-Python parsers of local
files, no network.

- ``load_sts``: STS-B tsv (score at column 4, sentences at 5 and 6) or a
  (s1, s2, score) tsv; scores divided by 5 into [0, 1]
- ``load_nli``: (premise, hypothesis, label) tsv, a label name or an int
- ``load_paws`` / ``load_quora``: paraphrase pairs with 0/1 labels
- ``load_parallel``: source \\t target lines (.tsv or .tsv.gz)
- ``load_sentence_pool``: one sentence (or document) per line
- ``load_wic``: word-in-context rows, with an optional gold file
- ``load_conll_ner``: CoNLL token ... tag lines, blank-line separated
- ``load_documents_json``: JSON / JSONL documents with labels, optionally
  split into paragraphs (``split_paragraphs``)
- ``load_gwsc``: graded word similarity in context
- ``stratified_split`` / ``stratified_kfold``: label-stratified splits

Each loader returns plain lists and dicts; ``data.pairs`` turns them into
fixed-shape batches.
"""

from __future__ import annotations

import collections
import csv
import gzip
import json
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

NLI_LABELS = {"entailment": 0, "neutral": 1, "contradiction": 2}


def _open(path: str, mode="rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode, encoding="utf-8")
    return open(path, mode, encoding="utf-8")


def load_sts(path: str, score_scale: float = 5.0) -> List[Tuple[str, str, float]]:
    """STS-B: official 7+ column tsv (score at col 4, sents at 5,6) or a
    simple (s1, s2, score) tsv. Scores normalized to [0, 1]."""
    out = []
    with _open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 7:
                score, s1, s2 = parts[4], parts[5], parts[6]
            elif len(parts) == 3:
                s1, s2, score = parts
            else:
                continue
            try:
                sc = float(score) / score_scale
            except ValueError:
                continue
            out.append((s1, s2, sc))
    return out


def load_nli(path: str) -> List[Tuple[str, str, int]]:
    """(premise, hypothesis, label) tsv, header allowed; label name or int."""
    out = []
    with _open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 3:
                continue
            s1, s2, lab = parts[0], parts[1], parts[2].strip().lower()
            if lab in NLI_LABELS:
                out.append((s1, s2, NLI_LABELS[lab]))
            elif lab.isdigit():
                out.append((s1, s2, int(lab)))
    return out


def load_paws(path: str) -> List[Tuple[str, str, int]]:
    """PAWS/PAWS-X tsv: id, sentence1, sentence2, label."""
    out = []
    with _open(path) as f:
        reader = csv.reader(f, delimiter="\t")
        for row in reader:
            if len(row) < 4 or row[3] not in ("0", "1"):
                continue
            out.append((row[1], row[2], int(row[3])))
    return out


def load_quora(path: str) -> List[Tuple[str, str, int]]:
    """Quora duplicate questions tsv: ... question1, question2,
    is_duplicate as the last 3 columns."""
    out = []
    with _open(path) as f:
        reader = csv.reader(f, delimiter="\t")
        for row in reader:
            if len(row) < 3 or row[-1] not in ("0", "1"):
                continue
            out.append((row[-3], row[-2], int(row[-1])))
    return out


def load_parallel(path: str, max_pairs: Optional[int] = None) -> List[Tuple[str, str]]:
    """Parallel corpus tsv(.gz): source \\t target per line."""
    out = []
    with _open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and parts[0] and parts[1]:
                out.append((parts[0], parts[1]))
                if max_pairs and len(out) >= max_pairs:
                    break
    return out


def load_sentence_pool(path: str, max_sentences: Optional[int] = None) -> List[str]:
    """One sentence per line (distillation pools)."""
    out = []
    with _open(path) as f:
        for line in f:
            t = line.strip()
            if t:
                out.append(t)
                if max_sentences and len(out) >= max_sentences:
                    break
    return out


def load_wic(data_path: str, gold_path: Optional[str] = None) -> List[Dict]:
    """WiC: word \\t pos \\t idx1-idx2 \\t sent1 \\t sent2 (+ gold T/F)."""
    rows = []
    with _open(data_path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5:
                continue
            w, pos, idxs, s1, s2 = parts[:5]
            i1, i2 = (int(x) for x in idxs.split("-"))
            rows.append(
                {"word": w, "pos": pos, "idx1": i1, "idx2": i2,
                 "sent1": s1, "sent2": s2, "label": None}
            )
    if gold_path:
        with _open(gold_path) as f:
            gold = [l.strip() for l in f if l.strip()]
        if len(gold) != len(rows):
            # silent zip truncation would leave label=None tails that the
            # batch builder maps to 0 — corrupted training data, no error
            raise ValueError(
                f"gold file has {len(gold)} labels for {len(rows)} rows"
            )
        for row, g in zip(rows, gold):
            row["label"] = 1 if g == "T" else 0
    return rows


def load_conll_ner(path: str) -> List[Dict]:
    """CoNLL: token <sp/tab> ... tag, blank-line separated sentences."""
    sents, toks, tags = [], [], []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("-DOCSTART-"):
                if toks:
                    sents.append({"tokens": toks, "tags": tags})
                    toks, tags = [], []
                continue
            parts = line.split()
            toks.append(parts[0])
            tags.append(parts[-1])
    if toks:
        sents.append({"tokens": toks, "tags": tags})
    return sents


def split_paragraphs(
    text: str, max_words: int = 64, by: str = "\n"
) -> List[str]:
    """Document → ≤max_words paragraphs (documents_dataset.py:113-136)."""
    out = []
    for block in text.split(by):
        words = block.split()
        if not words:
            continue
        for i in range(0, len(words), max_words):
            out.append(" ".join(words[i : i + max_words]))
    return out


def load_documents_json(
    path: str,
    text_key: str = "text",
    label_key: str = "label",
    max_paragraph_words: int = 0,
) -> List[Dict]:
    """JSON/JSONL document collections with labels (Japanese news corpus
    analogue). Optional paragraph splitting."""
    docs = []
    with _open(path) as f:
        first = f.read(1)
        f.seek(0)
        records = (
            json.load(f) if first == "[" else (json.loads(l) for l in f if l.strip())
        )
        for rec in records:
            text = rec[text_key]
            label = rec.get(label_key)
            if max_paragraph_words:
                for p in split_paragraphs(text, max_paragraph_words):
                    docs.append({"text": p, "label": label})
            else:
                docs.append({"text": text, "label": label})
    return docs


# ---------------------------------------------------------------------------
# Splits (reference dataset.py:28-107 — stratified split + k-fold)
# ---------------------------------------------------------------------------

def stratified_split(
    examples: Sequence, labels: Sequence, test_ratio: float = 0.2, seed: int = 0
) -> Tuple[list, list]:
    rng = random.Random(seed)
    by_label: Dict = collections.defaultdict(list)
    for ex, lab in zip(examples, labels):
        by_label[lab].append(ex)
    train, test = [], []
    for lab, items in by_label.items():
        rng.shuffle(items)
        n_test = max(int(len(items) * test_ratio), 1) if len(items) > 1 else 0
        test.extend(items[:n_test])
        train.extend(items[n_test:])
    rng.shuffle(train)
    rng.shuffle(test)
    return train, test


def stratified_kfold(
    examples: Sequence, labels: Sequence, k: int = 5, seed: int = 0
):
    """Yield (train, valid) k times, label-stratified."""
    rng = random.Random(seed)
    by_label: Dict = collections.defaultdict(list)
    for ex, lab in zip(examples, labels):
        by_label[lab].append(ex)
    folds = [[] for _ in range(k)]
    for lab, items in by_label.items():
        rng.shuffle(items)
        for i, ex in enumerate(items):
            folds[i % k].append(ex)
    for i in range(k):
        valid = folds[i]
        train = [ex for j in range(k) if j != i for ex in folds[j]]
        rng.shuffle(train)
        yield train, valid


def load_gwsc(path: str) -> List[Dict]:
    """Graded word similarity in context (GWSC / CoSimLex-style;
    reference src/dataset/gwsc_dataset.py + experiments/eval_gwsc.py):
    tsv rows ``word <tab> idx1 <tab> idx2 <tab> context1 <tab> context2
    <tab> score``; also accepts the 4-column variant where the word's
    position is found by string match."""
    rows = []
    with _open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 6:
                w, i1, i2, c1, c2, sc = parts[:6]
                try:
                    rows.append({
                        "word": w, "idx1": int(i1), "idx2": int(i2),
                        "sent1": c1, "sent2": c2, "score": float(sc),
                        "label": None,
                    })
                except ValueError:
                    continue
            elif len(parts) >= 4:
                w, c1, c2, sc = parts[:4]
                try:
                    score = float(sc)
                except ValueError:
                    continue
                def _pos(ctx):
                    toks = ctx.lower().split()
                    wl = w.lower()
                    for i, t in enumerate(toks):
                        if t.strip(".,!?;:'\"") == wl:
                            return i
                    return 0
                rows.append({
                    "word": w, "idx1": _pos(c1), "idx2": _pos(c2),
                    "sent1": c1, "sent2": c2, "score": score, "label": None,
                })
    return rows

"""Pair batches for bi-encoder training (port of
``text_similarity_tpu.data.pairs.build_pair_batches`` in bi mode).

Pairs are tokenized once, sorted by the longer side's length and grouped
into batches of a fixed batch size, each padded to the bucket of its
longest row (static shapes); the tail batch is padded with masked rows
(``valid`` 0). The arrays equal the JAX package's for the same tokenizer,
pairs and seed. The cross-encoder mode and the packed, sequence, distill
and word builders come with their train steps.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .batching import BUCKETS, pick_bucket


def _tok_rows(tokenizer, texts: Sequence[str], max_len: int) -> List[List[int]]:
    """[CLS] body [SEP] of each text, the body cut to max_len − 2."""
    return [
        [tokenizer.cls_id] + body[: max_len - 2] + [tokenizer.sep_id]
        for body in tokenizer.tokenize_many(list(texts))
    ]


def _cap_bucket(longest: int, buckets, max_len: int) -> int:
    """The bucket of ``longest``, clamped to max_len; past the last bucket,
    max_len itself."""
    width = pick_bucket(longest, buckets)
    if longest > width:   # the bucket list is exhausted: honour max_len
        width = max_len
    return min(width, max_len)


def _pad_rows(rows, batch_idx, bs: int, width: int, pad_id: int):
    ids = np.full((bs, width), pad_id, np.int32)
    mask = np.zeros((bs, width), np.int32)
    for j, r in enumerate(batch_idx):
        row = rows[r][:width]
        ids[j, : len(row)] = row
        mask[j, : len(row)] = 1
    return ids, mask


def build_pair_batches(
    tokenizer,
    pairs: Sequence,                  # [(a, b), ...]
    targets: Sequence,                # labels / scores, len == len(pairs)
    batch_size: int = 32,
    max_len: int = 128,
    mode: str = "bi",
    buckets=BUCKETS,
    shuffle: bool = True,
    seed: int = 0,
    target_dtype=np.float32,
) -> List[Dict[str, np.ndarray]]:
    """→ batches {ids_a, mask_a, ids_b, mask_b, target, valid} as numpy
    arrays, in an order shuffled with ``np.random.RandomState(seed)``."""
    if mode != "bi":
        raise NotImplementedError(f"mode={mode!r}: the port builds bi-encoder batches only")
    rng = np.random.RandomState(seed)
    targets = np.asarray(targets)
    rows_a = _tok_rows(tokenizer, [p[0] for p in pairs], max_len)
    rows_b = _tok_rows(tokenizer, [p[1] for p in pairs], max_len)
    lens = np.maximum([len(r) for r in rows_a], [len(r) for r in rows_b])
    order = np.argsort(lens, kind="stable")
    batches = []
    for s in range(0, len(order), batch_size):
        g = order[s : s + batch_size]
        width = _cap_bucket(int(lens[g].max()), buckets, max_len)
        ids_a, mask_a = _pad_rows(rows_a, g, batch_size, width, tokenizer.pad_id)
        ids_b, mask_b = _pad_rows(rows_b, g, batch_size, width, tokenizer.pad_id)
        tgt = np.zeros((batch_size,), target_dtype)
        valid = np.zeros((batch_size,), np.int32)
        tgt[: len(g)] = targets[g]
        valid[: len(g)] = 1
        batches.append({"ids_a": ids_a, "mask_a": mask_a, "ids_b": ids_b, "mask_b": mask_b,
                        "target": tgt, "valid": valid})
    if shuffle:
        rng.shuffle(batches)
    return batches

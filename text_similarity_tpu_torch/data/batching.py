"""Length-bucketed batching (copy of ``text_similarity_tpu.data.batching``).

Rows are sorted by length and grouped into batches of ``batch_size``; each
batch pads to the enclosing power-of-two bucket, so an encode sees a small
set of shapes.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

BUCKETS = (16, 32, 64, 128, 256, 512)


def pick_bucket(length: int, buckets: Sequence[int] = BUCKETS) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def pad_to_bucket(
    ids: np.ndarray, mask: np.ndarray, buckets: Sequence[int] = BUCKETS
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (B, L) arrays with zeros up to the enclosing bucket length."""
    length = ids.shape[1]
    tgt = pick_bucket(length, buckets)
    if tgt == length:
        return ids, mask
    pad = tgt - length
    return np.pad(ids, ((0, 0), (0, pad))), np.pad(mask, ((0, 0), (0, pad)))


class LengthBucketBatcher:
    """Groups pre-tokenized rows into fixed-shape batches: sorted by token
    length, ``batch_size`` rows per batch (tail batches padded with
    all-masked dummy rows), optionally shuffled at batch level."""

    def __init__(
        self,
        batch_size: int,
        buckets: Sequence[int] = BUCKETS,
        shuffle_batches: bool = True,
        seed: int = 0,
    ):
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.shuffle_batches = shuffle_batches
        self.rng = np.random.RandomState(seed)

    def batches(
        self,
        row_ids: List[List[int]],
        extras: Optional[List] = None,
        pad_id: int = 0,
    ) -> Iterator[dict]:
        """Yield dicts: ids (B,L), mask (B,L), valid (B,) bool, index (B,)
        original row index (−1 for padding rows), plus ``extra`` when
        per-row payloads are given."""
        order = np.argsort([len(r) for r in row_ids], kind="stable")
        groups = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.shuffle_batches:
            self.rng.shuffle(groups)
        for g in groups:
            rows = [row_ids[i] for i in g]
            L = pick_bucket(max(len(r) for r in rows), self.buckets)
            B = self.batch_size
            ids = np.full((B, L), pad_id, np.int32)
            mask = np.zeros((B, L), np.int32)
            index = np.full((B,), -1, np.int64)
            for j, (i_orig, r) in enumerate(zip(g, rows)):
                rl = r[:L]   # rows longer than the largest bucket truncate
                ids[j, : len(rl)] = rl
                mask[j, : len(rl)] = 1
                index[j] = i_orig
            batch = {
                "ids": ids,
                "mask": mask,
                "valid": index >= 0,
                "index": index,
            }
            if extras is not None:
                batch["extra"] = [extras[i] for i in g]
            yield batch

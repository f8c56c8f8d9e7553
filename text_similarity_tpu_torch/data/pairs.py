"""Batch builders for training (port of ``text_similarity_tpu.data.pairs``).

- ``build_pair_batches``: pairs tokenized once, sorted by length and
  grouped into batches of a fixed batch size, each padded to the bucket of
  its longest row; the tail batch is padded with masked rows (``valid``
  0). ``mode="bi"`` gives the two sides apart (bi-encoder), ``"cross"``
  one [CLS] a [SEP] b [SEP] row with token types (cross-encoder).
- ``build_packed_pair_batches`` / ``packed_pair_batches_from_rows``:
  several short rows a fixed-width row (first-fit decreasing, the C
  placement of ``data.packing``), one static shape set for the batches.
- ``build_sequence_batches``: documents and labels (classification).
- ``build_distill_batches``: student tokens with the teacher's embeddings
  as targets (both sides of a parallel corpus in the multilingual mode).
- ``build_word_batches``: WiC twin sentences with the target word's
  sub-token positions.

The arrays equal the JAX package's for the same tokenizer, input and seed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..native import ffd_place_native
from .batching import BUCKETS, pick_bucket
from .packing import pack_sequences
from .tokenization import _basic_tokenize


def _tok_rows(tokenizer, texts: Sequence[str], max_len: int) -> List[List[int]]:
    """[CLS] body [SEP] of each text, the body cut to max_len − 2 (a
    ``tokenizer.json`` adapter: its own padded batch, the padding
    stripped)."""
    if hasattr(tokenizer, "tokenize_many"):
        return [
            [tokenizer.cls_id] + body[: max_len - 2] + [tokenizer.sep_id]
            for body in tokenizer.tokenize_many(list(texts))
        ]
    ids, mask = tokenizer.encode_batch(list(texts), max_len)
    return [[int(t) for t in ids[i, : int(mask[i].sum())]] for i in range(len(texts))]


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
    """→ batches as numpy arrays, in an order shuffled with
    ``np.random.RandomState(seed)``: {ids_a, mask_a, ids_b, mask_b, target,
    valid} in bi mode, {ids, mask, type_ids, labels, valid} in cross
    mode."""
    rng = np.random.RandomState(seed)
    targets = np.asarray(targets)
    if mode == "cross":
        batches = _cross_batches(tokenizer, pairs, targets, batch_size, max_len, buckets,
                                 target_dtype)
        if shuffle:
            rng.shuffle(batches)
        return batches
    if mode != "bi":
        raise ValueError(f"mode must be 'bi' or 'cross', not {mode!r}")
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


def _cross_batches(tokenizer, pairs, targets, batch_size, max_len, buckets, target_dtype):
    """Joint [CLS] a [SEP] b [SEP] rows with token types, sorted by length,
    each batch padded to its bucket."""
    ids_all, mask_all, tts_all = tokenizer.encode_pair_batch(
        [p[0] for p in pairs], [p[1] for p in pairs], max_len=max_len, pad_to=max_len,
    )
    lens = mask_all.sum(1)
    order = np.argsort(lens, kind="stable")
    batches = []
    for s in range(0, len(order), batch_size):
        g = order[s : s + batch_size]
        width = _cap_bucket(int(lens[g].max()), buckets, max_len)
        ids = np.full((batch_size, width), tokenizer.pad_id, np.int32)
        mask = np.zeros((batch_size, width), np.int32)
        tts = np.zeros((batch_size, width), np.int32)
        tgt = np.zeros((batch_size,), target_dtype)
        valid = np.zeros((batch_size,), np.int32)
        ids[: len(g)] = ids_all[g, :width]
        mask[: len(g)] = mask_all[g, :width]
        tts[: len(g)] = tts_all[g, :width]
        tgt[: len(g)] = targets[g]
        valid[: len(g)] = 1
        batches.append({"ids": ids, "mask": mask, "type_ids": tts, "labels": tgt,
                        "valid": valid})
    return batches


def _pack_group(rows, group, width, pad_id, types=None):
    return pack_sequences(
        [rows[i] for i in group], width, pad_id=pad_id,
        row_types=[types[i] for i in group] if types is not None else None,
    )


def _n_rows(lens: np.ndarray, width: int) -> int:
    """The rows ``pack_sequences`` fills with sequences of these lengths
    (each ≤ width): its longest-first order and first-fit placement (the C
    placement, which places every sequence as the Python one does)."""
    return ffd_place_native(np.sort(lens)[::-1], width)[0]


def _packing_prefix(g, la, lb, rows_per_side: int, width: int, cross: bool) -> int:
    """The longest prefix of group ``g`` whose sides each pack into
    ``rows_per_side`` rows: the reference drops the group's last member
    and repacks until both sides fit, which is this prefix (scanned from
    the whole group down, the row count by placement alone; a prefix
    whose tokens exceed the rows' capacity is skipped unplaced)."""
    a, b = la[g], lb[g]
    cap = rows_per_side * width
    ca, cb = np.cumsum(a), np.cumsum(b)
    m = len(g)
    while m > 1:
        if (ca[m - 1] <= cap and (cross or cb[m - 1] <= cap)
                and _n_rows(a[:m], width) <= rows_per_side
                and (cross or _n_rows(b[:m], width) <= rows_per_side)):
            break
        m -= 1
    return m


def _pad_packed(pk, rows_per_side, max_segments, with_types=False):
    """One ``pack_sequences`` layout padded to the batch set's shapes: R
    rows (padding rows all zero) and M owner slots (−1)."""
    r = pk["ids"].shape[0]
    keys = ("ids", "segments", "positions") + (("type_ids",) if with_types else ())
    out = {k: np.pad(pk[k], ((0, rows_per_side - r), (0, 0))) for k in keys}
    ow = pk["owners"]
    out["owners"] = np.pad(ow, ((0, rows_per_side - r), (0, max_segments - ow.shape[1])),
                           constant_values=-1)
    return out


def build_packed_pair_batches(
    tokenizer,
    pairs: Sequence,
    targets: Sequence,
    rows_per_side: int = 32,
    width: int = 128,
    mode: str = "bi",                 # "bi" (twin towers) | "cross" (joint)
    shuffle: bool = True,
    seed: int = 0,
    target_dtype=np.float32,
) -> List[Dict[str, np.ndarray]]:
    """Packed pair batches: several short rows a ``width``-token row behind
    a block-diagonal mask, so the work tracks real tokens. Every batch has
    the same shapes:

      mode="bi":    ids_a / segments_a / positions_a (R, W), owners_a (R,
                    M), the same for b, target (P,), valid (P,)
      mode="cross": ids / segments / positions / type_ids (R, W), owners
                    (R, M), labels (P,), valid (P,)

    R = rows_per_side, W = width; M (segment slots, a power of two) and P
    (pair slots, a multiple of 8) are the largest the set needs. For
    ``train.steps.make_packed_{bi_encoder,classifier}_train_step``."""
    if not len(pairs):
        return []
    cross = mode == "cross"
    types = None
    if cross:
        ids_all, mask_all, tts_all = tokenizer.encode_pair_batch(
            [p[0] for p in pairs], [p[1] for p in pairs], max_len=width
        )
        lens = mask_all.sum(axis=1)
        rows_a = [list(ids_all[i, : lens[i]]) for i in range(len(pairs))]
        types = [list(tts_all[i, : lens[i]]) for i in range(len(pairs))]
        rows_b = rows_a
    else:
        rows_a = _tok_rows(tokenizer, [p[0] for p in pairs], width)
        rows_b = _tok_rows(tokenizer, [p[1] for p in pairs], width)
    return packed_pair_batches_from_rows(
        rows_a, rows_b, targets, rows_per_side=rows_per_side, width=width,
        pad_id=tokenizer.pad_id, types=types, cross=cross, shuffle=shuffle, seed=seed,
        target_dtype=target_dtype,
    )


def packed_pair_batches_from_rows(
    rows_a: Sequence[Sequence[int]],
    rows_b: Sequence[Sequence[int]],
    targets: Sequence,
    rows_per_side: int = 32,
    width: int = 128,
    pad_id: int = 0,
    types: Optional[Sequence[Sequence[int]]] = None,
    cross: bool = False,
    shuffle: bool = True,
    seed: int = 0,
    target_dtype=np.float32,
) -> List[Dict[str, np.ndarray]]:
    """``build_packed_pair_batches`` from token rows. ``cross=True`` reads
    rows_a as joint [CLS] a [SEP] b [SEP] rows (rows_b unused).

    Pairs are grouped longest first under a budget of 98% of R × W tokens a
    side; a group whose side does not pack into R rows passes its shortest
    members on to the next group, the fewest that let it fit."""
    if not len(rows_a):
        return []
    targets = np.asarray(targets)
    rng = np.random.RandomState(seed)
    rows_a = [list(r[:width]) for r in rows_a]
    rows_b = rows_a if cross else [list(r[:width]) for r in rows_b]
    if types is not None:
        types = [list(t[:width]) for t in types]
    la = np.asarray([len(r) for r in rows_a], np.int64)
    lb = np.asarray([len(r) for r in rows_b], np.int64)
    cost = la if cross else np.maximum(la, lb)

    order = list(np.argsort(-cost, kind="stable"))
    cap = int(rows_per_side * width * 0.98)
    groups: List[List[int]] = []
    cur: List[int] = []
    sa = sb = 0
    for i in order:
        a_len = len(rows_a[i])
        b_len = a_len if cross else len(rows_b[i])
        if cur and (sa + a_len > cap or sb + b_len > cap):
            groups.append(cur)
            cur, sa, sb = [], 0, 0
        cur.append(int(i))
        sa += a_len
        sb += b_len
    if cur:
        groups.append(cur)

    packed_groups = []
    spill: List[int] = []
    gi = 0
    while gi < len(groups) or spill:
        g = (spill + groups[gi]) if gi < len(groups) else spill
        gi += 1
        m = _packing_prefix(np.asarray(g), la, lb, rows_per_side, width, cross)
        g, spill = g[:m], g[m:]   # the shortest members move on, in order
        pa = _pack_group(rows_a, g, width, pad_id, types)
        pb = pa if cross else _pack_group(rows_b, g, width, pad_id)
        packed_groups.append((g, pa, pb))

    m = max(max(pa["owners"].shape[1], pb["owners"].shape[1]) for _, pa, pb in packed_groups)
    if m > 1:
        m = 1 << (m - 1).bit_length()
    p_cap = max(len(g) for g, _, _ in packed_groups)
    p_cap = -(-p_cap // 8) * 8

    batches = []
    for g, pa, pb in packed_groups:
        tgt = np.zeros((p_cap,) + targets.shape[1:], target_dtype)
        valid = np.zeros((p_cap,), np.int32)
        tgt[: len(g)] = targets[g]
        valid[: len(g)] = 1
        if cross:
            side = _pad_packed(pa, rows_per_side, m, with_types=True)
            batches.append({"ids": side["ids"], "segments": side["segments"],
                            "positions": side["positions"], "type_ids": side["type_ids"],
                            "owners": side["owners"], "labels": tgt, "valid": valid})
        else:
            a = _pad_packed(pa, rows_per_side, m)
            b = _pad_packed(pb, rows_per_side, m)
            batches.append({"ids_a": a["ids"], "segments_a": a["segments"],
                            "positions_a": a["positions"], "owners_a": a["owners"],
                            "ids_b": b["ids"], "segments_b": b["segments"],
                            "positions_b": b["positions"], "owners_b": b["owners"],
                            "target": tgt, "valid": valid})
    if shuffle:
        rng.shuffle(batches)
    return batches


def build_sequence_batches(
    tokenizer,
    texts: Sequence[str],
    labels: Sequence[int],
    batch_size: int = 32,
    max_len: int = 256,
    buckets=BUCKETS,
    shuffle: bool = True,
    seed: int = 0,
) -> List[Dict[str, np.ndarray]]:
    """Document-classification batches {ids, mask, type_ids (zeros),
    labels, valid}, length-sorted and bucketed as the pair batches."""
    rng = np.random.RandomState(seed)
    rows = _tok_rows(tokenizer, texts, max_len)
    labels = np.asarray(labels)
    lens = np.asarray([len(r) for r in rows])
    order = np.argsort(lens, kind="stable")
    batches = []
    for s in range(0, len(order), batch_size):
        g = order[s : s + batch_size]
        width = _cap_bucket(int(lens[g].max()), buckets, max_len)
        ids, mask = _pad_rows(rows, g, batch_size, width, tokenizer.pad_id)
        lab = np.zeros((batch_size,), np.int32)
        valid = np.zeros((batch_size,), np.int32)
        lab[: len(g)] = labels[g]
        valid[: len(g)] = 1
        batches.append({"ids": ids, "mask": mask, "type_ids": np.zeros_like(ids),
                        "labels": lab, "valid": valid})
    if shuffle:
        rng.shuffle(batches)
    return batches


def build_distill_batches(
    student_tokenizer,
    sentences: Sequence[str],
    teacher_embeddings: np.ndarray,     # (N, D) the teacher's targets
    batch_size: int = 32,
    max_len: int = 128,
    buckets=BUCKETS,
    shuffle: bool = True,
    seed: int = 0,
    src_sentences: Optional[Sequence[str]] = None,
) -> List[Dict[str, np.ndarray]]:
    """Distillation batches {ids_a, mask_a, ids_b, mask_b (a copy of the a
    side), target (B, D), valid}, length-sorted and bucketed as the pair
    batches. With ``src_sentences`` (the teacher's side of a parallel
    corpus, aligned 1:1 with ``sentences``) the student trains on both
    sides against the same teacher embedding (student(src) ≈ student(tgt)
    ≈ teacher(src))."""
    if src_sentences is not None:
        if len(src_sentences) != len(sentences):
            raise ValueError(f"src/tgt length mismatch: {len(src_sentences)} vs "
                             f"{len(sentences)} (parallel corpora must align 1:1)")
        sentences = list(src_sentences) + list(sentences)
        teacher_embeddings = np.concatenate([teacher_embeddings, teacher_embeddings])
    rng = np.random.RandomState(seed)
    rows = _tok_rows(student_tokenizer, sentences, max_len)
    lens = np.asarray([len(r) for r in rows])
    order = np.argsort(lens, kind="stable")
    d = teacher_embeddings.shape[1]
    batches = []
    for s in range(0, len(order), batch_size):
        g = order[s : s + batch_size]
        width = _cap_bucket(int(lens[g].max()), buckets, max_len)
        ids, mask = _pad_rows(rows, g, batch_size, width, student_tokenizer.pad_id)
        tgt = np.zeros((batch_size, d), np.float32)
        valid = np.zeros((batch_size,), np.int32)
        tgt[: len(g)] = teacher_embeddings[g]
        valid[: len(g)] = 1
        batches.append({"ids_a": ids, "mask_a": mask, "ids_b": ids, "mask_b": mask,
                        "target": tgt, "valid": valid})
    if shuffle:
        rng.shuffle(batches)
    return batches


def _row_with_span(tokenizer, sent: str, word_idx: int, max_len: int, max_span: int):
    """[CLS] ids [SEP] of ``sent`` and the positions (−1 padded to
    ``max_span``) of the sub-tokens of its whitespace chunk ``word_idx``.
    Inside the chunk only the tokens with a letter or digit are marked
    (not the comma of "cat,"), all of them for a chunk of punctuation."""
    spans = tokenizer.token_spans(sent)
    lowercase = getattr(tokenizer, "lowercase", True)
    chunk_of = []
    for ci, chunk in enumerate(sent.split()):
        chunk_of.extend([ci] * len(_basic_tokenize(chunk, lowercase)))
    in_chunk = [wi for wi in range(len(spans))
                if wi < len(chunk_of) and chunk_of[wi] == word_idx]
    target = {wi for wi in in_chunk if any(ch.isalnum() for ch in spans[wi][0])}
    target = target or set(in_chunk)
    row = [tokenizer.cls_id]
    span_pos = [-1] * max_span
    n_marked = 0
    for wi, (w, positions) in enumerate(spans):
        if len(row) >= max_len - 1:
            break
        if wi in target:
            for p in range(len(row), len(row) + len(positions)):
                if n_marked < max_span and p < max_len - 1:
                    span_pos[n_marked] = p
                    n_marked += 1
        row.extend(tokenizer._wordpiece(w)[: max_len - 1 - len(row)])
    row.append(tokenizer.sep_id)
    return row, span_pos


def build_word_batches(
    tokenizer,
    examples: Sequence[Dict],           # data.datasets.load_wic rows
    batch_size: int = 32,
    max_len: int = 128,
    max_span: int = 8,
    shuffle: bool = True,
    seed: int = 0,
) -> List[Dict[str, np.ndarray]]:
    """WiC batches {ids_a, mask_a, span_a, ids_b, mask_b, span_b, target,
    valid, index}: the two sentences of each example with the target
    word's sub-token positions (``tokenizer.token_spans``), sorted by the
    longer side and bucketed; ``index`` is each row's example (−1 on
    padding)."""
    rng = np.random.RandomState(seed)
    rows_a, rows_b, spans_a, spans_b, labels = [], [], [], [], []
    for ex in examples:
        ra, sa = _row_with_span(tokenizer, ex["sent1"], ex["idx1"], max_len, max_span)
        rb, sb = _row_with_span(tokenizer, ex["sent2"], ex["idx2"], max_len, max_span)
        rows_a.append(ra)
        rows_b.append(rb)
        spans_a.append(sa)
        spans_b.append(sb)
        labels.append(ex["label"] if ex["label"] is not None else 0)
    lens = np.maximum([len(r) for r in rows_a], [len(r) for r in rows_b])
    order = np.argsort(lens, kind="stable")
    batches = []
    for s in range(0, len(order), batch_size):
        g = order[s : s + batch_size]
        width = _cap_bucket(int(lens[g].max()), BUCKETS, max_len)
        ids_a, mask_a = _pad_rows(rows_a, g, batch_size, width, tokenizer.pad_id)
        ids_b, mask_b = _pad_rows(rows_b, g, batch_size, width, tokenizer.pad_id)
        sa = np.full((batch_size, max_span), -1, np.int32)
        sb = np.full((batch_size, max_span), -1, np.int32)
        lab = np.zeros((batch_size,), np.int32)
        valid = np.zeros((batch_size,), np.int32)
        index = np.full((batch_size,), -1, np.int64)
        n = len(g)
        sa[:n] = np.asarray([spans_a[r] for r in g], np.int32).reshape(n, max_span)
        sb[:n] = np.asarray([spans_b[r] for r in g], np.int32).reshape(n, max_span)
        lab[:n] = np.asarray(labels)[g]
        valid[:n] = 1
        index[:n] = g
        batches.append({"ids_a": ids_a, "mask_a": mask_a, "span_a": sa,
                        "ids_b": ids_b, "mask_b": mask_b, "span_b": sb,
                        "target": lab, "valid": valid, "index": index})
    if shuffle:
        rng.shuffle(batches)
    return batches

"""CrossEncoder — pair scoring for reranking and pair classification (port
of ``text_similarity_tpu.models.cross_encoder``).

[CLS] a [SEP] b [SEP] pairs run through the encoder with token types; the
CLS state (through the tanh pooler where the arch has one) feeds a linear
head. One output is the score; two give the softmax probability of the
second class; more give the raw logits.

``predict`` scores pairs either in length-bucketed padded batches or packed
(several pairs to a row behind a block-diagonal mask, each pair read at its
own [CLS] by ``segment_first_pool``, then the pooler's tanh). ``"auto"``
packs by the reference's rule: more than 8 pairs, cls pooling, and bucketed
tokens ≥ ``PACK_AUTO_RATIO`` × the packed estimate. Attention runs the
reference path on every device (``impl="auto"`` never packs heads).

``_dispatch_packed_layout`` queues a layout's forwards without waiting for
the device (pinned host copies, scores left on the device) and
``_collect_packed`` drains them: ``pipelines.rerank`` tokenizes and packs
the next wave on the host while the card scores the last one.

``save`` / ``load`` use the JAX package's directory layout (``arch.json``,
``step_*/params.npz`` with ``{"encoder", "head"}``, ``meta.json`` with
``pooling`` and ``num_classes``, ``vocab.txt``), so a cross-encoder saved by
either package loads in the other.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..compress.quantize import dequantize_params, quantize_params_int8
from ..core import checkpoint as ckpt
from ..core.config import EncoderArch
from ..core.precision import DEFAULT_PRECISION, Precision, precision_for, resolve_device
from ..data.batching import BUCKETS, pick_bucket
from ..data.packing import pack_pair_arrays, pack_sequences
from ..data.tokenization import load_tokenizer
from ..train.steps import classifier_forward, init_classifier_head
from .encoder import cross_params_from_jax, dequant_weight, encoder_forward, init_params
from .pooling import segment_first_pool
from .sentence_encoder import _tree_to


def _strip_pair_rows(ids, mask, tts) -> Tuple[List[List[int]], List[List[int]]]:
    """Padded (N, L) pair arrays → per-pair token and type lists."""
    lens = mask.sum(axis=1)
    rows = [ids[i, : lens[i]].tolist() for i in range(ids.shape[0])]
    types = [tts[i, : lens[i]].tolist() for i in range(ids.shape[0])]
    return rows, types


class CrossEncoder:
    """Pair scorer over a ``{"encoder", "head"}`` parameter tree on one
    device."""

    # bucketed batches must cost at least this many times the packed
    # layout's tokens before "auto" packs (the reference's constant)
    PACK_AUTO_RATIO = 1.3

    def __init__(
        self,
        params: dict,               # {"encoder": ..., "head": ...}
        arch: EncoderArch,
        tokenizer=None,
        num_classes: int = 1,
        pooling: str = "cls",
        precision: Precision = DEFAULT_PRECISION,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.params = _tree_to(params, self.device)
        self.arch = arch
        self.tokenizer = tokenizer
        self.num_classes = num_classes
        self.pooling = pooling
        self.precision = precision

    @classmethod
    def init(
        cls, generator: torch.Generator, arch: EncoderArch, tokenizer=None,
        num_classes: int = 1, device="cuda", **kw,
    ) -> "CrossEncoder":
        """Random weights drawn from ``generator`` (a CPU generator): the
        encoder's, then the head's."""
        params = {
            "encoder": init_params(arch, generator),
            "head": init_classifier_head(generator, arch.hidden_size, num_classes, device="cpu"),
        }
        return cls(params, arch, tokenizer, num_classes, device=device, **kw)

    def _as_device(self, x) -> torch.Tensor:
        """A host int array → int32 on the device; on the card through
        pinned memory without waiting for the copy."""
        t = torch.from_numpy(np.ascontiguousarray(x, np.int32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _score_of_logits(self, logits: torch.Tensor) -> torch.Tensor:
        if logits.shape[-1] == 1:
            return logits[..., 0]
        if logits.shape[-1] == 2:
            # the probability of the positive class is the rank score
            return torch.softmax(logits, dim=-1)[..., 1]
        return logits

    def _out_shape(self, n: int) -> tuple:
        return (n,) if self.num_classes <= 2 else (n, self.num_classes)

    @torch.no_grad()
    def score_tokens(self, ids, mask, type_ids=None) -> np.ndarray:
        """Scores of a padded (B, L) pair batch → (B,) or (B, C) f32."""
        ids, mask = self._as_device(ids), self._as_device(mask)
        type_ids = torch.zeros_like(ids) if type_ids is None else self._as_device(type_ids)
        logits = classifier_forward(
            self.params, ids, mask, type_ids, arch=self.arch, precision=self.precision,
            pooling=self.pooling,
        )
        return self._score_of_logits(logits).float().cpu().numpy()

    @torch.no_grad()
    def _packed_scores(self, ids, segments, positions, type_ids, max_segments: int) -> torch.Tensor:
        """Scores of a packed (R, W) layout → (R, M) or (R, M, C) on the
        device, slot (r, m) for the row's m-th pair."""
        if self.pooling != "cls":
            raise ValueError("packed scoring supports cls pooling only")
        enc = self.params["encoder"]
        out = encoder_forward(
            enc, ids, (segments > 0).to(torch.int32), type_ids, arch=self.arch,
            precision=self.precision, segment_ids=segments, position_ids=positions,
        )
        pooled = segment_first_pool(out.last_hidden_state, segments, max_segments)
        if self.arch.has_pooler and "pooler" in enc:
            # the dense route's classifier_forward reads the pooler's tanh
            pw = enc["pooler"]
            pooled = torch.tanh(pooled.float() @ dequant_weight(pw["w"]).float() + pw["b"].float())
        head = self.params["head"]
        logits = pooled.float() @ dequant_weight(head["w"]).float() + head["b"].float()
        return self._score_of_logits(logits)

    def _pack_bodies(self, a, b, width: int, max_len: int):
        """Both sides through ``encode_bodies``, packed into rows of
        ``width`` → the layout."""
        tok = self.tokenizer
        ba, la = tok.encode_bodies(a, max_len - 3)
        bb, lb = tok.encode_bodies(b, max_len - 3)
        return pack_pair_arrays(
            ba, la, bb, lb, width, cls_id=tok.cls_id, sep_id=tok.sep_id, pad_id=tok.pad_id,
            max_len=max_len,
        )

    def predict_packed(
        self,
        pairs: Sequence,
        width: int = 256,
        rows_per_batch: int = 512,
        max_len: int = 256,
        max_segments: int = 0,   # 0: the layout's own slot count
    ) -> np.ndarray:
        """Score pairs through greedy packing → as ``predict`` (score i for
        pairs[i])."""
        if self.tokenizer is None:
            raise ValueError("cross encoder has no tokenizer")
        a = [p[0] for p in pairs]
        b = [p[1] for p in pairs]
        ml = min(max_len, width)
        if hasattr(self.tokenizer, "encode_bodies"):
            layout = self._pack_bodies(a, b, width, ml)
            return self._predict_packed_layout(layout, len(pairs), rows_per_batch, max_segments)
        ids, mask, tts = self.tokenizer.encode_pair_batch(a, b, max_len=ml)
        rows, types = _strip_pair_rows(ids, mask, tts)
        return self._predict_packed_rows(rows, types, len(pairs), width, rows_per_batch,
                                         max_segments)

    def _predict_packed_rows(
        self, rows, types, n_pairs: int, width: int, rows_per_batch: int = 512,
        max_segments: int = 0,
    ) -> np.ndarray:
        layout = pack_sequences(rows, width, pad_id=self.tokenizer.pad_id, row_types=types)
        return self._predict_packed_layout(layout, n_pairs, rows_per_batch, max_segments)

    def _dispatch_packed_layout(self, packed, rows_per_batch: int = 512, max_segments: int = 0):
        """Queue the forwards of a packed layout, ``rows_per_batch`` rows
        each, without waiting for the device → [(owners (rows, M), scores
        on the device)], drained by ``_collect_packed``."""
        m = max_segments or int(packed["owners"].shape[1])
        if packed["owners"].shape[1] > m:
            raise ValueError(
                f"layout needs {packed['owners'].shape[1]} segment slots, max_segments={m}"
            )
        pending = []
        for st in range(0, packed["ids"].shape[0], rows_per_batch):
            chunk = {key: self._as_device(packed[key][st:st + rows_per_batch])
                     for key in ("ids", "segments", "positions", "type_ids")}
            ow = packed["owners"][st:st + rows_per_batch]
            ow = np.pad(ow, ((0, 0), (0, m - ow.shape[1])), constant_values=-1)
            scores = self._packed_scores(chunk["ids"], chunk["segments"], chunk["positions"],
                                         chunk["type_ids"], m)
            pending.append((ow, scores))
        return pending

    @staticmethod
    def _collect_packed(pending, out: np.ndarray, base: int = 0) -> None:
        """Drain queued packed scores into ``out`` in pair order; ``base``
        offsets the owner indices (a wave's first pair)."""
        for ow, scores in pending:
            sh = scores.float().cpu().numpy()
            sel = ow >= 0
            out[base + ow[sel]] = sh[sel]

    def _predict_packed_layout(
        self, packed, n_pairs: int, rows_per_batch: int = 512, max_segments: int = 0,
    ) -> np.ndarray:
        out = np.zeros(self._out_shape(n_pairs), np.float32)
        self._collect_packed(self._dispatch_packed_layout(packed, rows_per_batch, max_segments),
                             out)
        return out

    def predict(
        self,
        pairs: Sequence,            # (text_a, text_b) pairs
        batch_size: int = 64,
        max_len: int = 256,
        packed="auto",
    ) -> np.ndarray:
        """Score text pairs → (N,) scores (or (N, C) logits). ``packed``:
        True packs into rows of the widest pair's bucket; False runs
        in-order batches of ``batch_size``, each padded to its bucket;
        "auto" packs more than 8 pairs under cls pooling when the bucketed
        tokens reach ``PACK_AUTO_RATIO`` × the packed estimate; a Performer
        model, whose linear attention has no block-diagonal form, never
        packs under "auto"."""
        if self.tokenizer is None:
            raise ValueError("cross encoder has no tokenizer")
        a = [p[0] for p in pairs]
        b = [p[1] for p in pairs]
        auto = (packed == "auto" and self.pooling == "cls" and len(pairs) > 8
                and self.arch.attention_type != "performer")
        if packed is True or auto:
            fast = hasattr(self.tokenizer, "encode_bodies")
            if fast:
                # a pair's packed length is min(la + lb, budget) + 3 after
                # the longest-first truncation
                ba, la = self.tokenizer.encode_bodies(a, max_len - 3)
                bb, lb = self.tokenizer.encode_bodies(b, max_len - 3)
                lens = np.minimum(la + lb, max_len - 3) + 3
            else:
                ids, mask, tts = self.tokenizer.encode_pair_batch(a, b, max_len=max_len)
                lens = mask.sum(axis=1)
            width = pick_bucket(int(lens.max()), BUCKETS)
            # the bucketed cost of the loop below: each in-order chunk of
            # batch_size rows pads to its longest row's bucket
            bucket_tokens = 0
            for st in range(0, len(pairs), batch_size):
                bucket_tokens += batch_size * pick_bucket(int(lens[st:st + batch_size].max()),
                                                          BUCKETS)
            est_rows = -(-int(lens.sum()) // int(width * 0.98))
            if packed is True or bucket_tokens >= self.PACK_AUTO_RATIO * est_rows * width:
                if fast:
                    layout = pack_pair_arrays(
                        ba, la, bb, lb, width, cls_id=self.tokenizer.cls_id,
                        sep_id=self.tokenizer.sep_id, pad_id=self.tokenizer.pad_id,
                        max_len=min(max_len, width),
                    )
                    return self._predict_packed_layout(layout, len(pairs))
                rows, types = _strip_pair_rows(ids, mask, tts)
                return self._predict_packed_rows(rows, types, len(pairs), width)
        out = np.zeros(self._out_shape(len(pairs)), np.float32)
        for start in range(0, len(pairs), batch_size):
            stop = min(start + batch_size, len(pairs))
            ids, mask, tts = self.tokenizer.encode_pair_batch(
                a[start:stop], b[start:stop], max_len=max_len
            )
            # columns padded to the bucket; rows past the largest bucket
            # truncate. The tail batch runs its real rows only: rows are
            # independent, so this changes no score
            L = pick_bucket(ids.shape[1], BUCKETS)
            w = min(ids.shape[1], L)
            pad = ((0, 0), (0, L - w))
            out[start:stop] = self.score_tokens(
                np.pad(ids[:, :w], pad), np.pad(mask[:, :w], pad), np.pad(tts[:, :w], pad)
            )
        return out

    def to_int8(self) -> "CrossEncoder":
        """Quantize the weights to int8 for serving: the encoder's dense
        layers run int8 products; the pooler and the head dequantize their
        kernels."""
        self.params = quantize_params_int8(self.params)
        return self

    # ------------------------------------------------------------------
    # Persistence (the JAX package's layout)
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        ckpt.save_checkpoint(
            path, self.params, step=0,
            meta={"pooling": self.pooling, "num_classes": self.num_classes},
        )
        with open(os.path.join(path, "arch.json"), "w") as f:
            f.write(self.arch.to_json())
        if self.tokenizer is not None and hasattr(self.tokenizer, "save_vocab"):
            self.tokenizer.save_vocab(os.path.join(path, "vocab.txt"))

    @classmethod
    def load(cls, path: str, bf16: bool = True, device="cuda") -> "CrossEncoder":
        """Load a directory written by either package. The class count is
        ``meta.json``'s ``num_classes``, else the head's width; a checkpoint
        in the int8 deployment format dequantizes to bf16 (``bf16=True``)
        or f32 weights."""
        with open(os.path.join(path, "arch.json")) as f:
            arch = EncoderArch.from_json(f.read())
        cdir = ckpt.latest_checkpoint(path)
        if cdir is None:
            raise FileNotFoundError(f"no step_* checkpoint under {path!r}")
        tree, _, meta = ckpt.restore_checkpoint_raw(cdir)
        num_classes = int(meta.get("num_classes", np.asarray(tree["head"]["b"]).shape[0]))
        params = cross_params_from_jax(tree, arch, num_classes)
        if meta.get("format") == "int8" or meta.get("int8"):
            params = dequantize_params(params, torch.bfloat16 if bf16 else torch.float32)
        try:
            tok = load_tokenizer(path)
        except FileNotFoundError:
            tok = None
        return cls(
            params, arch, tok, num_classes=num_classes, pooling=meta.get("pooling", "cls"),
            precision=precision_for(bf16), device=device,
        )

"""SentenceEncoder — the user-facing embedding model (port of
``text_similarity_tpu.models.sentence_encoder``).

tokenize → length-bucketed batches → encoder → pooling → optional
projection → f32 L2 normalisation. ``save``/``load`` use the JAX package's
directory layout (``arch.json`` + ``step_*/params.npz`` + ``vocab.txt``),
so an encoder saved by either package loads in the other.

``to_int8`` quantizes the weights for int8 serving (dense layers then run
per-token activation quant and int8×int8→int32 products); a checkpoint
saved in the int8 deployment format (``format: int8``) loads dequantized,
as in the reference.

Long documents: an encoder converted for long context (positions tiled by
``models.hf_convert.extend_positions``, ``attention_window`` and
``window_global_cls`` set, as a JAX-saved long encoder's ``arch.json``
holds) encodes with ``encode(texts, max_len=4096, buckets=BUCKETS + (1024,
2048, 4096), batch_size=8)``; on the card every 4096-token batch runs the
flash kernel K5 in each layer (``encoder_forward``'s ``"auto"`` rule).

Training: ``enc.params = state.params["encoder"]`` takes the trained
weights back (as the JAX CLI does after ``Trainer.execute``) and ``save``
writes them in the shared layout.

Not ported yet: packed variable-length encode (``packed=True``; ``"auto"``
runs bucketed, which gives the same vectors), ``encode_long`` (the
context-parallel encode over a device mesh).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..compress.quantize import dequantize_params, quantize_params_int8
from ..core import checkpoint as ckpt
from ..core.config import EncoderArch
from ..core.precision import DEFAULT_PRECISION, Precision, precision_for, resolve_device
from ..data.batching import BUCKETS, LengthBucketBatcher
from ..data.tokenization import load_tokenizer
from .encoder import (
    Encoder, _cast_tree, dequant_weight, encoder_forward, params_from_jax,
)
from .pooling import pool


class SentenceEncoder(nn.Module):
    """Bi-encoder sentence embedding model (SBERT-class)."""

    def __init__(
        self,
        params: dict,
        arch: EncoderArch,
        tokenizer=None,
        pooling: str = "mean",
        precision: Precision = DEFAULT_PRECISION,
        device="cuda",
    ):
        super().__init__()
        self.device = resolve_device(device)
        params = _tree_to(params, self.device)
        self.encoder = Encoder(arch, params, precision)
        self.arch = arch
        self.tokenizer = tokenizer
        self.pooling = pooling
        self.precision = precision

    @property
    def params(self) -> dict:
        return self.encoder.tree()

    @params.setter
    def params(self, tree: dict) -> None:
        """Take another parameter tree, e.g. a trained one
        (``state.params["encoder"]``): copies of its leaves on the encoder's
        device become the frozen weights, so later in-place optimizer steps
        on the trained tree leave the encoder as it was."""
        self._set_params(_tree_to(tree, self.device, copy=True))

    @property
    def embedding_dim(self) -> int:
        return self.arch.embedding_size

    @torch.no_grad()
    def embed_tokens(self, ids, mask) -> torch.Tensor:
        """Embed a pre-tokenized (B, L) batch → (B, D) normalized f32 on
        the encoder's device."""
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.int32).to(self.device)
        mask = torch.as_tensor(np.asarray(mask), dtype=torch.int32).to(self.device)
        params = self.params
        out = encoder_forward(
            params, ids, mask, arch=self.arch, precision=self.precision
        )
        emb = pool(self.pooling, out.last_hidden_state, mask)
        if "projection" in params:
            pw = params["projection"]
            emb = emb.float() @ dequant_weight(pw["w"]).float() + pw["b"]
        emb = emb.float()
        norm = torch.sqrt((emb * emb).sum(dim=-1, keepdim=True))
        return emb / norm.clamp_min(1e-12)

    def forward(self, ids, mask) -> torch.Tensor:
        return self.embed_tokens(ids, mask)

    def _tokenize_rows(self, texts: Sequence[str], max_len: int):
        """texts → token-id rows ([CLS] body [SEP], ≤ max_len)."""
        if self.tokenizer is None:
            raise ValueError("encoder has no tokenizer; use embed_tokens")
        body = self.tokenizer.tokenize_many(texts)
        return [
            [self.tokenizer.cls_id] + r[: max_len - 2] + [self.tokenizer.sep_id]
            for r in body
        ]

    def encode(
        self,
        texts: Sequence[str],
        batch_size: int = 128,
        max_len: int = 256,
        buckets: Sequence[int] = BUCKETS,
        device_output: bool = False,
        packed="auto",
    ):
        """Encode texts → (N, D) f32 normalized embeddings, in input order:
        a numpy array, or a tensor on the encoder's device with
        ``device_output=True``. Batches are length-sorted and padded to a
        bucket. ``packed="auto"`` runs bucketed (the packed layout gives
        the same vectors); ``packed=True`` is not ported yet."""
        if packed is True:
            raise NotImplementedError(
                "packed encode is not ported yet (ROADMAP queue 1: packed "
                "var-length encode); use packed=False or 'auto'"
            )
        n = len(texts)
        out = torch.zeros((n, self.embedding_dim), dtype=torch.float32, device=self.device)
        if n:
            row_ids = self._tokenize_rows(texts, max_len)
            batcher = LengthBucketBatcher(
                batch_size, buckets=buckets, shuffle_batches=False
            )
            for batch in batcher.batches(row_ids, pad_id=self.tokenizer.pad_id):
                sel = batch["valid"]
                # padding rows of the tail batch are dropped before the
                # forward: rows are independent, so this changes no vector
                emb = self.embed_tokens(batch["ids"][sel], batch["mask"][sel])
                idx = torch.as_tensor(batch["index"][sel]).to(self.device)
                out[idx] = emb
        return out if device_output else out.cpu().numpy()

    def _set_params(self, params: dict) -> "SentenceEncoder":
        self.encoder = Encoder(self.arch, params, self.precision)
        return self

    def to_int8(self) -> "SentenceEncoder":
        """Quantize the weights to int8 for serving (inference only):
        kernels and embedding tables become per-channel int8 with f32
        scales; dense layers then quantize their input per token."""
        return self._set_params(quantize_params_int8(self.params))

    def to_bf16(self) -> "SentenceEncoder":
        """Store the floating weights in bf16 (LayerNorm math stays f32 in
        the forward)."""
        return self._set_params(_cast_tree(self.params, torch.bfloat16))

    # ------------------------------------------------------------------
    # Persistence (the JAX package's layout)
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        ckpt.save_checkpoint(path, self.params, step=0, meta={"pooling": self.pooling})
        with open(os.path.join(path, "arch.json"), "w") as f:
            f.write(self.arch.to_json())
        if self.tokenizer is not None and hasattr(self.tokenizer, "save_vocab"):
            self.tokenizer.save_vocab(os.path.join(path, "vocab.txt"))

    @classmethod
    def load(cls, path: str, bf16: bool = True, device="cuda") -> "SentenceEncoder":
        """Load a directory written by either package. A checkpoint in the
        int8 deployment format dequantizes to bf16 (``bf16=True``) or f32
        weights, as the reference does; a tree saved after ``to_int8``
        keeps its int8 leaves."""
        with open(os.path.join(path, "arch.json")) as f:
            arch = EncoderArch.from_json(f.read())
        cdir = ckpt.latest_checkpoint(path)
        if cdir is None:
            raise FileNotFoundError(f"no step_* checkpoint under {path!r}")
        tree, _, meta = ckpt.restore_checkpoint_raw(cdir)
        params = params_from_jax(tree, arch)
        if meta.get("format") == "int8" or meta.get("int8"):
            params = dequantize_params(params, torch.bfloat16 if bf16 else torch.float32)
        try:
            tok = load_tokenizer(path)
        except FileNotFoundError:
            tok = None
        return cls(
            params,
            arch,
            tokenizer=tok,
            pooling=meta.get("pooling", "mean"),
            precision=precision_for(bf16),
            device=device,
        )


def _tree_to(tree: dict, device: torch.device, copy: bool = False) -> dict:
    return {
        k: _tree_to(v, device, copy) if isinstance(v, dict) else v.detach().to(device, copy=copy)
        for k, v in tree.items()
    }

"""SentenceEncoder — the user-facing embedding model (port of
``text_similarity_tpu.models.sentence_encoder``).

tokenize → length-bucketed batches (or packed rows) → encoder → pooling →
optional projection → f32 L2 normalisation. ``save``/``load`` use the JAX package's
directory layout (``arch.json`` + ``step_*/params.npz`` + ``vocab.txt``, or
a ``tokenizer.json`` read through ``data.tokenization.HFTokenizerAdapter``),
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

Packed encode (``data.packing``): several short texts share one row of a
bucket's width behind a block-diagonal attention mask, with positions
restarting in each segment and a per-segment mean pool. ``encode`` takes
that route under the reference's ``packed="auto"`` rule (more than 8 texts,
mean pooling, bucketed tokens ≥ ``PACK_AUTO_RATIO`` × the packed estimate),
so both packages route a call alike; the embeddings equal the bucketed
ones up to the order of float sums. One deliberate divergence: a windowed
model (``attention_window > 0``) never packs, where the reference's rule
reads no window. A packed row would band by row position and give the
global CLS to its first segment only, and segment masking runs the plain
attention at the row's full width; so ``"auto"`` runs such a model
bucketed and ``packed=True`` raises. The same holds for a Performer model
(``attention_type="performer"``), whose linear attention has no
block-diagonal form (its global sums would mix a row's segments); the
reference's ``"auto"`` packs it by length and then raises.

MoE (``num_experts > 0``): an expert's capacity counts the batch's tokens,
padding included, so a text's embedding depends on the batch it is encoded
in (bucketed, packed, alone). ``encode`` therefore runs the reference's
batch shapes for an MoE model: a bucket's tail batch keeps its padding
rows, and a packed forward is padded to ``rows_per_batch`` rows.
``to_int8`` quantizes the experts and keeps the router in f32.

``from_hf`` converts a live ``transformers`` model (``models.hf_convert``);
``embed_token_stack`` embeds an (n, B, L) stack of pre-tokenized batches.

Data-parallel encode (``mesh=``, a ``core.mesh.Mesh``): each bucketed or
packed batch splits by rows over the mesh ``data`` axis
(``core.mesh.shard_batch``), each piece runs on its device with the weights
copied there once, and the vectors gather back onto the encoder's device.
Rows are independent, so the vectors are those of the mesh-less encode up
to the order of float sums. An MoE model keeps each batch whole (its
capacity counts the batch) and takes the data devices in turn.

``encode_long(texts, mesh, strategy="ring" | "ulysses")`` encodes documents
context-parallel over the mesh ``seq`` axis (``models.long_context``):
exact full attention with the sequence split across the axis, at a width
snapped to a power-of-2 bucket that divides over the axis, then
``encode``'s pool → projection → L2 tail.
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
from ..core.mesh import DATA_AXIS, SEQ_AXIS, on_devices, shard_batch
from ..core.precision import DEFAULT_PRECISION, Precision, precision_for, resolve_device
from ..data.batching import BUCKETS, LengthBucketBatcher, pick_bucket
from ..data.packing import pack_sequences
from ..data.tokenization import load_tokenizer
from ..utils.profiling import span
from .encoder import (
    Encoder, _cast_tree, dequant_weight, encoder_forward, params_from_jax,
)
from .pooling import pool, segment_mean_pool


# texts a padded tokenizer batch in _tokenize_rows (bounds its host buffers)
_ROWS_CHUNK = 16384


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
        mesh=None,        # a core.mesh.Mesh: data-parallel encode over its data axis
    ):
        super().__init__()
        self.device = resolve_device(device)
        params = _tree_to(params, self.device)
        self.encoder = Encoder(arch, params, precision)
        self.arch = arch
        self.tokenizer = tokenizer
        self.pooling = pooling
        self.precision = precision
        self.mesh = mesh
        self._replicas: dict = {}   # the weights on each data device
        self._turn = 0              # the data device an MoE batch takes next

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

    def _as_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.int32).to(self.device)

    @staticmethod
    def _project_normalize(params: dict, emb: torch.Tensor) -> torch.Tensor:
        """Optional projection head, then f32 L2 normalisation."""
        if "projection" in params:
            pw = params["projection"]
            emb = emb.float() @ dequant_weight(pw["w"]).float() + pw["b"]
        emb = emb.float()
        norm = torch.sqrt((emb * emb).sum(dim=-1, keepdim=True))
        return emb / norm.clamp_min(1e-12)

    @torch.no_grad()
    def embed_tokens(self, ids, mask) -> torch.Tensor:
        """Embed a pre-tokenized (B, L) batch → (B, D) normalized f32 on
        the encoder's device."""
        def run(params, ids, mask):
            out = encoder_forward(params, ids, mask, arch=self.arch, precision=self.precision)
            return self._project_normalize(params, pool(self.pooling, out.last_hidden_state, mask))

        with span("ts.encoder.forward"):
            return self._data_parallel(run, self._as_device(ids), self._as_device(mask))

    def _params_on(self, device: torch.device) -> dict:
        if device not in self._replicas:
            self._replicas = on_devices(self.params, self.mesh.axis_devices(DATA_AXIS))
        return self._replicas[device]

    def _data_parallel(self, fn, *arrays: torch.Tensor) -> torch.Tensor:
        """``fn(params, *arrays)`` → rows on the encoder's device: with a
        mesh whose data axis is longer than 1, the rows split over it and
        gather back (an MoE batch stays whole on the next data device)."""
        if self.mesh is None or self.mesh.shape[DATA_AXIS] == 1:
            return fn(self.params, *arrays)
        if self.arch.num_experts > 0:
            devs = self.mesh.axis_devices(DATA_AXIS)
            dev = devs[self._turn % len(devs)]
            self._turn += 1
            return fn(self._params_on(dev), *(a.to(dev) for a in arrays)).to(self.device)
        outs = [fn(self._params_on(piece[0].device), *piece)
                for piece in shard_batch(self.mesh, arrays) if piece[0].shape[0]]
        return torch.cat([o.to(self.device) for o in outs])

    @torch.no_grad()
    def embed_token_stack(self, ids, mask) -> torch.Tensor:
        """Embed an (n, B, L) stack of batches → (n, B, D) normalized f32 on
        the encoder's device, batch i equal to ``embed_tokens(ids[i],
        mask[i])``."""
        ids, mask = np.asarray(ids), np.asarray(mask)
        if ids.shape[0] == 0:
            return torch.zeros((0, ids.shape[1], self.embedding_dim), dtype=torch.float32,
                               device=self.device)
        return torch.stack([self.embed_tokens(i, m) for i, m in zip(ids, mask)])

    @torch.no_grad()
    def embed_tokens_packed(self, ids, segments, positions, max_segments: int = 0) -> torch.Tensor:
        """Embed a packed (R, W) layout (``pack_sequences``) → (R, M, D)
        normalized f32 on the encoder's device: slot (r, m) holds the
        embedding of the row's m-th packed sequence, zeros for an empty
        slot. M is ``max_segments``, or the largest segment tag."""
        self._check_packable()
        m = max_segments or int(np.max(np.asarray(segments)))
        def run(params, ids, segments, positions):
            out = encoder_forward(
                params, ids, (segments > 0).to(torch.int32), arch=self.arch,
                precision=self.precision, segment_ids=segments, position_ids=positions,
            )
            return self._project_normalize(params,
                                           segment_mean_pool(out.last_hidden_state, segments, m))

        with span("ts.encoder.forward"):
            return self._data_parallel(
                run, *(self._as_device(x) for x in (ids, segments, positions)))

    def encode_packed(
        self,
        texts: Sequence[str],
        width: int = 128,
        rows_per_batch: int = 256,
        max_len: int = 128,
        max_segments: int = 0,   # 0: the layout's own slot count
        device_output: bool = False,
    ):
        """Encode texts through greedy packing into rows of ``width``
        tokens → (N, D) normalized f32, row i for texts[i] (as ``encode``)."""
        row_ids = self._tokenize_rows(texts, max_len)
        return self._encode_packed_rows(
            row_ids, len(texts), width=width, rows_per_batch=rows_per_batch,
            max_segments=max_segments, device_output=device_output,
        )

    def _encode_packed_rows(
        self,
        row_ids,
        n_texts: int,
        width: int,
        rows_per_batch: int = 256,
        max_segments: int = 0,
        device_output: bool = False,
        round_segments: bool = False,
    ):
        """Pack pre-tokenized rows and embed them, ``rows_per_batch`` packed
        rows a forward → (N, D). With ``round_segments`` the derived slot
        count rounds up to a power of two, as the reference's serving calls
        do. Empty slots land in one extra trash row of the output."""
        self._check_packable()
        with span("ts.pack"):
            packed = pack_sequences(row_ids, width, pad_id=self.tokenizer.pad_id)
        m = max_segments or int(packed["owners"].shape[1])
        if round_segments and not max_segments and m > 1:
            m = 1 << (m - 1).bit_length()
        if packed["owners"].shape[1] > m:
            raise ValueError(
                f"layout needs {packed['owners'].shape[1]} segment slots, max_segments={m}"
            )
        out = torch.zeros((n_texts + 1, self.embedding_dim), dtype=torch.float32, device=self.device)
        for st in range(0, packed["ids"].shape[0], rows_per_batch):
            chunk = {key: packed[key][st:st + rows_per_batch]
                     for key in ("ids", "segments", "positions", "owners")}
            pad = rows_per_batch - chunk["ids"].shape[0]
            if pad and self.arch.num_experts > 0:
                # MoE capacity counts the reference's padded rows
                chunk = {key: np.pad(val, ((0, pad), (0, 0)),
                                     constant_values=-1 if key == "owners" else 0)
                         for key, val in chunk.items()}
            emb = self.embed_tokens_packed(chunk["ids"], chunk["segments"], chunk["positions"], m)
            ow = chunk["owners"]
            ow = np.pad(ow, ((0, 0), (0, m - ow.shape[1])), constant_values=-1)
            idx = torch.as_tensor(np.where(ow >= 0, ow, n_texts).reshape(-1)).to(self.device)
            out[idx] = emb.reshape(-1, self.embedding_dim)
        out = out[:n_texts]
        return out if device_output else out.cpu().numpy()

    def _check_packable(self) -> None:
        if self.pooling != "mean":
            raise ValueError("packed encode supports mean pooling only")
        if self.arch.attention_window > 0:
            raise ValueError(
                "packed encode does not support a windowed model (attention_window="
                f"{self.arch.attention_window}): encode it with packed=False"
            )
        if self.arch.attention_type == "performer":
            raise ValueError(
                "packed encode does not support Performer attention (its linear sums would "
                "mix a row's segments): encode it with packed=False"
            )

    def forward(self, ids, mask) -> torch.Tensor:
        return self.embed_tokens(ids, mask)

    def _tokenize_rows(self, texts: Sequence[str], max_len: int):
        """texts → token-id rows ([CLS] body [SEP], ≤ max_len)."""
        if self.tokenizer is None:
            raise ValueError("encoder has no tokenizer; use embed_tokens")
        # the padded batch of every tokenizer: the C batch of the native
        # WordPiece, [CLS] body[: max_len - 2] [SEP] of the Python one,
        # HFTokenizerAdapter's own specials and truncation
        rows = []
        with span("ts.tokenize"):
            for st in range(0, len(texts), _ROWS_CHUNK):
                ids, mask = self.tokenizer.encode_batch(texts[st:st + _ROWS_CHUNK], max_len)
                lens = mask.sum(axis=1)
                rows += [ids[i, : lens[i]].tolist() for i in range(len(lens))]
        return rows

    # bucketed batches must cost at least this many times the packed
    # layout's tokens before "auto" packs (the reference's constant)
    PACK_AUTO_RATIO = 1.3

    def use_packed(self, row_ids, batch_size: int, buckets: Sequence[int]) -> bool:
        """The reference's ``packed="auto"`` rule: more than 8 rows, mean
        pooling, and the bucketed tokens (same-bucket groups of
        ``batch_size`` rows, tail batches counted full) ≥ PACK_AUTO_RATIO ×
        the packed estimate (rows of the widest row's bucket, filled to
        98%). Unlike the reference, a windowed or a Performer model never
        packs."""
        if (self.pooling != "mean" or self.arch.attention_window > 0
                or self.arch.attention_type == "performer" or len(row_ids) <= 8):
            return False
        lens = np.asarray([len(r) for r in row_ids], np.int64)
        width = pick_bucket(int(lens.max()), buckets)
        blens = np.asarray([pick_bucket(int(n), buckets) for n in lens])
        bucket_tokens = 0
        for b in np.unique(blens):
            n_batches = -(-int((blens == b).sum()) // batch_size)
            bucket_tokens += n_batches * batch_size * int(b)
        est_rows = -(-int(lens.sum()) // int(width * 0.98))
        return bucket_tokens >= self.PACK_AUTO_RATIO * est_rows * width

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
        ``device_output=True``. ``packed``: True packs the texts into rows
        of the widest text's bucket (mean pooling, no attention window);
        False runs length-sorted batches, each padded to a bucket; "auto"
        packs when :meth:`use_packed` says so."""
        with span("ts.encode"):
            n = len(texts)
            if n == 0:
                out = torch.zeros((0, self.embedding_dim), dtype=torch.float32,
                                  device=self.device)
                return out if device_output else out.cpu().numpy()
            row_ids = self._tokenize_rows(texts, max_len)
            if packed is True or (
                packed == "auto" and self.use_packed(row_ids, batch_size, buckets)
            ):
                width = pick_bucket(max(len(r) for r in row_ids), buckets)
                return self._encode_packed_rows(
                    row_ids, n, width=width, device_output=device_output, round_segments=True,
                )
            out = torch.zeros((n, self.embedding_dim), dtype=torch.float32, device=self.device)
            batcher = LengthBucketBatcher(batch_size, buckets=buckets, shuffle_batches=False)
            moe = self.arch.num_experts > 0
            batches = batcher.batches(row_ids, pad_id=self.tokenizer.pad_id)
            for batch in _spanned(batches, "ts.pack"):
                sel = batch["valid"]
                idx = torch.as_tensor(batch["index"][sel]).to(self.device)
                if moe:
                    # an expert's capacity counts the whole batch, padding rows
                    # included, as in the reference
                    emb = self.embed_tokens(batch["ids"], batch["mask"])
                    out[idx] = emb[torch.as_tensor(np.flatnonzero(sel)).to(self.device)]
                    continue
                # padding rows of the tail batch are dropped before the
                # forward: rows are independent, so this changes no vector
                out[idx] = self.embed_tokens(batch["ids"][sel], batch["mask"][sel])
            return out if device_output else out.cpu().numpy()

    @torch.no_grad()
    def encode_long(
        self,
        texts: Sequence[str],
        mesh,
        max_len: int = 4096,
        strategy: str = "ring",    # ring | ulysses (models.long_context)
        batch_size: int = 8,
    ) -> np.ndarray:
        """Encode documents context-parallel over ``mesh``'s seq axis →
        (N, D) normalized f32 numpy. The width snaps to a power-of-2 bucket
        from the axis length up (at most ``max_len``, a multiple of the
        axis); batches of ``batch_size`` rows, the tail padded with rows
        that keep one valid position."""
        from .long_context import encoder_forward_cp

        if self.tokenizer is None:
            raise ValueError("encoder has no tokenizer")
        n_seq = mesh.shape[SEQ_AXIS]
        ids, mask = self.tokenizer.encode_batch(list(texts), max_len)
        width = ids.shape[1]
        bucket = n_seq
        while bucket < width:
            bucket *= 2
        bucket = min(bucket, max(max_len, n_seq))
        if bucket % n_seq:
            bucket = (bucket + n_seq - 1) // n_seq * n_seq
        if bucket < width:     # max_len caps the tokenized width
            ids, mask = ids[:, :bucket], mask[:, :bucket]
        elif bucket > width:
            ids = np.pad(ids, ((0, 0), (0, bucket - width)))
            mask = np.pad(mask, ((0, 0), (0, bucket - width)))
        params = self.params
        out = np.zeros((len(texts), self.embedding_dim), np.float32)
        for start in range(0, len(texts), batch_size):
            stop = min(start + batch_size, len(texts))
            pad = batch_size - (stop - start)
            i_b = np.pad(ids[start:stop], ((0, pad), (0, 0)))
            m_b = np.pad(mask[start:stop], ((0, pad), (0, 0)))
            m_b[stop - start:, 0] = 1     # padding rows: one valid position
            i_t, m_t = self._as_device(i_b), self._as_device(m_b)
            h = encoder_forward_cp(params, i_t, m_t, arch=self.arch, mesh=mesh,
                                   strategy=strategy, precision=self.precision)
            emb = self._project_normalize(params, pool(self.pooling, h.to(self.device), m_t))
            out[start:stop] = emb[: stop - start].cpu().numpy()
        return out

    def _set_params(self, params: dict) -> "SentenceEncoder":
        self.encoder = Encoder(self.arch, params, self.precision)
        self._replicas = {}
        return self

    def to_int8(self) -> "SentenceEncoder":
        """Quantize the weights to int8 for serving (inference only):
        kernels and embedding tables become per-channel int8 with f32
        scales; dense layers then quantize their input per token. MoE
        experts quantize too (per-slot activation scales); the router
        stays f32."""
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
    def from_hf(cls, hf_model, tokenizer=None, pooling: str = "mean", device="cuda",
                **kw) -> "SentenceEncoder":
        """Build from a live transformers model (``models.hf_convert``; the
        model's ``.config`` and ``.state_dict()`` are read)."""
        from .hf_convert import convert_hf_model

        dev = resolve_device(device)
        params, arch = convert_hf_model(hf_model, device=dev)
        return cls(params, arch, tokenizer=tokenizer, pooling=pooling, device=dev, **kw)

    @classmethod
    def load(cls, path: str, bf16: bool = True, device="cuda", mesh=None) -> "SentenceEncoder":
        """Load a directory written by either package. A checkpoint in the
        int8 deployment format dequantizes to bf16 (``bf16=True``) or f32
        weights, as the reference does; a tree saved after ``to_int8``
        keeps its int8 leaves. ``mesh``: the data-parallel encode's."""
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
            mesh=mesh,
        )


def _tree_to(tree: dict, device: torch.device, copy: bool = False) -> dict:
    return {
        k: _tree_to(v, device, copy) if isinstance(v, dict) else v.detach().to(device, copy=copy)
        for k, v in tree.items()
    }


def _spanned(items, name: str):
    """Yield ``items``, each draw of the next one under ``span(name)``."""
    it = iter(items)
    while True:
        with span(name):
            item = next(it, None)
        if item is None:
            return
        yield item

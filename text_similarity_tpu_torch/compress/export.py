"""Serving export (port of ``text_similarity_tpu.compress.export``): the
encode step traced ahead of time with ``torch.export``, one program a
(batch, sequence) shape, shipped with the params it was traced on (int8 by
default), the arch and the tokenizer's vocab. A server loads the program
and the params and calls it with no model code.

The bundle's layout is the reference's: ``manifest.json`` (the keys
``arch``, ``pooling``, ``int8`` and ``functions``, each function with its
``name``, ``batch``, ``seq``, ``bytes`` and ``platforms``), ``arch.json``,
``vocab.txt`` and the params as a ``core.checkpoint`` step (meta ``int8``),
which the JAX package's ``restore_checkpoint_raw`` reads too. The programs
are ``encode_b{b}_s{s}.pt2`` files (``torch.export.save``) where the
reference writes StableHLO; ``platforms`` records the device the program
was traced on, where it runs.

The traced encoder takes the eager encoder's own attention rule
(``attention_impl="auto"``, ``ops.attention.auto_impl``): on the card at
S ≥ 4,096 with S % 128 == 0 it runs K5, which ``torch.export`` keeps as
the registered op ``text_similarity_tpu_torch::flash_fwd``; elsewhere the
plain attention. Unlike the reference's StableHLO, whose blob carries its
kernel, a program that names the op runs only where the port is
installed: ``load_exported_fn`` imports the op's registration first.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import torch
from torch import nn

from ..utils.logging import get_logger

logger = get_logger("export")


class _EncodeStep(nn.Module):
    """fn(params, ids, mask) → (B, D) L2-normalised f32 embeddings of the
    encoder's arch, pooling and precision."""

    def __init__(self, arch, precision, pooling: str):
        super().__init__()
        self.arch, self.precision, self.pooling = arch, precision, pooling

    def forward(self, params, ids, mask):
        from ..models.encoder import encoder_forward
        from ..models.pooling import pool
        from ..models.sentence_encoder import SentenceEncoder

        out = encoder_forward(params, ids, mask, arch=self.arch, precision=self.precision)
        return SentenceEncoder._project_normalize(
            params, pool(self.pooling, out.last_hidden_state, mask))


def export_encoder(
    encoder,                        # SentenceEncoder
    path: str,
    batch_sizes: Sequence[int] = (32,),
    seq_lens: Sequence[int] = (128,),
    quantize: bool = True,
) -> dict:
    """Export the encode step for each (batch, seq) shape on the encoder's
    device, traced on the params the bundle ships (quantized first when
    ``quantize``) with the eager encoder's attention rule (K5 on the card
    from 4,096 tokens) → the manifest (also written as
    ``manifest.json``)."""
    from ..core.checkpoint import save_checkpoint
    from ..models.sentence_encoder import _tree_to
    from .quantize import quantize_params_int8

    os.makedirs(path, exist_ok=True)
    dev = encoder.device
    params = _tree_to(encoder.params, encoder.device)
    if quantize:
        params = quantize_params_int8(params)
    step = _EncodeStep(encoder.arch, encoder.precision, encoder.pooling)
    manifest = {"arch": json.loads(encoder.arch.to_json()), "pooling": encoder.pooling,
                "int8": bool(quantize), "functions": []}
    for b in batch_sizes:
        for s in seq_lens:
            ids = torch.zeros((b, s), dtype=torch.int32, device=dev)
            mask = torch.ones((b, s), dtype=torch.int32, device=dev)
            with torch.no_grad():
                program = torch.export.export(step, (params, ids, mask), strict=False)
            name = f"encode_b{b}_s{s}.pt2"
            file = os.path.join(path, name)
            torch.export.save(program, file)
            size = os.path.getsize(file)
            manifest["functions"].append({"name": name, "batch": b, "seq": s, "bytes": size,
                                          "platforms": [dev.type]})
            logger.info("exported %s (%d bytes, platforms=%s)", name, size, [dev.type])
    save_checkpoint(path, params, step=0, meta={"int8": bool(quantize)})
    with open(os.path.join(path, "arch.json"), "w") as f:
        f.write(encoder.arch.to_json())
    if encoder.tokenizer is not None and hasattr(encoder.tokenizer, "save_vocab"):
        encoder.tokenizer.save_vocab(os.path.join(path, "vocab.txt"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_exported_fn(path: str, name: str):
    """One exported program as a callable fn(params, ids, mask), with the
    params of :func:`load_exported_params` on the device the manifest's
    ``platforms`` names. K5's op is registered first (importing
    ``ops.attention``), since a program traced with it names it."""
    from ..ops import attention  # noqa: F401 (registers text_similarity_tpu_torch::flash_fwd)

    return torch.export.load(os.path.join(path, name)).module()


def load_exported_params(path: str, device="cuda") -> dict:
    """The bundle's params as tensors on ``device``, rebuilt from the
    checkpoint's flat key paths (an int8 leaf as its ``{"q", "s"}``
    pair)."""
    from ..core.checkpoint import latest_checkpoint, restore_checkpoint_raw
    from ..core.precision import resolve_device

    dev = resolve_device(device)
    tree, _, _ = restore_checkpoint_raw(latest_checkpoint(path))

    def to(t):
        return {k: to(v) if isinstance(v, dict) else torch.from_numpy(v).to(dev)
                for k, v in t.items()}

    return to(tree)

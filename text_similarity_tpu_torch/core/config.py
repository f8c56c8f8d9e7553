"""Frozen config dataclasses, mirrored from ``text_similarity_tpu.core.config``.

``EncoderArch`` keeps every field of the reference so that an ``arch.json``
written by the JAX package (``EncoderArch.to_json``) reads back here
unchanged. ``TrainConfig`` carries the optimizer's hyper-parameters and
the reference's run fields; ``MeshConfig`` and ``RunConfig`` read and write
the JAX package's run JSON (``RunConfig.to_json`` / ``from_json``).
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class EncoderArch:
    """Architecture of a BERT-class transformer encoder (BERT / MiniLM /
    DistilBERT / RoBERTa layouts; same fields and defaults as the JAX
    package)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"  # "gelu" (erf) | "gelu_new" | "relu" | ...
    pad_token_id: int = 0
    position_offset: int = 0
    has_token_type: bool = True
    has_pooler: bool = True
    projection_dim: int = 0
    attention_dropout: float = 0.1
    hidden_dropout: float = 0.1
    head_dim_override: int = 0
    attention_type: str = "softmax"
    performer_features: int = 0
    performer_kernel: str = "softmax"
    performer_redraw_every: int = 0
    performer_local_heads: int = 0
    performer_local_window: int = 64
    share_layers: bool = False
    embed_factor_size: int = 0
    attention_window: int = 0
    window_global_cls: bool = False
    num_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.num_heads

    @property
    def embedding_size(self) -> int:
        """Output embedding width (after optional projection)."""
        return self.projection_dim or self.hidden_size

    def replace(self, **kw) -> "EncoderArch":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "EncoderArch":
        return cls(**json.loads(s))


ARCH_PRESETS = {
    "bert-base": EncoderArch(),
    "bert-large": EncoderArch(
        hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096
    ),
    "distilbert-base": EncoderArch(
        num_layers=6, has_token_type=False, has_pooler=False
    ),
    "minilm-l6": EncoderArch(
        hidden_size=384, num_layers=6, num_heads=12, intermediate_size=1536
    ),
    "minilm-l12": EncoderArch(
        hidden_size=384, num_layers=12, num_heads=12, intermediate_size=1536
    ),
    "roberta-base": EncoderArch(
        vocab_size=50265,
        max_position=514,
        type_vocab_size=1,
        layer_norm_eps=1e-5,
        pad_token_id=1,
        position_offset=2,
    ),
    "xlm-roberta-base": EncoderArch(
        vocab_size=250002,
        max_position=514,
        type_vocab_size=1,
        layer_norm_eps=1e-5,
        pad_token_id=1,
        position_offset=2,
    ),
    "albert-base": EncoderArch(
        vocab_size=30000,
        hidden_act="gelu_new",
        share_layers=True,
        embed_factor_size=128,
    ),
    "tiny-test": EncoderArch(
        vocab_size=1024,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        intermediate_size=128,
        max_position=128,
    ),
}


@dataclass(frozen=True)
class IndexConfig:
    """IVF index parameters (same fields as the JAX package)."""

    num_clusters: int = 1024
    num_probes: int = 16
    kmeans_iters: int = 12
    top_k: int = 10
    max_cluster_size: int = 0  # 0 = auto (corpus / clusters * 4)
    quantize_int8: bool = False

    @classmethod
    def auto(cls, n: int) -> "IndexConfig":
        """Size the index from the corpus: C ≈ 2·√N rounded to a power of
        two, probes ≈ C/37; corpora of 3M rows and more cap clusters at
        about twice the mean size (same rule as the JAX package)."""
        c = 2 ** int(round(math.log2(max(2.0 * math.sqrt(max(n, 1)), 8.0))))
        c = max(8, min(c, max(n // 32, 8)))
        probes = max(4, min(c, int(round(c / 37)) or 4))
        cap = 0
        if n >= 3_000_000:
            cap = max(8, (2 * n // c + 511) // 512 * 512)
        return cls(num_clusters=c, num_probes=probes, max_cluster_size=cap)


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout, the JAX package's fields: ``data`` (data
    parallel), ``model`` (tensor parallel), ``index`` (corpus shards); a
    size of 1 leaves the axis unused. ``core.mesh.make_mesh`` builds the
    mesh itself."""

    data: int = 1
    model: int = 1
    index: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.index

    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "model", "index")


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters, with the JAX package's names and
    defaults: AdamW with no-decay groups, linear warmup then decay, global
    norm clipping, gradient accumulation, and the run fields the CLI reads
    (batch size, epochs, bf16 compute). The last four fields are carried
    for ``RunConfig``'s JSON; the port reads none of them."""

    lr: float = 2e-5
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    warmup_ratio: float = 0.1
    max_grad_norm: float = 1.0
    batch_size: int = 32
    epochs: int = 1
    grad_accum_steps: int = 1
    seed: int = 0
    bf16: bool = True
    max_seq_len: int = 256
    eval_in_train: bool = True
    save_best: bool = True
    metric_direction: str = "max"


@dataclass(frozen=True)
class RunConfig:
    """The run's whole configuration (the JAX package's ``RunConfig``): the
    model's preset name and arch, the mesh, training and index configs and
    the save path. ``to_json`` writes what the JAX package writes;
    ``from_json`` reads either package's file."""

    model_name: str = "minilm-l6"
    arch: EncoderArch = field(default_factory=lambda: ARCH_PRESETS["minilm-l6"])
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    save_path: str = "checkpoints"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        d = json.loads(s)
        return cls(
            model_name=d.get("model_name", "minilm-l6"),
            arch=EncoderArch(**d["arch"]),
            mesh=MeshConfig(**d["mesh"]),
            train=TrainConfig(**d["train"]),
            index=IndexConfig(**d["index"]),
            save_path=d.get("save_path", "checkpoints"),
        )

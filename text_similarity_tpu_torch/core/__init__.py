from .config import ARCH_PRESETS, EncoderArch, IndexConfig, TrainConfig
from .mesh import (
    DATA_AXIS, EXPERT_AXIS, INDEX_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh, PartitionSpec,
    ShardedLeaf, gather_leaf, local_mesh, make_mesh, place, shard_leaf, unshard,
)
from .precision import (
    DEFAULT_PRECISION,
    FP32_PRECISION,
    Precision,
    precision_for,
    resolve_device,
)

__all__ = [
    "ARCH_PRESETS",
    "EncoderArch",
    "IndexConfig",
    "TrainConfig",
    "DATA_AXIS",
    "EXPERT_AXIS",
    "INDEX_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SEQ_AXIS",
    "Mesh",
    "PartitionSpec",
    "ShardedLeaf",
    "gather_leaf",
    "local_mesh",
    "make_mesh",
    "place",
    "shard_leaf",
    "unshard",
    "DEFAULT_PRECISION",
    "FP32_PRECISION",
    "Precision",
    "precision_for",
    "resolve_device",
]

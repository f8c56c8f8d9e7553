from .brute import BruteForceIndex
from .ivf import IVFIndex
from .sharded import ShardedBruteForceIndex, ShardedIVFIndex
from .store import EmbeddingStore

__all__ = [
    "BruteForceIndex", "EmbeddingStore", "IVFIndex", "ShardedBruteForceIndex", "ShardedIVFIndex",
]

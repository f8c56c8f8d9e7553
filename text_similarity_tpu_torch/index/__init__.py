from .brute import BruteForceIndex
from .ivf import IVFIndex
from .store import EmbeddingStore

__all__ = ["BruteForceIndex", "EmbeddingStore", "IVFIndex"]

from .rerank import RankingPipeline
from .search import SemanticSearchPipeline
from .serve import SearchServer

__all__ = ["RankingPipeline", "SemanticSearchPipeline", "SearchServer"]

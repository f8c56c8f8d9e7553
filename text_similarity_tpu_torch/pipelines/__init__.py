from .rerank import RankingPipeline
from .search import SemanticSearchPipeline, SentenceMiningPipeline, compare_models
from .serve import SearchServer

__all__ = [
    "RankingPipeline", "SemanticSearchPipeline", "SentenceMiningPipeline", "SearchServer",
    "compare_models",
]

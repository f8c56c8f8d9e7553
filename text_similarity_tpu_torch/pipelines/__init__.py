from .clustering import ClusteringPipeline
from .rerank import RankingPipeline
from .search import (
    SemanticSearchPipeline, SentenceMiningPipeline, ShardedSearchPipeline, compare_models,
)
from .serve import SearchServer
from .topic import TopicModelingPipeline

__all__ = [
    "ClusteringPipeline", "RankingPipeline", "SemanticSearchPipeline", "SentenceMiningPipeline",
    "SearchServer", "ShardedSearchPipeline", "TopicModelingPipeline", "compare_models",
]

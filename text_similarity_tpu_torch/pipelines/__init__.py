from .clustering import ClusteringPipeline
from .rerank import RankingPipeline
from .search import SemanticSearchPipeline, SentenceMiningPipeline, compare_models
from .serve import SearchServer
from .topic import TopicModelingPipeline

__all__ = [
    "ClusteringPipeline", "RankingPipeline", "SemanticSearchPipeline", "SentenceMiningPipeline",
    "SearchServer", "TopicModelingPipeline", "compare_models",
]

from .search import SemanticSearchPipeline

__all__ = ["SemanticSearchPipeline"]

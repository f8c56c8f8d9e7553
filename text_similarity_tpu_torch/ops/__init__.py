from .topk import cosine_topk, l2_normalize

__all__ = ["cosine_topk", "l2_normalize"]

from .evaluators import ClassifierEvaluator, ParaphraseEvaluator, RetrievalEvaluator
from .meters import (
    AverageMeter,
    Metrics,
    average_precision,
    best_threshold_accuracy,
    best_threshold_f1,
    classification_metrics,
    retrieval_accuracy,
    similarity_metrics,
)

__all__ = [
    "AverageMeter",
    "Metrics",
    "similarity_metrics",
    "best_threshold_accuracy",
    "best_threshold_f1",
    "average_precision",
    "retrieval_accuracy",
    "classification_metrics",
    "ParaphraseEvaluator",
    "RetrievalEvaluator",
    "ClassifierEvaluator",
]

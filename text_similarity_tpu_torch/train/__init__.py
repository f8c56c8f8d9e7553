from .optim import AdamW, linear_warmup_schedule, make_optimizer
from .prefetch import DevicePrefetcher
from .steps import (
    TrainState,
    init_classifier_head,
    init_train_state,
    make_bi_encoder_train_step,
)
from .trainer import Trainer

__all__ = [
    "AdamW",
    "make_optimizer",
    "linear_warmup_schedule",
    "make_bi_encoder_train_step",
    "TrainState",
    "init_train_state",
    "init_classifier_head",
    "DevicePrefetcher",
    "Trainer",
]

from .optim import AdamW, linear_warmup_schedule, make_optimizer
from .prefetch import DevicePrefetcher
from .steps import (
    TrainState,
    classifier_forward,
    init_classifier_head,
    init_train_state,
    make_bi_encoder_train_step,
    make_classifier_train_step,
    make_mlm_train_step,
    make_packed_bi_encoder_train_step,
    make_packed_classifier_train_step,
    make_token_classifier_train_step,
    mlm_forward,
    mlm_mask_batch,
    packed_classifier_forward,
    token_classifier_forward,
)
from .trainer import Trainer

__all__ = [
    "AdamW",
    "make_optimizer",
    "linear_warmup_schedule",
    "make_bi_encoder_train_step",
    "make_classifier_train_step",
    "make_packed_bi_encoder_train_step",
    "make_packed_classifier_train_step",
    "make_token_classifier_train_step",
    "make_mlm_train_step",
    "mlm_forward",
    "mlm_mask_batch",
    "packed_classifier_forward",
    "token_classifier_forward",
    "TrainState",
    "init_train_state",
    "classifier_forward",
    "init_classifier_head",
    "DevicePrefetcher",
    "Trainer",
]

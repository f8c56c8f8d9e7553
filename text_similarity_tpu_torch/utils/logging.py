"""Logger factory (port of ``text_similarity_tpu.utils.logging.get_logger``):
one stderr handler a logger, named ``text_similarity_tpu_torch.<name>``."""

from __future__ import annotations

import logging

_FMT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(f"text_similarity_tpu_torch.{name}")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger

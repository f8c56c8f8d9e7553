"""Logger factory and JSONL run log (port of
``text_similarity_tpu.utils.logging``): ``get_logger`` gives one stderr
handler a logger, named ``text_similarity_tpu_torch.<name>``;
``JsonlRunLog`` appends one JSON event a line to a run's log file."""

from __future__ import annotations

import json
import logging
import time

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


class JsonlRunLog:
    """Append-only JSONL event log for a run."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def log(self, event: str, **fields):
        rec = {"ts": round(time.time(), 3), "event": event, **fields}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

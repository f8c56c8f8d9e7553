"""Trainer: the epoch loop with eval-in-train and best-metric checkpoints
(port of ``text_similarity_tpu.train.trainer``).

- Step metrics are device scalars, fetched at ``log_every`` boundaries
  (one host sync per window, not per step); a non-finite loss raises
  ``FloatingPointError`` there (the NaN guard).
- Checkpoints are step-stamped (params, the optimizer state and the step)
  and resumable; ``best`` and ``final`` name the snapshots of the tracked
  metric and the end; the run history goes to ``results.jsonl``.
- Async checkpoints: the state is copied on the device (ordered before the
  next step's in-place update on the same stream), and a writer thread
  moves the copy to the host and writes it; a failed write raises at the
  next save or ``join_pending_save``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from ..core import checkpoint as ckpt
from ..core.precision import resolve_device
from .steps import trainable

logger = logging.getLogger("text_similarity_tpu_torch.trainer")


def _device_copy(tree):
    """Tensors cloned on their device (Python numbers as they are)."""
    if isinstance(tree, dict):
        return {k: _device_copy(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


class Trainer:
    def __init__(
        self,
        step_fn: Callable,                   # (state, batch) -> (state, metrics)
        state,                               # TrainState
        save_path: Optional[str] = None,
        eval_fn: Optional[Callable] = None,  # (state) -> Dict[str, float]
        tracked_metric: str = "loss",
        direction: str = "min",
        log_every: int = 50,
        checkpoint_every: int = 0,           # steps; 0 = only best/final
        save_optimizer: bool = True,
        prefetch: int = 2,                   # device-prefetch depth; 0 = off
        async_checkpoint: bool = True,
        device="cuda",
    ):
        self.step_fn = step_fn
        self.state = state
        self.save_path = save_path
        self.eval_fn = eval_fn
        self.tracked_metric = tracked_metric
        self.direction = direction
        self.log_every = log_every
        self.checkpoint_every = checkpoint_every
        self.save_optimizer = save_optimizer
        self.prefetch = prefetch
        self.async_checkpoint = async_checkpoint
        self.device = resolve_device(device)
        self.best_metric = -math.inf if direction == "max" else math.inf
        self.history = []
        self._save_thread = None
        self._save_error = None

    def _is_better(self, value: float) -> bool:
        if self.direction == "max":
            return value > self.best_metric
        return value < self.best_metric

    def execute(
        self,
        batches_per_epoch: Callable[[int], Iterable[dict]],
        epochs: int = 1,
        write_results: bool = True,
    ) -> Dict:
        """Run training. ``batches_per_epoch(epoch)`` yields host or device
        batch dicts; with ``prefetch > 0`` a ``DevicePrefetcher`` copies the
        next batches to the device while the current step runs."""
        global_step = int(self.state.step)
        for epoch in range(epochs):
            t0 = time.time()
            pending = []   # device metric dicts, fetched at log boundaries
            n_steps = 0
            epoch_metrics: Dict[str, float] = {}
            epoch_batches = batches_per_epoch(epoch)
            prefetcher = None
            if self.prefetch > 0:
                from .prefetch import DevicePrefetcher

                epoch_batches = prefetcher = DevicePrefetcher(
                    epoch_batches, depth=self.prefetch, device=self.device
                )
            try:
                for batch in epoch_batches:
                    self.state, metrics = self.step_fn(self.state, batch)
                    pending.append(metrics)
                    n_steps += 1
                    global_step += 1
                    if len(pending) >= self.log_every:
                        epoch_metrics = self._drain(pending, epoch_metrics)
                        pending = []
                    if (self.checkpoint_every and self.save_path
                            and global_step % self.checkpoint_every == 0):
                        self._save(global_step, tag=None)
            finally:
                # a failing step must neither leave the producer blocked on
                # a full queue nor abandon a checkpoint mid-write (join only:
                # the step's error is not to be masked by a save error)
                if prefetcher is not None:
                    prefetcher.close()
                if self._save_thread is not None:
                    self._save_thread.join()
            epoch_metrics = self._drain(pending, epoch_metrics)
            avg = {k: v / max(n_steps, 1) for k, v in epoch_metrics.items()}
            record = {
                "epoch": epoch,
                "steps": n_steps,
                "seconds": round(time.time() - t0, 2),
                "train": {k: round(v, 6) for k, v in avg.items()},
            }
            if self.eval_fn is not None:
                eval_metrics = self.eval_fn(self.state)
                record["eval"] = {k: round(float(v), 6) for k, v in eval_metrics.items()}
                tracked = float(eval_metrics[self.tracked_metric])
                if self._is_better(tracked):
                    self.best_metric = tracked
                    if self.save_path:
                        self._save(global_step, tag="best")
            elif self.save_path:
                # track the train loss when no eval is configured
                tracked = avg.get("loss", 0.0)
                if self.direction == "min" and self._is_better(tracked):
                    self.best_metric = tracked
                    self._save(global_step, tag="best")
            self.history.append(record)
            logger.info("epoch %d: %s", epoch, json.dumps(record))

        if self.save_path:
            self._save(global_step, tag="final")
            self.join_pending_save()   # execute() returning ⇒ durable
            if write_results:
                with open(os.path.join(self.save_path, "results.jsonl"), "w") as f:
                    for r in self.history:
                        f.write(json.dumps(r) + "\n")
        return {"best_metric": self.best_metric, "history": self.history, "state": self.state}

    def _drain(self, pending, acc: Dict[str, float]) -> Dict[str, float]:
        if not pending:
            return acc
        for m in pending:
            for k, v in m.items():
                v = float(v)
                if k == "loss" and not math.isfinite(v):
                    raise FloatingPointError(
                        f"non-finite loss at step {int(self.state.step)}; run with "
                        "torch.autograd.set_detect_anomaly(True) to localize"
                    )
                acc[k] = acc.get(k, 0.0) + v
        return acc

    def _save(self, step: int, tag: Optional[str]):
        os.makedirs(self.save_path, exist_ok=True)
        params = self.state.params
        opt_state = self.state.opt_state if self.save_optimizer else None
        if not self.async_checkpoint:
            self._write_checkpoint(params, opt_state, step, tag)
            return
        self.join_pending_save()   # one writer at a time, in order
        # the step updates the live tensors in place: snapshot them on the
        # device now, and leave the host copy and the disk to the writer
        params, opt_state = _device_copy(params), _device_copy(opt_state)

        def write():
            try:
                self._write_checkpoint(params, opt_state, step, tag)
            except Exception as e:   # surfaced at the next save / join
                self._save_error = e

        self._save_thread = threading.Thread(target=write, daemon=True)
        self._save_thread.start()

    def _write_checkpoint(self, params, opt_state, step, tag):
        d = ckpt.save_checkpoint(
            self.save_path, params, opt_state=opt_state, step=step,
            meta={"tag": tag or "periodic", "best_metric": float(self.best_metric)},
        )
        if tag:
            with open(os.path.join(self.save_path, tag.upper()), "w") as f:
                f.write(os.path.basename(d))

    def join_pending_save(self):
        """Block until the in-flight async checkpoint (if any) is on disk;
        re-raise its error if it failed."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_error is not None:
            e, self._save_error = self._save_error, None
            raise e

    def resume(self, params_template=None, opt_template=None) -> bool:
        """Resume from the latest checkpoint under save_path (the current
        state's trees are the default templates) → whether one was found."""
        if not self.save_path:
            return False
        d = ckpt.latest_checkpoint(self.save_path)
        if d is None:
            return False
        params, opt_state, step, meta = ckpt.restore_checkpoint(
            d,
            params_template if params_template is not None else self.state.params,
            opt_template if opt_template is not None else self.state.opt_state,
        )
        self.state = self.state._replace(
            params=trainable(params),
            opt_state=opt_state if opt_state is not None else self.state.opt_state,
            step=int(step),
        )
        self.best_metric = meta.get("best_metric", self.best_metric)
        logger.info("resumed from %s (step %d)", d, step)
        return True

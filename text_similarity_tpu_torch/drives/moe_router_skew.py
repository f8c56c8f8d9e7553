"""MoE routing under a trained router: the dropped-token fraction when the
router has learnt to skew its load, beside a random router's, for each
(top_k, capacity factor) of ``SWEEP``.

Two modes, one JSON line each on stdout (progress on stderr):
  --train  MLM on Zipfian synthetic text (exponent 1.1, lengths 16..s) with
           the Switch load-balance loss, minilm-l6 geometry with 8 experts,
           top-k 2, capacity factor 1.25, vocab 8,192, f32; saves the
           parameters under ``.bench_cache/moe_router_ckpt`` (``--ckpt``) and
           prints the drop table of the trained router against a random one
           at 64 × 128 (``EVAL_SHAPE``).
  --sweep  loads that checkpoint and runs b 1,024 × s 128 (``SWEEP_SHAPE``)
           in bf16: sentences/s (three timed windows of five forwards each,
           every window printed, and their median) and ``moe_drop`` for each
           (top_k, cf), trained router against random, on the same data.

Every run is on the card unless ``--device cpu``. The geometry and the
shapes are the module's constants (``ARCH``, ``TRAIN_SHAPE``,
``EVAL_SHAPE``, ``SWEEP_SHAPE`` and their batch counts).

    python -m text_similarity_tpu_torch.drives.moe_router_skew --train [--steps 200]
    python -m text_similarity_tpu_torch.drives.moe_router_skew --sweep
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core.config import ARCH_PRESETS, TrainConfig
from ..core.precision import DEFAULT_PRECISION, FP32_PRECISION, resolve_device
from ..models.encoder import encoder_forward, init_params, params_from_jax
from ..train import init_train_state, make_optimizer
from ..train.steps import make_mlm_train_step

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CKPT = os.path.join(REPO, ".bench_cache", "moe_router_ckpt")
VOCAB = 8192
SPECIALS = (0, 1, 2, 3, 4)
MASK_ID = 4
SWEEP = [(1, 1.0), (1, 1.25), (1, 2.0), (2, 1.0), (2, 1.25), (2, 2.0)]
ARCH = "minilm-l6"          # the geometry the 8 experts go into
TRAIN_SHAPE = (16, 64)      # (rows, length) of a training batch
EVAL_SHAPE, EVAL_BATCHES = (64, 128), 4
SWEEP_SHAPE, SWEEP_BATCHES = (1024, 128), 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def make_arch():
    return ARCH_PRESETS[ARCH].replace(vocab_size=VOCAB, num_experts=8, expert_top_k=2,
                                      expert_capacity_factor=1.25)


def zipf_batch(rng: np.random.Generator, b: int, s: int):
    """Zipfian token ids (exponent 1.1) with lengths 16..s and a [CLS]-like
    first token → (ids, mask), int32 (b, s)."""
    ranks = np.arange(1, VOCAB - len(SPECIALS) + 1, dtype=np.float64)
    p = 1.0 / ranks ** 1.1
    p /= p.sum()
    ids = rng.choice(VOCAB - len(SPECIALS), size=(b, s), p=p) + len(SPECIALS)
    lens = rng.integers(min(16, s), s + 1, size=b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, ids, 0)
    ids[:, 0] = 2
    return ids.astype(np.int32), mask


def _random_params(arch, dev: torch.device) -> dict:
    """The random router's weights (seed 7), drawn on the CPU."""
    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    return to(init_params(arch, torch.Generator().manual_seed(7)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


@torch.no_grad()
def drop_table(params: dict, arch, batches, precision, dev, timing: bool = False) -> List[dict]:
    """``moe_drop`` and ``moe_aux`` (means over the batches), and with
    ``timing`` the sentences/s of the first batch, for each (top_k, cf)."""
    batches = [(torch.from_numpy(i).to(dev), torch.from_numpy(m).to(dev)) for i, m in batches]
    rows = []
    for top_k, cf in SWEEP:
        a = arch.replace(expert_top_k=top_k, expert_capacity_factor=cf)

        def fwd(ids, mask, a=a):
            out = encoder_forward(params, ids, mask, arch=a, precision=precision)
            return out.moe_aux, out.moe_drop

        stats = torch.stack([torch.stack(fwd(i, m)) for i, m in batches]).mean(dim=0)
        row = {"top_k": top_k, "cf": cf, "moe_drop": float(stats[1]),
               "moe_aux": float(stats[0])}
        if timing:
            ids, mask = batches[0]
            windows = []
            for _ in range(3):
                _sync(dev)
                t0 = time.perf_counter()
                for _ in range(5):
                    fwd(ids, mask)
                _sync(dev)
                windows.append(5 * ids.shape[0] / (time.perf_counter() - t0))
            row["sent_per_s_windows"] = windows
            row["sent_per_s"] = statistics.median(windows)
        rows.append(row)
        log(f"top{top_k} cf={cf}: {row}")
    return rows


def cmd_train(args, dev: torch.device) -> dict:
    arch = make_arch()
    params = {
        "encoder": init_params(arch, torch.Generator().manual_seed(0)),
        "mlm_bias": torch.zeros((arch.vocab_size,)),
    }
    b, s = TRAIN_SHAPE
    tx = make_optimizer(TrainConfig(lr=3e-4, batch_size=b), args.steps,
                        params_example=params)
    state = init_train_state(params, tx, seed=0, device=dev)
    step = make_mlm_train_step(arch, tx, mask_token_id=MASK_ID, special_ids=SPECIALS,
                               precision=FP32_PRECISION, device=dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.steps):
        ids, mask = zipf_batch(rng, b, s)
        state, m = step(state, {"ids": ids, "mask": mask})
        if i % 25 == 0 or i == args.steps - 1:
            log(f"step {i}: loss={float(m['loss']):.4f} aux={float(m['moe_aux']):.4f} "
                f"drop={float(m['moe_drop']):.4f} "
                f"({(time.perf_counter() - t0) / (i + 1):.3f} s/step)")
    train_s = time.perf_counter() - t0
    ckpt.save_checkpoint(args.ckpt, state.params, step=args.steps,
                         meta={"arch": f"{ARCH}+E8", "vocab": VOCAB, "data": "zipf-1.1 mlm"})
    log(f"checkpoint saved under {args.ckpt}")

    eb, es = EVAL_SHAPE
    evals = [zipf_batch(rng, eb, es) for _ in range(EVAL_BATCHES)]
    log("trained router:")
    trained = drop_table(state.params["encoder"], arch, evals, FP32_PRECISION, dev)
    log("random-init router (same data):")
    random_rows = drop_table(_random_params(arch, dev), arch, evals, FP32_PRECISION, dev)
    row = {"mode": "train", "steps": args.steps, "train_seconds": train_s,
           "final_loss": float(m["loss"]), "eval_shape": [eb, es], "trained": trained,
           "random": random_rows}
    emit(row)
    return row


def cmd_sweep(args, dev: torch.device) -> dict:
    arch = make_arch()
    cdir = ckpt.latest_checkpoint(args.ckpt)
    if cdir is None:
        raise SystemExit(f"no checkpoint under {args.ckpt}; run --train first")
    tree, tstep, _ = ckpt.restore_checkpoint_raw(cdir)
    params = params_from_jax(tree["encoder"], arch, device=dev)
    log(f"restored {cdir} (step {tstep})")
    b, s = SWEEP_SHAPE
    rng = np.random.default_rng(1)
    batches = [zipf_batch(rng, b, s) for _ in range(SWEEP_BATCHES)]
    log("trained router:")
    trained = drop_table(params, arch, batches, DEFAULT_PRECISION, dev, timing=True)
    log("random-init router (same data):")
    random_rows = drop_table(_random_params(arch, dev), arch, batches, DEFAULT_PRECISION, dev,
                             timing=True)
    row = {"mode": "sweep", "shape": [b, s], "trained": trained, "random": random_rows}
    emit(row)
    return row


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.train:
        return cmd_train(args, dev)
    if args.sweep:
        return cmd_sweep(args, dev)
    raise SystemExit("pass --train or --sweep")


if __name__ == "__main__":
    main()

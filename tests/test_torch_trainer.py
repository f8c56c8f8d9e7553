"""The port's Trainer, DevicePrefetcher and training checkpoints on the
CPU (the JAX package's ``tests/test_trainer.py``, carried over): best,
final and results files, resume, the NaN guard, async checkpoints (a
snapshot taken before the next step's in-place update; write errors
surfacing), prefetch order, errors and close, and accumulation against
one larger batch."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from text_similarity_tpu_torch.core import checkpoint as ckpt
from text_similarity_tpu_torch.core.config import ARCH_PRESETS, TrainConfig
from text_similarity_tpu_torch.core.precision import FP32_PRECISION
from text_similarity_tpu_torch.models import init_params
from text_similarity_tpu_torch.train import (
    DevicePrefetcher,
    Trainer,
    TrainState,
    init_train_state,
    make_bi_encoder_train_step,
    make_optimizer,
)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = ARCH_PRESETS["tiny-test"].replace(hidden_dropout=0.0, attention_dropout=0.0)


def _batch(b=4, s=8, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "ids_a": rng.randint(5, ARCH.vocab_size, (b, s)).astype(np.int32),
        "mask_a": np.ones((b, s), np.int32),
        "ids_b": rng.randint(5, ARCH.vocab_size, (b, s)).astype(np.int32),
        "mask_b": np.ones((b, s), np.int32),
        "target": rng.rand(b).astype(np.float32),
        "valid": np.ones((b,), np.int32),
    }


def _setup(lr=1e-3, seed=0, cfg=None):
    cfg = cfg or TrainConfig(lr=lr, warmup_ratio=0.0)
    params = {"encoder": init_params(ARCH, torch.Generator().manual_seed(seed))}
    tx = make_optimizer(cfg, total_steps=10, params_example=params)
    state = init_train_state(params, tx, device="cpu")
    step = make_bi_encoder_train_step(ARCH, tx, precision=FP32_PRECISION, device="cpu")
    return tx, state, step, _batch()


def test_trainer_saves_best_and_results(tmp_path):
    _, state, step, batch = _setup()
    calls = {"n": 0}

    def eval_fn(state):
        calls["n"] += 1
        return {"metric": float(calls["n"])}   # strictly improving

    tr = Trainer(step, state, save_path=str(tmp_path), eval_fn=eval_fn, tracked_metric="metric",
                 direction="max", log_every=2, device="cpu")
    result = tr.execute(lambda e: iter([batch] * 5), epochs=3)
    assert result["best_metric"] == 3.0
    for name in ("BEST", "FINAL", "results.jsonl"):
        assert os.path.exists(tmp_path / name)
    assert len(result["history"]) == 3 and result["history"][0]["train"]["loss"] > 0
    with open(tmp_path / "results.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1, 2]
    assert result["state"].step == 15


def test_trainer_resume_restores_step_params_and_optimizer(tmp_path):
    tx, state, step, batch = _setup()
    tr = Trainer(step, state, save_path=str(tmp_path), device="cpu")
    tr.execute(lambda e: iter([batch] * 4), epochs=2)
    _, state2, _, _ = _setup(seed=1)
    tr2 = Trainer(step, state2, save_path=str(tmp_path), device="cpu")
    assert tr2.resume()
    assert tr2.state.step == 8 and tr2.state.opt_state["count"] == 8
    saved = tr.state.params["encoder"]["embeddings"]["word"]
    resumed = tr2.state.params["encoder"]["embeddings"]["word"]
    assert resumed.requires_grad and torch.equal(saved.detach(), resumed.detach())
    torch.testing.assert_close(tr2.state.opt_state["mu"]["encoder"]["embeddings"]["word"],
                               tr.state.opt_state["mu"]["encoder"]["embeddings"]["word"])
    assert not Trainer(step, state2, save_path=str(tmp_path / "none"), device="cpu").resume()


def test_checkpoint_round_trip_with_optimizer_state(tmp_path):
    """params.npz and opt_state.npz restore into the templates' structure,
    dtypes and Python counters."""
    tx, state, step, batch = _setup()
    state, _ = step(state, batch)
    d = ckpt.save_checkpoint(str(tmp_path), state.params, opt_state=state.opt_state, step=1)
    assert os.path.exists(os.path.join(d, "opt_state.npz"))
    params, opt, n, _ = ckpt.restore_checkpoint(d, state.params, state.opt_state)
    assert n == 1 and opt["count"] == 1 and isinstance(opt["count"], int)
    for a, b in ((params, state.params), (opt["nu"], state.opt_state["nu"])):
        w1, w2 = a["encoder"]["layers"]["attn"]["q"]["w"], b["encoder"]["layers"]["attn"]["q"]["w"]
        assert w1.dtype == w2.dtype and torch.equal(w1, w2.detach())
    assert ckpt.restore_checkpoint(d, state.params)[1] is None


def test_trainer_nan_guard():
    _, state, _, batch = _setup()

    def bad_step(state, b):
        return state._replace(step=state.step + 1), {"loss": torch.tensor(float("nan"))}

    tr = Trainer(bad_step, state, log_every=1, device="cpu")
    with pytest.raises(FloatingPointError):
        tr.execute(lambda e: iter([batch]), epochs=1)


def test_device_prefetcher_order_and_errors():
    batches = [{"x": np.full((2, 2), i, np.float32)} for i in range(6)]
    out = list(DevicePrefetcher(iter(batches), depth=2, device="cpu"))
    assert [float(b["x"][0, 0]) for b in out] == list(range(6))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)

    def bad_gen():
        yield {"x": np.zeros((2, 2), np.float32)}
        raise RuntimeError("producer boom")

    pf = DevicePrefetcher(bad_gen(), depth=1, device="cpu")
    next(pf)
    with pytest.raises(RuntimeError, match="producer boom"):
        next(pf)
    with pytest.raises(StopIteration):   # iteration ends after the error
        next(pf)


def test_device_prefetcher_close_releases_producer():
    def endless():
        i = 0
        while True:
            yield {"x": np.full((2,), i, np.float32)}
            i += 1

    pf = DevicePrefetcher(endless(), depth=2, device="cpu")
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    pf.close()   # idempotent
    with pytest.raises(StopIteration):
        next(pf)


def test_trainer_closes_prefetcher_on_step_error(monkeypatch):
    import text_similarity_tpu_torch.train.prefetch as prefetch

    made = []
    real = prefetch.DevicePrefetcher

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(prefetch, "DevicePrefetcher", Spy)
    _, state, _, batch = _setup()

    def failing_step(state, b):
        raise ValueError("step failed")

    tr = Trainer(failing_step, state, device="cpu")
    with pytest.raises(ValueError, match="step failed"):
        tr.execute(lambda e: iter([batch] * 10), epochs=1)
    assert made and not made[0]._thread.is_alive()


def test_trainer_async_checkpoint_correct_and_durable(tmp_path):
    """The snapshot holds the parameters of the step it names, although the
    next steps update the live tensors in place before the writer runs;
    execute() returns only after the final checkpoint is on disk."""
    _, state, step, batch = _setup(lr=1e-2)
    tr = Trainer(step, state, save_path=str(tmp_path), checkpoint_every=2, async_checkpoint=True,
                 device="cpu")
    seen = {}
    real_step = tr.step_fn

    def recording_step(state, b):
        state, m = real_step(state, b)
        seen[state.step] = state.params["encoder"]["embeddings"]["word"].detach().clone()
        return state, m

    tr.step_fn = recording_step
    tr.execute(lambda e: iter([batch] * 4), epochs=1)
    for n in (2, 4):
        tree, _, _ = ckpt.restore_checkpoint_raw(str(tmp_path / f"step_{n:08d}"))
        np.testing.assert_array_equal(tree["encoder"]["embeddings"]["word"], seen[n].numpy())
    with open(tmp_path / "FINAL") as f:
        assert f.read() == "step_00000004"


def test_trainer_async_checkpoint_error_surfaces(tmp_path):
    _, state, step, _ = _setup()
    tr = Trainer(step, state, save_path=str(tmp_path), async_checkpoint=True, device="cpu")
    # a FILE where the writer renames its step dir: the thread fails
    (tmp_path / "step_00000001").write_text("in the way")
    tr._save(1, tag=None)
    with pytest.raises(OSError):
        tr.join_pending_save()
    tr.join_pending_save()   # the error is consumed


def test_grad_accumulation_matches_large_batch():
    """Two accumulation micro-steps of 4 rows give the update of one batch
    of 8 (the mean of the two gradients, one optimizer step)."""
    big = _batch(b=8, seed=1)
    halves = [{k: v[:4] for k, v in big.items()}, {k: v[4:] for k, v in big.items()}]
    base = TrainConfig(lr=1e-3, warmup_ratio=0.0, weight_decay=0.0,
                       max_grad_norm=1e9)

    def run(cfg, batches):
        _, state, _, _ = _setup(cfg=cfg)
        tx = make_optimizer(cfg, total_steps=10, params_example=state.params)
        state = TrainState(state.params, tx.init(state.params), 0, state.rng)
        step = make_bi_encoder_train_step(ARCH, tx, precision=FP32_PRECISION, device="cpu")
        for b in batches:
            state, _ = step(state, b)
        return state.params

    p_big = run(dataclasses.replace(base, grad_accum_steps=1), [big])
    p_acc = run(dataclasses.replace(base, grad_accum_steps=2), halves)
    a = p_big["encoder"]["layers"]["attn"]["q"]["w"].detach()
    b = p_acc["encoder"]["layers"]["attn"]["q"]["w"].detach()
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)

"""Bi-encoder fine-tuning through ``Trainer.execute`` (prefetch on) with
``make_bi_encoder_train_step``: the multiple-negatives ranking loss over
pairs of long documents (a document and the same words reordered), a fixed
set of batches made from the seed and cycled.

Set-up builds one train state and trainer, and drives it from the seed
through its first ``check_steps`` steps, on distinct batches, through the
same ``Trainer.execute`` and step as the window; the window then goes on
with that same trainer. The check follows those first steps with the plain
reference (``reference.train``, the same keep-masks) and compares, by the
worst leaf: ``loss_gap``, the widest gap of a step's loss; ``grad_gap``, the
gap between the norms of the first clipped gradient (the program's worked
out from AdamW's first moment after one step) as a share of the
reference's norm or the median leaf's, whichever is larger; and
``change_gap``, the same of the parameters' change after the steps, over
the leaves whose reference gradient is at least a thousandth of the median
leaf's (the others move by round-off alone).

Variants (read by ``calibrate``): none runs another program; the control
and the faults are the reference put in the program's place."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import flops, gen, trace, weights
from . import Window, cuda_sync

FLASH_FWD = ("flash_fwd_bf16",)
FLASH_BWD = ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")


def leaf_norms(flat: dict) -> dict:
    return {p: float(t.double().norm()) for p, t in flat.items()}


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers from per-leaf norms and losses of two runs."""
    g_p, g_r = prog["grad1"], ref["grad1"]
    med_g = float(np.median(list(g_r.values())))
    grad_gap = max(abs(g_p[p] - g_r[p]) / max(g_r[p], med_g) for p in g_r)
    moved = [p for p in g_r if g_r[p] >= 1e-3 * med_g]
    d_p, d_r = prog["delta"], ref["delta"]
    med_d = float(np.median([d_r[p] for p in moved]))
    change_gap = max(abs(d_p[p] - d_r[p]) / max(d_r[p], med_d) for p in moved)
    loss_gap = max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"]))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


class Cell:
    unit = "step"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device="cuda", variant=None):
        self.cfg, self.t, self.seed, self.device = cfg, traffic, int(seed), torch.device(device)
        self.variant = variant
        self.fields = weights.arch_fields(cfg)
        self.sync = cuda_sync(self.device)
        self.gen_seed = gen.torch_seed(self.seed, 5)

    def opt(self) -> dict:
        t = self.t
        return {"lr": t["lr"], "total_steps": t["total_steps"],
                "warmup_steps": int(t["total_steps"] * t["warmup_ratio"]),
                "adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-8,
                "weight_decay": t["weight_decay"], "max_grad_norm": t["max_grad_norm"]}

    def setup(self) -> None:
        from text_similarity_tpu_torch.core.config import EncoderArch, TrainConfig
        from text_similarity_tpu_torch.train import (
            Trainer, init_train_state, make_bi_encoder_train_step, make_optimizer,
        )

        t = self.t
        n = t["batches"] * t["pairs_per_step"]
        pairs, _ = gen.document_pairs(n, *t["doc_tokens"], gen.rng_for(self.seed, 1))
        self.batches = gen.pair_batches(pairs, t["pairs_per_step"], t["bucket"], t["bucket"])
        self.tokens = [int(b["mask_a"].sum() + b["mask_b"].sum()) for b in self.batches]
        self.lens = [(b["mask_a"].sum(1), b["mask_b"].sum(1)) for b in self.batches]
        arch = EncoderArch(**self.fields)
        params = weights.make_params(self.fields, gen.torch_seed(self.seed, 0), self.device)
        o = self.opt()
        cfg = TrainConfig(lr=o["lr"], weight_decay=o["weight_decay"],
                          warmup_ratio=t["warmup_ratio"], max_grad_norm=o["max_grad_norm"])
        tx = make_optimizer(cfg, t["total_steps"], params_example={"encoder": params})
        state = init_train_state({"encoder": params}, tx, seed=self.gen_seed, device=self.device)
        del params
        step = make_bi_encoder_train_step(arch, tx, loss_type="mnrl", pooling="mean",
                                          device=self.device)
        inner_tx = tx.step

        def tx_step(*a, **kw):
            with trace.span("optimizer"):
                return inner_tx(*a, **kw)

        tx.step = tx_step
        self.losses, self.done = [], 0
        self.b1 = o["adam_b1"]
        self.snap = {}
        k = t["check_steps"]

        def watched(st, batch):
            if self.done == 0:
                self.snap["p0"] = {p: v.detach().clone()
                                   for p, v in weights.flatten(st.params["encoder"]).items()}
            with trace.span("train_step"):
                st, metrics = step(st, batch)
            self.done += 1
            if self.done <= k:
                self.losses.append(metrics["loss"])
            if self.done == 1:
                self.snap["g1"] = {p: v / (1.0 - self.b1) for p, v in weights.flatten(
                    st.opt_state["mu"]["encoder"]).items()}
            if self.done == k:
                self.snap["pk"] = {p: v.detach().clone()
                                   for p, v in weights.flatten(st.params["encoder"]).items()}
            return st, metrics

        self.trainer = Trainer(watched, state, log_every=t["log_every"], prefetch=t["prefetch"],
                               device=self.device)
        self.trainer.execute(lambda e: iter(self.batches[:k]), epochs=1, write_results=False)
        self.sync()
        self.readings = self._program_readings()
        self.next = k

    def _program_readings(self) -> dict:
        s = self.snap
        return {"losses": [float(x) for x in self.losses],
                "grad1": leaf_norms(s.pop("g1")),
                "delta": leaf_norms({p: s["pk"][p] - s["p0"][p] for p in s["p0"]})}

    def _run(self, deadline=None, n_steps=None) -> list:
        """Steps through ``Trainer.execute`` over the batches in turn, until
        ``deadline`` (checked as the prefetcher takes the next batch) or for
        ``n_steps`` → the batch indices fed."""
        fed = []
        nb = len(self.batches)

        def feed():
            while True:
                if n_steps is not None and len(fed) >= n_steps:
                    return
                if deadline is not None and time.perf_counter() >= deadline:
                    return
                b = self.next % nb
                self.next += 1
                fed.append(b)
                yield self.batches[b]

        self.trainer.execute(lambda e: feed(), epochs=1, write_results=False)
        self.sync()
        return fed

    def window(self, seconds: float) -> Window:
        win = Window()
        self.sync()
        t0 = time.perf_counter()
        start_done = self.done
        fed = self._run(deadline=t0 + seconds)
        win.wall_s = time.perf_counter() - t0
        ran = fed[: self.done - start_done]
        win.work = [float(self.tokens[b]) for b in ran]
        win.latencies = [win.wall_s / max(len(ran), 1)] * len(ran)
        win.tags = ran
        self.window_batches = ran
        return win

    def traced(self) -> int:
        n = self.t["trace_steps"]
        self.traced_batches = self._run(n_steps=n)
        return n

    def e2e(self, win: Window) -> dict:
        return {"train_tokens_per_s": win.rate()}

    def layer_ctx(self, win: Window, reading) -> dict:
        f = self.fields
        nh, hd = f["num_heads"], f["hidden_size"] // f["num_heads"]
        w, cls, L = f["attention_window"], f["window_global_cls"], f["num_layers"]
        non_emb = weights.non_embedding_params(f)
        width = self.t["bucket"]
        useful = 0.0
        for b in self.window_batches:
            for lens in self.lens[b]:
                useful += 6.0 * non_emb * float(lens.sum()) + 3 * 4.0 * f["hidden_size"] * L * \
                    flops.band_pairs(lens, w, cls)
        fwd, bwd = [], []
        for b in self.traced_batches:
            for lens in self.lens[b]:
                fwd += [flops.flash_fwd(len(lens), width, nh, hd, lens, w, cls)] * L
                bwd += [flops.flash_bwd(len(lens), width, nh, hd, lens, w, cls)] * L
        return {"window": win, "reading": reading, "useful_flops": useful,
                "flash_fwd_work": fwd, "flash_fwd_kernels": FLASH_FWD,
                "flash_bwd_work": bwd, "flash_bwd_kernels": FLASH_BWD,
                "optimizer_range": "optimizer"}

    def free(self) -> None:
        self.trainer = None
        self.snap = {}

    def reference(self, lowp=None, fault=None) -> dict:
        from ..reference import encoder as E
        from ..reference import train as R

        E.no_tf32()
        k = self.t["check_steps"]
        flat0 = weights.make_flat(self.fields, gen.torch_seed(self.seed, 0), self.device)
        dev_batches = [{key: torch.as_tensor(v, device=self.device) for key, v in b.items()}
                       for b in self.batches[:k]]
        out = R.follow(flat0, self.fields, dev_batches, self.gen_seed, self.opt(), k, lowp, fault)
        return {"losses": out["losses"], "grad1": leaf_norms(out["grad1"]),
                "delta": leaf_norms(out["delta"])}

    def check(self) -> dict:
        return gaps(self.readings, self.reference())


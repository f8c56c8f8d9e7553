"""Distillation (port of ``text_similarity_tpu.compress.distill``): a
layer-drop student initialised from a subset of the teacher's layers, then
trained to the teacher's sentence embeddings (``SentenceEncoderDistiller``,
with the multilingual teacher → student mode), to PCA-reduced teacher
embeddings through a new projection (``DimReducingDistiller``), or to a
classifier teacher's logits and hidden states (``FastFormersDistiller``).

The layers are stacked on a leading axis, so "keep layers [0, 2, 4]" is
one gather. The student's leaves are copies, never views of the teacher's
tensors: the optimizer updates the student in place. Teacher targets are
computed once, in one encode of the training sentences, before the
steps. Training runs on the teacher's device. (``train`` and ``models``
are imported where they run: ``models.encoder`` imports
``compress.quantize``.)
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import EncoderArch, TrainConfig
from ..core.precision import precision_for
from ..data.pairs import build_distill_batches
from ..utils.logging import get_logger

logger = get_logger("distill")


def _copy(tree: dict) -> dict:
    return {k: _copy(v) if isinstance(v, dict) else v.detach().clone() for k, v in tree.items()}


def extract_student_layers(teacher_params: dict, keep_layers: Sequence[int]) -> dict:
    """The teacher's encoder params with only the stacked layers
    ``keep_layers``, every leaf a copy."""
    student = {k: _copy(v) for k, v in teacher_params.items() if k != "layers"}
    layers = teacher_params["layers"]
    idx = torch.as_tensor(list(keep_layers), dtype=torch.long)

    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v.detach()[idx.to(v.device)]
                for k, v in tree.items()}

    student["layers"] = take(layers)
    return student


def every_other_layers(num_layers: int, keep: int) -> List[int]:
    """An evenly spaced subset of ``keep`` layers, the last always kept."""
    if keep >= num_layers:
        return list(range(num_layers))
    idx = np.linspace(0, num_layers - 1, keep)
    return sorted({int(round(i)) for i in idx})


def pca_reduce(emb: np.ndarray, dim: int, device="cuda"):
    """The PCA projection of teacher embeddings to ``dim`` (a student with a
    narrower output learns the teacher's geometry) → (reduced (N, dim),
    (mean, components)), numpy; the SVD runs on ``device``."""
    from ..ops.pca import pca_fit_transform

    from ..core.precision import resolve_device

    x = torch.as_tensor(np.asarray(emb, np.float32)).to(resolve_device(device))
    reduced, mu, comp = pca_fit_transform(x, dim)
    return reduced.cpu().numpy(), (mu.cpu().numpy(), comp.cpu().numpy())


class SentenceEncoderDistiller:
    """Distil a ``SentenceEncoder`` teacher into a shallower student."""

    def __init__(
        self,
        teacher,                       # SentenceEncoder
        keep_layers: Optional[Sequence[int]] = None,
        num_student_layers: Optional[int] = None,
        train_config: TrainConfig = TrainConfig(lr=1e-4, epochs=1),
    ):
        self.teacher = teacher
        if keep_layers is None:
            keep_layers = every_other_layers(
                teacher.arch.num_layers, num_student_layers or teacher.arch.num_layers // 2)
        self.keep_layers = list(keep_layers)
        self.cfg = train_config
        self.student_arch = teacher.arch.replace(num_layers=len(self.keep_layers))

    def _targets(self, sentences, src_sentences, bs):
        teacher_inputs = list(src_sentences or sentences)
        logger.info("computing teacher targets for %d sentences", len(teacher_inputs))
        return self.teacher.encode(teacher_inputs, batch_size=bs)

    def _train(self, params, batches, eval_fn, label):
        """The distill-MSE steps (remat on) over ``batches`` for the
        configured epochs → the student ``SentenceEncoder``."""
        from ..models.sentence_encoder import SentenceEncoder
        from ..train import init_train_state, make_bi_encoder_train_step, make_optimizer

        dev = self.teacher.device
        params = {"encoder": params}
        tx = make_optimizer(self.cfg, len(batches) * self.cfg.epochs, params_example=params)
        state = init_train_state(params, tx, seed=self.cfg.seed, device=dev)
        step = make_bi_encoder_train_step(
            self.student_arch, tx, loss_type="distill_mse", pooling=self.teacher.pooling,
            precision=precision_for(self.cfg.bf16), remat=True, device=dev,
        )
        for epoch in range(self.cfg.epochs):
            pend = []
            for b in batches:
                state, m = step(state, b)
                pend.append(m["loss"])
            losses = torch.stack(pend).cpu().tolist()     # one sync an epoch
            logger.info("%s epoch %d: mse %.6f -> %.6f", label, epoch, losses[0],
                        np.mean(losses[-10:]))
            if eval_fn is not None:
                logger.info("eval: %s", eval_fn(state))
        return SentenceEncoder(
            state.params["encoder"], self.student_arch, tokenizer=self.teacher.tokenizer,
            pooling=self.teacher.pooling, precision=self.teacher.precision, device=dev,
        )

    def distill(
        self,
        sentences: Sequence[str],
        eval_fn: Optional[Callable] = None,
        src_sentences: Optional[Sequence[str]] = None,
        batch_size: Optional[int] = None,
        max_len: int = 128,
    ):
        """Train the student to the teacher's embeddings of ``sentences`` →
        the student ``SentenceEncoder``. Multilingual mode: the teacher
        encodes ``src_sentences`` (e.g. the English side) and the student
        learns both sides against them."""
        bs = batch_size or self.cfg.batch_size
        teacher_emb = self._targets(sentences, src_sentences, bs)
        batches = build_distill_batches(
            self.teacher.tokenizer, list(sentences), teacher_emb, batch_size=bs,
            max_len=max_len, seed=self.cfg.seed,
            src_sentences=list(src_sentences) if src_sentences is not None else None,
        )
        student = extract_student_layers(self.teacher.params, self.keep_layers)
        return self._train(student, batches, eval_fn, "distill")


class DimReducingDistiller(SentenceEncoderDistiller):
    """Layer drop and a narrower output: the student keeps a layer subset
    and gains a new (H, student_dim) projection head, trained against the
    PCA-reduced teacher embeddings (``self.pca`` holds the mean and the
    components)."""

    def __init__(self, teacher, student_dim: int, **kw):
        super().__init__(teacher, **kw)
        self.student_dim = student_dim
        self.student_arch = self.student_arch.replace(projection_dim=student_dim)
        self.pca = None

    def distill(
        self,
        sentences,
        eval_fn: Optional[Callable] = None,
        src_sentences: Optional[Sequence[str]] = None,
        batch_size=None,
        max_len: int = 128,
    ):
        bs = batch_size or self.cfg.batch_size
        teacher_emb = self._targets(sentences, src_sentences, bs)
        reduced, self.pca = pca_reduce(teacher_emb, self.student_dim, self.teacher.device)
        batches = build_distill_batches(
            self.teacher.tokenizer, list(sentences), reduced, batch_size=bs, max_len=max_len,
            seed=self.cfg.seed,
            src_sentences=list(src_sentences) if src_sentences is not None else None,
        )
        student = extract_student_layers(self.teacher.params, self.keep_layers)
        g = torch.Generator().manual_seed(self.cfg.seed)
        h = self.teacher.arch.hidden_size
        student["projection"] = {
            "w": torch.randn((h, self.student_dim), generator=g) * 0.02,
            "b": torch.zeros((self.student_dim,)),
        }
        return self._train(student, batches, eval_fn, "dim-reduce distill")


class FastFormersDistiller:
    """Classifier distillation: the teacher's logits (temperature-scaled
    KL), its layer-mapped hidden states (MSE) and optionally the hard labels
    (CE), through ``train.steps.make_fastformers_distill_step`` on the
    teacher's device."""

    def __init__(
        self,
        teacher_params: dict,            # {"encoder", "head"} tensors
        teacher_arch: EncoderArch,
        keep_layers: Optional[Sequence[int]] = None,
        num_student_layers: Optional[int] = None,
        train_config: TrainConfig = TrainConfig(lr=5e-5, epochs=1),
        temperature: float = 2.0,
        alpha_kl: float = 1.0,
        alpha_state: float = 1.0,
        alpha_ce: float = 0.0,
        pooling: str = "cls",
    ):
        self.teacher_params = teacher_params
        self.teacher_arch = teacher_arch
        if keep_layers is None:
            keep_layers = every_other_layers(
                teacher_arch.num_layers, num_student_layers or teacher_arch.num_layers // 2)
        self.keep_layers = list(keep_layers)
        self.student_arch = teacher_arch.replace(num_layers=len(self.keep_layers))
        self.cfg = train_config
        self.kw = dict(temperature=temperature, alpha_kl=alpha_kl, alpha_state=alpha_state,
                       alpha_ce=alpha_ce, pooling=pooling)

    def distill(self, batches: Sequence[dict]):
        """batches: dicts with ids / mask (type_ids / labels / valid) →
        (student params, one metrics dict of floats a step)."""
        from ..train import init_train_state, make_fastformers_distill_step, make_optimizer

        dev = self.teacher_params["head"]["w"].device
        student_params = {
            "encoder": extract_student_layers(self.teacher_params["encoder"], self.keep_layers),
            "head": _copy(self.teacher_params["head"]),
        }
        tx = make_optimizer(self.cfg, max(len(batches) * self.cfg.epochs, 1),
                            params_example=student_params)
        state = init_train_state(student_params, tx, seed=self.cfg.seed, device=dev)
        # student layer i starts from teacher layer keep_layers[i]: the
        # state MSE aligns with those hidden states
        layer_map = np.asarray([0] + [k + 1 for k in self.keep_layers], np.int32)
        step = make_fastformers_distill_step(
            self.student_arch, self.teacher_arch, tx, precision=precision_for(self.cfg.bf16),
            layer_map=layer_map, device=dev, **self.kw,
        )
        history = []
        for epoch in range(self.cfg.epochs):
            pend = []
            for b in batches:
                state, m = step(state, b, self.teacher_params)
                pend.append(m)
            history.extend({k: float(v) for k, v in m.items()} for m in pend)
            logger.info("fastformers epoch %d: loss %.4f -> %.4f (kl %.4f)", epoch,
                        history[0]["loss"], history[-1]["loss"], history[-1]["kl"])
        return state.params, history

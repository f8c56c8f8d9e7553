"""Metric meters (the port's copy of
``text_similarity_tpu.evaluation.meters``), host-side numpy run once per
evaluation:

- ``AverageMeter`` / ``Metrics``: running averages of named scalars
- ``similarity_metrics``: Pearson and Spearman of gold scores against
  cosine, euclidean, manhattan and dot similarity, and the largest
  Spearman
- ``best_threshold_accuracy`` / ``best_threshold_f1``: the best cut of the
  sorted scores (no cut between tied scores)
- ``average_precision``: tied scores grouped at one threshold, as sklearn
- ``binary_similarity_report``: the three above over cosine scores
- ``retrieval_accuracy``: bitext argmax retrieval in both directions
- ``classification_metrics``: accuracy and macro F1 of logits
- ``roc_curve`` / ``save_roc_plot``
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
from scipy.stats import pearsonr, spearmanr


class AverageMeter:
    """Running average of a scalar (reference metrics.py:125-161)."""

    def __init__(self, name: str = "meter"):
        self.name = name
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class Metrics:
    """Bundle of named meters (reference metrics.py:104-122)."""

    def __init__(self, *names: str):
        self.meters = {n: AverageMeter(n) for n in names}

    def update(self, name: str, val: float, n: int = 1):
        self.meters[name].update(val, n)

    def averages(self) -> Dict[str, float]:
        return {n: m.avg for n, m in self.meters.items()}

    def display(self) -> str:
        return " ".join(f"{n}={m.avg:.4f}" for n, m in self.meters.items())


# ---------------------------------------------------------------------------
# Similarity correlation metrics
# ---------------------------------------------------------------------------

def _cosine(u, v):
    un = np.linalg.norm(u, axis=1)
    vn = np.linalg.norm(v, axis=1)
    return np.sum(u * v, axis=1) / np.maximum(un * vn, 1e-12)


def similarity_metrics(
    u: np.ndarray, v: np.ndarray, gold: np.ndarray
) -> Dict[str, float]:
    """Pearson/Spearman between gold scores and 4 similarity functions;
    also reports the max Spearman (the reference's tracked ``embed_sim``)."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    gold = np.asarray(gold, np.float64)

    sims = {
        "cosine": _cosine(u, v),
        "euclidean": -np.linalg.norm(u - v, axis=1),
        "manhattan": -np.sum(np.abs(u - v), axis=1),
        "dot": np.sum(u * v, axis=1),
    }
    out: Dict[str, float] = {}
    for name, s in sims.items():
        out[f"pearson_{name}"] = float(pearsonr(gold, s)[0])
        out[f"spearman_{name}"] = float(spearmanr(gold, s)[0])
    out["spearman_max"] = max(out[f"spearman_{n}"] for n in sims)
    return out


# ---------------------------------------------------------------------------
# Best-threshold binary metrics
# ---------------------------------------------------------------------------

def best_threshold_accuracy(
    scores: np.ndarray, labels: np.ndarray
) -> Dict[str, float]:
    """Max accuracy over thresholds placed between consecutive sorted
    scores; higher score = predicted positive (reference metrics.py:276-314,
    itself the sentence-transformers BinaryClassificationEvaluator rule)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(int)
    order = np.argsort(-scores, kind="stable")   # deterministic under ties
    s, l = scores[order], labels[order]
    total = len(l)
    if total == 0:
        return {"accuracy": 0.0, "threshold": 0.0}
    pos_total = int(l.sum())

    # start from the all-negative predictor (threshold above every score)
    # so 0/1-pair inputs don't return the -1 sentinel
    best_acc = (total - pos_total) / total
    best_thr = float(s[0]) + 1.0
    tp = 0
    for i in range(total - 1):
        tp += l[i]
        if s[i] == s[i + 1]:
            # no realizable threshold separates tied scores — counting a
            # cut here would overstate accuracy (same rule as the
            # tie-grouped AP below)
            continue
        # predict positive for items 0..i
        correct = tp + ((total - i - 1) - (pos_total - tp))
        acc = correct / total
        if acc > best_acc:
            best_acc = acc
            best_thr = (s[i] + s[i + 1]) / 2
    return {"accuracy": float(best_acc), "threshold": float(best_thr)}


def best_threshold_f1(
    scores: np.ndarray, labels: np.ndarray
) -> Dict[str, float]:
    """Max F1 over the same threshold sweep (reference metrics.py:406-447),
    with the precision/recall at the best point."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(int)
    order = np.argsort(-scores, kind="stable")   # deterministic under ties
    s, l = scores[order], labels[order]
    pos_total = max(int(l.sum()), 1)

    best = {"f1": 0.0, "precision": 0.0, "recall": 0.0, "threshold": 0.0}
    tp = 0
    for i in range(len(l) - 1):
        tp += l[i]
        if s[i] == s[i + 1]:
            continue   # unrealizable cut between tied scores
        npred = i + 1
        precision = tp / npred
        recall = tp / pos_total
        if precision + recall > 0:
            f1 = 2 * precision * recall / (precision + recall)
            if f1 > best["f1"]:
                best = {
                    "f1": float(f1),
                    "precision": float(precision),
                    "recall": float(recall),
                    "threshold": float((s[i] + s[i + 1]) / 2),
                }
    return best


def average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
    """AP of ranking positives above negatives (reference metrics.py:383-403
    delegates to sklearn.average_precision_score). Tied scores are grouped
    at one threshold exactly as sklearn does — a per-item sweep would give
    order-dependent AP whenever scores tie (common with bf16/int8 cosine
    scores)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    pos = int(labels.sum())
    if pos == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    s, y = scores[order], labels[order]
    tp = np.cumsum(y)
    fp = np.cumsum(~y)
    # evaluate at the LAST index of each distinct threshold (groups ties)
    distinct = np.r_[np.nonzero(np.diff(s))[0], s.size - 1]
    tp_t, fp_t = tp[distinct], fp[distinct]
    precision = tp_t / np.maximum(tp_t + fp_t, 1)
    recall = tp_t / pos
    prev_recall = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - prev_recall) * precision))


def binary_similarity_report(
    u: np.ndarray, v: np.ndarray, labels: np.ndarray
) -> Dict[str, float]:
    """Cosine scores → best-threshold acc, F1, AP (the PAWS/Quora paraphrase
    eval bundle, reference evaluators.py:57-96)."""
    scores = _cosine(np.asarray(u, np.float64), np.asarray(v, np.float64))
    out = {}
    out.update(best_threshold_accuracy(scores, labels))
    f1 = best_threshold_f1(scores, labels)
    out["f1"] = f1["f1"]
    out["precision"] = f1["precision"]
    out["recall"] = f1["recall"]
    out["average_precision"] = average_precision(scores, labels)
    return out


# ---------------------------------------------------------------------------
# Bitext retrieval
# ---------------------------------------------------------------------------

def retrieval_accuracy(
    src: np.ndarray, tgt: np.ndarray
) -> Dict[str, float]:
    """Tatoeba-style bitext retrieval: fraction of rows whose argmax over
    the full cosine matrix is the aligned translation, both directions
    (reference metrics.py:469-507)."""
    src = np.asarray(src, np.float64)
    tgt = np.asarray(tgt, np.float64)
    src = src / np.maximum(np.linalg.norm(src, axis=1, keepdims=True), 1e-12)
    tgt = tgt / np.maximum(np.linalg.norm(tgt, axis=1, keepdims=True), 1e-12)
    sim = src @ tgt.T
    n = sim.shape[0]
    s2t = float(np.mean(np.argmax(sim, axis=1) == np.arange(n)))
    t2s = float(np.mean(np.argmax(sim, axis=0) == np.arange(n)))
    return {"acc_src2tgt": s2t, "acc_tgt2src": t2s, "acc_mean": (s2t + t2s) / 2}


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------

def classification_metrics(
    logits: np.ndarray, labels: np.ndarray
) -> Dict[str, float]:
    pred = np.argmax(np.asarray(logits), axis=-1)
    labels = np.asarray(labels)
    acc = float(np.mean(pred == labels))
    # macro F1
    f1s = []
    for c in np.unique(labels):
        tp = np.sum((pred == c) & (labels == c))
        fp = np.sum((pred == c) & (labels != c))
        fn = np.sum((pred != c) & (labels == c))
        p = tp / max(tp + fp, 1)
        r = tp / max(tp + fn, 1)
        f1s.append(2 * p * r / max(p + r, 1e-12))
    return {"accuracy": acc, "macro_f1": float(np.mean(f1s))}


def roc_curve(scores: np.ndarray, labels: np.ndarray):
    """ROC curve points + AUC from raw scores (reference plot_roc,
    src/utils/metrics.py:64-79, which delegates to sklearn.roc_curve —
    here self-contained). Returns (fpr, tpr, thresholds, auc)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    order = np.argsort(-scores, kind="stable")
    s, y = scores[order], labels[order]
    tp = np.cumsum(y)
    fp = np.cumsum(~y)
    # keep the last index of each distinct threshold
    distinct = np.r_[np.nonzero(np.diff(s))[0], s.size - 1]
    tp, fp, thr = tp[distinct], fp[distinct], s[distinct]
    p = max(int(labels.sum()), 1)
    n = max(int((~labels).sum()), 1)
    tpr = np.r_[0.0, tp / p]
    fpr = np.r_[0.0, fp / n]
    trapezoid = getattr(np, "trapezoid", None) or np.trapz   # numpy < 2: trapz
    auc = float(trapezoid(tpr, fpr))
    return fpr, tpr, np.r_[np.inf, thr], auc


def save_roc_plot(path: str, scores, labels) -> bool:
    """Write a ROC plot PNG if matplotlib is importable; otherwise write
    the curve as CSV next to it. Returns True if a PNG was written."""
    fpr, tpr, _, auc = roc_curve(scores, labels)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(4, 4))
        ax.plot(fpr, tpr, label=f"AUC={auc:.3f}")
        ax.plot([0, 1], [0, 1], "--", lw=0.8)
        ax.set_xlabel("FPR"); ax.set_ylabel("TPR"); ax.legend()
        fig.savefig(path, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return True
    except Exception:
        np.savetxt(
            path + ".csv",
            np.c_[fpr, tpr],
            delimiter=",",
            header="fpr,tpr",
        )
        return False

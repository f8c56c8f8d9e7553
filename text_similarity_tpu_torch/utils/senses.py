"""Sense-embedding banks, ARES / LMMS style (a copy of
``text_similarity_tpu.utils.senses``, which imports no JAX: the port keeps
its own).

Load text-format sense embeddings ("sense_key v1 v2 ... vD" a line) into a
key → vector map, reduce their width (a truncated SVD in numpy), and build
the dense (S, D) bank and key list that ``models.word_encoder.match_sense``
matches against. The WordNet sense-key conventions are kept, so ARES and
LMMS files load unchanged."""

from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, encoding="utf-8")


def load_sense_embeddings(
    path: str,
    max_senses: Optional[int] = None,
    skip_header: bool = True,
) -> Dict[str, np.ndarray]:
    """Parse "key v1 ... vD" lines (ARES/LMMS text format; first line is
    usually a count/dim header)."""
    out: Dict[str, np.ndarray] = {}
    with _open(path) as f:
        for i, line in enumerate(f):
            if i == 0 and skip_header:
                parts = line.split()
                if len(parts) == 2 and all(p.isdigit() for p in parts):
                    continue
            parts = line.rstrip().split(" ")
            if len(parts) < 3:
                continue
            key = parts[0]
            try:
                vec = np.asarray([float(x) for x in parts[1:]], np.float32)
            except ValueError:
                continue
            out[key] = vec
            if max_senses and len(out) >= max_senses:
                break
    return out


def reduce_dim(
    bank: Dict[str, np.ndarray], dim: int
) -> Dict[str, np.ndarray]:
    """TruncatedSVD-style reduction (reference utils.py:281-315).

    Like sklearn's TruncatedSVD the matrix is NOT mean-centered: centering
    would shift every reduced vector by a projection of the mean and
    change cosine 1-NN winners vs the reference's reduced bank."""
    keys = list(bank.keys())
    mat = np.stack([bank[k] for k in keys])
    # economy SVD; project onto top-`dim` right singular vectors
    _, _, vt = np.linalg.svd(mat, full_matrices=False)
    red = mat @ vt[:dim].T
    return {k: red[i].astype(np.float32) for i, k in enumerate(keys)}


def sense_key_lemma(key: str) -> str:
    """'long%3:00:02::' → 'long' (WordNet sense-key convention)."""
    return key.split("%")[0]


def build_sense_bank(
    bank: Dict[str, np.ndarray],
    restrict_lemmas: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, List[str]]:
    """Dense (S, D) matrix + key list, optionally restricted to lemmas
    (per-word candidate filtering, reference utils.py:190-262)."""
    if restrict_lemmas is not None:
        lemmas = set(restrict_lemmas)
        items = [
            (k, v) for k, v in bank.items() if sense_key_lemma(k) in lemmas
        ]
    else:
        items = list(bank.items())
    if not items:
        raise ValueError("empty sense bank after filtering")
    keys = [k for k, _ in items]
    mat = np.stack([v for _, v in items]).astype(np.float32)
    return mat, keys


def save_sense_bank(path: str, bank: Dict[str, np.ndarray]) -> None:
    keys = list(bank.keys())
    np.savez(
        path,
        # fixed-width unicode (no object dtype): loads with
        # allow_pickle=False, keeping the repo's no-pickle persistence rule
        keys=np.asarray(keys, dtype=np.str_),
        vectors=np.stack([bank[k] for k in keys]),
    )


def load_sense_bank_npz(path: str) -> Dict[str, np.ndarray]:
    import os

    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"   # np.savez appends the suffix
    with np.load(path, allow_pickle=False) as z:
        return {str(k): v for k, v in zip(z["keys"], z["vectors"])}

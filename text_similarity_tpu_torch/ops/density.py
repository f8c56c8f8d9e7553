"""Density-based clustering of unit vectors (port of
``text_similarity_tpu.ops.density``): DBSCAN at a fixed cosine radius and
an HDBSCAN-class multi-radius selection.

- The ε-neighbourhood graph is a thresholded cosine product, computed
  ``chunk`` rows at a time (``torch.matmul``, as the reference leaves it to
  XLA), so the (N, N) similarity never materialises.
- Connected components resolve by min-label propagation with pointer
  jumping: labels are representative row ids, so ``labels[labels]``
  halves a chain's depth; a sweep ends when no label changed (a host read
  a sweep, the reference's ``while_loop`` condition).
- ``hdbscan_cosine`` runs DBSCAN over an ascending ladder of radii, builds
  the condensed cluster tree from the (m, N) label matrix on the host and
  selects clusters by excess of mass (the reference's host code, copied).

Core points (≥ min_samples neighbours, itself included) merge through
core-core edges; a border point takes the smallest label of its core
neighbours; the rest is noise (−1). Everything runs on ``x``'s device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _compact_labels(labels: np.ndarray) -> np.ndarray:
    """Labels renumbered 0..k−1 in order of first appearance (noise stays
    −1)."""
    out = np.full(labels.shape, -1, np.int64)
    seen: dict = {}
    for i, lab in enumerate(labels):
        if lab < 0:
            continue
        if lab not in seen:
            seen[lab] = len(seen)
        out[i] = seen[lab]
    return out


def dbscan_cosine(
    x,                       # (N, D) L2-normalised
    eps: float = 0.3,        # cosine-distance radius
    min_samples: int = 5,
    max_sweeps: int = 0,     # 0: at most N sweeps (the loop ends when nothing changes)
    chunk: int = 1024,       # rows a block of the adjacency (memory N · chunk)
) -> np.ndarray:
    """→ (N,) int64 labels, −1 = noise, the clusters numbered 0..k−1 in
    order of first appearance. ``dbscan_cosine.sweeps`` holds the number
    of propagation sweeps the last call took."""
    x = torch.as_tensor(x).float()
    n = x.shape[0]
    chunk = min(int(chunk), -(-n // 8) * 8)
    labels, dbscan_cosine.sweeps = _dbscan_device(x, float(eps), int(min_samples),
                                                  int(max_sweeps), chunk)
    return _compact_labels(labels.cpu().numpy()[:n])


dbscan_cosine.sweeps = 0


def _dbscan_device(x: torch.Tensor, eps: float, min_samples: int, max_sweeps: int,
                   chunk: int):
    """→ ((N_padded,) labels, the sweeps taken)."""
    n, d = x.shape
    dev = x.device
    xp = torch.cat([x, x.new_zeros(((-n) % chunk, d))])
    nb = xp.shape[0]
    valid = torch.arange(nb, device=dev) < n
    thr = float(np.float32(1.0 - np.float32(eps)))
    sent = nb                                   # "no label"

    def blocks():
        for st in range(0, nb, chunk):
            yield xp[st:st + chunk] @ xp.T      # (chunk, N) cosines

    deg = torch.cat([((s >= thr) & valid[None]).sum(dim=1) for s in blocks()])
    core = (deg >= min_samples) & valid
    labels = torch.where(core, torch.arange(nb, device=dev), torch.full((nb,), sent, device=dev))

    def neighbor_min(lab):
        # the smallest label among each row's core neighbours
        out = []
        for s in blocks():
            adj = (s >= thr) & core[None]
            out.append(torch.where(adj, lab[None], sent).amin(dim=1))
        return torch.cat(out)

    sweeps = 0
    for sweeps in range(1, (max_sweeps or nb) + 1):
        new = torch.where(core, torch.minimum(labels, neighbor_min(labels)), labels)
        for _ in range(2):                      # pointer jumping, twice a sweep
            jumped = new[new.clamp(0, nb - 1)]
            new = torch.where(new < sent, torch.minimum(new, jumped), new)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    labels = torch.where(core, labels, neighbor_min(labels))   # border points
    return torch.where(labels >= sent, -1, labels), sweeps


DEFAULT_EPS_GRID = (0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.55)


def hdbscan_cosine(
    x,                                           # (N, D) L2-normalised
    eps_grid: Optional[Sequence[float]] = None,  # cosine radii
    min_samples: int = 5,
    chunk: int = 1024,
) -> np.ndarray:
    """Variable-density clustering with no single ε → (N,) labels, −1 =
    noise: DBSCAN at each radius of the ladder gives clusters nested
    across the density levels λ = 1/ε; each condensed cluster's stability
    Σ_p (λ_leave(p) − λ_birth) is weighed against its children's sum
    (excess of mass)."""
    eps_grid = sorted(eps_grid or DEFAULT_EPS_GRID)
    x = torch.as_tensor(x).float()
    levels = np.stack([dbscan_cosine(x, eps=e, min_samples=min_samples, chunk=chunk)
                       for e in eps_grid])      # (m, N), tight → loose
    lam = np.asarray([1.0 / e for e in eps_grid])
    return _stability_select(levels, lam, x.shape[0])


def _stability_select(levels: np.ndarray, lam: np.ndarray, n: int) -> np.ndarray:
    """The condensed tree and the excess-of-mass selection on the host.
    ``levels[i]`` holds the labels at density λ_i (descending); clusters at
    level i lie inside clusters at level i + 1."""
    m = levels.shape[0]

    class Node:
        __slots__ = ("level", "label", "members", "birth_lam", "stab", "children",
                     "chain_members")

        def __init__(self, level, label, members):
            self.level = level
            self.label = label
            self.members = members
            self.birth_lam = None
            self.stab = 0.0
            self.children = []
            self.chain_members = None

    raw: dict = {}
    for i in range(m):
        labs = levels[i]
        for lab in np.unique(labs):
            if lab < 0:
                continue
            raw[(i, int(lab))] = np.nonzero(labs == lab)[0]

    # a cluster at level i lies in one cluster at level i + 1 (border
    # points can break containment: the majority parent)
    child_of: dict = {}
    for (i, lab), rows in raw.items():
        if i == m - 1:
            continue
        up = levels[i + 1][rows]
        up = up[up >= 0]
        if up.size == 0:
            continue
        vals, cnts = np.unique(up, return_counts=True)
        child_of.setdefault((i + 1, int(vals[np.argmax(cnts)])), []).append((i, lab))

    def build(key, birth_lam):
        # a single child extends the chain (the same cluster at a denser
        # λ); several split it
        i, lab = key
        node = Node(i, lab, raw[key])
        node.birth_lam = birth_lam
        leave = np.full(len(node.members), birth_lam)
        ck = key
        while True:
            kids = child_of.get(ck, [])
            if len(kids) != 1:
                break
            ck = kids[0]
            still = np.isin(node.members, raw[ck])
            leave = np.where(still, lam[ck[0]], leave)
        in_end = np.isin(node.members, raw[ck])
        leave = np.where(in_end, lam[ck[0]], leave)
        node.stab = float(np.sum(leave - birth_lam))
        node.chain_members = raw[ck]
        for kid in child_of.get(ck, []):
            node.children.append(build(kid, lam[ck[0]]))
        return node

    # roots are born at λ = 0, so a cluster of the loosest level alone
    # still lives long enough to beat its noise fragments
    roots = [build((m - 1, int(lab)), 0.0) for lab in np.unique(levels[m - 1]) if lab >= 0]

    out = np.full(n, -1, np.int64)
    next_id = [0]

    def best(node):
        child_sum = sum(best(c) for c in node.children)
        return max(node.stab, child_sum) if node.children else node.stab

    def select(node):
        child_sum = sum(best(c) for c in node.children)
        if node.children and child_sum > node.stab:
            for c in node.children:
                select(c)
        else:
            out[node.members] = next_id[0]
            next_id[0] += 1

    for r in roots:
        select(r)
    return _compact_labels(out)

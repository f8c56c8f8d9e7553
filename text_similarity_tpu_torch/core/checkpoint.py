"""Checkpoint layout shared with the JAX package.

A checkpoint is a directory ``step_XXXXXXXX/`` holding ``params.npz`` (flat
arrays keyed by ``/``-joined tree paths), optionally ``opt_state.npz`` (the
optimizer state, the same way) and ``meta.json``; ``LATEST`` in the parent
names the newest one. This module reads and writes that layout from plain
nested dicts of numpy arrays, tensors or Python numbers, so parameters move
between the two packages (a trained encoder saved here loads in the JAX
package). The port's optimizer state has its own tree (``train.optim``),
so an ``opt_state.npz`` resumes only in the package that wrote it.
Sharding metadata is not written; any that a JAX checkpoint carries is
ignored.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(val, dict):
            flat.update(_flatten(val, path))
        elif isinstance(val, torch.Tensor):
            flat[path] = val.detach().to("cpu").numpy()
        else:
            flat[path] = np.asarray(val)
    return flat


def save_checkpoint(
    path: str,
    params: dict,
    opt_state: Optional[dict] = None,
    step: int = 0,
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Write ``path/step_{step:08d}`` (via a ``.tmp`` dir renamed at the
    end, so a crash never leaves a half-written step dir) and point
    ``LATEST`` at it."""
    ckpt_dir = os.path.join(path, f"step_{step:08d}")
    tmp_dir = ckpt_dir + ".tmp"
    if os.path.isdir(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    np.savez(os.path.join(tmp_dir, "params.npz"), **_flatten(params))
    if opt_state is not None:
        np.savez(os.path.join(tmp_dir, "opt_state.npz"), **_flatten(opt_state))
    with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
        json.dump({"step": step, "meta": meta or {}}, f, indent=2)
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.rename(tmp_dir, ckpt_dir)
    with open(os.path.join(path, "LATEST"), "w") as f:
        f.write(os.path.basename(ckpt_dir))
    return ckpt_dir


def latest_checkpoint(path: str) -> Optional[str]:
    latest = os.path.join(path, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            name = f.read().strip()
        d = os.path.join(path, name)
        if os.path.isdir(d):
            return d
    cands = sorted(
        d for d in (os.listdir(path) if os.path.isdir(path) else [])
        if re.match(r"step_\d+$", d)
    )
    return os.path.join(path, cands[-1]) if cands else None


def restore_checkpoint_raw(ckpt_dir: str) -> Tuple[dict, int, Dict[str, Any]]:
    """→ (nested dict of numpy arrays, step, meta), rebuilt from the flat
    key paths alone."""
    with np.load(os.path.join(ckpt_dir, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree: dict = {}
    for key, arr in flat.items():
        parts = key.split(_SEP)
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = arr
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        info = json.load(f)
    return tree, info["step"], info.get("meta", {})


def _unflatten_into(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    """The template's tree with each leaf read from ``flat``: a tensor leaf
    becomes a tensor of its dtype on its device, a Python number a number
    of its type."""
    out = {}
    for key, val in template.items():
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(val, dict):
            out[key] = _unflatten_into(val, flat, path)
            continue
        if path not in flat:
            raise KeyError(f"checkpoint missing key {path!r}")
        arr = flat[path]
        if isinstance(val, torch.Tensor):
            if tuple(arr.shape) != tuple(val.shape):
                raise ValueError(f"{path}: shape {arr.shape} != template {tuple(val.shape)}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(val.device, val.dtype)
        else:
            out[key] = type(val)(arr.item())
    return out


def restore_checkpoint(
    ckpt_dir: str,
    params_template: dict,
    opt_template: Optional[dict] = None,
) -> Tuple[dict, Optional[dict], int, Dict[str, Any]]:
    """→ (params, opt_state, step, meta) in the templates' structure,
    dtypes and devices; opt_state is None without a template or without
    ``opt_state.npz``."""
    with np.load(os.path.join(ckpt_dir, "params.npz")) as z:
        params = _unflatten_into(params_template, dict(z))
    opt_state = None
    opt_path = os.path.join(ckpt_dir, "opt_state.npz")
    if opt_template is not None and os.path.exists(opt_path):
        with np.load(opt_path) as z:
            opt_state = _unflatten_into(opt_template, dict(z))
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        info = json.load(f)
    return params, opt_state, info["step"], info.get("meta", {})

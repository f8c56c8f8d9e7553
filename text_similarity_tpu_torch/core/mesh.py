"""Device mesh and its collectives (port of ``text_similarity_tpu.core.mesh``).

One process drives every device, as the JAX package's single controller
does. A :class:`Mesh` is a named-axis array of ``torch.device``s in the
reference's axis order (data, pipe, model, expert, seq, index). A tensor
sharded along one axis is a list of per-position tensors, each on its
position's device; a collective is a plain function over such a list whose
data moves by device-to-device copies (``Tensor.to(device,
non_blocking=True)``, a peer copy between cards):

- ``all_gather(xs, dim, tiled)``: every position gets all the pieces,
  stacked on a new ``dim`` or (tiled) concatenated along it;
- ``ppermute(xs, perm)``: position ``dst`` gets ``xs[src]`` for each
  ``(src, dst)`` pair, zeros where no pair sends to it;
- ``all_to_all(xs, split_axis, concat_axis)``: tiled, as ``jax.lax.all_to_all``
  with ``tiled=True``: position j gets the j-th ``split_axis`` chunk of every
  position's piece, concatenated along ``concat_axis`` in position order.

An explicit device list may name one device more than once: several shards
then share a card (or the CPU), as the JAX tests place them on virtual CPU
devices. A copy to the device a tensor already lies on is no copy, so a
result may alias its input: nothing here updates a piece in place.

The axes:

- ``data``   — batch rows (data-parallel encode)
- ``pipe``   — pipeline stages
- ``model``  — tensor parallelism
- ``expert`` — MoE experts
- ``seq``    — context parallelism (ring / Ulysses attention)
- ``index``  — corpus shards (per-shard top-k, merged on the first device)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .precision import resolve_device

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
INDEX_AXIS = "index"
AXES = (DATA_AXIS, PIPE_AXIS, MODEL_AXIS, EXPERT_AXIS, SEQ_AXIS, INDEX_AXIS)


class Mesh:
    """A (data, pipe, model, expert, seq, index) array of devices."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh has {len(AXES)} axes, got {devices.ndim}")
        self.devices = devices
        self.axis_names = AXES
        self.shape: Dict[str, int] = dict(zip(AXES, devices.shape))

    @property
    def first_device(self) -> torch.device:
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, every other axis at its first
        position (the pieces of a tensor sharded along ``axis`` only)."""
        idx = [0] * len(AXES)
        idx[AXES.index(axis)] = slice(None)
        return list(self.devices[tuple(idx)])

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}; {[str(d) for d in self.devices.flat]})"


def _device(dev) -> torch.device:
    """A ``torch.device`` with its index: ``cuda`` names the current card,
    so that pieces compare equal to the devices their tensors report."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    data: int = -1,
    model: int = 1,
    seq: int = 1,
    index: int = 1,
    pipe: int = 1,
    expert: int = 1,
    devices: Optional[Sequence] = None,
    device="cuda",
) -> Mesh:
    """A mesh over ``devices`` (default: every visible card for ``device=
    "cuda"``, which raises where there is none; the one CPU for ``"cpu"``).
    ``data=-1`` takes whatever devices the other axes leave. The axis order
    is the reference's (data, pipe, model, expert, seq, index)."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devs = [torch.device("cpu")]
    else:
        devs = [_device(d) for d in devices]
        for d in devs:
            resolve_device(d)
    n = len(devs)
    rest = pipe * model * expert * seq * index
    if data == -1:
        if n % rest != 0:
            raise ValueError(f"{n} devices not divisible by pipe*model*expert*seq*index={rest}")
        data = n // rest
    if data * rest != n:
        raise ValueError(f"mesh {data}x{pipe}x{model}x{expert}x{seq}x{index} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(data, pipe, model, expert, seq, index))


def local_mesh(device="cuda") -> Mesh:
    """A data mesh over every local device (one-card encode / serve)."""
    return make_mesh(device=device)


def is_multichip() -> bool:
    return torch.cuda.is_available() and torch.cuda.device_count() > 1


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    # a copy to the host is blocking: the host may read it at once
    return x.to(dev, non_blocking=dev.type == "cuda")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, axis: str = DATA_AXIS) -> list:
    """Split every tensor of ``tree`` along its leading dim over ``axis`` →
    one tree a position, its pieces on the position's device. Rows split as
    ``torch.tensor_split`` splits them: the first B mod n pieces hold one
    row more."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    return [
        _map(tree, lambda x, i=i: _to(torch.as_tensor(x).tensor_split(n)[i], devs[i]))
        for i in range(n)
    ]


def on_devices(tree, devices: Sequence) -> Dict[torch.device, object]:
    """``tree`` on each distinct device of ``devices``, keyed by device: one
    copy a device, and none on the device a tensor already lies on (the
    tensor itself). Positions that share a device share its copy, so no
    caller may update one in place."""
    copies: Dict[torch.device, object] = {}
    for d in map(_device, devices):
        if d not in copies:
            copies[d] = _map(tree, lambda x: _to(x, d))
    return copies


def replicate(mesh: Mesh, tree, axis: Optional[str] = None) -> list:
    """A copy of ``tree`` for each position of ``axis`` (every device of the
    mesh when None), made once for each distinct device (``on_devices``)."""
    devs = mesh.axis_devices(axis) if axis else list(mesh.devices.flat)
    copies = on_devices(tree, devs)
    return [copies[d] for d in devs]


# ---------------------------------------------------------------------------
# Collectives over a list of per-position tensors
# ---------------------------------------------------------------------------

def all_gather(xs: Sequence[torch.Tensor], dim: int = 0, tiled: bool = False) -> List[torch.Tensor]:
    """Every position gets every piece, on its own device: stacked along a
    new ``dim``, or concatenated along ``dim`` with ``tiled``."""
    join = torch.cat if tiled else torch.stack
    return [join([_to(y, x.device) for y in xs], dim) for x in xs]


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Position ``dst`` gets ``xs[src]`` for each ``(src, dst)`` of
    ``perm``; a position no pair sends to gets zeros."""
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError(f"ppermute sends twice to position {dst}")
        out[dst] = _to(xs[src], xs[dst].device)
    return [torch.zeros_like(x) if o is None else o for x, o in zip(xs, out)]


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int, concat_axis: int) -> List[torch.Tensor]:
    """Tiled all-to-all: each piece splits into n equal chunks along
    ``split_axis``; position j gets chunk j of every piece, concatenated
    along ``concat_axis`` in position order."""
    n = len(xs)
    size = xs[0].shape[split_axis]
    if size % n:
        raise ValueError(f"dim {split_axis} of size {size} does not split into {n} pieces")
    chunks = [x.chunk(n, dim=split_axis) for x in xs]
    return [
        torch.cat([_to(chunks[i][j], xs[j].device) for i in range(n)],
                  dim=concat_axis)
        for j in range(n)
    ]

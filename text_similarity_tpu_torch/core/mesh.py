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
collective's result may alias its input: nothing here updates such a piece in
place.

Placed parameters (the sharded train state): a :class:`PartitionSpec` names,
per tensor dim, the mesh axis it is split over (or None), as JAX's
``PartitionSpec`` does. ``shard_leaf`` cuts a tensor into a
:class:`ShardedLeaf`: one piece a distinct shard, each owning its storage
(the optimizer updates pieces in place), on the device of its position with
every axis the spec does not name at 0. A replicated leaf is one piece on
the first device; a leaf split over ``data`` (FSDP) one piece a data
position; over ``model`` (tensor parallelism) one a model position.
``gather_leaf`` assembles a leaf, or the slice of it that one position
holds, on a device by differentiable copies, so the gradients of the copies
sum back into the pieces in the backward (the psum of a replicated leaf's
gradient, the reduce-scatter of an FSDP piece's). ``unshard`` turns a tree
back into whole tensors on one device (saving, tests).

The axes:

- ``data``   — batch rows (data-parallel encode)
- ``pipe``   — pipeline stages
- ``model``  — tensor parallelism
- ``expert`` — MoE experts
- ``seq``    — context parallelism (ring / Ulysses attention)
- ``index``  — corpus shards (per-shard top-k, merged on the first device)
"""

from __future__ import annotations

import itertools
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


# ---------------------------------------------------------------------------
# Placed parameters: specs, sharded leaves
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """Per tensor dim, the mesh axis it is split over or None (whole), as
    ``jax.sharding.PartitionSpec``; a spec shorter than the tensor leaves
    its trailing dims whole."""

    def __new__(cls, *dims):
        for a in dims:
            if a is not None and a not in AXES:
                raise ValueError(f"unknown mesh axis {a!r} in a spec (axes: {AXES})")
        named = [a for a in dims if a is not None]
        if len(set(named)) != len(named):
            raise ValueError(f"a spec names an axis twice: {dims}")
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class ShardedLeaf:
    """One parameter placed on a mesh by a spec. ``pieces`` holds one tensor
    a distinct shard, in row-major order over the spec's axes (in dim
    order); ``shape`` is the whole leaf's."""

    __slots__ = ("pieces", "spec", "mesh", "shape")

    def __init__(self, pieces: List[torch.Tensor], spec: PartitionSpec, mesh: Mesh, shape):
        self.pieces = list(pieces)
        self.spec = spec
        self.mesh = mesh
        self.shape = torch.Size(shape)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def split_dims(self) -> List[Tuple[int, str]]:
        """(dim, axis) for every dim the spec splits, in dim order."""
        return [(d, a) for d, a in enumerate(self.spec) if a is not None]

    def like(self, pieces: List[torch.Tensor]) -> "ShardedLeaf":
        """Another leaf with this one's placement (gradients, moments)."""
        return ShardedLeaf(pieces, self.spec, self.mesh, self.shape)

    def __repr__(self) -> str:
        return (f"ShardedLeaf({tuple(self.shape)}, {self.spec!r}, {len(self.pieces)} pieces, "
                f"{self.dtype})")


def _piece_device(mesh: Mesh, split: List[Tuple[int, str]], index: Tuple[int, ...]) -> torch.device:
    pos = [0] * len(AXES)
    for (_, axis), i in zip(split, index):
        pos[AXES.index(axis)] = i
    return mesh.devices[tuple(pos)]


def shard_leaf(x: torch.Tensor, mesh: Mesh, spec: PartitionSpec) -> ShardedLeaf:
    """Cut ``x`` by ``spec`` into a :class:`ShardedLeaf`. Every split dim
    must divide evenly over its axis (JAX refuses an uneven ``device_put``
    too). Each piece is a contiguous clone on its device, so no piece is a
    view of another, even where positions share a device."""
    spec = PartitionSpec(*spec)
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec!r} has more dims than the tensor's {tuple(x.shape)}")
    spec = PartitionSpec(*spec, *([None] * (x.ndim - len(spec))))
    leaf = ShardedLeaf([], spec, mesh, x.shape)
    split = leaf.split_dims
    for d, a in split:
        if x.shape[d] % mesh.shape[a]:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not split evenly over axis "
                             f"{a!r} of size {mesh.shape[a]}")
    for index in itertools.product(*(range(mesh.shape[a]) for _, a in split)):
        piece = x
        for (d, a), i in zip(split, index):
            piece = piece.chunk(mesh.shape[a], dim=d)[i]
        dev = _piece_device(mesh, split, index)
        leaf.pieces.append(piece.detach().to(dev).contiguous().clone())
    return leaf


def gather_leaf(leaf: ShardedLeaf, device, keep: Optional[Dict[str, int]] = None
                ) -> torch.Tensor:
    """The leaf on ``device``, by differentiable copies: a dim split over an
    axis named in ``keep`` takes that position's piece only (a model
    position's head slice), every other split dim is concatenated whole
    (the FSDP all-gather)."""
    keep = keep or {}
    dev = _device(device)
    split = leaf.split_dims
    grid = np.empty(len(leaf.pieces), dtype=object)
    for i, piece in enumerate(leaf.pieces):   # element-wise: numpy would unpack tensors
        grid[i] = piece
    grid = grid.reshape([leaf.mesh.shape[a] for _, a in split])
    idx = tuple(keep[a] if a in keep else slice(None) for _, a in split)
    grid = grid[idx]
    dims = [d for d, a in split if a not in keep]

    def assemble(g, ds):
        if not ds:
            return _to(g if isinstance(g, torch.Tensor) else g.item(), dev)
        return torch.cat([assemble(sub, ds[1:]) for sub in g], dim=ds[0])

    return assemble(grid, dims)


def pieces_of(x) -> List[torch.Tensor]:
    """The tensors that hold a leaf: a sharded leaf's pieces, else the leaf."""
    return x.pieces if isinstance(x, ShardedLeaf) else [x]


def mesh_of(tree) -> Optional[Mesh]:
    """The mesh of the first sharded leaf of ``tree``, None if it has none."""
    if isinstance(tree, ShardedLeaf):
        return tree.mesh
    if isinstance(tree, dict):
        for v in tree.values():
            m = mesh_of(v)
            if m is not None:
                return m
    return None


def place(tree, mesh: Mesh, specs=None):
    """Every tensor of ``tree`` as a :class:`ShardedLeaf` by the spec at its
    path in ``specs`` (a tree like ``tree``; None replicates every leaf:
    one piece on the first device)."""
    if isinstance(tree, dict):
        if specs is not None and not isinstance(specs, dict):
            raise ValueError(f"spec {specs!r} given for a subtree")
        out = {}
        for k, v in tree.items():
            if specs is not None and k not in specs:
                raise KeyError(f"no spec for {k!r}")
            out[k] = place(v, mesh, None if specs is None else specs[k])
        return out
    return shard_leaf(torch.as_tensor(tree), mesh, PartitionSpec() if specs is None else specs)


@torch.no_grad()
def unshard(tree, device=None):
    """Every :class:`ShardedLeaf` of ``tree`` as one whole tensor on
    ``device`` (default: its first piece's device); other leaves as they
    are. For saving a sharded state and for comparing it."""
    if isinstance(tree, dict):
        return {k: unshard(v, device) for k, v in tree.items()}
    if isinstance(tree, ShardedLeaf):
        return gather_leaf(tree, device if device is not None else tree.pieces[0].device)
    return tree

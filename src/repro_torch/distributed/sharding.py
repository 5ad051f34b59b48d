"""Sharding rules and placed tensors of the CTR path over a :class:`Mesh`.

Counterpart of the CTR subset of ``repro.distributed.sharding``:
``mesh_batch_axes``, ``ctr_param_specs``, ``batch_specs``, ``drop_axis``,
``fit_spec``, ``fit_spec_tree`` and ``input_shardings``, over a
``PartitionSpec``-like :class:`P`. The LM rules (``LOGICAL_RULES``,
``param_specs`` and the rest) come with the LM zoo.

The port's counterpart of a ``jax.Array`` with a ``NamedSharding`` is a
:class:`Placed` value: a global shape, a :class:`NamedSharding` (``mesh``,
``spec``, ``is_fully_replicated``) and one local tensor per mesh
position. Positions on one device that hold the same slice share one
tensor, so no replica is copied onto a device that already holds it, and
a slice on the source tensor's own device is a view of it (a row shard of
a contiguous table is contiguous). ``place(tensor, mesh, spec)`` is the
reference's ``device_put(x, NamedSharding(mesh, spec))``.

Trees are nested dicts and lists; every other object is a leaf (a
:class:`P` too, though it is a tuple).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

import numpy as np
import torch

from .mesh import Mesh

__all__ = ["P", "NamedSharding", "Placed", "place", "place_tree",
           "to_named", "mesh_batch_axes", "ctr_param_specs", "batch_specs",
           "drop_axis", "fit_spec", "fit_spec_tree", "input_shardings",
           "data_groups", "tree_map"]


class P(tuple):
    """A partition spec: one entry per leading dim of a value, each
    ``None`` (replicated), a mesh axis name or a tuple of names (the dim
    split over their product, the first name major)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _map_with_path(fn: Callable, tree: Any, path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _ndim(x) -> int:
    return x.ndim if hasattr(x, "ndim") else len(x.shape)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How a value lies over ``mesh``: dim ``i`` split over the axes of
    ``spec[i]``, replicated over every other axis."""
    mesh: Mesh
    spec: P

    def shards(self, dim: int) -> int:
        """Into how many pieces dim ``dim`` is split."""
        if dim >= len(self.spec):
            return 1
        return math.prod(self.mesh.shape[a] for a in _axes(self.spec[dim]))

    @property
    def is_fully_replicated(self) -> bool:
        return all(self.shards(i) == 1 for i in range(len(self.spec)))

    def _split(self, ndim: int) -> tuple[tuple[str, ...], ...]:
        """Per dim, the axes that really split it (size above 1)."""
        return tuple(tuple(a for a in _axes(self.spec[i])
                           if self.mesh.shape[a] > 1)
                     if i < len(self.spec) else () for i in range(ndim))

    def is_equivalent_to(self, other: "NamedSharding", ndim: int) -> bool:
        """True when both put the same slice of an ``ndim``-d value on
        every position."""
        return (self.mesh == other.mesh
                and self._split(ndim) == other._split(ndim))

    def shard_index(self, pos: tuple[int, ...], dim: int) -> int:
        """Which piece of dim ``dim`` position ``pos`` holds."""
        idx = 0
        if dim < len(self.spec):
            names = self.mesh.axis_names
            for a in _axes(self.spec[dim]):
                idx = idx * self.mesh.shape[a] + pos[names.index(a)]
        return idx

    def local_slices(self, pos: tuple[int, ...], shape) -> tuple:
        out = []
        for dim, size in enumerate(shape):
            n = self.shards(dim)
            i = self.shard_index(pos, dim)
            out.append(slice(i * size // n, (i + 1) * size // n))
        return tuple(out)


class Placed:
    """A value laid out over a mesh: its global ``shape`` and ``dtype``,
    its ``sharding`` and one local tensor per mesh position
    (:meth:`local`)."""

    def __init__(self, shape, dtype: torch.dtype, sharding: NamedSharding,
                 local: dict[tuple[int, ...], torch.Tensor]):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self._local = local

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def local(self, pos: tuple[int, ...]) -> torch.Tensor:
        """The tensor at mesh position ``pos``."""
        return self._local[tuple(pos)]

    def full(self, device: torch.device | str | None = None
             ) -> torch.Tensor:
        """The whole value on ``device`` (the mesh's first device by
        default), assembled from the shards."""
        device = self.mesh.first_device if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        done = set()
        for pos, t in self._local.items():
            sl = self.sharding.local_slices(pos, self.shape)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in done:
                out[sl] = t.to(device)
                done.add(key)
        return out

    def __repr__(self) -> str:
        return (f"Placed(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec}, mesh={self.mesh.shape})")


def place(x: torch.Tensor | Placed, mesh: Mesh, spec: P) -> Placed:
    """``x`` laid out over ``mesh`` per ``spec`` (every split dim must
    divide; :func:`fit_spec` drops the axes that do not). A slice bound for
    ``x``'s own device is a view of ``x`` (made contiguous when a column
    split needs it); a slice bound for another device is copied there once,
    whatever the number of positions on that device. An ``x`` already
    placed that way is returned as it is."""
    sharding = NamedSharding(mesh, P(*spec))
    if isinstance(x, Placed):
        if x.sharding.is_equivalent_to(sharding, x.ndim):
            return x
        x = x.full()
    if len(sharding.spec) > x.ndim:
        raise ValueError(f"spec {sharding.spec} has more entries than "
                         f"{tuple(x.shape)} has dims")
    for dim, size in enumerate(x.shape):
        n = sharding.shards(dim)
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{n} ways ({sharding.spec}); use fit_spec")
    made: dict = {}
    local = {}
    for pos in np.ndindex(mesh.devices.shape):
        dev = mesh.devices[pos]
        sl = sharding.local_slices(pos, x.shape)
        key = (dev, tuple((s.start, s.stop) for s in sl))
        if key not in made:
            whole = all(s.start == 0 and s.stop == n
                        for s, n in zip(sl, x.shape))
            piece = x if whole else x[sl]
            if piece.device != dev:
                piece = piece.to(dev)
            elif not piece.is_contiguous():
                piece = piece.contiguous()
            made[key] = piece
        local[pos] = made[key]
    return Placed(x.shape, x.dtype, sharding, local)


def place_tree(tree: Any, mesh: Mesh, specs: Any) -> Any:
    """:func:`place` over a tree of tensors and the matching spec tree."""
    return tree_map(lambda x, s: place(x, mesh, s), tree, specs)


def to_named(mesh: Mesh, spec_tree: Any) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

def mesh_batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """The mesh axes a batch splits over (``pod``, then ``data``)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def ctr_param_specs(tree: Any) -> Any:
    """CTR models: embedding tables row-sharded over ``model``, dense
    layers replicated, by leaf name (``repro.distributed.sharding:204``):
    ``mega_table`` (DenseStore) and ``backing`` (CachedStore) are the
    vocab-parallel tables; ``cache``/``slot_of_row`` replicate; any other
    2-d leaf of at least 2**16 elements splits its columns over
    ``model``. Leaves are tensors or anything with a ``shape``."""
    def leaf_spec(path: str, leaf) -> P:
        ndim = _ndim(leaf)
        if re.search(r"(mega_table|backing)$", path) and ndim == 2:
            return P("model", None)
        if path.endswith("cache") or path.endswith("slot_of_row"):
            return P()
        if ndim == 2 and leaf.shape[0] * leaf.shape[1] >= 1 << 16:
            return P(None, "model")
        return P()
    return _map_with_path(leaf_spec, tree)


def batch_specs(mesh: Mesh, batch_tree: Any) -> Any:
    """Split the leading (global-batch) dim of every leaf over the mesh's
    batch axes (replicate everything on a mesh with none)."""
    b = mesh_batch_axes(mesh)
    b = b if len(b) > 1 else (b[0] if b else None)
    return tree_map(lambda x: P(*([b] + [None] * (_ndim(x) - 1))),
                    batch_tree)


def drop_axis(spec_tree: Any, axis: str) -> Any:
    """Remove one mesh axis from every spec in the tree."""
    def fix(spec: P) -> P:
        out = []
        for dim in spec:
            kept = tuple(a for a in _axes(dim) if a != axis)
            out.append(kept if len(kept) > 1 else
                       (kept[0] if kept else None))
        return P(*out)
    return tree_map(fix, spec_tree)


def fit_spec(mesh: Mesh, spec: P, shape) -> P:
    """Drop the mesh axes of every dim they do not divide evenly: that dim
    replicates instead (a batch of 6 over ``data`` = 4, Criteo's
    6,648,548 rows over ``model`` = 8)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for size, axes in zip(shape, dims):
        n = math.prod(mesh.shape[a] for a in _axes(axes))
        out.append(axes if axes is not None and size % n == 0 else None)
    return P(*out)


def fit_spec_tree(mesh: Mesh, specs: Any, shapes: Any) -> Any:
    return tree_map(lambda s, x: fit_spec(mesh, s, x.shape), specs, shapes)


def input_shardings(mesh: Mesh, shapes: Any) -> Any:
    """Shardings of a plan's per-call inputs (``ids``-style leaves): the
    leading dim over the batch axes (:func:`batch_specs`), fitted per leaf
    (:func:`fit_spec`) so a batch the data axis does not divide
    replicates."""
    return to_named(mesh, fit_spec_tree(mesh, batch_specs(mesh, shapes),
                                        shapes))


def data_groups(mesh: Mesh, model_axis: str | None = "model",
                batch_axes: tuple[str, ...] | None = None
                ) -> list[list[tuple[int, ...]]]:
    """Mesh positions by batch shard: ``groups[i][j]`` is the position
    holding batch shard ``i`` (over ``batch_axes``, default
    :func:`mesh_batch_axes`, the first major) and model shard ``j``.
    Positions that differ only along another axis hold the same shards,
    and the first of them stands for all."""
    names = mesh.axis_names
    batch = mesh_batch_axes(mesh) if batch_axes is None else tuple(
        a for a in batch_axes if a in names)
    n_batch = math.prod(mesh.shape[a] for a in batch)
    model = model_axis if model_axis in names else None
    n_model = mesh.shape[model] if model else 1
    groups = [[None] * n_model for _ in range(n_batch)]
    for pos in np.ndindex(mesh.devices.shape):
        named = dict(zip(names, pos))
        if any(named[a] for a in names if a not in batch and a != model):
            continue
        i = 0
        for a in batch:
            i = i * mesh.shape[a] + named[a]
        groups[i][named[model] if model else 0] = pos
    return groups

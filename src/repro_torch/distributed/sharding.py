"""Sharding rules and placed tensors over a :class:`Mesh`.

Counterpart of ``repro.distributed.sharding``, over a
``PartitionSpec``-like :class:`P`: the CTR path's ``ctr_param_specs``,
``batch_specs``, ``drop_axis``, ``fit_spec``, ``fit_spec_tree`` and
``input_shardings``, and the LM zoo's logical-axis rules
(``LOGICAL_RULES``, ``LOGICAL_RULES_FSDP``, ``make_shard_fn``), path
rules (``param_specs``, ``fsdp_param_specs``) and ``cache_specs``.

``make_shard_fn`` is the LM models' ``shard`` hook. The reference's hook
is ``with_sharding_constraint``, which changes no value; the port's
resolves the logical axes through the policy's rules, raises where the
reference's constraint could not be built (a rank that differs, a mesh
axis the mesh lacks) and returns ``x`` itself. The dense arithmetic of an
LM runs whole on the mesh's first device unless its cell's parameters
are placed (``Cell.place_params``, ``tensor_parallel``); the decode's
per-position work is the sequence-split flash decode
(``models/lm/layers.flash_decode_sharded``).
The reference stacks a group's layers along a leading scan dimension; the
port keeps one leaf a layer (``layers/3/attn/wq``), so a port parameter
spec is the reference's for that leaf without its leading ``None``.

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
           "data_groups", "axis_line", "axis_group", "pieces", "tree_map",
           "LOGICAL_RULES", "LOGICAL_RULES_FSDP",
           "make_shard_fn", "fsdp_param_specs", "param_specs",
           "cache_specs"]


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


def _shape(x) -> tuple:
    """A leaf's shape; a Python number (an LM cache's ``index``) is a
    0-d leaf, as the reference's int32 scalar is."""
    return tuple(x.shape) if hasattr(x, "shape") else ()


def _ndim(x) -> int:
    return len(_shape(x))


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

    def __getitem__(self, i: int) -> "Placed":
        """Index ``i`` of a leading dim that no axis splits (a stacked
        cache's layer): each position's tensor indexed in place, a view
        that writes through, positions sharing a tensor sharing the
        view."""
        if self.sharding.shards(0) != 1:
            raise ValueError(f"dim 0 of {self} is split over the mesh")
        if not isinstance(i, int) or not -self.shape[0] <= i < self.shape[0]:
            raise IndexError(f"index {i!r} into dim 0 of {self}")
        views: dict = {}
        local = {pos: views.setdefault(id(t), t[i])
                 for pos, t in self._local.items()}
        return Placed(self.shape[1:], self.dtype,
                      NamedSharding(self.mesh, P(*self.sharding.spec[1:])),
                      local)

    def split_dim(self, axis: str) -> int | None:
        """The dim that mesh axis ``axis`` splits (None: replicated over
        it, or an axis of size 1)."""
        if self.mesh.shape.get(axis, 1) == 1:
            return None
        for dim in range(self.ndim):
            if axis in self.sharding._split(self.ndim)[dim]:
                return dim
        return None

    def gather(self, pos: tuple[int, ...], axis: str | tuple[str, ...]
               ) -> torch.Tensor:
        """Position ``pos``'s tensor with the split over ``axis`` (one mesh
        axis or a tuple of them) undone: the pieces of the positions that
        differ from ``pos`` only along those axes (:func:`axis_group`),
        in shard order, joined on ``pos``'s device (the all-gather). A
        value the axes do not split is ``pos``'s own tensor. The axes
        must split one dim, and split it alone (a pure-FSDP weight's
        ``("data", "model")`` dim gathers over both)."""
        axes = _axes(axis)
        split = self.sharding._split(self.ndim)
        dims = [d for d in range(self.ndim) if set(split[d]) & set(axes)]
        if not dims:
            return self.local(pos)
        if len(dims) > 1 or not set(split[dims[0]]) <= set(axes):
            raise NotImplementedError(
                f"{self} is split over more than the axes {axes} on one "
                "dim")
        dim = dims[0]
        dev = self.mesh.devices[tuple(pos)]
        pieces = {}
        for q in axis_group(self.mesh, pos, axes):
            pieces.setdefault(self.sharding.shard_index(q, dim), q)
        return torch.cat([self.local(pieces[k]).to(dev)
                          for k in sorted(pieces)], dim=dim)

    def slice_key(self, pos: tuple[int, ...]) -> tuple:
        """``(start, stop)`` of each dim that position ``pos`` holds."""
        return tuple((s.start, s.stop) for s in
                     self.sharding.local_slices(pos, self.shape))

    def distinct(self) -> list[tuple[tuple[int, ...], torch.Tensor]]:
        """Each distinct local tensor once, with the first position that
        holds it, in position order."""
        seen: dict = {}
        for pos in np.ndindex(self.mesh.devices.shape):
            seen.setdefault(id(self._local[pos]), (pos, self._local[pos]))
        return list(seen.values())

    def holders(self) -> dict[tuple, list[tuple[int, ...]]]:
        """The positions holding each distinct slice (:meth:`slice_key`),
        slices in the order of their first holder, positions in mesh
        order."""
        out: dict = {}
        for pos in np.ndindex(self.mesh.devices.shape):
            out.setdefault(self.slice_key(pos), []).append(pos)
        return out

    def like(self, fn: Callable[[torch.Tensor], torch.Tensor],
             dtype: torch.dtype | None = None) -> "Placed":
        """A value of this shape and sharding whose tensor at every
        position is ``fn`` of this one's there, called once per distinct
        tensor, so positions that share a tensor share the result."""
        made = {id(t): fn(t) for _, t in self.distinct()}
        return Placed(self.shape, self.dtype if dtype is None else dtype,
                      self.sharding, {pos: made[id(t)]
                                      for pos, t in self._local.items()})

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


def place(x: torch.Tensor | Placed, mesh: Mesh, spec: P, *,
          contiguous: bool = True,
          draw: Callable[[tuple, torch.device], torch.Tensor] | None = None
          ) -> Placed:
    """``x`` laid out over ``mesh`` per ``spec`` (every split dim must
    divide; :func:`fit_spec` drops the axes that do not). A slice bound for
    ``x``'s own device is a view of ``x`` (made contiguous when a column
    split needs it, unless ``contiguous`` is False: weights a GEMM reads
    through their strides stay views); a slice bound for another device is
    copied there once, whatever the number of positions on that device. An
    ``x`` already placed that way is returned as it is. With ``draw``,
    ``x`` gives only the shape and dtype (a ``meta`` tensor) and each
    distinct slice is made on its device as ``draw(key, device)``, ``key``
    its ``(start, stop)`` by dim, once a device."""
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
        if key not in made and draw is not None:
            made[key] = draw(key[1], dev)
        elif key not in made:
            whole = all(s.start == 0 and s.stop == n
                        for s, n in zip(sl, x.shape))
            piece = x if whole else x[sl]
            if piece.device != dev:
                piece = piece.to(dev)
            elif contiguous and not piece.is_contiguous():
                piece = piece.contiguous()
            made[key] = piece
        local[pos] = made[key]
    return Placed(x.shape, x.dtype, sharding, local)


def pieces(x: torch.Tensor | Placed) -> list[torch.Tensor]:
    """A placed value's distinct tensors (:meth:`Placed.distinct`, in
    position order), or a tensor alone: values placed alike (one
    sharding, positions sharing tensors alike) give matching lists."""
    if isinstance(x, Placed):
        return [t for _, t in x.distinct()]
    return [x]


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
    return tree_map(lambda s, x: fit_spec(mesh, s, _shape(x)), specs,
                    shapes)


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


def axis_line(mesh: Mesh, pos: tuple[int, ...], axis: str
              ) -> list[tuple[int, ...]]:
    """The positions that differ from ``pos`` only along ``axis``, in
    axis order (``pos`` among them)."""
    i = mesh.axis_names.index(axis)
    return [tuple(pos[:i]) + (k,) + tuple(pos[i + 1:])
            for k in range(mesh.shape[axis])]


def axis_group(mesh: Mesh, pos: tuple[int, ...], axes: tuple[str, ...]
               ) -> list[tuple[int, ...]]:
    """The positions that differ from ``pos`` only along ``axes``, in
    mesh order (``pos`` among them)."""
    idx = [mesh.axis_names.index(a) for a in axes]
    out = []
    for sub in np.ndindex(*(mesh.devices.shape[i] for i in idx)):
        q = list(pos)
        for i, k in zip(idx, sub):
            q[i] = k
        out.append(tuple(q))
    return out


# ---------------------------------------------------------------------------
# the LM zoo: logical axes, parameter and cache specs
# ---------------------------------------------------------------------------

def LOGICAL_RULES(mesh: Mesh) -> dict[str, Any]:
    """Logical activation axis -> mesh axes under tensor parallelism
    with FSDP: batch over (pod, data), heads / mlp / vocab / experts over
    model, and the decode KV cache's sequence over model."""
    batch = mesh_batch_axes(mesh)
    b = batch if len(batch) > 1 else (batch[0] if batch else None)
    return {
        "batch": b,
        "seq": None,
        "kv_seq": "model",       # sequence-parallel KV cache (decode)
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "expert_mlp": None,      # model axis is taken by experts in MoE
        "vocab": "model",
        "experts": "model",
    }


def LOGICAL_RULES_FSDP(mesh: Mesh) -> dict[str, Any]:
    """Pure FSDP: batch over (data × model), every other logical axis
    replicated (no tensor parallelism)."""
    batch = tuple(a for a in ("data", "model") if a in mesh.axis_names)
    b = batch if len(batch) > 1 else (batch[0] if batch else None)
    rules = {k: None for k in LOGICAL_RULES(mesh)}
    rules["batch"] = b
    rules["kv_seq"] = None
    return rules


def make_shard_fn(mesh: Mesh, policy: str = "tp_fsdp") -> Callable:
    """The LM models' ``shard(x, logical_axes)`` hook for ``mesh`` under
    ``policy`` (``"fsdp"``: :func:`LOGICAL_RULES_FSDP`, else
    :func:`LOGICAL_RULES`). It resolves each logical axis (an unknown
    name, or None, replicates), raises ``ValueError`` when the axes do
    not number ``x.ndim`` or a resolved axis is not on the mesh, and
    returns ``x`` itself: a layout constraint never changes a value."""
    rules = (LOGICAL_RULES_FSDP(mesh) if policy == "fsdp"
             else LOGICAL_RULES(mesh))

    def shard(x, logical_axes):
        if len(logical_axes) != x.ndim:
            raise ValueError(f"logical axes {tuple(logical_axes)} for a "
                             f"{x.ndim}-d value of shape {tuple(x.shape)}")
        spec = P(*(rules.get(a) if a is not None else None
                   for a in logical_axes))
        missing = [a for dim in spec for a in _axes(dim)
                   if a not in mesh.axis_names]
        if missing:
            raise ValueError(f"{tuple(logical_axes)} resolves to {spec}, "
                             f"but the mesh has no axis {missing}")
        return x
    return shard


def fsdp_param_specs(specs: Any) -> Any:
    """TP×FSDP parameter specs rewritten to pure FSDP: the TP
    (``model``) dim takes the whole (data, model) grid and the old FSDP
    (``data``) dim is freed."""
    def fix(spec: P) -> P:
        return P(*(("data", "model") if dim == "model"
                   else None if dim == "data" else dim for dim in spec))
    return tree_map(fix, specs)


# Each rule: (regex over the "/"-joined path of a leaf in the reference's
# stacked layout, spec of one layer's leaf); the first match wins.
_DENSE_RULES = [
    (r"embed$", P("model", "data")),
    (r"lm_head$", P("data", "model")),
    (r"attn/w[qkv]$", P("data", "model")),
    (r"attn/wo$", P("model", "data")),
    (r"mlp/w_(gate|up|in)$", P("data", "model")),
    (r"mlp/w_(down|out)$", P("model", "data")),
    (r"mlp/b_in$", P("model")),
    (r"pos_dec$", P(None, None)),
]

_MOE_RULES = [
    (r"moe/router$", P(None, None)),
    (r"moe/w_(gate|up)$", P("model", "data", None)),    # E × D × F
    (r"moe/w_down$", P("model", None, "data")),         # E × F × D
] + _DENSE_RULES

# llama4-scale (``cfg.moe_token_replicate``): experts over model and the
# FFN dim over data, so the expert bank never moves
_MOE_TOKEN_REPLICATE_RULES = [
    (r"moe/router$", P(None, None)),
    (r"moe/w_(gate|up)$", P("model", None, "data")),    # E × D × F/data
    (r"moe/w_down$", P("model", "data", None)),         # E × F/data × D
] + _DENSE_RULES

_RWKV_RULES = [
    (r"embed$", P("model", "data")),
    (r"lm_head$", P("data", "model")),
    (r"w[rkvg]$", P("data", "model")),
    (r"wo$", P("model", "data")),
    (r"wck$", P("data", "model")),
    (r"wcv$", P("model", "data")),
    (r"wcr$", P("data", "model")),
    (r"w_lora_a$", P("data", None)),
    (r"w_lora_b$", P(None, "data")),
    (r"(^|/)u$", P("model", None)),
]

_ZAMBA_RULES = [
    (r"embed$", P("model", "data")),
    (r"lm_head$", P("data", "model")),
    (r"mamba/w_in$", P("data", "model")),
    (r"mamba/w_out$", P("model", "data")),
    (r"mamba/conv_w$", P(None, "model")),
    (r"mamba/ln_y$", P("model")),
    (r"shared/w_in$", P("data", "model")),
    (r"shared/attn/w[qkv]$", P("data", "model")),
    (r"shared/attn/wo$", P("model", "data")),
    (r"shared/mlp/w_(gate|up)$", P("data", "model")),
    (r"shared/mlp/w_down$", P("model", "data")),
]

_ENCDEC_RULES = [
    (r"(xattn|attn)/w[qkv]$", P("data", "model")),
    (r"(xattn|attn)/wo$", P("model", "data")),
] + _DENSE_RULES

_FAMILY_RULES = {
    "dense": _DENSE_RULES,
    "vlm": _DENSE_RULES,
    "moe": _MOE_RULES,
    "ssm": _RWKV_RULES,
    "hybrid": _ZAMBA_RULES,
    "encdec": _ENCDEC_RULES,
}

#: the reference's stacked groups (``bridge.STACKED``), a list of
#: per-layer dicts in a port tree
_STACKED = re.compile(r"^(layers|mamba|encoder|decoder)/\d+(/|$)")


def param_specs(family: str, tree: Any, cfg: Any = None) -> Any:
    """The spec of every leaf of an LM parameter tree (``tensor_tree()``
    of a model, meta or real). A leaf's path is matched with the layer
    index of a stacked group taken out (``mamba/5/w_in`` as the
    reference's ``mamba/w_in``), so the reference's rules apply as they
    are written; a rule with one entry fewer than the leaf has dims gets
    a leading None, a rank that fits neither replicates, and a leaf no
    rule matches (norms, scalars) replicates. MoE with
    ``cfg.moe_token_replicate`` takes the token-replicate rules."""
    rules = _FAMILY_RULES[family]
    if (family == "moe" and cfg is not None
            and getattr(cfg, "moe_token_replicate", False)):
        rules = _MOE_TOKEN_REPLICATE_RULES

    def leaf_spec(path: str, leaf) -> P:
        ref_path = _STACKED.sub(r"\1\2", path)
        ndim = _ndim(leaf)
        for pat, spec in rules:
            if re.search(pat, ref_path):
                if len(spec) == ndim - 1:
                    return P(None, *spec)
                return spec if len(spec) == ndim else P()
        return P()
    return _map_with_path(leaf_spec, tree)


def cache_specs(family: str, mesh: Mesh, cache_tree: Any,
                seq_shard: bool = True) -> Any:
    """Decode-cache placement. KV caches (L, B, S, kv, hd): batch over
    (pod, data), sequence over model (``seq_shard``). Recurrent states of
    four or more dims: batch over data, heads over model; two or three
    dims: batch only; ``index`` replicated. ``family`` is unused, as in
    the reference."""
    del family
    b = mesh_batch_axes(mesh)
    b = b if len(b) > 1 else b[0]
    sp = "model" if seq_shard else None

    def leaf(path: str, x) -> P:
        ndim = _ndim(x)
        if ndim == 5 and ("k" in path or "v" in path):
            return P(None, b, sp, None, None)
        if path.endswith("index"):
            return P()
        if ndim >= 4:
            return P(None, b, "model", *([None] * (ndim - 3)))
        if ndim >= 2:
            return P(None, b, *([None] * (ndim - 2)))
        return P()
    return _map_with_path(leaf, cache_tree)

"""LM weights split over a mesh: the tensor-parallel step, for serving
and for training.

Port-only. In the reference this work is XLA's partitioner's: its
``Cell.lower()`` hands the compiled step its parameters under
``in_shardings=named(cell.pspecs)`` (``repro.launch.steps``), and GSPMD
derives each position's share of every GEMM and the collectives between
them. The port's single controller issues that work itself, position by
position, over the parameter tree placed by ``Cell.place_params``
(:class:`TensorParallel`):

* The residual stream lives once per batch shard, on that row's first
  position (:class:`Rows`, rows from ``sharding.data_groups``): the rules
  leave ``embed`` whole, so norms, RoPE on whole heads and residual adds
  run there.
* Column-parallel weights (``model`` on the output dim: ``attn/w[qkv]``,
  ``mlp/w_(gate|up|in)``, ``mlp/b_in``, ``lm_head``): the row's
  activation goes to each model position of the row, which multiplies by
  its own columns (:meth:`TensorParallel.col_linear`, a :class:`Cols`).
* Row-parallel weights (``model`` on the input dim: ``attn/wo``,
  ``mlp/w_(down|out)``): each position multiplies its slice of the
  activation; the partial sums go to the row's first position and add in
  model order 0…m−1 (the all-reduce); a bias is added once, after the sum
  (:meth:`TensorParallel.row_linear`).
* FSDP (``data`` on a weight's other dim): before its GEMM a position
  gathers its model column's pieces over the data axis, in data order
  (the all-gather, ``Placed.gather``); positions on one device share the
  gathered tensor, which is dropped when the step reaches the next layer
  and at the head (:meth:`TensorParallel.weight`).
* Pure FSDP (a train cell's ``"fsdp"`` policy: the batch over ``("data",
  "model")``, every weight's split dim over both): no tensor
  parallelism. Each position is a batch row of its own and gathers every
  weight whole over the grid before its use.
* The vocab-parallel embedding (each model position looks up the ids in
  its vocab range, zeros elsewhere, and the partials sum in model order:
  bitwise the whole gather) and head (each model position's logits
  columns, joined in order) (:meth:`TensorParallel.embed`,
  :meth:`TensorParallel.head`).

The attention and MoE layouts built on these are in
``models/lm/layers.py`` (``_qkv_split``, ``flash_decode_sharded``) and
``models/lm/moe.py`` (``_moe_split``).

Every copy between positions goes through :meth:`TensorParallel.send`:
counted in ``moved`` by (kind, position), under its source and its
destination, then moved to the destination's device (free between
positions of one device, and counted all the same). The kinds are
``KINDS``: ``tp_reduce`` (an activation to the row's model positions and
the partial sums back), ``fsdp_gather``, ``vocab`` (token ids, embedding
partials, logits columns and rows), ``heads`` (q/k/v and attention
outputs moved so that attention sees whole heads, and k/v to a prefill's
cache; in the recurrent families, the projection columns, decays and
weight columns a position's heads read), ``moe_tokens`` (tokens and
dispatched buffers to the experts' positions), ``merge`` (the
sequence-parallel decode's traffic), ``state`` (a recurrent state's
new slice to the positions that hold it but did not compute it) and
``grad_reduce`` (weight gradients to the positions that hold the
pieces).

Training (``Cell.place_params`` on a train cell, then
``training.make_train_step``). The trainable leaves are the placed
pieces, one tensor per device and slice (``TensorParallel.tree``, the
parameters of the step's ``TrainState``). Under autograd a send is a
``torch.autograd.Function`` whose backward sends the gradient back,
counted under the same kind; under ``layers.remat`` the recomputation
repeats a layer's sends and gathers, and they are counted again. The
backward runs on each card's autograd thread: the counts take a lock,
and a use's gradient is one dict entry. Every
weight a position reads (:meth:`TensorParallel.weight`: a piece, or the
pieces gathered) is a *use*, whose gradient autograd hands to this
object instead of accumulating it anywhere. :meth:`TensorParallel.grads`
then reduces them itself: each slice's gradient is the sum, on the
slice's first holder and in fp32, of the part of every use that covers
it, positions in mesh order and a position's uses in forward order (the
reduce-scatter of a gather's gradient, and the all-reduce of a
replicated piece's); the sum goes to every other holder (``grad_reduce``
both ways), so the replicas of a piece stay bitwise equal.

The recurrent families (``models/lm/rwkv6.py``, ``models/lm/zamba2.py``)
run their heads at :meth:`TensorParallel.head_sites`: each model position
its own heads where they divide evenly over the row, else every head on
the row's first position. Their state caches are placed by
``sharding.cache_specs`` (:meth:`TensorParallel.place_states`, heads over
``model``) and each step writes every position's slice in place
(:meth:`TensorParallel.write_state`); a state is never gathered whole.
Their train steps place no state: each head site starts its scan from
zeros on its own device and keeps nothing. A head site's scan runs
through :meth:`TensorParallel.scan_sites`, which a one-row trace joins
over the row's sites.

A one-row placement (``one_row``, the meta trace of ``Cell.lower``)
runs the work of batch row 0 alone and counts every other row by
symmetry: the rows are alike, and shifting the batch-axis coordinates of
every position maps one row's work onto another's. A copy between
positions that shift together (within a row, an FSDP gather, a state
write) is counted for the traced row, and :meth:`TensorParallel.fold`
gives each position the sum of those counts over its batch-axis
coordinates. A copy with one end that does not shift (the mesh's first
position, a routing unit of every row) is counted for each row as it is
made (:meth:`TensorParallel.send_fixed`); so is work done once for all
the rows (:meth:`TensorParallel.every_row`), and the gradient reduction
(:meth:`TensorParallel.grads`), whose first holders do not shift,
counts every row's uses from the traced row's by formula. The pieces of
the other rows' positions are the traced row's tensors (the same
shapes), so the optimizer and the reduction run over the traced row's
slices alone. Row 0 holds the mesh's first position, so every copy there
is made or counted in the traced row. Once folded, ``moved`` holds every
position's counts, as a trace of all the rows would. Such a placement
runs on a ``meta`` mesh only: the other rows' work is not done. Work
that several positions of the traced row do alike, each on its own
slice, runs once over the slices joined, every copy counted as made:
llama4's experts over their F-holders (:meth:`partials_summed`) and a
recurrent row's head sites (:meth:`scan_sites`), so a trace dispatches
about the ops of the unplaced step, whose scans step through every
token.
"""

from __future__ import annotations

import contextlib
import functools
import math
import re
import threading
from collections import Counter
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from .mesh import Mesh
from .sharding import (Placed, _axes, axis_group, axis_line, cache_specs,
                       data_groups, fit_spec_tree, place, tree_map)

__all__ = ["KINDS", "TensorParallel", "Rows", "Cols", "RowsNotAlike"]

KINDS = ("tp_reduce", "fsdp_gather", "vocab", "heads", "moe_tokens",
         "merge", "state", "grad_reduce")

#: a leaf's layer: the stacked groups of ``tensor_tree()`` paths
_LAYER = re.compile(r"^((?:layers|mamba|encoder|decoder)/\d+)/")


def _paths(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _part(pl: Placed, split: tuple, key: tuple, pos: tuple, axes: tuple,
          g: torch.Tensor) -> torch.Tensor | None:
    """The part of use gradient ``g`` (of ``pl`` at ``pos``, gathered over
    ``axes``; ``split``: ``pl``'s axes by dim) that covers the slice
    ``key``, or None when the use does not cover it."""
    cover = [(0, n) if set(split[d]) & set(axes) else ab
             for d, (ab, n) in enumerate(zip(pl.slice_key(pos), pl.shape))]
    if not all(c0 <= k0 and k1 <= c1 for (k0, k1), (c0, c1)
               in zip(key, cover)):
        return None
    return g[tuple(slice(k0 - c0, k1 - c0) for (k0, k1), (c0, _)
                   in zip(key, cover))]


class _Send(torch.autograd.Function):
    """A copy between positions under autograd: the backward sends the
    gradient back to the source's device, counted under the same
    kind."""

    @staticmethod
    def forward(ctx, t, tp, kind, src, dst):
        ctx.back = (tp, kind, dst, src, t.device)
        return t.to(tp.mesh.devices[dst])

    @staticmethod
    def backward(ctx, g):
        tp, kind, src, dst, dev = ctx.back
        tp.count(kind, g, src, dst)
        return g.to(dev), None, None, None, None


class _SendFixed(torch.autograd.Function):
    """:meth:`TensorParallel.send_fixed` under autograd: the backward's
    copies back are counted for every row too."""

    @staticmethod
    def forward(ctx, t, tp, kind, src, dst, moving):
        ctx.back = (tp, kind, src, dst, moving, t.device)
        return t.to(tp.mesh.devices[dst])

    @staticmethod
    def backward(ctx, g):
        tp, kind, src, dst, moving, dev = ctx.back
        tp._count_rows(kind, _nbytes(g), src, dst, moving)
        return g.to(dev), None, None, None, None, None


class RowsNotAlike(Exception):
    """A one-row trace met work that the rows do not do alike (a train
    step's routing unit of every row): trace all the rows instead."""


class _RowPlaced(Placed):
    """A placed value of a one-row placement: each position's tensor is
    that of the position of row 0 with the same coordinates off the
    batch axes (``stand``), and :meth:`holders` lists the slices those
    positions hold."""

    def __init__(self, shape, dtype, sharding, local, stand: dict):
        super().__init__(shape, dtype, sharding, local)
        self._stand = stand

    def holders(self) -> dict[tuple, list[tuple[int, ...]]]:
        out: dict = {}
        for pos in sorted(set(self._stand.values())):
            out.setdefault(self.slice_key(pos), []).append(pos)
        return out


class _SendEach(torch.autograd.Function):
    """:meth:`TensorParallel._send_each` under autograd: the backward
    counts each pair's gradient on its way back."""

    @staticmethod
    def forward(ctx, t, tp, kind, pairs):
        ctx.back = (tp, kind, pairs)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        tp, kind, pairs = ctx.back
        for src, dst in pairs:
            tp.count(kind, g, dst, src)
        return g, None, None, None


class _Use(torch.autograd.Function):
    """A weight as one position reads it, under autograd: forward, the
    tensor itself (an alias); backward, the gradient handed to ``tp`` as
    use ``uid``'s and nothing passed on (``anchor`` is a leaf that only
    makes the output require grad)."""

    @staticmethod
    def forward(ctx, anchor, w, tp, uid):
        ctx.tp, ctx.uid = tp, uid
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        ctx.tp._got[ctx.uid] = g
        return None, None, None, None


class TensorParallel:
    """A model's parameter tree placed over ``mesh`` by ``specs`` (views on
    the weights' own device, one copy on each other device) and the
    per-position work of a split step.

    ``batch_axes`` (a mesh axis, a tuple of them, or None) split the
    batch: ``rows[i][j]`` is the position of batch shard ``i`` and model
    shard ``j``; ``n_rows`` counts them. ``moved`` counts the bytes
    copied between positions by ``(kind, position)``; it grows until the
    caller clears it. ``train``: the weights read under autograd are uses
    whose gradients :meth:`grads` reduces (a train cell's placement).
    ``one_row``: ``rows`` is row 0 alone, and the others are counted by
    symmetry (the module's docstring; :meth:`fold` ends such a step's
    count); ``mesh`` must then be on the ``meta`` device. ``draw``: the
    leaves of ``tree`` give only shapes (``meta``), and each piece is
    made where it lies as ``draw(path, leaf, key, device)`` (``key``: its
    ``(start, stop)`` by dim; ``sharding.place``).
    """

    def __init__(self, mesh: Mesh, tree: Any, specs: Any, batch_axes, *,
                 train: bool = False, one_row: bool = False,
                 draw: Callable | None = None):
        if one_row and mesh.first_device.type != "meta":
            raise ValueError("a one-row placement counts the other rows' "
                             "work without doing it: meta meshes only")
        self.mesh = mesh
        self.train = train
        self.batch_axes = batch_axes
        baxes = _axes(batch_axes)
        # pure FSDP splits the batch over the model axis too: no tensor
        # parallelism, and weights gather over every axis
        self.model_axis = ("model" if "model" in mesh.axis_names
                           and "model" not in baxes else None)
        self.rows = data_groups(mesh, model_axis=self.model_axis,
                                batch_axes=baxes)
        self.n_rows = len(self.rows)
        self.n_model = (mesh.shape[self.model_axis] if self.model_axis
                        else 1)
        self.gather_axes = tuple(a for a in mesh.axis_names
                                 if a != self.model_axis)
        self.moved: Counter = Counter()
        self._lock = threading.Lock()
        # column splits stay views: the GEMMs read them through strides
        paths = {id(t): path for path, t in _paths(tree)}
        self.tree = tree_map(lambda x, s: place(
            x, mesh, s, contiguous=False, draw=None if draw is None else
            functools.partial(draw, paths[id(x)], x)), tree, specs)
        self.one_row = one_row and self.n_rows > 1
        self._once = False
        if self.one_row:
            # the batch axes' indices, each row's coordinates on them, and
            # the row-0 position standing for each position
            self._bidx = [mesh.axis_names.index(a) for a in baxes
                          if a in mesh.axis_names]
            self._shifts = [tuple(row[0][k] for k in self._bidx)
                            for row in self.rows]
            self.rows = self.rows[:1]
            self._row: Counter = Counter()
            self._stand = {pos: tuple(0 if k in self._bidx else c
                                      for k, c in enumerate(pos))
                           for pos in np.ndindex(mesh.devices.shape)}
            self.tree = tree_map(self._alias, self.tree)
        self._by_id = {id(t): (path, pl) for (path, t), (_, pl) in
                       zip(_paths(tree), _paths(self.tree))}
        self._gathered: dict = {}
        self._counted: set = set()
        self._layer: str | None = None
        # training: the weights read under autograd, and their gradients
        self.uses: list[tuple] = []
        self._got: dict[int, torch.Tensor] = {}
        self._anchor = torch.zeros((), requires_grad=True)

    # -- counting -----------------------------------------------------------
    def count(self, kind: str, t: torch.Tensor, src: tuple,
              dst: tuple) -> None:
        """Count ``t``'s bytes from position ``src`` to ``dst`` (nothing
        when they are one position); in a one-row trace, for the traced
        row, to be folded (:meth:`fold`), unless done once for every row
        (:meth:`every_row`)."""
        if src != dst:
            n = _nbytes(t)
            with self._lock:        # backwards count from each card's thread
                moved = (self._row if self.one_row and not self._once
                         else self.moved)
                moved[kind, src] += n
                moved[kind, dst] += n

    def send(self, kind: str, t: torch.Tensor, src: tuple,
             dst: tuple) -> torch.Tensor:
        """``t`` from position ``src`` to ``dst``: counted (unless they are
        one position) and moved to ``dst``'s device; under autograd the
        gradient comes back the same way (:class:`_Send`)."""
        self.count(kind, t, src, dst)
        if src != dst and torch.is_grad_enabled() and t.requires_grad:
            return _Send.apply(t, self, kind, src, dst)
        return t.to(self.mesh.devices[dst])

    def send_fixed(self, kind: str, t: torch.Tensor, src: tuple,
                   dst: tuple, moving: str = "src") -> torch.Tensor:
        """:meth:`send` of a copy that a batch row makes between one of
        its positions (``src`` or ``dst``, as ``moving`` says) and a
        position that is the same for every row (the mesh's first, a
        routing unit's home). Each row calls it for its own copy; in a
        one-row trace the traced row's call counts every row's, its
        moving end shifted to that row."""
        if not self.one_row or self._once:
            return self.send(kind, t, src, dst)
        self._count_rows(kind, _nbytes(t), src, dst, moving)
        if torch.is_grad_enabled() and t.requires_grad:
            return _SendFixed.apply(t, self, kind, src, dst, moving)
        return t.to(self.mesh.devices[dst])

    def _send_each(self, kind: str, t: torch.Tensor,
                   pairs: list[tuple]) -> torch.Tensor:
        """``t`` copied between each ``(src, dst)`` of ``pairs``, all
        counted (under autograd each gradient's way back too) and ``t``
        returned once: a one-row trace's stand-in for copies that several
        positions make alike (:meth:`partials_summed`); its tensors are
        ``meta``."""
        for src, dst in pairs:
            self.count(kind, t, src, dst)
        if torch.is_grad_enabled() and t.requires_grad:
            return _SendEach.apply(t, self, kind, pairs)
        return t

    def _shift(self, pos: tuple, i: int) -> tuple:
        """``pos`` with its batch-axis coordinates moved on by row
        ``i``'s."""
        pos = list(pos)
        for k, c in zip(self._bidx, self._shifts[i]):
            pos[k] = (pos[k] + c) % self.mesh.devices.shape[k]
        return tuple(pos)

    def _count_rows(self, kind: str, n: int, src: tuple, dst: tuple,
                    moving: str) -> None:
        with self._lock:
            for i in range(len(self._shifts)):
                s = self._shift(src, i) if moving == "src" else src
                d = self._shift(dst, i) if moving == "dst" else dst
                if s != d:
                    self.moved[kind, s] += n
                    self.moved[kind, d] += n

    def partials_summed(self, fn: Callable, x: torch.Tensor,
                        weights: tuple, src: tuple, dst: tuple,
                        holders: list[tuple], kinds: tuple[str, str], *,
                        gather: bool = True) -> torch.Tensor:
        """The sum on ``dst``, in holder order, of each holder's partial
        ``fn(x, *w)``: ``x`` sent from ``src`` to each of ``holders``
        (``kinds[0]``), each of ``weights`` read there (:meth:`weight`,
        ``gather``) and the partial sent to ``dst`` (``kinds[1]``). With
        several holders the weights stay split over ``data`` and ``fn``
        must sum over their slices, each slice's term its own (a SwiGLU's
        over F): a one-row trace joins the holders' slices along that dim
        and runs ``fn`` once, every copy counted, for the same FLOPs,
        forward and backward, in a fraction of the ops."""
        if self.one_row and len(holders) > 1 and not gather:
            ws = [torch.cat([self.weight(w, q, gather=False)
                             for q in holders],
                            dim=self.placed(w).split_dim("data"))
                  for w in weights]
            xj = self._send_each(kinds[0], x, [(src, q) for q in holders])
            return self._send_each(kinds[1], fn(xj, *ws),
                                   [(q, dst) for q in holders])
        out = None
        for q in holders:
            xj = self.send(kinds[0], x, src, q)
            part = fn(xj, *(self.weight(w, q, gather=gather)
                            for w in weights))
            part = self.send(kinds[1], part, q, dst)
            out = part if out is None else out + part
        return out

    def scan_sites(self, fn: Callable, sites: list[tuple], args: list[tuple],
                   dims: tuple) -> list[tuple]:
        """``fn(*args[k])`` for each of a row's head sites ``sites[k]``
        (``(position, lo, hi)``, :meth:`head_sites`), its arguments
        already on its position: each site's output (b, s, heads, ...)
        and final state (b, heads, ...). ``fn`` (a recurrence) treats its
        heads independently; ``dims`` gives each argument's head dim, or
        None for one that every site holds alike (the same value at
        each).

        A one-row trace joins the sites' arguments along their head dims
        (an argument held alike is read from the first site) and runs
        ``fn`` once, over all the row's heads as the unplaced step does,
        then splits each output back by the sites' ``[lo, hi)``: the same
        FLOPs, forward and backward, in a fraction of the ops. The sites'
        other work stays theirs, so every copy is counted as before. An
        argument held alike gets its whole gradient on the first site and
        none on the others: the same sum, the copies being one value."""
        if not self.one_row or len(sites) == 1:
            return [fn(*a) for a in args]
        joined = [args[0][k] if d is None else
                  torch.cat([a[k] for a in args], dim=d)
                  for k, d in enumerate(dims)]
        sizes = [hi - lo for _, lo, hi in sites]
        out, state = fn(*joined)
        return list(zip(out.split(sizes, dim=2), state.split(sizes, dim=1)))

    def op_rows(self) -> int:
        """The batch rows that an op run now stands for: each row in a
        one-row trace (but for work done once for every row), else one."""
        return self.n_rows if self.one_row and not self._once else 1

    @contextlib.contextmanager
    def _done_once(self):
        prev, self._once = self._once, True
        try:
            yield
        finally:
            self._once = prev

    @contextlib.contextmanager
    def every_row(self):
        """Work done once for every row's tokens together, on row 0's
        positions (a routing unit of every row): a one-row trace counts
        its copies and ops as they are, not for each row. A train step's
        rows are then not alike (row 0's positions use the weights for
        all), so a one-row trace raises :class:`RowsNotAlike` and is run
        over every row instead."""
        if self.one_row and self.train:
            raise RowsNotAlike("a train step's work of every row on row 0")
        with self._done_once():
            yield

    def fold(self) -> None:
        """End a one-row trace's count: each position gets the traced
        row's counts summed over its batch-axis coordinates (every row's
        copies of those kinds). A no-op for a placement of every row."""
        if not self.one_row:
            return
        with self._lock:
            row, self._row = self._row, Counter()
            for (kind, pos), n in row.items():
                for i in range(len(self._shifts)):
                    self.moved[kind, self._shift(pos, i)] += n

    def join_rows(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The rows' parts, on one position, joined in row order (in a
        one-row trace the traced row's part stands for each row's)."""
        if not self.one_row:
            return torch.cat(parts)
        with self._done_once():
            return torch.cat(parts * self.n_rows)

    def bytes_by_kind(self) -> dict[str, int]:
        """The bytes copied between positions by kind, each copy once."""
        out = dict.fromkeys(KINDS, 0)
        for (kind, _), n in self.moved.items():
            out[kind] += n
        return {k: n // 2 for k, n in out.items()}

    def by_position(self, kind: str | None = None) -> Counter:
        """Bytes each position sent and received (of one kind, or all)."""
        out: Counter = Counter()
        for (k, pos), n in self.moved.items():
            if kind is None or k == kind:
                out[pos] += n
        return out

    # -- weights ------------------------------------------------------------
    def placed(self, t: torch.Tensor) -> Placed:
        try:
            return self._by_id[id(t)][1]
        except KeyError:
            raise KeyError("not a parameter of the placed model") from None

    def model_dim(self, t: torch.Tensor) -> int | None:
        """The dim of parameter ``t`` that the ``model`` axis splits for
        tensor parallelism (None under pure FSDP)."""
        if self.model_axis is None:
            return None
        return self.placed(t).split_dim(self.model_axis)

    def model_range(self, t: torch.Tensor, j: int) -> tuple[int, int]:
        """Model shard ``j``'s range of ``t``'s model-split dim."""
        n = self.placed(t).shape[self.model_dim(t)]
        return j * n // self.n_model, (j + 1) * n // self.n_model

    def _gather_axes(self, pl: Placed) -> tuple[str, ...]:
        return tuple(a for a in self.gather_axes
                     if pl.split_dim(a) is not None)

    def weight(self, t: torch.Tensor, pos: tuple, *,
               gather: bool = True) -> torch.Tensor:
        """What position ``pos`` multiplies by for parameter ``t``: its
        local piece, with the FSDP split (``data``; under pure FSDP
        ``data`` and ``model``) gathered (``gather``; each position
        counted once a layer, one tensor a device). Moving to a leaf of
        another layer, or :meth:`release`, drops the gathered tensors.
        When training under autograd the tensor is a use (:class:`_Use`)
        whose gradient :meth:`grads` reduces."""
        path, pl = self._by_id[id(t)]
        m = _LAYER.match(path)
        layer = m.group(1) if m else ""
        if layer != self._layer:
            self.release()
            self._layer = layer
        axes = self._gather_axes(pl) if gather else ()
        if not axes:
            w = pl.local(pos)
        else:
            if (id(pl), pos) not in self._counted:
                self._counted.add((id(pl), pos))
                for q in axis_group(self.mesh, pos, axes):
                    self.count("fsdp_gather", pl.local(q), q, pos)
            key = (id(pl), self.mesh.devices[pos]) + tuple(
                0 if a in axes or pl.split_dim(a) is None else pos[k]
                for k, a in enumerate(self.mesh.axis_names))
            if key not in self._gathered:
                with torch.no_grad():
                    self._gathered[key] = pl.gather(pos, axes)
            w = self._gathered[key]
        if self.train and torch.is_grad_enabled():
            self.uses.append((pl, pos, axes))
            w = _Use.apply(self._anchor, w, self, len(self.uses) - 1)
        return w

    def grads(self) -> Any:
        """The weight gradients of the backward just run, reduced, as a
        tree of ``Placed`` values laid out as ``tree`` (one tensor per
        device and slice, in the parameter's dtype); the uses
        are then forgotten. Each slice's gradient is the fp32 sum, on its
        first holder, of the part of every use covering it (positions in
        mesh order, a position's uses in forward order), sent there from
        the use's position; the sum is sent to every other holder
        (``grad_reduce`` both ways). A slice no use covers is zero; a
        parameter no gradient reached raises, as the mesh-less step
        does."""
        got, uses = self._got, self.uses
        self._got, self.uses = {}, []
        by_leaf: dict = {}
        for uid, (pl, pos, axes) in enumerate(uses):
            if uid in got:
                by_leaf.setdefault(id(pl), []).append((pos, uid, axes,
                                                       got[uid]))
        missing = [path for path, pl in _paths(self.tree)
                   if id(pl) not in by_leaf]
        if missing:
            raise RuntimeError(f"no gradient reached parameters {missing}")
        reduce = self._reduce_row if self.one_row else self._reduce
        return tree_map(lambda pl: reduce(
            pl, sorted(by_leaf[id(pl)], key=lambda u: u[:2])), self.tree)

    def _alias(self, pl: Placed) -> _RowPlaced:
        return _RowPlaced(pl.shape, pl.dtype, pl.sharding,
                          {pos: pl.local(s) for pos, s in self._stand.items()},
                          self._stand)

    def _reduce_row(self, pl: Placed, uses: list) -> _RowPlaced:
        """:meth:`_reduce` in a one-row trace: every row's copies counted
        (:meth:`_count_reduce`), and the sums made for the slices of the
        traced row's positions, from the traced row's uses."""
        self._count_reduce(pl, uses)
        split = pl.sharding._split(pl.ndim)
        made: dict = {}
        for pos in sorted(set(self._stand.values())):
            key = pl.slice_key(pos)
            if key in made:
                continue
            acc = None
            for p, _, axes, g in uses:
                part = _part(pl, split, key, p, axes, g)
                if part is not None:
                    part = part.to(self.mesh.devices[pos]).float()
                    acc = part if acc is None else acc + part
            if acc is None:
                acc = torch.zeros([k1 - k0 for k0, k1 in key],
                                  device=self.mesh.devices[pos])
            made[key] = acc.to(pl.dtype)
        return _RowPlaced(pl.shape, pl.dtype, pl.sharding,
                          {pos: made[pl.slice_key(s)]
                           for pos, s in self._stand.items()}, self._stand)

    def _count_reduce(self, pl: Placed, uses: list) -> None:
        """:meth:`_reduce`'s ``grad_reduce`` bytes for leaf ``pl``, every
        row's uses counted from the traced row's ``uses``.

        A slice's first holder (its home) is its holder with coordinate 0
        on each axis that does not split the leaf. A use at ``p`` that
        gathers the axes ``G`` covers the slices that differ from ``p``'s
        only on ``G``: it sends each its part, but for ``p``'s own slice
        when ``p`` is its home. Over the rows, the uses of the traced
        use's shifts are at every position with its coordinates off the
        batch axes, and the homes they reach are counted in closed form.
        Each slice's sum then goes from its home to every other holder."""
        names, shape = self.mesh.axis_names, self.mesh.devices.shape
        size = dict(zip(names, shape))
        split = pl.sharding._split(pl.ndim)
        spl = {a for axes in split for a in axes}
        batch = {names[k] for k in self._bidx}
        idx = np.indices(shape)
        homes = np.ones(shape, bool)
        for k, a in enumerate(names):
            if a not in spl:
                homes &= idx[k] == 0
        numel = math.prod(k1 - k0 for k0, k1 in pl.slice_key(
            (0,) * len(shape)))
        out = np.zeros(shape, np.int64)
        for (p0, axes, itemsize), n_uses in Counter(
                (p, axes, g.element_size()) for p, _, axes, g in uses).items():
            whole = {a for d in split if set(d) & set(axes) for a in d}
            kept = spl - whole          # split axes the use does not gather
            part = numel * itemsize * n_uses
            shifts = np.ones(shape, bool)     # the use's position in each row
            reach = homes * math.prod(size[a] for a in batch
                                      if a not in kept)
            for k, a in enumerate(names):
                if a not in batch:
                    shifts &= idx[k] == p0[k]
                    if a in kept:
                        reach = reach * (idx[k] == p0[k])
            own = shifts & homes
            out += part * (shifts * math.prod(size[a] for a in whole)
                           - 2 * own + reach)
        holders = math.prod(size[a] for a in names if a not in spl)
        out += numel * pl.dtype.itemsize * np.where(homes, holders - 1, 1)
        with self._lock:
            for pos in zip(*np.nonzero(out)):
                pos = tuple(int(c) for c in pos)
                self.moved["grad_reduce", pos] += int(out[pos])

    def _reduce(self, pl: Placed, uses: list) -> Placed:
        split = pl.sharding._split(pl.ndim)
        local = {}
        for key, holders in pl.holders().items():
            home = holders[0]
            acc = None
            for pos, _, axes, g in uses:
                part = _part(pl, split, key, pos, axes, g)
                if part is None:
                    continue
                self.count("grad_reduce", part, pos, home)
                part = part.to(self.mesh.devices[home]).float()
                acc = part if acc is None else acc + part
            if acc is None:
                acc = torch.zeros([k1 - k0 for k0, k1 in key],
                                  device=self.mesh.devices[home])
            value = acc.to(pl.dtype)
            made: dict = {}
            for r in holders:
                self.count("grad_reduce", value, home, r)
                dev = self.mesh.devices[r]
                if dev not in made:
                    made[dev] = value.to(dev)
                local[r] = made[dev]
        return Placed(pl.shape, pl.dtype, pl.sharding, local)

    def cols(self, t: torch.Tensor, lo: int, hi: int, pos: tuple,
             dim: int = -1) -> torch.Tensor:
        """Indices ``[lo, hi)`` of parameter ``t``'s dim ``dim`` on
        position ``pos``: a slice of its own piece where the ``model``
        axis does not split that dim, else the overlapping pieces of the
        model positions of ``pos``'s row sent there (``heads``) and
        joined in order."""
        dim = dim % t.ndim
        if self.model_dim(t) != dim:
            return self.weight(t, pos).narrow(dim, lo, hi - lo)
        out = []
        for j, q in enumerate(axis_line(self.mesh, pos, "model")):
            a, b = self.model_range(t, j)
            if max(a, lo) < min(b, hi):
                piece = self.weight(t, q).narrow(dim, max(a, lo) - a,
                                                 min(b, hi) - max(a, lo))
                out.append(self.send("heads", piece, q, pos))
        return out[0] if len(out) == 1 else torch.cat(out, dim=dim)

    # -- recurrent states ---------------------------------------------------
    def head_sites(self, n_heads: int) -> list[list[tuple]]:
        """Where each batch row's ``n_heads`` heads run, ``(position,
        first head, end)`` in model order: model position ``j`` of the row
        heads ``[j·n/m, (j+1)·n/m)`` where ``m`` divides ``n`` (the heads
        that ``cache_specs`` puts on it), else all on the row's first
        position (a head that the model axis would cut, or one model
        position)."""
        m = self.n_model
        if m > 1 and n_heads % m == 0:
            return [[(pos, j * n_heads // m, (j + 1) * n_heads // m)
                     for j, pos in enumerate(row)] for row in self.rows]
        return [[(row[0], 0, n_heads)] for row in self.rows]

    def place_states(self, states: dict) -> dict:
        """Each stacked (L, B, ...) recurrent state of ``states`` placed
        over the mesh by its ``cache_specs`` entry, fitted (batch over the
        batch axes, heads over ``model``; a dim the axes do not divide
        stays whole), in the dict; a state placed so stays as it is.
        Returns ``states``."""
        specs = fit_spec_tree(self.mesh, cache_specs(None, self.mesh,
                                                     states), states)
        for key, spec in specs.items():
            states[key] = place(states[key], self.mesh, spec)
        return states

    def state_at(self, pl: Placed, i: int, pos: tuple,
                 *ranges: tuple[int, int]) -> torch.Tensor:
        """Position ``pos``'s tensor of one layer's placed state ``pl``
        (B, ...), checked to hold batch row ``i``'s rows and ``ranges`` of
        the dims after the batch: the tensor the position's step reads and
        writes."""
        b = pl.shape[0] // self.n_rows
        want = [(i * b, (i + 1) * b), *ranges]
        sl = pl.sharding.local_slices(pos, pl.shape)
        got = [(s.start, s.stop) for s in sl[:len(want)]]
        if got != want:
            raise ValueError(f"{pl} holds {got} at {pos}, not {want}")
        return pl.local(pos)

    def write_state(self, pl: Placed, pieces: list[tuple]) -> None:
        """Write new values of one layer's placed state ``pl`` into every
        position's tensor, in place. ``pieces`` lists ``(position, region,
        value)``: ``value`` is the state's ``region`` (``(start, stop)``
        of each leading dim) as ``position`` computed it, and goes into
        that position's own tensor first, uncounted. Every other position
        holding part of a region gets that part sent from the piece's
        position (``state``); positions of one device that share a tensor
        are written once and counted all the same."""
        done = set()

        def write(pos, src, region, value):
            region = [*region] + [(0, n) for n in pl.shape[len(region):]]
            sl = pl.sharding.local_slices(pos, pl.shape)
            inter = [(max(a, s.start), min(b, s.stop))
                     for (a, b), s in zip(region, sl)]
            if any(a >= b for a, b in inter):
                return
            part = value[tuple(slice(a - r, b - r) for (a, b), (r, _) in
                               zip(inter, region))]
            if src != pos:
                part = self.send("state", part, src, pos)
            local = pl.local(pos)
            key = (id(local), tuple(inter))
            if key not in done:
                done.add(key)
                local[tuple(slice(a - s.start, b - s.start)
                            for (a, b), s in zip(inter, sl))] = part

        for src, region, value in pieces:
            write(src, src, region, value)
        for pos in np.ndindex(self.mesh.devices.shape):
            for src, region, value in pieces:
                if pos != src:
                    write(pos, src, region, value)

    def release(self) -> None:
        """Drop the gathered weights."""
        self._gathered.clear()
        self._counted.clear()
        self._layer = None

    def local(self, t: Any, pos: tuple) -> Any:
        """``t`` as position ``pos`` uses it: a parameter's
        :meth:`weight`; another tensor (a derived table such as RoPE's, a
        position index) on ``pos``'s device, as each device would make
        it; anything else as it is."""
        if not torch.is_tensor(t):
            return t
        if id(t) in self._by_id:
            return self.weight(t, pos)
        return t.to(self.mesh.devices[pos])

    # -- activations --------------------------------------------------------
    def split_rows(self, x: torch.Tensor) -> "Rows":
        """A step input's batch rows on their rows' first positions (its
        placement by the cell's input specs, not a copy between
        positions)."""
        n = self.n_rows
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{n} batch shards")
        b = x.shape[0] // n
        return Rows(self, [x[i * b:(i + 1) * b].to(
            self.mesh.devices[row[0]]) for i, row in enumerate(self.rows)])

    def col_linear(self, x: "Rows", t: torch.Tensor,
                   bias: torch.Tensor | None = None, *,
                   transposed: bool = False) -> "Cols":
        """``x @ t (+ bias)`` with ``t``'s output dim over the model
        positions of each row (``t.T`` when ``transposed``, a tied head);
        a weight the model axis does not split multiplies whole on the
        row's first position."""
        out_dim = 0 if transposed else 1
        mdim = self.model_dim(t)
        if mdim is not None and mdim != out_dim:
            raise ValueError("col_linear on a row-parallel weight")
        pieces = []
        for i, row in enumerate(self.rows):
            sites = row if mdim is not None else row[:1]
            out = []
            for j, pos in enumerate(sites):
                w = self.weight(t, pos)
                y = x.at(i, j) @ (w.T if transposed else w)
                if bias is not None:
                    y = y + self.weight(bias, pos)
                lo, hi = (self.model_range(t, j) if mdim is not None
                          else (0, self.placed(t).shape[out_dim]))
                out.append((pos, lo, hi, y))
            pieces.append(out)
        return Cols(self, pieces)

    def row_linear(self, h: "Cols | Rows", t: torch.Tensor,
                   bias: torch.Tensor | None = None,
                   kind: str = "heads") -> "Rows":
        """``h @ t (+ bias)`` with ``t``'s input dim over the model
        positions of each row: each multiplies its columns of ``h``, the
        partials add on the row's first position in model order, then the
        bias. Columns of ``h`` not where ``t``'s rows are go there first
        (counted as ``kind``); a weight the model axis does not split
        multiplies whole on the row's first position."""
        if isinstance(h, Rows):
            h = Cols.of_rows(h)
        mdim = self.model_dim(t)
        if mdim not in (None, 0):
            raise ValueError("row_linear on a column-parallel weight")
        parts = []
        for i, row in enumerate(self.rows):
            home = row[0]
            if mdim is None:
                hw = h.row_at(i, home, kind)
                acc = hw @ self.weight(t, home)
            else:
                ranges = [self.model_range(t, j) for j in range(len(row))]
                have = h.pieces[i]
                if [(p, lo, hi) for p, lo, hi, _ in have] != [
                        (row[j], lo, hi) for j, (lo, hi) in
                        enumerate(ranges)]:
                    whole = h.row_at(i, home, kind)
                    have = [(row[j], lo, hi, self.send(
                        kind, whole[..., lo:hi], home, row[j]))
                        for j, (lo, hi) in enumerate(ranges)]
                acc = None
                for j, (pos, _, _, hj) in enumerate(have):
                    part = self.send("tp_reduce", hj @ self.weight(t, pos),
                                     pos, home)
                    acc = part if acc is None else acc + part
            if bias is not None:
                acc = acc + self.weight(bias, home)
            parts.append(acc)
        return Rows(self, parts)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> "Rows":
        """``table[tokens]`` (``layers.take_rows``), vocab-parallel: each
        model position of a row looks up the ids in its vocab range and
        zeros elsewhere, and the partials add on the row's first position
        in model order. An id outside the table stays outside every
        position's range, so the lookup raises (asserts on a card) as the
        whole gather does."""
        toks = self.split_rows(tokens)
        vocab = self.placed(table).shape[0]
        split = self.model_dim(table) == 0
        parts = []
        for i, row in enumerate(self.rows):
            home = row[0]
            ids = toks.parts[i]
            if not split:
                parts.append(F.embedding(ids, self.weight(table, home)))
                continue
            acc = None
            for j, pos in enumerate(row):
                lo, hi = self.model_range(table, j)
                mine = self.send("vocab", ids, home, pos)
                inside = (mine >= lo) & (mine < hi)
                other = (mine >= 0) & (mine < vocab) & ~inside
                rows_j = F.embedding(torch.where(other, 0, mine - lo),
                                     self.weight(table, pos))
                part = self.send("vocab", torch.where(
                    inside[..., None], rows_j, 0), pos, home)
                acc = part if acc is None else acc + part
            parts.append(acc)
        return Rows(self, parts)

    def head(self, x: "Rows", w: torch.Tensor, *,
             transposed: bool = False) -> torch.Tensor:
        """``x @ w``, vocab-parallel: each model position's logits
        columns join in order on its row's first position, the rows in
        order on the mesh's first device; the gathered weights are then
        released (the head ends a step)."""
        out = self.col_linear(x, w, transposed=transposed).to_rows("vocab")
        self.release()
        return out.whole("vocab")


class Rows:
    """A batch-split activation: ``parts[i]`` is batch shard ``i``'s rows,
    on its row's first position ``tp.rows[i][0]``. ``shape`` is the whole
    value's; ``at(i, j)`` is part ``i`` on model position ``j`` of its
    row, sent once (``tp_reduce``)."""

    def __init__(self, tp: TensorParallel, parts: list[torch.Tensor]):
        self.tp = tp
        self.parts = list(parts)
        self._at: dict = {}

    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.parts[0].shape[0] * self.tp.n_rows,
                           *self.parts[0].shape[1:]))

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def map(self, fn: Callable, *args, **kwargs) -> "Rows":
        """``fn`` on each part, with each :class:`Rows` argument's part
        and each tensor as the row's first position uses it
        (``TensorParallel.local``)."""
        out = []
        for i, part in enumerate(self.parts):
            pos = self.tp.rows[i][0]
            a = [x.parts[i] if isinstance(x, Rows) else self.tp.local(x, pos)
                 for x in args]
            out.append(fn(part, *a, **kwargs))
        return Rows(self.tp, out)

    def at(self, i: int, j: int) -> torch.Tensor:
        if (i, j) not in self._at:
            row = self.tp.rows[i]
            self._at[i, j] = self.tp.send("tp_reduce", self.parts[i],
                                          row[0], row[j])
        return self._at[i, j]

    def __add__(self, other) -> "Rows":
        return self.map(lambda a, b: a + b, other)

    def __getitem__(self, idx) -> "Rows":
        return self.map(lambda a: a[idx])

    def whole(self, kind: str) -> torch.Tensor:
        """The value on the mesh's first device, rows joined in order."""
        at0 = (0,) * self.tp.mesh.devices.ndim
        return self.tp.join_rows([
            self.tp.send_fixed(kind, p, self.tp.rows[i][0], at0)
            for i, p in enumerate(self.parts)])


class Cols:
    """An activation split by columns: per batch row ``i``,
    ``pieces[i]`` lists ``(position, lo, hi, tensor)`` in model order,
    each tensor columns ``[lo, hi)`` of the row's value (columns of its
    last dim, or heads of a (b, s, heads, hd) piece: ``dim`` is the dim
    the pieces join along)."""

    def __init__(self, tp: TensorParallel, pieces: list[list[tuple]],
                 dim: int = -1):
        self.tp = tp
        self.pieces = pieces
        self.dim = dim

    @classmethod
    def of_rows(cls, x: Rows) -> "Cols":
        return cls(x.tp, [[(x.tp.rows[i][0], 0, p.shape[-1], p)]
                          for i, p in enumerate(x.parts)])

    def map(self, fn: Callable, *args, dim: int | None = None,
            **kwargs) -> "Cols":
        """``fn`` on each piece where it lies, with the same piece of each
        :class:`Cols` argument and each tensor as that position uses it
        (``TensorParallel.local``); ranges kept, ``dim`` the new joining
        dim (default: this one's)."""
        out = []
        for i, row in enumerate(self.pieces):
            out.append([(pos, lo, hi, fn(t, *(
                a.pieces[i][k][3] if isinstance(a, Cols)
                else self.tp.local(a, pos) for a in args), **kwargs))
                for k, (pos, lo, hi, t) in enumerate(row)])
        return Cols(self.tp, out, self.dim if dim is None else dim)

    def gathered(self, kind: str) -> "Cols":
        """Each row's pieces joined on the row's first position (one
        piece a row, covering every column)."""
        out = []
        for i, row in enumerate(self.pieces):
            home = self.tp.rows[i][0]
            out.append([(home, row[0][1], row[-1][2],
                         self.row_at(i, home, kind))])
        return Cols(self.tp, out, self.dim)

    def take(self, i: int, lo: int, hi: int, dst: tuple,
             kind: str) -> torch.Tensor:
        """Columns ``[lo, hi)`` of row ``i`` on position ``dst``: the
        overlapping pieces' columns sent there (``kind``) and joined in
        order."""
        out = []
        for pos, a, b, t in self.pieces[i]:
            if max(a, lo) < min(b, hi):
                piece = t.narrow(self.dim, max(a, lo) - a,
                                 min(b, hi) - max(a, lo))
                out.append(self.tp.send(kind, piece, pos, dst))
        return out[0] if len(out) == 1 else torch.cat(out, dim=self.dim)

    def row_at(self, i: int, dst: tuple, kind: str, *,
               fixed: bool = False) -> torch.Tensor:
        """Row ``i`` whole on position ``dst`` (``fixed``: a position that
        is the same for every row, ``TensorParallel.send_fixed``)."""
        send = self.tp.send_fixed if fixed else self.tp.send
        parts = [send(kind, t, pos, dst) for pos, _, _, t in self.pieces[i]]
        return parts[0] if len(parts) == 1 else torch.cat(parts,
                                                          dim=self.dim)

    def to_rows(self, kind: str) -> Rows:
        """Each row whole on its first position."""
        return Rows(self.tp, [self.row_at(i, self.tp.rows[i][0], kind)
                              for i in range(len(self.pieces))])

    def whole(self, kind: str) -> torch.Tensor:
        """The value on the mesh's first device."""
        at0 = (0,) * self.tp.mesh.devices.ndim
        return self.tp.join_rows([self.row_at(i, at0, kind, fixed=True)
                                  for i in range(len(self.pieces))])

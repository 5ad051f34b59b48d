"""FusedEmbeddingCollection — store-backed realization of paper Alg. 1.

Counterpart of ``repro.embedding.collection``. All k per-field tables are
concatenated row-wise into one mega-table; per-field ids become global
rows via static offsets, and one gather replaces k serial lookups (C2,
with C3's output-first allocation inside the kernel). Where the table
lives is the store's business.

The reference's ``apply(params, ids)`` is this module's ``forward(ids)``
and its ``apply_multihot`` is ``forward_multihot`` (``nn.Module.apply``
means something else in PyTorch).

Distribution: the dense table (or a cached store's backing) is
row-sharded over a mesh's ``model`` axis (vocab-parallel).
``apply_sharded`` is the masked local gather + sum over the model axis,
driven from one process: for each batch shard, each model shard gathers
its own rows on its own device (K1 on the shard, rows outside it zeroed;
K3/K4 over a cached store's shard, hit or miss; K2 for pooled ids), and
the partial outputs are summed onto the batch shard's device in shard
order. Exactly one shard contributes each row, so the sum is the 1-device
lookup bit for bit, but for an entry of -0.0, which comes back +0.0, as
the reference's ``psum`` returns it. :func:`sharded_vocab_lookup` is the
same pattern over one row-sharded table, for vocabulary lookups.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.distributed.sharding import Placed, data_groups
from repro_torch.kernels import multi_table_lookup as mtl
from repro_torch.kernels import ops as kops

from .spec import FusedEmbeddingSpec
from .store import DenseStore, EmbeddingStore

__all__ = ["FusedEmbeddingCollection", "GroupLookup",
           "sharded_vocab_lookup"]


def _batch_shards(x: torch.Tensor, mesh, groups: list) -> list:
    """``x``'s rows split over the batch shards of ``groups`` (all of them
    to the first when the batch does not divide), each on its shard's
    device: ``[(group, rows), ...]``."""
    n = len(groups)
    if x.shape[0] % n:
        groups, n = groups[:1], 1
    rows = x.shape[0] // n
    return [(g, x[i * rows:(i + 1) * rows].to(mesh.devices[g[0]]))
            for i, g in enumerate(groups)]


def _gather(parts: list[torch.Tensor], device) -> torch.Tensor:
    """Batch shards' outputs, in batch order, on ``device``."""
    if len(parts) == 1:
        return parts[0].to(device)
    return torch.cat([p.to(device) for p in parts])


class FusedEmbeddingCollection(nn.Module):
    """Lookup front-end over an :class:`EmbeddingStore` (a ``DenseStore``
    on ``device`` unless one is given)."""

    def __init__(self, spec: FusedEmbeddingSpec,
                 store: EmbeddingStore | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        self.spec = spec
        self.store = store if store is not None else DenseStore(
            spec, device=device)
        # row_dtype is the store's wire-format choice, not part of the
        # model's schema: two specs differing only there are compatible
        if dataclasses.replace(self.store.spec, row_dtype=None) != \
                dataclasses.replace(spec, row_dtype=None):
            raise ValueError("store was built for a different embedding "
                             f"spec: {self.store.spec} != {spec}")
        self.register_buffer("offsets", torch.as_tensor(
            spec.offsets, dtype=torch.int32, device=self.store.device))

    def dense_view(self) -> torch.Tensor:
        """The full (rows, d) table, whichever tier holds it."""
        return self.store.dense_view()

    def partition_spec(self, model_axis: str | None = "model") -> dict:
        """Mesh placement of the store's buffers (vocab-parallel tables;
        cache tiers replicated)."""
        return self.store.partition_spec(model_axis)

    def offsets_on(self, device: torch.device) -> torch.Tensor:
        """The field offsets on ``device`` (copied there once)."""
        if device == self.offsets.device:
            return self.offsets
        cache = self.__dict__.setdefault("_offsets_on", {})
        if device not in cache:
            cache[device] = self.offsets.to(device)
        return cache[device]

    def forward(self, ids: torch.Tensor, *, strategy: str = "auto",
                runtime: dict[str, torch.Tensor] | None = None
                ) -> torch.Tensor:
        """ids (b, k) int32 -> (b, k*d): one fused lookup."""
        return self.store.lookup(ids, self.offsets, strategy=strategy,
                                 runtime=runtime)

    def forward_multihot(self, ids: torch.Tensor, mask: torch.Tensor, *,
                         strategy: str = "auto",
                         runtime: dict[str, torch.Tensor] | None = None
                         ) -> torch.Tensor:
        """ids/mask (b, k, h) -> (b, k*d) sum-pooled."""
        return self.store.lookup_multihot(ids, mask, self.offsets,
                                          strategy=strategy, runtime=runtime)

    def apply_serial(self, ids: torch.Tensor) -> torch.Tensor:
        """Baseline: k separate gathers + concat (PyTorch-A)."""
        return kops.multi_table_lookup(ids, self.store.dense_view(),
                                       self.offsets, strategy="serial")

    # -- distributed lookup --------------------------------------------------
    def lookup_group(self, ids: torch.Tensor, tensors: dict[str, Placed],
                     group: list[tuple[int, ...]], *,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
        """One batch shard's lookup over the positions ``group`` (its
        model shards, in order): ``ids`` (b, k) (or (b, k, h) under
        ``mask``) on the first position's device, ``tensors`` the store's
        leaves placed over the mesh. A row-sharded table takes the masked
        local gather on every model shard's device, summed here in shard
        order; a replicated one, one lookup here."""
        store = self.store
        leaf = store.sharded_leaf
        first = group[0]
        mesh = next(iter(tensors.values())).mesh
        dev = mesh.devices[first]
        if leaf is None or tensors[leaf].sharding.shards(0) == 1:
            return store.lookup_shard(
                {k: v.local(first) for k, v in tensors.items()}, ids,
                self.offsets_on(dev), mask=mask)
        table = tensors[leaf]
        out = None
        for pos in group:
            local = {k: v.local(pos) for k, v in tensors.items()}
            where = mesh.devices[pos]
            lo = table.sharding.shard_index(pos, 0) * local[leaf].shape[0]
            part = store.lookup_shard(
                local, ids.to(where), self.offsets_on(where),
                mask=None if mask is None else mask.to(where),
                shard=(lo, table.shape[0])).to(dev)
            out = part if out is None else out + part
        return out

    def _sharded(self, ids, mask, mesh, model_axis, batch_axes, tensors):
        if tensors is None:
            tensors = self.store.place(self.store.device_tensors(), mesh,
                                       model_axis)
        groups = data_groups(mesh, model_axis, batch_axes)
        outs = []
        shards = _batch_shards(ids, mesh, groups)
        masks = ([None] * len(shards) if mask is None
                 else [m for _, m in _batch_shards(mask, mesh, groups)])
        for (group, rows), m in zip(shards, masks):
            outs.append(self.lookup_group(rows, tensors, group, mask=m))
        return _gather(outs, mesh.first_device)

    def apply_sharded(self, ids: torch.Tensor, mesh, *,
                      model_axis: str = "model",
                      batch_axes: tuple[str, ...] = ("data",),
                      tensors: dict[str, Placed] | None = None
                      ) -> torch.Tensor:
        """Vocab-parallel fused lookup of ``ids`` (b, k) over ``mesh``:
        rows over ``batch_axes`` (all on the first batch shard when they
        do not divide b), the table over ``model_axis``. ``tensors``: the
        store's leaves already placed (default: placed here from the
        store's buffers). Returns (b, k*d) on the mesh's first device.
        Ids outside the table clamp into it, as the 1-device lookup's do
        (the reference's ``shard_map`` path zeroes them)."""
        return self._sharded(ids, None, mesh, model_axis, batch_axes,
                             tensors)

    def apply_multihot_sharded(self, ids: torch.Tensor, mask: torch.Tensor,
                               mesh, *, model_axis: str = "model",
                               batch_axes: tuple[str, ...] = ("data",),
                               tensors: dict[str, Placed] | None = None
                               ) -> torch.Tensor:
        """:meth:`apply_sharded` for pooled ids/mask (b, k, h): each model
        shard pools the slots whose rows it holds (K2, or K3/K4 over a
        cached store), and the shards' sums add up (``rtol 1e-5, atol
        1e-5`` of the 1-device pool: the order of the additions
        differs)."""
        return self._sharded(ids, mask, mesh, model_axis, batch_axes,
                             tensors)

    def observe(self, ids) -> None:
        """Feed served (b, k) id traffic (numpy or a tensor) to the store's
        admission counters, on the host."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids, dtype=np.int64)
        if ids.ndim == 1:
            ids = ids[None, :]
        self.store.observe(ids + self.spec.offsets[None, :])


class GroupLookup:
    """A collection's lookups for one batch shard of a mesh plan: it
    stands in for the collection in that shard's copy of the model, so
    the model's graph (``emb(ids)``, ``emb(ids, runtime=...)``) runs the
    vocab-parallel lookup of :meth:`FusedEmbeddingCollection.lookup_group`
    unchanged. ``static`` holds the placed leaves that are no runtime
    input (a ``DenseStore``'s table); a call's ``runtime`` brings the
    others, placed."""

    def __init__(self, collection: FusedEmbeddingCollection,
                 group: list[tuple[int, ...]],
                 static: dict[str, Placed], device: torch.device):
        self.collection = collection
        self.spec = collection.spec
        self.store = collection.store
        self.group = group
        self.static = static
        self.device = device

    def __call__(self, ids: torch.Tensor, *,
                 runtime: dict | None = None) -> torch.Tensor:
        return self.collection.lookup_group(
            ids, {**self.static, **(runtime or {})}, self.group)

    def dense_view(self) -> torch.Tensor:
        """The whole table on this batch shard's device (the "naive"
        level's per-field gathers read it)."""
        return self.collection.dense_view().to(self.device)


def sharded_vocab_lookup(table: Placed, ids: torch.Tensor, *,
                         model_axis: str = "model",
                         group: list[tuple[int, ...]] | None = None
                         ) -> torch.Tensor:
    """Vocab-parallel lookup of ``ids`` (any shape, global row ids, on the
    first position's device) in ``table``, a (rows, d) table placed
    row-sharded over ``model_axis``: on each model shard of ``group``
    (default: the mesh's first batch shard), K1 over the shard's rows
    with the ids outside them zeroed, summed in shard order. Ids outside
    the whole table give zeros, as in the reference. Returns
    ``ids.shape + (d,)``."""
    mesh = table.mesh
    if group is None:
        group = data_groups(mesh, model_axis)[0]
    dev = mesh.devices[group[0]]
    flat = ids.reshape(-1, 1).to(torch.int32)
    out = None
    for pos in group:
        local = table.local(pos)
        where = mesh.devices[pos]
        lo = table.sharding.shard_index(pos, 0) * local.shape[0]
        mine = flat.to(where)
        valid = (mine >= lo) & (mine < lo + local.shape[0])
        offs = torch.full((1,), -lo, dtype=torch.int32, device=where)
        part = torch.where(valid, mtl.mtl_gather(mine, offs, local), 0.0)
        out = part.to(dev) if out is None else out + part.to(dev)
    return out.reshape(*ids.shape, table.shape[1])

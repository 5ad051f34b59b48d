"""EmbeddingStore — the tier that holds the mega-table behind the lookup.

Counterpart of ``repro.embedding.store``. Here a store is an
``nn.Module`` that owns its tensors as buffers on an explicit device.
``DenseStore`` keeps the whole ``(rows, d)`` mega-table in device memory;
every lookup is one fused gather. ``CachedStore``
(``repro_torch.embedding.cached``) keeps a hot-row cache over the full
backing table; ``HostBackedStore`` (``repro_torch.embedding.host``) keeps
the backing in host memory and stages each batch's misses onto the
device before its lookup (``needs_staging``).

The ``runtime_keys`` contract carries over: a store that can swap its
tensors between calls lists them there, and graphs take them as runtime
inputs (edge names from :func:`runtime_edge`) instead of closing over
them. ``DenseStore`` lists none. Where the reference's store methods take
and return a parameter subtree, the port's read and replace the store's
own buffers.

Over a device mesh (``repro_torch.distributed``) a store says how its
buffers lie (``partition_spec``: the vocab-parallel table row-sharded
over ``model``, every small tier replicated), ``place`` lays a set of
its tensors out that way, and ``lookup_shard`` runs one position's part
of a lookup on that position's tensors: the masked local gather over a
row shard, whose outputs summed over the model shards are the lookup.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch import quant
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import P, Placed, fit_spec, place
from repro_torch.kernels import multi_table_lookup as mtl
from repro_torch.kernels import ops as kops

from .spec import FusedEmbeddingSpec

__all__ = ["StoreStats", "EmbeddingStore", "DenseStore", "runtime_edge",
           "validate_deltas", "check_index_map"]


def runtime_edge(prefix: str, leaf: str) -> str:
    """Graph-input edge name of one runtime store tensor."""
    return f"{prefix}:{leaf}"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def validate_deltas(spec: FusedEmbeddingSpec, row_ids, new_rows
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Canonicalize one ``(row_id, new_row)`` delta batch (numpy or torch).

    ``row_ids`` become a unique int64 vector (duplicates keep the **last**
    occurrence: the stream is ordered), ``new_rows`` the matching
    ``(n, d)`` full-precision array. Rejects ids out of range and any id at
    or past ``spec.zero_row``: the zero row must stay zero for multi-hot
    masking, so a trainer can never push values into it.
    """
    row_ids = _host(row_ids).astype(np.int64).reshape(-1)
    rows = _host(new_rows).astype(np.dtype(spec.dtype))
    if rows.ndim == 1:
        rows = rows[None, :]
    if rows.shape != (row_ids.size, spec.dim):
        raise ValueError(f"delta rows shape {rows.shape} != "
                         f"{(row_ids.size, spec.dim)}")
    if row_ids.size == 0:
        return row_ids, rows
    if row_ids.min() < 0 or row_ids.max() >= spec.zero_row:
        bad = row_ids[(row_ids < 0) | (row_ids >= spec.zero_row)]
        raise ValueError(
            f"delta row ids {bad[:8].tolist()} out of range [0, "
            f"{spec.zero_row}) — the zero row must stay zero (multi-hot "
            "masking depends on it)")
    _, first_in_reversed = np.unique(row_ids[::-1], return_index=True)
    keep = row_ids.size - 1 - first_in_reversed
    return row_ids[keep], rows[keep]


def check_index_map(m: np.ndarray, rows: int, capacity: int) -> None:
    """A valid cache index map: ``rows`` entries, each in ``[-1, C)``, the
    cached rows filling each of the ``C`` slots exactly once."""
    if m.shape != (rows,):
        raise ValueError(f"index map has shape {m.shape}, expected "
                         f"{(rows,)}")
    if m.min() < -1 or m.max() >= capacity:
        raise ValueError(f"index map entries must lie in [-1, {capacity})")
    slots = np.sort(m[m >= 0])
    if not np.array_equal(slots, np.arange(capacity)):
        raise ValueError(f"index map holds {slots.size} slots, not each "
                         f"of the {capacity} once")


@dataclasses.dataclass
class StoreStats:
    """Host-side traffic counters of one embedding store.

    ``hits``/``misses`` count row lookups against the store's current
    index map; ``refreshes`` counts cache rebuilds; ``delta_rows`` rows
    whose values changed through :meth:`EmbeddingStore.apply_deltas`. The
    byte counters are wire bytes (``spec.wire_row_bytes``):
    ``gather_bytes`` the gather traffic of observed lookups,
    ``quant_bytes_saved`` what int8 rows saved against full precision,
    ``quant_rows`` rows pushed through ``repro_torch.quant``. All stay
    zero for ``DenseStore``.

    The staging counters are live only for stores with ``needs_staging``:
    ``staged_rows`` rows gathered from the host backing at serve time (the
    prefetch worker had not got there first), ``prefetched_rows`` rows
    already staged when their batch arrived, ``h2d_bytes`` the wire bytes
    of the rows staged at serve time (``staged_rows · wire_row_bytes``,
    the reference's count) and ``staging_overflows`` batches whose miss
    set exceeded the staging buffer (served in chunks).
    """
    hits: int = 0
    misses: int = 0
    refreshes: int = 0
    staged_rows: int = 0
    prefetched_rows: int = 0
    h2d_bytes: int = 0
    staging_overflows: int = 0
    gather_bytes: int = 0
    quant_rows: int = 0
    quant_bytes_saved: int = 0
    delta_rows: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        n = self.lookups
        return self.hits / n if n else 0.0


class EmbeddingStore(nn.Module):
    """Interface of the embedding parameter tier.

    Implementations must be bit-exact with each other: a store is a
    memory-system choice, never a numerics choice (int8 rows relax this
    to the accuracy gate).
    """

    #: True when the store keeps a rebuildable cache tier
    refreshable: bool = False
    #: buffers that compiled plans take as per-call inputs (swappable);
    #: empty for stores that never swap their tensors
    runtime_keys: tuple = ()
    #: True when the device tensors alone cannot resolve every lookup:
    #: the caller must :meth:`stage` each batch's ids before its lookup
    #: (and may :meth:`prefetch_hint` upcoming batches)
    needs_staging: bool = False
    #: the buffer that holds the whole table, row-sharded over a mesh's
    #: model axis (vocab-parallel); None when every buffer replicates
    sharded_leaf: str | None = None

    def __init__(self, spec: FusedEmbeddingSpec):
        super().__init__()
        self.spec = spec
        self.stats = StoreStats()

    @property
    def device(self) -> torch.device:
        """Where the store's tensors live (read without touching them)."""
        return next(self.buffers()).device

    @property
    def quantized(self) -> bool:
        """True when rows travel as int8 + per-row fp32 scale."""
        return self.spec.quantized

    @property
    def wire_row_bytes(self) -> int:
        """Bytes one row moves on a gather."""
        return self.spec.wire_row_bytes

    def _observe_traffic(self, rows: np.ndarray) -> None:
        """Wire-byte accounting of every tiered store's ``observe``:
        ``rows`` are the clipped global rows this batch gathered."""
        self.stats.gather_bytes += rows.size * self.wire_row_bytes
        if self.quantized:
            full = self.spec.dim * np.dtype(self.spec.dtype).itemsize
            self.stats.quant_bytes_saved += rows.size * (
                full - self.wire_row_bytes)

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def init_dense_table(self, table: torch.Tensor,
                         generator: torch.Generator) -> None:
        """The canonical mega-table init: normal × 0.05, with the zero row
        set to 0 (``store.py:198-209``)."""
        table.normal_(0.0, 0.05, generator=generator)
        table[self.spec.zero_row:] = 0.0

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def adopt(self, tensors: dict[str, torch.Tensor]) -> None:
        """Take over another store's tensors (its buffers by name:
        ``{"mega_table"}`` or ``{"backing", ...}``) in this store's
        layout, values preserved bit for bit — a store swap is a placement
        change, not a re-init."""
        raise NotImplementedError

    def resync(self) -> None:
        """Re-derive host-side state from the buffers after they were
        written from outside (a loaded parameter tree). No-op here."""

    def dense_view(self) -> torch.Tensor:
        """The full (rows, d) table."""
        raise NotImplementedError

    def runtime_tensors(self) -> dict[str, torch.Tensor]:
        """Leaf name -> tensor for every ``runtime_keys`` buffer."""
        return {leaf: getattr(self, leaf) for leaf in self.runtime_keys}

    def device_tensors(self) -> dict[str, torch.Tensor]:
        """Leaf name -> tensor for every buffer: the reference's parameter
        subtree of this store."""
        return dict(self.named_buffers(recurse=False))

    # -- mesh placement ----------------------------------------------------
    def partition_spec(self, model_axis: str | None = "model") -> dict:
        """Leaf name -> :class:`P` of every buffer over a mesh."""
        raise NotImplementedError

    def place(self, tensors: dict[str, torch.Tensor], mesh,
              model_axis: str | None = "model") -> dict[str, Placed]:
        """Lay ``tensors`` (some of this store's leaves, by name) out over
        ``mesh`` per :meth:`partition_spec`, dropping the mesh axes a
        leaf's dim does not divide (``fit_spec``): the placement every
        mesh plan reads its store tensors in, so a refresh or delta
        published through here matches the plans' ``runtime_shardings``.
        On a mesh without ``model_axis`` everything replicates."""
        axis = model_axis if model_axis in mesh.axis_names else None
        specs = self.partition_spec(axis)
        return {k: place(v, mesh, fit_spec(mesh, specs[k], v.shape))
                for k, v in tensors.items()}

    def lookup_shard(self, tensors: dict[str, torch.Tensor],
                     ids: torch.Tensor, offsets: torch.Tensor, *,
                     mask: torch.Tensor | None = None,
                     shard: tuple[int, int] | None = None) -> torch.Tensor:
        """One mesh position's lookup over its local ``tensors`` (one-hot
        ``(b, k)`` ids, or ``(b, k, h)`` ids pooled under ``mask``), on
        their device. ``shard=(row_lo, n_rows)``: the
        :attr:`sharded_leaf` holds global rows ``[row_lo, row_lo +
        its height)`` of ``n_rows``, every other leaf is whole, and rows
        outside the shard give zeros. ``None``: whole tensors, the
        1-device lookup."""
        raise NotImplementedError

    def _tensors(self, runtime: dict[str, torch.Tensor] | None
                 ) -> dict[str, torch.Tensor]:
        """The runtime tensors, with ``runtime``'s taking precedence."""
        t = self.runtime_tensors()
        if runtime:
            t.update(runtime)
        return t

    def _publish(self, tensors: dict[str, torch.Tensor]) -> None:
        """Swap the buffers to ``tensors`` in one step, after every queued
        kernel that may read the old ones has finished (the caching
        allocator may hand a dropped tensor's memory to the next
        allocation while a step queued on another stream still reads
        it)."""
        for name, t in tensors.items():
            old = getattr(self, name)
            if t.shape != old.shape or t.dtype != old.dtype:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} does "
                                 f"not replace {tuple(old.shape)} "
                                 f"{old.dtype}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for name, t in tensors.items():
            setattr(self, name, t)

    # -- lookup ------------------------------------------------------------
    def lookup(self, ids: torch.Tensor, offsets: torch.Tensor, *,
               strategy: str = "auto",
               runtime: dict[str, torch.Tensor] | None = None
               ) -> torch.Tensor:
        """ids (b, k) -> (b, k*d). ``runtime`` overrides the
        ``runtime_keys`` buffers for this call."""
        raise NotImplementedError

    def lookup_multihot(self, ids: torch.Tensor, mask: torch.Tensor,
                        offsets: torch.Tensor, *, strategy: str = "auto",
                        runtime: dict[str, torch.Tensor] | None = None
                        ) -> torch.Tensor:
        """ids/mask (b, k, h) -> (b, k*d) sum-pooled."""
        raise NotImplementedError

    # -- staging (only meaningful when ``needs_staging``) -----------------
    def stage(self, ids, mask=None) -> None:
        """Make every row of this batch reachable from the device tensors
        before its lookup. No-op for stores whose device tensors already
        cover every row."""

    def prefetch_hint(self, ids, mask=None) -> None:
        """Hint that ``ids`` will be served soon, so a staging store can
        resolve their misses off the serving thread. No-op here."""

    def split_for_staging(self, ids) -> list:
        """Split a batch into chunks each of which :meth:`stage` can
        resolve (the fallback after a staging overflow): one chunk for
        stores that do not stage."""
        return [np.asarray(ids)]

    # -- traffic / cache management ---------------------------------------
    def observe(self, global_rows: np.ndarray) -> None:
        """Record served row traffic (host side). No-op here."""

    def refresh(self) -> None:
        """Rebuild any cache tier from observed traffic. No-op here."""

    def apply_deltas(self, row_ids, new_rows) -> int:
        """Apply online ``(row_id, new_row)`` deltas (a live trainer's
        push) and return the number of rows applied. Only stores whose
        tensors are runtime plan inputs support it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support online deltas: its "
            "tensors are compiled into plans as constants, not runtime "
            "inputs. Serve through CachedStore or HostBackedStore (their "
            "tiers republish through the recompile-free swap).")

    @property
    def cached_traffic_fraction(self) -> float:
        """Share of observed traffic whose rows are currently cached (1.0
        for a store that holds everything in one tier)."""
        return 1.0

    def describe(self) -> str:
        raise NotImplementedError


class DenseStore(EmbeddingStore):
    """The monolithic mega-table: one ``mega_table`` buffer of shape
    ``(spec.rows, spec.dim)`` on ``device``."""

    sharded_leaf = "mega_table"

    def __init__(self, spec: FusedEmbeddingSpec, *,
                 device: torch.device | str | None = None):
        super().__init__(spec)
        device = resolve_device(device)
        self.register_buffer("mega_table", torch.zeros(
            (spec.rows, spec.dim), dtype=getattr(torch, spec.dtype),
            device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.init_dense_table(self.mega_table, generator)

    @torch.no_grad()
    def adopt(self, tensors: dict[str, torch.Tensor]) -> None:
        if "mega_table" in tensors:
            table = tensors["mega_table"]
        elif "backing_scale" in tensors \
                and tensors["backing"].dtype == torch.int8:
            # a quantized tiered store: rebuild full-precision rows (the
            # int8 grid is all the values that remain)
            table = quant.dequantize_rows(tensors["backing"],
                                          tensors["backing_scale"])
        else:
            table = tensors["backing"]
        self.mega_table = table.to(self.mega_table.device,
                                   self.mega_table.dtype, copy=True)

    def dense_view(self) -> torch.Tensor:
        return self.mega_table

    def lookup(self, ids: torch.Tensor, offsets: torch.Tensor, *,
               strategy: str = "auto",
               runtime: dict[str, torch.Tensor] | None = None
               ) -> torch.Tensor:
        return kops.multi_table_lookup(ids, self.mega_table, offsets,
                                       strategy=strategy)

    def lookup_multihot(self, ids: torch.Tensor, mask: torch.Tensor,
                        offsets: torch.Tensor, *, strategy: str = "auto",
                        runtime: dict[str, torch.Tensor] | None = None
                        ) -> torch.Tensor:
        return kops.multi_table_lookup_multihot(ids, mask, self.mega_table,
                                                offsets, strategy=strategy)

    def partition_spec(self, model_axis: str | None = "model") -> dict:
        """Row-sharded (vocab-parallel) placement of the mega-table."""
        return {"mega_table": P(model_axis, None)}

    def lookup_shard(self, tensors: dict[str, torch.Tensor],
                     ids: torch.Tensor, offsets: torch.Tensor, *,
                     mask: torch.Tensor | None = None,
                     shard: tuple[int, int] | None = None) -> torch.Tensor:
        """K1 (one-hot) or K2 (pooled) on the local table. A one-hot row
        shard is K1 over the shard (rows clamped into it) with the rows
        outside ``[row_lo, row_lo + height)`` set to zero after; K2 takes
        the shard itself."""
        table = tensors["mega_table"]
        if mask is not None:
            return mtl.mtl_gather_multihot(ids, mask.to(torch.float32),
                                           offsets, table, shard=shard)
        if shard is None:
            return mtl.mtl_gather(ids, offsets, table)
        lo, n_rows = shard
        n_local, d = table.shape
        rows = (ids.to(torch.int64) + offsets.to(torch.int64)) \
            .clamp_(0, n_rows - 1)
        valid = (rows >= lo) & (rows < lo + n_local)
        vals = mtl.mtl_gather(ids, offsets - lo, table)
        b, k = ids.shape
        return torch.where(valid.unsqueeze(-1), vals.view(b, k, d),
                           0.0).view(b, k * d)

    def describe(self) -> str:
        return f"dense(rows={self.spec.rows},d={self.spec.dim})"

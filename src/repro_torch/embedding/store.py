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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch import quant
from repro_torch.device import resolve_device
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

    def describe(self) -> str:
        return f"dense(rows={self.spec.rows},d={self.spec.dim})"

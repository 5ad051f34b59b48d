"""CachedStore — HugeCTR-style hot-row cache over a backing mega-table.

Counterpart of ``repro.embedding.cached``. Two tiers, one index map, all
device buffers:

  ``backing``     (rows, d)  the full mega-table.
  ``cache``       (C, d)     copies of the C hottest rows.
  ``slot_of_row`` (rows,)    int32 cache slot of each global row, -1 when
                             the row is not cached.

A lookup is one two-level gather, K3 ``mtl_gather_two_level``: hits read
the cache, misses the backing. Cache rows are verbatim copies of backing
rows, so the store is bitwise equal to a ``DenseStore`` on the same table;
the cache state only changes where a row is read from.

Admission follows the observed traffic: ``observe`` counts served rows on
the host, and ``refresh`` re-admits the C most frequent (ties go to the
lower row id). Until the first refresh the cache holds the lowest C row
ids.

With ``row_dtype="int8"`` both tiers hold int8 rows with one fp32 scale
per row (``backing_scale (rows, 1)``, ``cache_scale (C, 1)``), quantized
once at ``from_dense``/``adopt`` (and per delta row), and the lookup is K4
``mtl_gather_two_level_q8``, which dequantizes in the kernel.

Every buffer in ``runtime_keys`` is a runtime input of compiled plans, so
``refresh`` and ``apply_deltas`` never recompile. They build fresh tensors
on the side, never writing into one a queued kernel may still read, and
publish them in one swap of the buffers. Before the swap drops the old
tensors, the device is synchronized: the caching allocator may hand a
dropped tensor's memory to the next allocation on its stream, and a plan
step queued on another stream could otherwise still be reading it.
Mesh placement (``partition_spec``/``place``) comes with the multi-device
slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import quant
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

from .spec import FusedEmbeddingSpec
from .store import EmbeddingStore, check_index_map, validate_deltas

__all__ = ["CachedStore"]


class CachedStore(EmbeddingStore):
    """Hot-row cache of capacity ``C`` rows over the full backing table,
    on ``device``.

    The store keeps a host mirror of the index map (``_slot_of_row``) and
    per-row traffic counts (``_counts``); ``observe``, ``refresh`` and
    ``apply_deltas`` read the mirror, never the device map.
    """

    refreshable = True
    runtime_keys = ("cache", "backing", "slot_of_row")

    def __init__(self, spec: FusedEmbeddingSpec, capacity: int,
                 row_dtype: str | None = None, *,
                 device: torch.device | str | None = None):
        if row_dtype is not None:
            spec = dataclasses.replace(spec, row_dtype=row_dtype)
        super().__init__(spec)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        device = resolve_device(device)
        self.capacity = int(min(capacity, spec.rows))
        self._counts = np.zeros(spec.rows, dtype=np.int64)
        self._slot_of_row = self._seed_map()
        wire = torch.int8 if self.quantized else getattr(torch, spec.dtype)
        self.register_buffer("backing", torch.zeros(
            (spec.rows, spec.dim), dtype=wire, device=device))
        self.register_buffer("cache", torch.zeros(
            (self.capacity, spec.dim), dtype=wire, device=device))
        self.register_buffer("slot_of_row", torch.tensor(
            self._slot_of_row, device=device))
        if self.quantized:
            self.register_buffer("backing_scale", torch.ones(
                (spec.rows, 1), dtype=torch.float32, device=device))
            self.register_buffer("cache_scale", torch.ones(
                (self.capacity, 1), dtype=torch.float32, device=device))
            self.runtime_keys = ("cache", "cache_scale", "backing",
                                 "backing_scale", "slot_of_row")
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module.resync())

    def _seed_map(self) -> np.ndarray:
        m = np.full(self.spec.rows, -1, dtype=np.int32)
        m[:self.capacity] = np.arange(self.capacity, dtype=np.int32)
        return m

    # -- params ------------------------------------------------------------
    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        table = torch.empty((self.spec.rows, self.spec.dim),
                            dtype=getattr(torch, self.spec.dtype),
                            device=self.device)
        self.init_dense_table(table, generator)
        self.from_dense({"mega_table": table})

    @torch.no_grad()
    def from_dense(self, tensors: dict[str, torch.Tensor]) -> None:
        """Take a dense table (``{"mega_table": table}``) into the tiered
        layout, caching per the current index map. An int8 store quantizes
        the whole table here, once: every later refresh reuses these rows
        and scales."""
        table = tensors["mega_table"]
        scale = None
        if self.quantized:
            backing, scale = self._quantize_table(table.to(self.device))
        else:
            backing = table.to(self.device, copy=True)
        self._publish(self._with_cache(backing, self._slot_of_row, scale))

    @torch.no_grad()
    def adopt(self, tensors: dict[str, torch.Tensor]) -> None:
        if "backing" not in tensors:
            self.from_dense(tensors)
            return
        backing = tensors["backing"].to(self.device, copy=True)
        if self.quantized and backing.dtype != torch.int8:
            backing, scale = self._quantize_table(backing)
        else:
            scale = tensors.get("backing_scale")
            if scale is not None:
                scale = scale.to(self.device, copy=True)
        self._publish(self._with_cache(backing, self._slot_of_row, scale))

    def _quantize_table(self, table: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        q, scale = quant.quantize_rows(table)
        self.stats.quant_rows += int(table.shape[0])
        return q, scale

    def _with_cache(self, backing: torch.Tensor, slot_of_row: np.ndarray,
                    backing_scale: torch.Tensor | None = None
                    ) -> dict[str, torch.Tensor]:
        """Fresh runtime tensors for ``backing`` under index map
        ``slot_of_row`` (the cache gathered from the backing)."""
        check_index_map(slot_of_row, self.spec.rows, self.capacity)
        hot = np.flatnonzero(slot_of_row >= 0)
        cached_rows = hot[np.argsort(slot_of_row[hot])]   # row of slot s
        rows = torch.from_numpy(cached_rows).to(backing.device)
        out = {"backing": backing,
               "cache": backing.index_select(0, rows),
               "slot_of_row": torch.tensor(slot_of_row,
                                           device=backing.device)}
        if self.quantized:
            if backing_scale is None:
                raise ValueError("quantized store needs backing_scale "
                                 "alongside its int8 backing")
            out["backing_scale"] = backing_scale
            out["cache_scale"] = backing_scale.index_select(0, rows)
        return out

    def resync(self) -> None:
        """Bring the host mirror of the index map in line with the
        ``slot_of_row`` buffer (after a parameter tree was loaded)."""
        m = self.slot_of_row.cpu().numpy().astype(np.int32)
        check_index_map(m, self.spec.rows, self.capacity)
        self._slot_of_row = m

    def dense_view(self) -> torch.Tensor:
        if self.quantized:
            # the naive level wants fp32 rows: rebuild them from the int8
            # grid so every path sees identical values
            return quant.dequantize_rows(self.backing, self.backing_scale).to(
                getattr(torch, self.spec.dtype))
        return self.backing

    # -- lookup ------------------------------------------------------------
    def lookup(self, ids: torch.Tensor, offsets: torch.Tensor, *,
               strategy: str = "auto",
               runtime: dict[str, torch.Tensor] | None = None
               ) -> torch.Tensor:
        t = self._tensors(runtime)
        if self.quantized:
            return kops.multi_table_lookup_cached_q8(
                ids, t["cache"], t["cache_scale"], t["backing"],
                t["backing_scale"], t["slot_of_row"], offsets,
                strategy=strategy)
        return kops.multi_table_lookup_cached(
            ids, t["cache"], t["backing"], t["slot_of_row"], offsets,
            strategy=strategy)

    def lookup_multihot(self, ids: torch.Tensor, mask: torch.Tensor,
                        offsets: torch.Tensor, *, strategy: str = "auto",
                        runtime: dict[str, torch.Tensor] | None = None
                        ) -> torch.Tensor:
        t = self._tensors(runtime)
        if self.quantized:
            return kops.multi_table_lookup_cached_q8_multihot(
                ids, mask, t["cache"], t["cache_scale"], t["backing"],
                t["backing_scale"], t["slot_of_row"], offsets,
                strategy=strategy)
        return kops.multi_table_lookup_cached_multihot(
            ids, mask, t["cache"], t["backing"], t["slot_of_row"], offsets,
            strategy=strategy)

    # -- traffic / cache management ---------------------------------------
    def observe(self, global_rows: np.ndarray) -> None:
        # clip like the gather does, so one malformed id cannot wedge the
        # serving loop; O(b·k), no full-vocabulary allocation per batch
        rows = np.clip(np.asarray(global_rows).reshape(-1),
                       0, self._counts.size - 1)
        np.add.at(self._counts, rows, 1)
        hits = int((self._slot_of_row[rows] >= 0).sum())
        self.stats.hits += hits
        self.stats.misses += rows.size - hits
        self._observe_traffic(rows)

    @torch.no_grad()
    def refresh(self) -> None:
        """Re-admit the C most frequent observed rows (ties -> lower row
        id, so refresh is deterministic for any traffic history)."""
        order = np.lexsort((np.arange(self._counts.size), -self._counts))
        hot = np.sort(order[:self.capacity]).astype(np.int32)
        new_map = np.full(self._counts.size, -1, dtype=np.int32)
        new_map[hot] = np.arange(self.capacity, dtype=np.int32)
        fresh = self._with_cache(self.backing, new_map,
                                 getattr(self, "backing_scale", None))
        del fresh["backing"]                    # unchanged, not republished
        fresh.pop("backing_scale", None)
        self._publish(fresh)
        self._slot_of_row = new_map
        self.stats.refreshes += 1

    @torch.no_grad()
    def apply_deltas(self, row_ids, new_rows) -> int:
        """Write online trainer deltas into the backing and, for rows
        currently cached, into their cache slots (cache rows stay verbatim
        copies of backing rows); the index map is untouched. An int8 store
        quantizes the incoming fp32 rows once here, scales alongside.
        Out of place: the old tensors stay as they were until the swap."""
        rows_idx, vals = validate_deltas(self.spec, row_ids, new_rows)
        n = int(rows_idx.size)
        if n == 0:
            return 0
        dev = self.device
        idx = torch.from_numpy(rows_idx).to(dev)
        wire = torch.from_numpy(vals).to(dev)
        out = {}
        if self.quantized:
            wire, scale = quant.quantize_rows(wire)
            self.stats.quant_rows += n
            out["backing_scale"] = self.backing_scale.index_put(
                (idx,), scale)
        out["backing"] = self.backing.index_put((idx,), wire)
        slots = self._slot_of_row[rows_idx]
        cached = np.flatnonzero(slots >= 0)
        if cached.size:
            cidx = torch.from_numpy(slots[cached].astype(np.int64)).to(dev)
            pick = torch.from_numpy(cached).to(dev)
            out["cache"] = self.cache.index_put(
                (cidx,), wire.index_select(0, pick))
            if self.quantized:
                out["cache_scale"] = self.cache_scale.index_put(
                    (cidx,), scale.index_select(0, pick))
        self._publish(out)
        self.stats.delta_rows += n
        return n

    @property
    def cached_traffic_fraction(self) -> float:
        """Share of observed traffic mass landing on currently cached rows.
        O(rows): read it at refresh time, not per served batch."""
        total = int(self._counts.sum())
        if not total:
            return 0.0
        return float(self._counts[self._slot_of_row >= 0].sum()) / total

    def describe(self) -> str:
        q = ",int8" if self.quantized else ""
        return (f"cached(C={self.capacity},rows={self.spec.rows},"
                f"d={self.spec.dim}{q})")

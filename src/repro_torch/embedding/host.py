"""HostBackedStore — out-of-device-memory embedding tier with prefetch.

Counterpart of ``repro.embedding.host``. ``CachedStore`` keeps the whole
backing table on the device; this store keeps it in host memory, so the
largest servable vocabulary is no longer bounded by the card's memory:

  device  ``cache``               (C, d)   hot-row copies
          ``slot_of_row``         (rows,)  int32 cache map, -1 = uncached
          ``staging``             (S, d)   copies of recent batches' misses
          ``staging_slot_of_row`` (rows,)  int32 staging map, -1 = unstaged
  host    backing table           (rows, d) numpy array, never uploaded whole
  disk    optional third tier: ``backing_path=`` maps the backing from a
          file (``np.memmap``), so it need not fit host memory either.

A lookup is one three-level gather, K5 ``mtl_gather_three_level``: cache
hit → cache row, staged miss → staging row, neither → zero. So the serve
path stages every miss of a batch before its lookup: ``stage(ids)`` gathers
the batch's uncached rows from the host backing into the staging area
(most already there when :class:`~.prefetch.PrefetchPipeline`'s worker
took a hint) and uploads what changed. Cache and staging rows are
verbatim backing rows, so scores are bitwise a ``DenseStore``'s. With
``row_dtype="int8"`` all three tiers hold int8 rows and one fp32 scale per
row (``cache_scale``, ``staging_scale``, a ``.scale`` sidecar for the mmap
tier), quantized once at ``from_dense``/``adopt`` (and per delta row), and
the lookup is K6 ``mtl_gather_three_level_q8``.

Every device buffer is in ``runtime_keys``, so plans compiled with
``runtime_provider`` serve every staging, refresh and delta without a
recompile. Two ways of publishing:

* **Staging** writes in place, O(changed rows): the pipeline hands over
  the staging slots and map entries that changed since the last upload
  (under its lock, in the same critical section as the batch's staging),
  they are packed into one pinned host buffer, copied to the device in
  one transfer and scattered into ``staging``/``staging_slot_of_row`` on
  the current stream. That stream first waits for every lookup already
  queued on any stream (each lookup records an event where it ran), and
  every later lookup waits for the upload's event, so a queued step never
  sees a half-published staging area and the next step never sees a stale
  one. The pinned buffer is refilled only after its last copy finished.
* **Refresh and deltas** build ``cache``/``slot_of_row`` (and the cache's
  scales) aside and swap them in after a device sync, as ``CachedStore``
  does; the staging changes they cause (rows promoted out of staging,
  staged rows re-gathered) then go through the staging upload.

When one batch's distinct miss set exceeds ``S``, ``stage`` raises
``StagingOverflowError`` and the caller serves the batch in chunks
(:meth:`split_for_staging`): slower, never wrong. The caller's loop is the
reference engine's (``serving/engine.py:556-610``): hint batch t+1, stage
batch t (or its chunks), predict, observe.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch import quant
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

from .prefetch import PrefetchPipeline, StagingOverflowError
from .spec import FusedEmbeddingSpec
from .store import EmbeddingStore, check_index_map, validate_deltas

__all__ = ["HostBackedStore"]


def _as_tensor(x) -> torch.Tensor:
    """A tensor of ``x`` (numpy arrays are copied, so a read-only array
    never backs a tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x))


class HostBackedStore(EmbeddingStore):
    """Hot-row device cache + staging buffer over a host-resident backing,
    with its device tensors on ``device``.

    Args:
        spec: the fused embedding schema.
        capacity: device cache rows ``C`` (clamped to ``spec.rows``).
        staging_capacity: staging slots ``S``; must cover one sample's
            worst-case miss set (``k * multi_hot``) so chunked serving can
            always make progress. Default ``max(4 * k * multi_hot, 256)``
            (clamped to ``spec.rows``).
        backing_path: optional file for the third tier: the backing is a
            ``np.memmap`` of this file instead of a RAM array. Written by
            :meth:`from_dense`/:meth:`adopt`; reopen with :meth:`open`.
        row_dtype: ``"int8"`` stores all three tiers quantized.
        device: where the device tensors live (CUDA unless "cpu").

    The host keeps the backing, a mirror of the cache map
    (``_slot_of_row``), per-row traffic counts and the staging area
    (``pipeline``); ``observe``, ``refresh``, ``stage`` and
    ``apply_deltas`` read those, never the device tensors.
    ``upload_bytes`` counts the bytes the staging uploads copied host →
    device (``stats.h2d_bytes`` is the reference's count of staged row
    bytes).
    """

    refreshable = True
    needs_staging = True
    runtime_keys = ("cache", "slot_of_row", "staging", "staging_slot_of_row")

    def __init__(self, spec: FusedEmbeddingSpec, capacity: int,
                 staging_capacity: int | None = None,
                 backing_path: str | os.PathLike | None = None,
                 row_dtype: str | None = None, *,
                 device: torch.device | str | None = None):
        if row_dtype is not None:
            spec = dataclasses.replace(spec, row_dtype=row_dtype)
        super().__init__(spec)
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        device = resolve_device(device)
        self.capacity = int(min(capacity, spec.rows))
        per_sample = spec.k * spec.multi_hot
        if staging_capacity is None:
            staging_capacity = max(4 * per_sample, 256)
        if staging_capacity < per_sample:
            raise ValueError(
                f"staging_capacity {staging_capacity} < one sample's "
                f"worst-case miss set k*multi_hot = {per_sample}; chunked "
                "serving could never make progress")
        self.staging_capacity = int(min(staging_capacity, spec.rows))
        self.backing_path = os.fspath(backing_path) if backing_path else None
        self._backing: np.ndarray | None = None
        self._backing_scale: np.ndarray | None = None
        self._counts = np.zeros(spec.rows, dtype=np.int64)
        self._slot_of_row = self._seed_map()
        self.pipeline = PrefetchPipeline(self, self.staging_capacity)
        wire = torch.int8 if self.quantized else getattr(torch, spec.dtype)
        self.register_buffer("cache", torch.zeros(
            (self.capacity, spec.dim), dtype=wire, device=device))
        self.register_buffer("slot_of_row", torch.tensor(
            self._slot_of_row, device=device))
        self.register_buffer("staging", torch.zeros(
            (self.staging_capacity, spec.dim), dtype=wire, device=device))
        self.register_buffer("staging_slot_of_row", torch.full(
            (spec.rows,), -1, dtype=torch.int32, device=device))
        if self.quantized:
            self.register_buffer("cache_scale", torch.ones(
                (self.capacity, 1), dtype=torch.float32, device=device))
            self.register_buffer("staging_scale", torch.zeros(
                (self.staging_capacity, 1), dtype=torch.float32,
                device=device))
            self.runtime_keys = ("cache", "cache_scale", "slot_of_row",
                                 "staging", "staging_scale",
                                 "staging_slot_of_row")
        self.upload_bytes = 0
        self._pinned: torch.Tensor | None = None   # packed upload buffer
        self._pending: tuple | None = None         # what _pack packed
        self._uploaded = None      # event after the last staging upload
        self._readers: dict = {}   # stream handle -> event after a lookup
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module.resync())

    def _seed_map(self) -> np.ndarray:
        m = np.full(self.spec.rows, -1, dtype=np.int32)
        m[:self.capacity] = np.arange(self.capacity, dtype=np.int32)
        return m

    # -- host backing --------------------------------------------------------
    def host_view(self) -> np.ndarray:
        """The (rows, d) backing table in host memory (or on disk via
        mmap), in wire format: int8 for quantized stores."""
        if self._backing is None:
            raise RuntimeError("no backing attached yet — call from_dense/"
                               "adopt (or HostBackedStore.open for an "
                               "existing backing_path)")
        return self._backing

    def host_scale_view(self) -> np.ndarray:
        """The (rows, 1) fp32 per-row scales of a quantized backing."""
        if self._backing_scale is None:
            raise RuntimeError("no quantized backing attached — scales "
                               "exist only for row_dtype='int8' stores "
                               "with a backing")
        return self._backing_scale

    def cache_map_view(self) -> np.ndarray:
        """Host mirror of ``slot_of_row`` (the prefetch worker reads it)."""
        return self._slot_of_row

    @property
    def _scale_path(self) -> str | None:
        return self.backing_path + ".scale" if self.backing_path else None

    def _set_backing(self, table) -> None:
        """Take ``table`` (a tensor on any device, or an array) as the
        backing; an int8 store quantizes it here, once. A tensor is
        copied; a numpy array of the right dtype is kept as it is (a
        read-only one is copied on the first delta)."""
        shape = (self.spec.rows, self.spec.dim)
        if tuple(table.shape) != shape:
            raise ValueError(f"backing shape {tuple(table.shape)} != {shape}")
        scale = None
        if self.quantized:
            q, s = quant.quantize_rows(
                _as_tensor(table).to(getattr(torch, self.spec.dtype)))
            table, scale = q.cpu().numpy(), s.cpu().numpy()
            self.stats.quant_rows += shape[0]
        elif isinstance(table, torch.Tensor):
            table = table.detach().to("cpu", getattr(torch, self.spec.dtype),
                                      copy=True).numpy()
        else:
            table = np.ascontiguousarray(
                np.asarray(table, dtype=np.dtype(self.spec.dtype)))
        if self.backing_path is not None:
            mm = np.memmap(self.backing_path, dtype=table.dtype, mode="w+",
                           shape=table.shape)
            mm[:] = table
            mm.flush()
            table = mm
            if scale is not None:
                sm = np.memmap(self._scale_path, dtype=np.float32,
                               mode="w+", shape=scale.shape)
                sm[:] = scale
                sm.flush()
                scale = sm
        self._backing, self._backing_scale = table, scale

    @classmethod
    def open(cls, spec: FusedEmbeddingSpec, capacity: int,
             backing_path: str | os.PathLike,
             staging_capacity: int | None = None,
             row_dtype: str | None = None, mode: str = "r", *,
             device: torch.device | str | None = None) -> "HostBackedStore":
        """Attach an existing on-disk backing (written by ``from_dense``/
        ``adopt`` with the same spec and ``row_dtype``) without reading it
        into memory. ``mode="r"`` maps it read-only, and
        :meth:`apply_deltas` then refuses; ``mode="r+"`` accepts deltas
        and writes them to the file."""
        if mode not in ("r", "r+"):
            raise ValueError(f"mode must be 'r' or 'r+', got {mode!r}")
        store = cls(spec, capacity, staging_capacity=staging_capacity,
                    backing_path=backing_path, row_dtype=row_dtype,
                    device=device)
        wire = np.int8 if store.quantized else np.dtype(spec.dtype)
        store._backing = np.memmap(store.backing_path, dtype=wire, mode=mode,
                                   shape=(spec.rows, spec.dim))
        if store.quantized:
            store._backing_scale = np.memmap(
                store._scale_path, dtype=np.float32, mode=mode,
                shape=(spec.rows, 1))
        store._rebuild()
        return store

    # -- params --------------------------------------------------------------
    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        table = torch.empty((self.spec.rows, self.spec.dim),
                            dtype=getattr(torch, self.spec.dtype),
                            device=self.device)
        self.init_dense_table(table, generator)
        self.from_dense({"mega_table": table})

    def from_dense(self, tensors: dict) -> None:
        """Take a dense table (``{"mega_table": table}``) as the host
        backing and build the device tensors from it."""
        self.adopt(tensors)

    @torch.no_grad()
    def adopt(self, tensors: dict) -> None:
        """Take a dense (``mega_table``) or tiered (``backing``, with
        ``backing_scale`` when int8) table, tensor or numpy, as the host
        backing, bit for bit (int8 rows are dequantized and quantized
        again, as the reference does)."""
        leaf = tensors.get("mega_table", tensors.get("backing"))
        if leaf is None:
            raise ValueError("adopt needs a dense ('mega_table') or tiered "
                             "('backing') table — a host-backed store has "
                             "no table among its tensors; use open()")
        if "backing_scale" in tensors and leaf.dtype in (np.int8, torch.int8):
            leaf = quant.dequantize_rows(_as_tensor(leaf),
                                         _as_tensor(tensors["backing_scale"]))
        self._set_backing(leaf)
        self._rebuild()

    def _cache_tensors(self) -> dict[str, torch.Tensor]:
        """Fresh cache tensors for the current host map, the cache rows
        gathered from the host backing."""
        check_index_map(self._slot_of_row, self.spec.rows, self.capacity)
        hot = np.flatnonzero(self._slot_of_row >= 0)
        cached_rows = hot[np.argsort(self._slot_of_row[hot])]
        dev = self.device
        out = {"cache": torch.from_numpy(
                   self.host_view()[cached_rows]).to(dev),
               "slot_of_row": torch.from_numpy(
                   self._slot_of_row.copy()).to(dev)}
        if self.quantized:
            out["cache_scale"] = torch.from_numpy(
                self.host_scale_view()[cached_rows]).to(dev)
        return out

    def _rebuild(self) -> None:
        """Build every device tensor from the host state and publish."""
        fresh = self._cache_tensors()

        def whole(slots, rows, buf, sbuf, smap):
            fresh["staging"] = torch.from_numpy(buf.copy()).to(self.device)
            fresh["staging_slot_of_row"] = torch.from_numpy(
                smap.copy()).to(self.device)
            if sbuf is not None:
                fresh["staging_scale"] = torch.from_numpy(
                    sbuf.copy()).to(self.device)
        self.pipeline.take_changes(whole)
        self._publish(fresh)

    def resync(self) -> None:
        """Bring the host mirrors in line with the device buffers after
        they were written from outside (a loaded parameter tree): the
        cache map, and the staging area with its map."""
        m = self.slot_of_row.cpu().numpy().astype(np.int32)
        check_index_map(m, self.spec.rows, self.capacity)
        self._slot_of_row = m
        sbuf = self.staging_scale.cpu().numpy() if self.quantized else None
        self.pipeline.load(self.staging.cpu().numpy(), sbuf,
                           self.staging_slot_of_row.cpu().numpy())

    def dense_view(self) -> torch.Tensor:
        raise NotImplementedError(
            "HostBackedStore keeps the backing table in host memory; there "
            "is no device-resident dense view (that ceiling is the point). "
            "Use host_view() for host-side access, or a DenseStore/"
            "CachedStore for paths that need the whole table on the device "
            "(the serial baseline, the 'naive' level).")

    def device_bytes(self) -> int:
        """Bytes of embedding state on the device: cache and staging rows
        (and their scales) plus the two int32 maps; never the backing."""
        return sum(t.numel() * t.element_size()
                   for t in self.runtime_tensors().values())

    # -- staging (the per-batch miss pipeline) -------------------------------
    def _global_rows(self, ids, mask=None) -> np.ndarray:
        """Local (…, k[, h]) ids -> clipped global rows, masked slots
        dropped (their lookup reads the zero row, nothing to stage)."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids, dtype=np.int64)
        if ids.ndim == 1:
            ids = ids[None, :]
        offs = self.spec.offsets
        rows = ids + (offs[None, :] if ids.ndim == 2 else offs[None, :, None])
        if mask is not None:
            if isinstance(mask, torch.Tensor):
                mask = mask.cpu().numpy()
            rows = rows[np.asarray(mask).astype(bool)]
        return np.clip(rows.reshape(-1), 0, self.spec.rows - 1)

    def miss_rows(self, ids, mask=None) -> np.ndarray:
        """Distinct global rows of this batch absent from the device cache
        (the set the staging area must resolve)."""
        rows = np.unique(self._global_rows(ids, mask))
        return rows[self._slot_of_row[rows] < 0]

    def stage(self, ids, mask=None) -> None:
        """Resolve this batch's cache misses into the staging area and
        upload what changed. Raises :class:`StagingOverflowError` when the
        distinct miss set exceeds the staging area; serve the batch in
        :meth:`split_for_staging` chunks then."""
        miss = self.miss_rows(ids, mask)
        try:
            staged, already = self.pipeline.ensure(miss, pack=self._pack)
        except StagingOverflowError:
            self.stats.staging_overflows += 1
            raise
        self.stats.staged_rows += staged
        self.stats.prefetched_rows += already
        # wire bytes of the rows staged at serve time (d + 4 for int8
        # rows with their scale, 4·d full precision): the reference's count
        self.stats.h2d_bytes += staged * self.wire_row_bytes
        self._upload()

    def prefetch_hint(self, ids, mask=None) -> None:
        """Queue an upcoming batch's rows for staging off the serving
        thread (call it with batch t+1 before serving batch t)."""
        self.pipeline.hint(self._global_rows(ids, mask))

    def split_for_staging(self, ids) -> list:
        """Split a (b, k) batch into row-contiguous chunks whose distinct
        miss sets each fit the staging area. Greedy; a one-row chunk
        always fits because ``staging_capacity >= k * multi_hot``."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        chunks, start, covered = [], 0, set()
        for i in range(ids.shape[0]):
            miss = set(self.miss_rows(ids[i:i + 1]).tolist())
            if i > start and len(covered | miss) > self.staging_capacity:
                chunks.append(ids[start:i])
                start, covered = i, miss
            else:
                covered |= miss
        chunks.append(ids[start:])
        return chunks

    def _pack(self, slots: np.ndarray, rows: np.ndarray, buf: np.ndarray,
              sbuf: np.ndarray | None, smap: np.ndarray) -> None:
        """Pack the changed staging slots (index, row, scale) and map
        entries (row, slot) into the pinned upload buffer; runs under the
        pipeline's lock."""
        n_s, n_m = slots.size, rows.size
        if n_s == 0 and n_m == 0:
            self._pending = None
            return
        d = self.spec.dim
        parts = [("slots", np.int64, (n_s,)), ("rows", buf.dtype, (n_s, d))]
        if sbuf is not None:
            parts.append(("scales", np.float32, (n_s, 1)))
        parts += [("map_rows", np.int64, (n_m,)),
                  ("map_slots", np.int32, (n_m,))]
        layout, total = {}, 0
        for name, dtype, shape in parts:
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            layout[name] = (total, dtype, shape)
            total += -(-nbytes // 8) * 8                # 8-byte aligned
        host = self._host_buffer(total).numpy()

        def view(name):
            off, dtype, shape = layout[name]
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            return host[off:off + n].view(dtype).reshape(shape)
        view("slots")[:] = slots
        np.take(buf, slots, axis=0, out=view("rows"))
        if sbuf is not None:
            np.take(sbuf, slots, axis=0, out=view("scales"))
        view("map_rows")[:] = rows
        np.take(smap, rows, out=view("map_slots"))
        self._pending = (layout, total)

    def _host_buffer(self, nbytes: int) -> torch.Tensor:
        """The pinned upload buffer, at least ``nbytes`` long, once the
        copy that last read it has finished."""
        if self._uploaded is not None:
            self._uploaded.synchronize()
        if self._pinned is None or self._pinned.numel() < nbytes:
            size = max(nbytes, 2 * (0 if self._pinned is None
                                    else self._pinned.numel()))
            self._pinned = torch.empty(
                size, dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        return self._pinned

    def _upload(self) -> None:
        """Copy what :meth:`_pack` packed to the device in one transfer and
        scatter it into the staging tensors, on the current stream, after
        every lookup queued so far."""
        if self._pending is None:
            return
        layout, total = self._pending
        self._pending = None
        dev = self.device
        cuda = dev.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(dev)
            for event in self._readers.values():
                stream.wait_event(event)
        packed = torch.empty(total, dtype=torch.uint8, device=dev)
        packed.copy_(self._pinned[:total], non_blocking=True)

        def view(name, dtype):
            off, _, shape = layout[name]
            n = int(np.prod(shape)) * dtype.itemsize
            return packed[off:off + n].view(dtype).view(shape)
        slots = view("slots", torch.int64)
        if slots.numel():
            self.staging.index_copy_(0, slots, view("rows",
                                                    self.staging.dtype))
            if self.quantized:
                self.staging_scale.index_copy_(0, slots,
                                               view("scales", torch.float32))
        rows = view("map_rows", torch.int64)
        if rows.numel():
            self.staging_slot_of_row.index_copy_(
                0, rows, view("map_slots", torch.int32))
        if cuda:
            self._uploaded = stream.record_event()
        self.upload_bytes += total

    def _upload_changes(self) -> None:
        """Upload the staging changes a refresh or delta caused."""
        self.pipeline.take_changes(self._pack)
        self._upload()

    # -- lookup --------------------------------------------------------------
    def _read(self, lookup):
        """Run ``lookup()`` ordered after the last staging upload, and
        remember where it ran, so the next upload waits for it."""
        if self.device.type != "cuda":
            return lookup()
        stream = torch.cuda.current_stream(self.device)
        if self._uploaded is not None:
            stream.wait_event(self._uploaded)
        out = lookup()
        self._readers[stream.cuda_stream] = stream.record_event()
        return out

    def lookup(self, ids: torch.Tensor, offsets: torch.Tensor, *,
               strategy: str = "auto",
               runtime: dict[str, torch.Tensor] | None = None
               ) -> torch.Tensor:
        t = self._tensors(runtime)
        if self.quantized:
            return self._read(lambda: kops.multi_table_lookup_host_q8(
                ids, t["cache"], t["cache_scale"], t["staging"],
                t["staging_scale"], t["slot_of_row"],
                t["staging_slot_of_row"], offsets, strategy=strategy))
        return self._read(lambda: kops.multi_table_lookup_host(
            ids, t["cache"], t["staging"], t["slot_of_row"],
            t["staging_slot_of_row"], offsets, strategy=strategy))

    def lookup_multihot(self, ids: torch.Tensor, mask: torch.Tensor,
                        offsets: torch.Tensor, *, strategy: str = "auto",
                        runtime: dict[str, torch.Tensor] | None = None
                        ) -> torch.Tensor:
        t = self._tensors(runtime)
        if self.quantized:
            return self._read(lambda: kops.multi_table_lookup_host_q8_multihot(
                ids, mask, t["cache"], t["cache_scale"], t["staging"],
                t["staging_scale"], t["slot_of_row"],
                t["staging_slot_of_row"], offsets, strategy=strategy))
        return self._read(lambda: kops.multi_table_lookup_host_multihot(
            ids, mask, t["cache"], t["staging"], t["slot_of_row"],
            t["staging_slot_of_row"], offsets, strategy=strategy))

    # -- traffic / cache management ------------------------------------------
    def observe(self, global_rows: np.ndarray) -> None:
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
        id) into the device cache, gathered from the host backing, and
        drop them from staging (hot staged rows graduate to the cache)."""
        order = np.lexsort((np.arange(self._counts.size), -self._counts))
        hot = np.sort(order[:self.capacity]).astype(np.int32)
        new_map = np.full(self._counts.size, -1, dtype=np.int32)
        new_map[hot] = np.arange(self.capacity, dtype=np.int32)
        self._slot_of_row = new_map
        self.pipeline.drop(hot)
        self.stats.refreshes += 1
        self._publish(self._cache_tensors())
        self._upload_changes()

    @torch.no_grad()
    def apply_deltas(self, row_ids, new_rows) -> int:
        """Write online trainer deltas through all three tiers.

        The host backing (RAM array or writable memmap) is updated in
        place under the pipeline's lock, and staged copies of the updated
        rows are re-gathered before the lock drops. Cached rows get their
        cache slots rewritten in a fresh cache tensor, swapped in after a
        device sync. An int8 store quantizes the incoming fp32 rows once.
        A read-only memmap (``open(mode="r")``) refuses; a read-only
        adopted array is copied once, on the first delta.
        """
        rows_idx, vals = validate_deltas(self.spec, row_ids, new_rows)
        n = int(rows_idx.size)
        if n == 0:
            return 0
        backing = self.host_view()
        if not backing.flags.writeable:
            if isinstance(backing, np.memmap):
                raise ValueError(
                    "host backing is a read-only memmap "
                    "(HostBackedStore.open defaults to mode='r'); reopen "
                    "with mode='r+' to accept online deltas")
            self._backing = backing = backing.copy()
        scale = None
        if self.quantized:
            q, s = quant.quantize_rows(torch.from_numpy(vals))
            wire, scale = q.numpy(), s.numpy()
            self.stats.quant_rows += n

            def write():
                backing[rows_idx] = wire
                self.host_scale_view()[rows_idx] = scale
        else:
            wire = vals

            def write():
                backing[rows_idx] = wire
        self.pipeline.apply_backing_update(rows_idx, write)
        slots = self._slot_of_row[rows_idx]
        cached = np.flatnonzero(slots >= 0)
        if cached.size:
            dev = self.device
            cidx = torch.from_numpy(slots[cached].astype(np.int64)).to(dev)
            fresh = {"cache": self.cache.index_put(
                (cidx,), torch.from_numpy(wire[cached]).to(dev))}
            if self.quantized:
                fresh["cache_scale"] = self.cache_scale.index_put(
                    (cidx,), torch.from_numpy(scale[cached]).to(dev))
            self._publish(fresh)
        self._upload_changes()
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
        tier3 = ",mmap" if self.backing_path else ""
        q = ",int8" if self.quantized else ""
        return (f"host(C={self.capacity},S={self.staging_capacity},"
                f"rows={self.spec.rows},d={self.spec.dim}{tier3}{q})")

"""PrefetchPipeline — host-side staging of a HostBackedStore's misses.

Counterpart of ``repro.embedding.prefetch``: plain Python, numpy and one
daemon thread, with the reference's semantics. When the backing table
lives in host memory, each batch's cache misses must be on the device
before its lookup. This module owns the host side of that:

  * a **staging area** of ``S`` host row slots mirroring the device
    staging buffer, with an LRU map ``row -> slot``;
  * an **async worker** that takes hints (the rows of batches not yet
    served) and stages their cache misses from the host backing while
    earlier batches compute on the device;
  * a synchronous ``ensure`` that closes any gap at serve time, so the
    device lookup never meets an unresolved row.

The one difference from the reference is how the store learns what to
upload. The reference snapshots the whole staging area (buffer and
``(rows,)`` map) for every batch that staged anything; here the pipeline
also records, under its lock, which staging slots and which map entries
changed since the last upload (rows staged, rows evicted, rows dropped by
a refresh, slots re-gathered by a delta) and hands only those to the
store's ``pack`` callable, still under the lock, so the upload moves
O(changed rows) bytes and the worker can stage again while it is in
flight. :meth:`snapshot` stays for tests.

When a batch's distinct miss set cannot fit the ``S`` slots, ``ensure``
raises :class:`StagingOverflowError` before touching anything, and the
caller serves the batch in chunks (``HostBackedStore.split_for_staging``).

Thread safety: one lock guards the staging area and the change record
(the serving thread's ``ensure``/``snapshot`` against the worker's
speculative staging); counters are read under the same lock.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Callable

import numpy as np

__all__ = ["StagingOverflowError", "PrefetchPipeline"]

#: ``pack(slots, rows, buf, sbuf, slot_of_staged)``: called under the
#: pipeline's lock with the changed staging slots and map rows (sorted
#: int64 arrays) and the live host buffers; copies what it needs.
Pack = Callable[[np.ndarray, np.ndarray, np.ndarray, "np.ndarray | None",
                 np.ndarray], None]


class StagingOverflowError(RuntimeError):
    """A batch's distinct miss set exceeds the staging buffer's capacity.

    Raised by :meth:`PrefetchPipeline.ensure` (and surfaced through
    ``HostBackedStore.stage``). The caller serves the batch in chunks
    instead — never with unresolved rows.
    """


class PrefetchPipeline:
    """Host-side staging area + async miss-resolution worker.

    Args:
        store: the owning ``HostBackedStore``, read for the live host
            backing and the current cache map (both change on adopt and
            refresh, so they are read per operation, never bound).
        capacity: number of staging row slots ``S``.

    The pipeline never touches the device: it fills a host staging buffer,
    bumps a version counter on every change and records what changed.
    """

    def __init__(self, store, capacity: int):
        if capacity < 1:
            raise ValueError(f"staging capacity must be >= 1, got {capacity}")
        self._store = store
        self.capacity = int(capacity)
        spec = store.spec
        # wire-format rows: int8 payload (+ fp32 scale) for quantized
        # stores, full-precision rows otherwise
        wire_dtype = np.int8 if spec.quantized else np.dtype(spec.dtype)
        self._buf = np.zeros((self.capacity, spec.dim), dtype=wire_dtype)
        self._sbuf = (np.zeros((self.capacity, 1), dtype=np.float32)
                      if spec.quantized else None)
        self._slot_of_staged = np.full(spec.rows, -1, dtype=np.int32)
        self._lru: OrderedDict[int, int] = OrderedDict()   # row -> slot
        self._free = list(range(self.capacity - 1, -1, -1))
        self._lock = threading.Lock()
        self._version = 0          # bumps on any buffer/map change
        # changes not yet handed to the store's upload
        self._dirty_slots: set[int] = set()
        self._dirty_rows: set[int] = set()
        # async worker
        self._q: deque[np.ndarray] = deque()
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._running = False
        self._idle = threading.Event()
        self._idle.set()
        # counters (read under _lock)
        self.n_prefetched = 0      # rows staged by the async worker
        self.n_hinted_batches = 0

    # -- staging area --------------------------------------------------------
    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def staged_rows(self) -> int:
        with self._lock:
            return len(self._lru)

    def _stage_rows_locked(self, need: np.ndarray, miss_set: set) -> int:
        """Gather ``need`` backing rows into free or evicted slots. The
        caller holds the lock and has checked that the miss set fits."""
        backing = self._store.host_view()
        scales = self._store.host_scale_view() if self._sbuf is not None \
            else None
        staged = 0
        for row in need:
            row = int(row)
            if self._slot_of_staged[row] >= 0:      # raced with the worker
                self._lru.move_to_end(row)
                continue
            if self._free:
                slot = self._free.pop()
            else:
                # evict the least-recently-used row NOT in this miss set
                victim = next(r for r in self._lru if r not in miss_set)
                slot = self._lru.pop(victim)
                self._slot_of_staged[victim] = -1
                self._dirty_rows.add(victim)
            self._buf[slot] = backing[row]
            if scales is not None:
                self._sbuf[slot] = scales[row]
            self._slot_of_staged[row] = slot
            self._lru[row] = slot
            self._dirty_slots.add(slot)
            self._dirty_rows.add(row)
            staged += 1
        if staged:
            self._version += 1
        return staged

    def _take_changes_locked(self, pack: Pack) -> None:
        slots = np.fromiter(sorted(self._dirty_slots), dtype=np.int64,
                            count=len(self._dirty_slots))
        rows = np.fromiter(sorted(self._dirty_rows), dtype=np.int64,
                           count=len(self._dirty_rows))
        pack(slots, rows, self._buf, self._sbuf, self._slot_of_staged)
        self._dirty_slots.clear()
        self._dirty_rows.clear()

    def ensure(self, miss_rows: np.ndarray, pack: Pack | None = None
               ) -> tuple[int, int]:
        """Make every row in ``miss_rows`` staged; returns
        ``(n_newly_staged, n_already_staged)``.

        ``miss_rows`` are unique global rows absent from the device cache.
        Rows already staged (by an earlier batch or the worker) count as
        prefetch hits. Raises :class:`StagingOverflowError`, with nothing
        changed, when the set cannot fit ``S`` slots. ``pack``, when
        given, receives the changes since the last upload under the same
        lock, so no worker eviction can fall between this batch's staging
        and its upload.
        """
        miss_rows = np.asarray(miss_rows).reshape(-1)
        if miss_rows.size > self.capacity:
            raise StagingOverflowError(
                f"batch misses {miss_rows.size} distinct uncached rows; "
                f"staging buffer holds {self.capacity} — serve in chunks "
                "(split_for_staging) or raise staging_capacity")
        with self._lock:
            need = miss_rows[self._slot_of_staged[miss_rows] < 0]
            already = int(miss_rows.size - need.size)
            # refresh LRU position of reused rows so hot staged rows survive
            for row in miss_rows[self._slot_of_staged[miss_rows] >= 0]:
                self._lru.move_to_end(int(row))
            staged = self._stage_rows_locked(need, set(miss_rows.tolist()))
            if pack is not None:
                self._take_changes_locked(pack)
        return staged, already

    def take_changes(self, pack: Pack) -> None:
        """Hand the changes since the last upload to ``pack`` (under the
        lock) and forget them."""
        with self._lock:
            self._take_changes_locked(pack)

    def snapshot(self) -> tuple[np.ndarray, np.ndarray | None,
                                np.ndarray, int]:
        """Copy of ``(staging_buf, scale_buf_or_None, slot_of_staged,
        version)``. The recorded changes stay for the next upload."""
        with self._lock:
            sbuf = self._sbuf.copy() if self._sbuf is not None else None
            return self._buf.copy(), sbuf, self._slot_of_staged.copy(), \
                self._version

    def load(self, buf: np.ndarray, sbuf: np.ndarray | None,
             slot_of_staged: np.ndarray) -> None:
        """Replace the staging area with ``buf``/``sbuf`` under the map
        ``slot_of_staged`` (state loaded from outside). The LRU order is
        not part of that state: staged rows are ranked by slot, lowest
        first, the order in which an empty pipeline fills its slots."""
        m = np.asarray(slot_of_staged, dtype=np.int32)
        if m.shape != self._slot_of_staged.shape:
            raise ValueError(f"staging map has shape {m.shape}, expected "
                             f"{self._slot_of_staged.shape}")
        staged = np.flatnonzero(m >= 0)
        slots = m[staged]
        if slots.size and (slots.max() >= self.capacity
                           or np.unique(slots).size != slots.size):
            raise ValueError(f"staging map entries must be distinct slots "
                             f"in [-1, {self.capacity})")
        order = np.argsort(slots, kind="stable")
        with self._lock:
            self._buf[...] = buf
            if self._sbuf is not None:
                self._sbuf[...] = sbuf
            self._slot_of_staged = m.copy()
            self._lru = OrderedDict((int(staged[i]), int(slots[i]))
                                    for i in order)
            used = set(slots.tolist())
            self._free = [s for s in range(self.capacity - 1, -1, -1)
                          if s not in used]
            self._dirty_slots.clear()
            self._dirty_rows.clear()
            self._version += 1

    def apply_backing_update(self, rows: np.ndarray, write) -> int:
        """Run ``write()`` (a host-backing mutation covering ``rows``)
        under the staging lock, then re-gather any of those rows already
        in staging slots so the buffer never serves stale values.

        The worker and the serving thread gather backing rows under this
        same lock, so a staged row is either entirely pre-delta or
        entirely post-delta. Returns how many staged slots were
        re-gathered.
        """
        rows = np.asarray(rows).reshape(-1)
        with self._lock:
            write()
            backing = self._store.host_view()
            scales = self._store.host_scale_view() if self._sbuf is not None \
                else None
            refreshed = 0
            for row in rows:
                slot = int(self._slot_of_staged[int(row)])
                if slot < 0:
                    continue
                self._buf[slot] = backing[int(row)]
                if scales is not None:
                    self._sbuf[slot] = scales[int(row)]
                self._dirty_slots.add(slot)
                refreshed += 1
            if refreshed:
                self._version += 1
            return refreshed

    def drop(self, rows: np.ndarray) -> int:
        """Evict ``rows`` from staging (a refresh promoted them into the
        device cache; their slots are better spent on cold rows)."""
        dropped = 0
        with self._lock:
            for row in np.asarray(rows).reshape(-1):
                row = int(row)
                slot = self._lru.pop(row, None)
                if slot is not None:
                    self._slot_of_staged[row] = -1
                    self._free.append(slot)
                    self._dirty_rows.add(row)
                    dropped += 1
            if dropped:
                self._version += 1
        return dropped

    # -- async worker --------------------------------------------------------
    def hint(self, miss_rows: np.ndarray) -> None:
        """Queue candidate rows for speculative staging off-thread.

        Best effort: the worker stages what fits into free (or
        LRU-evictable) slots and skips the rest; ``ensure`` closes any gap
        at serve time. Starts the daemon worker lazily and restarts it
        after a ``stop``.
        """
        rows = np.asarray(miss_rows).reshape(-1)
        if rows.size == 0:
            return
        with self._cv:
            self._q.append(rows)
            self._idle.clear()
            if self._thread is None or not self._thread.is_alive():
                self._running = True
                self._thread = threading.Thread(
                    target=self._worker_loop, daemon=True,
                    name="embedding-prefetch")
                self._thread.start()
            self._cv.notify()

    def stop(self) -> None:
        """Stop the worker thread (joins). Later hints restart it."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join()
        self._idle.set()

    def wait_idle(self, timeout: float | None = 5.0) -> bool:
        """Block until the hint queue is drained (tests and benchmarks use
        this to make the prefetch counters deterministic)."""
        return self._idle.wait(timeout)

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while self._running and not self._q:
                    self._idle.set()
                    self._cv.wait()
                if not self._running:
                    self._idle.set()
                    return
                rows = self._q.popleft()
            try:
                self._prefetch(rows)
            except Exception:
                # speculative work only: ensure() redoes anything missed
                pass

    def _prefetch(self, rows: np.ndarray) -> None:
        """Stage the cache misses of a hinted batch, capped at what fits."""
        slot_of_row = self._store.cache_map_view()
        rows = np.unique(rows)
        miss = rows[slot_of_row[rows] < 0]
        if miss.size == 0:
            return
        with self._lock:
            need = miss[self._slot_of_staged[miss] < 0]
            # cap at free + evictable (never evict rows this hint needs)
            budget = len(self._free) + max(
                0, len(self._lru) - int((self._slot_of_staged[miss] >= 0)
                                        .sum()))
            need = need[:budget]
            n = self._stage_rows_locked(need, set(miss.tolist()))
            self.n_prefetched += n
            self.n_hinted_batches += 1

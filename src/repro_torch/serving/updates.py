"""Delta sources — the trainer side of online model updates.

Counterpart of ``repro.serving.updates`` (numpy only): the same classes,
and ``SyntheticTrainer``'s ``np.random.default_rng`` stream gives the
reference's deltas for the same seed.

Real CTR serving consumes a continuous stream of parameter pushes from a
live trainer (HugeCTR's incremental-update pipeline): embedding rows keep
training while yesterday's snapshot serves, and the serving tier applies
``(row_id, new_row)`` deltas without ever dropping a request or a
compiled plan. This module is the intake side of that stream:

  ``DeltaSource``      the protocol an engine pulls from — batches of
                       deltas plus the staleness the engine reports
                       (``rows_behind`` / ``seconds_behind``).
  ``DeltaBuffer``      a thread-safe FIFO a trainer (or RPC handler)
                       ``feed``\\ s; tracks arrival times so staleness is
                       measured, not guessed.
  ``SyntheticTrainer`` a seeded, finite, deterministic delta stream over
                       the vocabulary — what ``launch/serve.py
                       --delta-every`` and the benchmarks drive.

The application side lives in ``InferenceEngine.push_update`` /
``pull_updates`` and ``ServingRuntime.push_update`` /
``attach_delta_stream``: every batch lands through the store's
``apply_deltas`` and the engine's double-buffered publish, stamping a new
monotonic ``emb_version`` — a compiled plan reads one published subtree
per step, so it sees the stream entirely-before or entirely-after each
push, never torn.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

__all__ = ["DeltaSource", "DeltaBuffer", "SyntheticTrainer"]


class DeltaSource:
    """Protocol of a delta stream an engine can pull from.

    ``next_batch()`` returns the oldest unapplied ``(row_ids, new_rows)``
    pair — ids a 1-D integer array, rows the matching ``(n, d)``
    full-precision array — or ``None`` when the stream is (currently)
    drained. The two staleness accessors feed the engine's gauges:
    ``pending_rows()`` is how many delta rows are queued but unapplied
    (``rows_behind``), ``oldest_pending_s()`` how long the oldest of them
    has been waiting (``seconds_behind``; 0.0 when caught up).
    """

    def next_batch(self) -> tuple[np.ndarray, np.ndarray] | None:
        raise NotImplementedError

    def pending_rows(self) -> int:
        return 0

    def oldest_pending_s(self) -> float:
        return 0.0


class DeltaBuffer(DeltaSource):
    """Thread-safe FIFO between a trainer thread and the serving side.

    The producer calls :meth:`feed` with each push; the consumer (an
    engine's ``pull_updates``, or the runtime's ``delta_every`` cadence)
    drains it batch-by-batch via :meth:`next_batch`. Arrival timestamps
    ride along, so ``oldest_pending_s`` measures real queue age — the
    clock is injectable (``clock=``, default ``time.monotonic``) to keep
    staleness tests deterministic.
    """

    def __init__(self, clock=time.monotonic):
        self._q: deque[tuple[float, np.ndarray, np.ndarray]] = deque()
        self._lock = threading.Lock()
        self._pending = 0
        self._clock = clock

    def feed(self, row_ids, new_rows) -> int:
        """Queue one delta batch; returns rows now pending. Shapes are
        validated store-side at apply time (``validate_deltas``) — the
        buffer only requires ids and rows to agree on length."""
        row_ids = np.asarray(row_ids).reshape(-1)
        new_rows = np.asarray(new_rows)
        if new_rows.ndim == 1:
            new_rows = new_rows[None, :]
        if new_rows.shape[0] != row_ids.size:
            raise ValueError(f"{row_ids.size} row ids but "
                             f"{new_rows.shape[0]} rows")
        with self._lock:
            self._q.append((self._clock(), row_ids, new_rows))
            self._pending += int(row_ids.size)
            return self._pending

    def next_batch(self) -> tuple[np.ndarray, np.ndarray] | None:
        with self._lock:
            if not self._q:
                return None
            _, ids, rows = self._q.popleft()
            self._pending -= int(ids.size)
            return ids, rows

    def pending_rows(self) -> int:
        with self._lock:
            return self._pending

    def oldest_pending_s(self) -> float:
        with self._lock:
            if not self._q:
                return 0.0
            return max(0.0, self._clock() - self._q[0][0])


class SyntheticTrainer(DeltaSource):
    """A finite, seeded delta stream standing in for a live trainer.

    Emits ``n_batches`` batches of ``rows_per_batch`` deltas each, row
    ids drawn uniformly over ``[0, spec.zero_row)`` (the zero row and
    padding are never touched — stores reject them) and values from the
    same flat-scale normal family as ``init_dense_table``, so pushed rows
    are statistically indistinguishable from trained ones. Fully
    deterministic for a given ``seed``: the benchmark's structural
    counters and the A/B bit-exactness tests depend on replaying the
    identical stream.
    """

    def __init__(self, spec, rows_per_batch: int, n_batches: int,
                 seed: int = 0, clock=time.monotonic):
        if spec.zero_row < 1:
            raise ValueError("spec has no updatable rows")
        self.spec = spec
        self.rows_per_batch = int(rows_per_batch)
        self.n_batches = int(n_batches)
        self._emitted = 0
        self._lock = threading.Lock()
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._clock = clock
        self._t_next = None   # arrival time of the current head batch

    def _make_batch(self) -> tuple[np.ndarray, np.ndarray]:
        ids = self._rng.integers(0, self.spec.zero_row,
                                 size=self.rows_per_batch)
        rows = (self._rng.standard_normal(
            (self.rows_per_batch, self.spec.dim)) * 0.05).astype(
                np.dtype(self.spec.dtype))
        return ids, rows

    def next_batch(self) -> tuple[np.ndarray, np.ndarray] | None:
        with self._lock:
            if self._emitted >= self.n_batches:
                return None
            self._emitted += 1
            self._t_next = None
            return self._make_batch()

    def pending_rows(self) -> int:
        with self._lock:
            return (self.n_batches - self._emitted) * self.rows_per_batch

    def oldest_pending_s(self) -> float:
        """Age since the head batch became available (tracked from the
        first staleness read after the previous pull — a stand-in for a
        real trainer's push timestamp)."""
        with self._lock:
            if self._emitted >= self.n_batches:
                return 0.0
            if self._t_next is None:
                self._t_next = self._clock()
            return max(0.0, self._clock() - self._t_next)

    def replay(self, seed: int | None = None) -> "SyntheticTrainer":
        """A fresh trainer emitting the identical stream (tests replay it
        against a second engine to check A/B divergence is exactly the
        un-pushed deltas)."""
        return SyntheticTrainer(self.spec, self.rows_per_batch,
                                self.n_batches,
                                seed=self._seed if seed is None else seed,
                                clock=self._clock)

"""ServingRuntime — one async intake over many named engines.

Counterpart of ``repro.serving.runtime``. The port's models own their
tensors, so ``add_model`` takes no parameter tree, and there is no shared
``mesh`` (multi-device serving is ROADMAP Queue A item 4).

Production CTR serving rarely hosts a single model: ranking and
pre-ranking models (e.g. ``deepfm`` + ``dcnv2``) sit behind one RPC
surface, each with its own plan cache, batching policy, and embedding
tier. ``ServingRuntime`` is that router over ``InferenceEngine``s:

    rt = ServingRuntime()
    rt.add_model("deepfm", deepfm, policy=TimeoutBatch())
    rt.add_model("dcnv2", dcnv2, store=CachedStore(...))
    rt.start()                       # shared pool drains every engine
    fut = rt.submit("deepfm", row)   # routed by model name
    fut.result()
    rt.stats().p99_ms                # aggregated across engines
    rt.stop()

The runtime owns

* **per-model routing**: ``submit``/``predict`` dispatch on the model
  name; unknown names fail fast with the hosted set in the message;
* **lifecycle fan-out**: ``start``/``stop``/``warmup``/``flush`` reach
  every engine. By default ``start()`` attaches every engine to one
  shared :class:`~repro_torch.serving.DeviceScheduler` — ``pool_size``
  threads drain *all* queues least-SLO-slack-first, so hosting N models
  costs a constant thread count and a starved model's ``TimeoutBatch``
  deadline outranks a busy model's full buckets
  (``scheduler="per-engine"`` keeps the old worker-thread-per-engine
  mode; a row's score is the same either way — bitwise on the CPU, within
  ``rtol=1e-5, atol=1e-6`` on a card, where the bucket that serves it
  depends on timing and cuBLAS may pick another GEMM for another batch
  size);
* **shared admission cadence**: with ``refresh_every=N`` the runtime
  counts *total* submitted traffic across models and refreshes every
  refreshable embedding store each time N more requests arrived — one
  HugeCTR-style refresh clock for the whole deployment instead of one
  per engine. Refreshes are double-buffered tensor swaps, so they never
  recompile any engine's plans;
* **online model updates**: ``push_update(model, row_ids, new_rows)``
  routes trainer deltas to the named engine's versioned publish, and
  ``attach_delta_stream`` + ``delta_every=N`` drains a
  :class:`~repro_torch.serving.updates.DeltaSource` on the same shared
  admission clock;
* **aggregated stats**: :func:`ServingRuntime.stats` merges the
  per-engine counters into one :class:`RuntimeStats` snapshot (totals +
  merged latency percentiles + per-model ``EngineStats``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np

from .engine import (AGGREGATED_COUNTERS, EngineStats, InferenceEngine,
                     RequestFuture)
from .scheduler import DeviceScheduler

__all__ = ["ServingRuntime", "RuntimeStats"]


@dataclasses.dataclass(frozen=True)
class RuntimeStats:
    """Point-in-time aggregate over every hosted engine.

    ``p50_ms``/``p99_ms`` are computed over the *union* of the engines'
    rolling latency windows (recent samples, same caveat as
    ``EngineStats``). ``per_model`` holds a *snapshot* of each engine's
    stats, taken under that engine's lock (``EngineStats.snapshot``) —
    drill-down counters are consistent and never mutate under the
    reader; re-call :meth:`ServingRuntime.stats` for fresh numbers.
    ``device_time_share`` sums the per-engine shares, so it reads ~1.0
    when a shared scheduler has dispatched anything and 0.0 in
    per-engine-worker mode. Every counter named in
    ``engine.AGGREGATED_COUNTERS`` is a field here — :meth:`stats` sums
    them generically, and the import-time check below keeps the two
    definitions from drifting.

    Online-update staleness: ``emb_delta_pushes``/``emb_delta_rows`` and
    ``rows_behind`` sum across engines, while ``emb_version`` and
    ``seconds_behind`` take the **max** — versions are per-engine
    sequences (two A/B engines deliberately sit at different versions),
    so the aggregate answers "how fresh is the deployment's most-updated
    set / how stale is the worst engine", and ``per_model`` drills into
    each engine's own version and gauges.
    """
    n_models: int
    n_requests: int
    n_batches: int
    n_rejected: int
    queue_depth: int
    n_worker_errors: int
    p50_ms: float
    p99_ms: float
    cache_hits: int
    cache_misses: int
    emb_cache_refreshes: int
    emb_staged_rows: int
    emb_prefetched_rows: int
    emb_h2d_bytes: int
    emb_staging_overflows: int
    emb_gather_bytes: int
    emb_quant_rows: int
    emb_quant_bytes_saved: int
    emb_version: int
    emb_delta_pushes: int
    emb_delta_rows: int
    rows_behind: int
    seconds_behind: float
    mlp_quant_matmuls: int
    mlp_quant_weight_bytes: int
    mlp_quant_weight_bytes_saved: int
    sched_dispatches: int
    sched_preempted_slack_ms: float
    device_time_share: float
    per_model: dict[str, EngineStats]


_missing = [name for name in AGGREGATED_COUNTERS
            if name not in RuntimeStats.__dataclass_fields__]
assert not _missing, (
    f"RuntimeStats lacks fields for AGGREGATED_COUNTERS: {_missing}")
del _missing


class ServingRuntime:
    """Multi-model router: named ``InferenceEngine``s behind one intake.

    Args:
        refresh_every: shared admission cadence — refresh every
            refreshable store once per N submitted requests *across all
            models* (``None`` disables; engines may still run their own
            per-engine ``refresh_every``).
        scheduler: how :meth:`start` drains the hosted queues.
            ``"shared"`` (default): one :class:`DeviceScheduler` —
            ``pool_size`` threads serve every engine least-slack-first
            (thread count stays constant as models scale). A
            ``DeviceScheduler`` instance uses that scheduler (e.g. one
            pool shared across several runtimes on one device).
            ``"per-engine"``: the pre-scheduler compat mode, one worker
            thread per engine.
        pool_size: worker threads for the shared scheduler (ignored in
            ``"per-engine"`` mode or when a scheduler instance is
            passed).
        delta_every: online-update cadence — pull every attached delta
            stream (:meth:`attach_delta_stream`) once per N submitted
            requests across models, applying pending trainer pushes in a
            background thread off the intake hot path (same pattern as
            the shared admission refresh). Deltas land through each
            engine's versioned double-buffered publish, so cadence
            trades staleness (``rows_behind``/``seconds_behind``)
            against host-side scatter work only — never recompiles.
            ``None`` disables; :meth:`pull_updates`/:meth:`push_update`
            remain the manual surface.
    """

    def __init__(self, *, refresh_every: int | None = None,
                 scheduler: str | DeviceScheduler = "shared",
                 pool_size: int = 2, delta_every: int | None = None):
        self._engines: dict[str, InferenceEngine] = {}
        self.refresh_every = refresh_every
        if isinstance(scheduler, DeviceScheduler):
            self.scheduler_mode = "shared"
            self._scheduler: DeviceScheduler | None = scheduler
        elif scheduler in ("shared", "per-engine"):
            self.scheduler_mode = scheduler
            self._scheduler = None
        else:
            raise ValueError(f"scheduler must be 'shared', 'per-engine' or "
                             f"a DeviceScheduler, got {scheduler!r}")
        self.pool_size = pool_size
        self.delta_every = delta_every
        self._submitted = 0
        self._refreshing = False
        self._refresh_thread: threading.Thread | None = None
        self._delta_pulling = False
        self._delta_thread: threading.Thread | None = None
        self._admission_lock = threading.Lock()

    # -- registry ------------------------------------------------------------
    def add_engine(self, name: str, engine: InferenceEngine
                   ) -> InferenceEngine:
        """Host an existing engine under ``name``."""
        if name in self._engines:
            raise ValueError(f"model {name!r} already registered")
        self._engines[name] = engine
        return engine

    def add_model(self, name: str, model,
                  **engine_kwargs) -> InferenceEngine:
        """Build and host an ``InferenceEngine`` for ``model`` — kwargs go
        straight to :class:`InferenceEngine` (policy, store, level,
        device, ...)."""
        return self.add_engine(name, InferenceEngine(model,
                                                     **engine_kwargs))

    def engine(self, name: str) -> InferenceEngine:
        try:
            return self._engines[name]
        except KeyError:
            raise KeyError(f"no model {name!r}; hosting "
                           f"{sorted(self._engines)}") from None

    @property
    def models(self) -> tuple[str, ...]:
        return tuple(self._engines)

    # -- lifecycle -----------------------------------------------------------
    def warmup(self) -> None:
        for eng in self._engines.values():
            eng.warmup()

    @property
    def scheduler(self) -> DeviceScheduler | None:
        """The shared scheduler (None before ``start()`` or in
        per-engine mode)."""
        return self._scheduler

    def start(self) -> "ServingRuntime":
        """Start draining. Default (``scheduler="shared"``): attach every
        hosted engine to one :class:`DeviceScheduler` and start its
        ``pool_size``-thread pool — constant thread count however many
        models are hosted. Per-engine mode: one worker thread per engine
        (the pre-scheduler behaviour). Idempotent; engines added after a
        ``start()`` are picked up by calling it again."""
        if self.scheduler_mode == "shared":
            if self._scheduler is None:
                self._scheduler = DeviceScheduler(pool_size=self.pool_size)
            for name, eng in self._engines.items():
                self._scheduler.attach(name, eng)
            self._scheduler.start()
        else:
            for eng in self._engines.values():
                eng.start()
        return self

    def stop(self, flush: bool = True) -> None:
        """Stop the shared pool and/or every worker; with ``flush``
        (default) force-drain the leftover queues so no future stays
        unresolved. Joins any in-flight shared-admission refresh or
        delta pull. Every engine is stopped even if one raises; the
        first swallowed background-drain error
        (``EngineStats.n_worker_errors``) is re-raised at the end."""
        if self._scheduler is not None:
            self._scheduler.stop()
        errors: list[BaseException] = []
        for eng in self._engines.values():
            try:
                eng.stop(flush=flush)
            except Exception as exc:        # surface after stopping the rest
                errors.append(exc)
        with self._admission_lock:
            t, self._refresh_thread = self._refresh_thread, None
            d, self._delta_thread = self._delta_thread, None
        for bg in (t, d):
            if bg is not None and bg.is_alive():
                bg.join()
        if errors:
            raise errors[0]

    # -- intake --------------------------------------------------------------
    def submit(self, model: str, ids_row: np.ndarray) -> RequestFuture:
        """Route one request to ``model``'s engine; returns its future."""
        fut = self.engine(model).submit(ids_row)
        self._count_and_maybe_refresh(1)
        return fut

    def submit_many(self, model: str, rows: Sequence[np.ndarray]
                    ) -> list[RequestFuture]:
        futs = self.engine(model).submit_many(rows)
        self._count_and_maybe_refresh(len(futs))
        return futs

    def predict(self, model: str, ids) -> np.ndarray:
        """One-shot scores through ``model``'s engine (bypasses queues)."""
        return self.engine(model).predict(ids)

    def flush(self) -> dict[str, np.ndarray]:
        """Force-drain every engine; per-model scores in submit order."""
        return {name: eng.flush() for name, eng in self._engines.items()}

    # -- shared admission ----------------------------------------------------
    def _count_and_maybe_refresh(self, n: int) -> None:
        if not self.refresh_every and not self.delta_every:
            return
        with self._admission_lock:
            before = self._submitted
            self._submitted += n
            if self.delta_every:
                delta_crossed = (self._submitted // self.delta_every
                                 > before // self.delta_every)
                if delta_crossed and not self._delta_pulling:
                    # same off-hot-path rules as the refresh thread below:
                    # non-daemon, registered under the lock, joined in
                    # stop(). Deltas publish through each engine's
                    # versioned double-buffered swap — a short lag between
                    # crossing and publish only shows up as staleness.
                    self._delta_pulling = True
                    d = threading.Thread(target=self._pull_in_background,
                                         name="runtime-delta-pull")
                    self._delta_thread = d
                    d.start()
            if not self.refresh_every:
                return
            crossed = (self._submitted // self.refresh_every
                       > before // self.refresh_every)
            if crossed and not self._refreshing:
                # off the intake hot path: the boundary-crossing submit
                # must not pay the multi-store rebuild (or wait on drain
                # locks) — refreshes are double-buffered swaps, so a short
                # lag between crossing and publish is harmless. Non-daemon
                # (and joined in stop()): a daemon thread killed
                # mid-device-upload at interpreter exit aborts the
                # process. Registered under the lock so stop() can never
                # miss an in-flight refresh.
                self._refreshing = True
                t = threading.Thread(target=self._refresh_in_background,
                                     name="runtime-admission-refresh")
                self._refresh_thread = t
                t.start()

    def _refresh_in_background(self) -> None:
        try:
            self.refresh_all()
        finally:
            with self._admission_lock:
                self._refreshing = False

    def refresh_all(self) -> int:
        """Refresh every refreshable embedding store (double-buffered swap
        — no engine loses a compiled plan). Returns how many refreshed."""
        n = 0
        for eng in self._engines.values():
            store = eng.store
            if store is not None and store.refreshable:
                eng.refresh_cache()
                n += 1
        return n

    # -- online model updates ------------------------------------------------
    def push_update(self, model: str, row_ids, new_rows) -> int:
        """Apply one delta batch to ``model``'s engine (see
        :meth:`InferenceEngine.push_update`): the store scatters the new
        rows into backing + cache (+ staging), the engine publishes the
        fresh subtree in one swap and stamps the next ``emb_version`` —
        in-flight plans keep serving throughout, nothing recompiles.
        Returns rows applied (after dedupe)."""
        return self.engine(model).push_update(row_ids, new_rows)

    def attach_delta_stream(self, model: str, source) -> None:
        """Attach a :class:`~repro_torch.serving.updates.DeltaSource` to
        ``model``'s engine. Drained by :meth:`pull_updates` or, with
        ``delta_every=N``, automatically once per N submitted requests;
        its backlog feeds the engine's ``rows_behind`` /
        ``seconds_behind`` gauges either way."""
        self.engine(model).attach_delta_source(source)

    def pull_updates(self, max_batches: int | None = None) -> int:
        """Drain every attached delta stream now (up to ``max_batches``
        per engine); returns total rows applied across models."""
        return sum(eng.pull_updates(max_batches=max_batches)
                   for eng in self._engines.values())

    def _pull_in_background(self) -> None:
        try:
            self.pull_updates()
        finally:
            with self._admission_lock:
                self._delta_pulling = False

    # -- stats ---------------------------------------------------------------
    def stats(self) -> RuntimeStats:
        """Aggregate snapshot across engines (see :class:`RuntimeStats`)."""
        lat: list[float] = []
        tot = {name: 0 for name in AGGREGATED_COUNTERS}
        # max-aggregated gauges (see the RuntimeStats docstring): summing
        # per-engine version sequences or queue ages is meaningless.
        emb_version = 0
        seconds_behind = 0.0
        for eng in self._engines.values():
            eng.poll_staleness()       # gauges reflect the backlog *now*
            st = eng.stats
            with st.lock:
                lat.extend(st.latency_ms)
                for name in AGGREGATED_COUNTERS:
                    tot[name] += getattr(st, name)
                emb_version = max(emb_version, st.emb_version)
                seconds_behind = max(seconds_behind, st.seconds_behind)
        return RuntimeStats(
            n_models=len(self._engines),
            p50_ms=float(np.percentile(lat, 50)) if lat else 0.0,
            p99_ms=float(np.percentile(lat, 99)) if lat else 0.0,
            emb_version=emb_version,
            seconds_behind=seconds_behind,
            per_model={n: e.stats.snapshot()
                       for n, e in self._engines.items()},
            **tot)

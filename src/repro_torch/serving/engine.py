"""InferenceEngine — the single serving surface over compiled plans.

Counterpart of ``repro.serving.engine``. The deployment story (paper
Fig. 7) as three layers:

    plan  = compile_plan(model, "dual", 256)           # repro_torch.core
    eng   = InferenceEngine(model, policy=BucketedBatch())
    fut   = eng.submit(row); fut.result()              # async intake
    eng.submit(row); scores = eng.serve_pending()      # or sync drain

The port's models own their tensors, so the engine takes no parameter
tree: it serves the model as it stands, on ``device`` (CUDA unless the
caller says "cpu"). The engine owns

* a **plan cache** keyed by ``PlanKey`` (model, level, batch bucket,
  branch order, store, compute dtype) — each batching bucket compiles
  once and is reused for every later batch of that shape (hit/miss counts
  are in ``stats``);
* a **batching policy** (``repro_torch.serving.batching``) deciding how
  queued single-sample requests group into padded device batches;
* a **request queue of futures**: ``submit`` returns a
  :class:`RequestFuture` that resolves (score + latency) when its batch is
  served — either by a caller-driven drain (``serve_pending``/``flush``)
  or by the **background worker thread** (``start()``/``stop()``), or by
  a :class:`~repro_torch.serving.DeviceScheduler`'s shared pool;
* **latency accounting** separating queueing from compute (bounded rolling
  p50/p99 window — see ``EngineStats``; all counters behind one lock so
  the worker and callers never race). A request's latency ends when its
  scores are on the host: ``InferencePlan.predict`` ends in a
  device→host copy, so device time is always inside it;
* an optional **embedding store** tier (``store=CachedStore(...)``): the
  engine feeds served id traffic to the store's admission counters and
  rebuilds the hot-row cache on ``refresh_cache()`` (or every
  ``refresh_every`` batches). The store's tensors are runtime inputs of
  every compiled plan, so a refresh or a delta push never recompiles;
* the **staging pipeline** for out-of-device-memory stores
  (``store=HostBackedStore(...)``): before each batch's compute the
  engine stages the batch's cache misses (``store.stage``), and hints the
  next queued batch's ids to the store's prefetch worker; a miss set too
  big for the staging area is served in chunks through the same plan;
* **online model updates** (``push_update``/``pull_updates``), each
  publish stamped with a monotonic ``emb_version``.

**Publishing.** The reference engine holds a parameter tree and swaps in
a fresh subtree on every stage, refresh or push. Here the stores publish
into their own buffers, and each engine keeps the runtime tensor dict of
its *own* last publish (``model.store_runtime_env()``, taken under the
engine's ``_drain_lock``); its plans read that dict on every step through
``compile_plan(runtime_provider=...)``. So an engine pins the tensors of
its last publish: two engines sharing one ``CachedStore`` each serve
their own version (the A/B scenario), because a store's refresh and
deltas build new tensors and leave the old ones as they were. Every step
and every replacement of the dict happen under ``_drain_lock``, so a dict
is dropped only after the last step that read it has returned. A store
shared by two engines holds one set of buffers: a refresh or push through
either builds on the other's pushes. The host tier's staging upload
writes the staging area in place, so it cannot pin — the reference's own
caveat (``HostBackedStore.apply_deltas``).

**Threads.** The worker, a scheduler's pool threads and a runtime's
refresh and delta threads all launch work. A new thread's current CUDA
stream is the default stream: the "dual" step forks its branch streams
from it and joins back onto it, and a store's publish synchronizes the
device from whichever thread publishes.

**Mesh.** ``mesh=`` (a ``repro_torch.distributed.Mesh``) serves every
plan over many devices from this one process. The model's tensors are
placed once, at construction (``place_params``: tables row-sharded over
``model``, dense layers and cache tiers replicated), every plan is
compiled with the mesh against that placement, and every publish (a
stage, a refresh, a push) is of tensors placed the way the plans record
(``store.place``; ``runtime_shardings``), so no step re-places anything.
A host store is bound to the mesh (``bind_mesh``): its staging uploads
land on every device of the mesh. ``donate=`` is not taken: buffer
donation has no PyTorch meaning (a step's inputs are ordinary tensors
the caller keeps).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.plan import (InferencePlan, PlanKey, compile_plan,
                                   place_params, plan_key_for)
from repro_torch.device import resolve_device
from repro_torch.embedding import StagingOverflowError

from .batching import BatchPolicy, BucketedBatch

__all__ = ["InferenceEngine", "EngineStats", "RequestFuture", "ReadyBatch",
           "QueueFullError", "AGGREGATED_COUNTERS"]

#: StoreStats attribute -> the EngineStats counter mirroring it. This table
#: *is* the wiring: ``_mirror_store_stats`` copies by name under the stats
#: lock, so surfacing a new store counter means one entry here (plus the
#: EngineStats field), not another hand-written copy block.
_STORE_MIRROR = {
    "hits": "emb_cache_hits",
    "misses": "emb_cache_misses",
    "refreshes": "emb_cache_refreshes",
    "staged_rows": "emb_staged_rows",
    "prefetched_rows": "emb_prefetched_rows",
    "h2d_bytes": "emb_h2d_bytes",
    "staging_overflows": "emb_staging_overflows",
    "gather_bytes": "emb_gather_bytes",
    "quant_rows": "emb_quant_rows",
    "quant_bytes_saved": "emb_quant_bytes_saved",
}
# NOTE: StoreStats.delta_rows is deliberately NOT mirrored: two engines may
# share one store (A/B over a common backing), and a mirror would credit
# every engine with every push. ``push_update`` counts its own
# ``emb_delta_rows``, so per-engine and runtime totals stay exact.

#: ExecutorStats attribute -> the EngineStats counter accumulating it once
#: per *plan compile* (weight bytes are a property of the compiled plan,
#: not of served traffic); applied on every plan-cache miss.
_PLAN_MIRROR = {
    "mlp_quant_weight_bytes": "mlp_quant_weight_bytes",
    "mlp_quant_weight_bytes_saved": "mlp_quant_weight_bytes_saved",
}

#: Every additive EngineStats counter ``ServingRuntime.stats()`` rolls up
#: across engines — the engine's own totals plus the mirrored store/plan
#: counters above, so a counter added to either mirror table aggregates
#: into RuntimeStats without touching runtime.py (it still needs the
#: matching RuntimeStats field, which the dataclass asserts at import).
AGGREGATED_COUNTERS = (
    "n_requests", "n_batches", "n_rejected", "queue_depth",
    "n_worker_errors",
    "cache_hits", "cache_misses",
    "emb_cache_refreshes", "emb_staged_rows", "emb_prefetched_rows",
    "emb_h2d_bytes", "emb_staging_overflows", "emb_gather_bytes",
    "emb_quant_rows", "emb_quant_bytes_saved",
    "emb_delta_pushes", "emb_delta_rows", "rows_behind",
    "mlp_quant_matmuls", "mlp_quant_weight_bytes",
    "mlp_quant_weight_bytes_saved",
    "sched_dispatches", "sched_preempted_slack_ms", "device_time_share",
)
# emb_version and seconds_behind are aggregated by MAX, not sum — the
# runtime handles them as customs (a sum of versions means nothing).


@dataclasses.dataclass(frozen=True)
class ReadyBatch:
    """One engine's dispatch candidate, as seen by a device scheduler.

    ``slack_ms <= 0`` means the batch is due *now* (a full bucket, or a
    partial batch whose hold deadline has passed — ``-slack_ms`` is then
    how far past it already is); ``slack_ms > 0`` means a partial batch
    that becomes due in ``slack_ms`` (the scheduler's wake-up hint).
    ``partial`` tells the dispatcher whether serving it needs
    ``allow_partial`` — at dispatch time the engine re-decides against
    the *current* queue, so requests that arrived meanwhile coalesce into
    (possibly a larger bucket of) the same dispatch.
    """
    take: int
    bucket: int
    slack_ms: float
    partial: bool


class QueueFullError(RuntimeError):
    """``submit`` rejected a request because the engine's queue is at
    ``max_queue_depth`` (backpressure: a stalled device must surface as
    fast failures at the intake, not as an unbounded queue)."""


class RequestFuture:
    """Resolution handle for one submitted request.

    Resolves to the request's sigmoid score; ``latency_ms`` (submit →
    resolution, the same sample fed to the engine's rolling window) is set
    at resolution time. Futures resolve in submit order — within a batch
    and across batches — because a single drain loop serves the queue
    FIFO. Done-callbacks run on the resolving thread (the worker, for an
    engine with ``start()`` called).
    """

    __slots__ = ("_event", "_lock", "_score", "_exc", "_callbacks",
                 "t_submit", "latency_ms")

    def __init__(self, t_submit: float):
        self._event = threading.Event()
        self._lock = threading.Lock()   # guards _callbacks vs resolution
        self._score: float | None = None
        self._exc: BaseException | None = None
        self._callbacks: list[Callable[[RequestFuture], None]] = []
        self.t_submit = t_submit        # the submitting call's arrival
        self.latency_ms: float | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> float:
        """Block until resolved; returns the score (or re-raises the
        serving error that failed this request's batch)."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._score

    def add_done_callback(self, fn: Callable[[RequestFuture], None]) -> None:
        """Run ``fn(self)`` on resolution (immediately if already done).
        Callback exceptions are swallowed (stdlib-Future semantics): one
        bad callback must never block other requests from resolving."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def _run_callback(self, fn) -> None:
        try:
            fn(self)
        except Exception:
            pass

    def _finish(self) -> None:
        with self._lock:
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            self._run_callback(fn)

    def _resolve(self, score: float, latency_ms: float) -> None:
        self._score = score
        self.latency_ms = latency_ms
        self._finish()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._finish()


@dataclasses.dataclass
class EngineStats:
    """Serving counters: request/batch totals, queue depth, latency split,
    plan-cache behaviour, padding waste per bucket, and embedding-store
    cache health — the reference's fields, with its meanings.

    **Thread safety**: every mutation (and every compound read) happens
    under ``lock`` — one re-entrant lock covering the counters *and* the
    rolling latency window. ``p50_ms``/``p99_ms`` snapshot the window
    under the lock.

    Latency is a **bounded rolling window**: ``latency_ms`` keeps the most
    recent ``latency_window`` per-request samples (submit → scores on the
    host, so queueing plus device time); lifetime totals stay exact in
    ``n_requests`` and ``compute_ms_total`` (the time inside
    ``plan.predict`` and staging, per batch).

    ``queue_depth`` is the number of submitted-but-unserved requests at
    the last queue transition; ``n_rejected`` counts submits refused by
    the ``max_queue_depth`` bound.

    The ``emb_*`` counters mirror the engine's embedding store
    (``_STORE_MIRROR``); ``emb_cached_traffic_fraction`` is refreshed at
    ``refresh_cache`` time. ``emb_version`` is the monotonic version of
    the engine's published store tensors (+1 per applied push), hard-
    asserted never to run backwards on any step; ``emb_delta_pushes`` /
    ``emb_delta_rows`` count this engine's own pushes;
    ``rows_behind``/``seconds_behind`` are staleness gauges of the
    attached delta source. The ``mlp_quant_*`` trio counts int8 matmul
    dispatches and (once per compiled plan) int8 weight bytes.
    ``n_worker_errors`` counts errors a background drain swallowed after
    failing that batch's futures. The ``sched_*`` trio and
    ``device_time_share`` are live only when a ``DeviceScheduler`` serves
    this engine.
    """
    n_requests: int = 0
    n_batches: int = 0
    n_rejected: int = 0
    queue_depth: int = 0
    n_worker_errors: int = 0
    sched_dispatches: int = 0
    sched_preempted_slack_ms: float = 0.0
    device_time_share: float = 0.0
    compute_ms_total: float = 0.0
    latency_window: int = 8192
    latency_ms: deque = None
    cache_hits: int = 0
    cache_misses: int = 0
    compile_ms_per_bucket: dict = dataclasses.field(default_factory=dict)
    batches_per_bucket: dict = dataclasses.field(default_factory=dict)
    padded_rows_total: int = 0
    emb_cache_hits: int = 0
    emb_cache_misses: int = 0
    emb_cache_refreshes: int = 0
    emb_cached_traffic_fraction: float = 0.0
    emb_staged_rows: int = 0
    emb_prefetched_rows: int = 0
    emb_h2d_bytes: int = 0
    emb_staging_overflows: int = 0
    emb_gather_bytes: int = 0
    emb_quant_rows: int = 0
    emb_quant_bytes_saved: int = 0
    emb_version: int = 0
    emb_delta_pushes: int = 0
    emb_delta_rows: int = 0
    rows_behind: int = 0
    seconds_behind: float = 0.0
    mlp_quant_matmuls: int = 0
    mlp_quant_weight_bytes: int = 0
    mlp_quant_weight_bytes_saved: int = 0

    def __post_init__(self):
        self.latency_ms = deque(self.latency_ms or (),
                                maxlen=self.latency_window)
        self.lock = threading.RLock()

    def snapshot(self) -> "EngineStats":
        """Consistent point-in-time copy, taken under the lock: containers
        are copied, the new object has its own lock, and later engine
        activity never mutates it."""
        with self.lock:
            kw = {}
            for f in dataclasses.fields(self):
                v = getattr(self, f.name)
                if isinstance(v, deque):
                    v = tuple(v)
                elif isinstance(v, dict):
                    v = dict(v)
                kw[f.name] = v
        return EngineStats(**kw)

    @property
    def p50_ms(self) -> float:
        with self.lock:
            samples = list(self.latency_ms)
        return float(np.percentile(samples, 50)) if samples else 0.0

    @property
    def p99_ms(self) -> float:
        with self.lock:
            samples = list(self.latency_ms)
        return float(np.percentile(samples, 99)) if samples else 0.0

    @property
    def padding_waste(self) -> float:
        """Fraction of served device rows that were padding."""
        with self.lock:
            rows = self.n_requests + self.padded_rows_total
            return self.padded_rows_total / rows if rows else 0.0

    @property
    def emb_cache_hit_rate(self) -> float:
        """Row-lookup hit rate of the embedding store's hot cache."""
        with self.lock:
            n = self.emb_cache_hits + self.emb_cache_misses
            return self.emb_cache_hits / n if n else 0.0

    @property
    def emb_prefetch_hit_rate(self) -> float:
        """Fraction of staged miss rows the async prefetch worker resolved
        before the batch reached the serve path."""
        with self.lock:
            n = self.emb_staged_rows + self.emb_prefetched_rows
            return self.emb_prefetched_rows / n if n else 0.0


class InferenceEngine:
    """Batched CTR inference over a cache of compiled ``InferencePlan``s.

    Args:
        model: a ``CTRModel`` whose tensors live on ``device``.
        level: Fig.-8 executor level for every plan this engine compiles.
        policy: batching policy; default ``BucketedBatch()``.
        branch_order: breadth-first head-branch choice (§V-H).
        compute_dtype: ``"fp32"`` or ``"int8"`` (int8 MLP matmuls, see
            ``compile_plan``); part of the plan cache key.
        store: optional embedding store (``CachedStore``,
            ``HostBackedStore``) the model's main table moves into,
            bit for bit (``model.use_store(store)``).
        refresh_every: rebuild the store's hot cache every N served
            batches; ``None`` = manual ``refresh_cache()`` only.
        max_queue_depth: backpressure bound — ``submit`` beyond this many
            queued requests returns a future failed with
            :class:`QueueFullError`. ``None`` never rejects.
        latency_window: size of the rolling latency window.
        worker_tick_ms: how long the background worker waits between
            drain attempts while the policy holds requests back.
        device: where the plans run; CUDA unless the caller says "cpu"
            (raises without a card). With a ``mesh``, its first device.
        mesh: serve over this device mesh (see the module docstring).

    The reference's ``donate=`` is not taken: donation has no PyTorch
    meaning.
    """

    def __init__(self, model, *, level: str = "dual",
                 policy: BatchPolicy | None = None,
                 branch_order: str = "longer_first",
                 compute_dtype: str = "fp32",
                 store=None,
                 refresh_every: int | None = None,
                 max_queue_depth: int | None = None,
                 latency_window: int = 8192,
                 worker_tick_ms: float = 0.5,
                 device: torch.device | str | None = None,
                 mesh=None):
        if mesh is not None:
            if device is not None and resolve_device(device).type \
                    != mesh.first_device.type:
                raise ValueError(f"device {device} is not where the mesh "
                                 f"{mesh} lives")
            device = mesh.first_device
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}; the engine "
                             f"was asked for {self.device}")
        self.model = model
        if store is not None:
            model.use_store(store)
        self.mesh = mesh
        # placed once: every plan compiles against it, and every publish
        # places the store tensors the same way
        self._placed = (place_params(model, mesh) if mesh is not None
                        else None)
        staging = self._staging_store
        if staging is not None and mesh is not None:
            staging.bind_mesh(mesh)
        self.max_queue_depth = max_queue_depth
        self.level = level
        self.policy = policy if policy is not None else BucketedBatch()
        self.branch_order = branch_order
        self.compute_dtype = compute_dtype
        self.refresh_every = refresh_every
        self.worker_tick_ms = worker_tick_ms
        self._plans: dict[PlanKey, InferencePlan] = {}
        self._queue: deque = deque()
        # lock order (never reversed): _drain_lock -> _cv -> stats.lock.
        # _drain_lock serializes everything that touches host-side store
        # state or runs a step (drains, one-shot predicts, observe,
        # staging, refresh, pushes) and is re-entrant so an auto-refresh
        # inside a drain doesn't self-deadlock.
        self._cv = threading.Condition(threading.Lock())
        self._drain_lock = threading.RLock()
        self._compile_lock = threading.Lock()
        self._worker: threading.Thread | None = None
        self._running = False
        self._scheduler = None        # set by DeviceScheduler.attach
        self._delta_source = None     # set by attach_delta_source
        # highest emb_version any compiled step has observed — the floor
        # the _runtime_env monotonicity hard-assert enforces
        self._version_floor = 0
        self.worker_error: BaseException | None = None
        self.stats = EngineStats(latency_window=latency_window)
        self._env: dict[str, torch.Tensor] = {}
        self._publish_env()

    # -- embedding store -----------------------------------------------------
    @property
    def store(self):
        """The model's main embedding store (DenseStore unless swapped)."""
        coll = getattr(self.model, "embedding", None)
        return getattr(coll, "store", None)

    def _publish_env(self) -> None:
        """Take the store's current runtime tensors as this engine's
        published set. Caller holds ``_drain_lock`` (or is the
        constructor); the old dict is dropped here, after every step that
        read it has returned."""
        env = self.model.store_runtime_env(self.mesh)
        with self.stats.lock:
            self._env = env

    @property
    def published(self) -> dict:
        """The store tensors of this engine's last publish, by graph edge
        (placed over the mesh when there is one): what every step reads."""
        with self.stats.lock:
            return dict(self._env)

    def _runtime_env(self) -> dict:
        """This engine's published runtime store tensors, read by every
        compiled step. The dict read and the version read happen under
        the stats lock — the lock ``push_update`` publishes under — and
        the **version-monotonicity hard-assert** holds: the set a step
        binds always belongs to a version >= every version previously
        observed."""
        with self.stats.lock:
            v = self.stats.emb_version
            if v < self._version_floor:
                raise AssertionError(
                    f"embedding version ran backwards: step observed "
                    f"v{v} after v{self._version_floor} was already "
                    "served — torn/reordered publish")
            self._version_floor = v
            return self._env

    def _observe_traffic(self, rows: np.ndarray) -> None:
        """Feed served ids to the store's admission counters and mirror
        the store's health into ``stats``. Only refreshable stores pay
        this; the O(rows) cached-traffic scan waits for refresh time."""
        coll = getattr(self.model, "embedding", None)
        if coll is None or not coll.store.refreshable:
            return
        coll.observe(rows)
        self._mirror_store_stats()

    def _mirror_store_stats(self) -> None:
        ss = self.store.stats
        st = self.stats
        with st.lock:
            for src, dst in _STORE_MIRROR.items():
                setattr(st, dst, getattr(ss, src))

    # -- staging (out-of-device-memory stores) --------------------------------
    @property
    def _staging_store(self):
        """The embedding store when it needs per-batch staging, else None."""
        store = self.store
        if store is not None and getattr(store, "needs_staging", False):
            return store
        return None

    def _predict_staged(self, plan: InferencePlan, rows: np.ndarray
                        ) -> np.ndarray:
        """Run ``plan.predict`` with every embedding miss of ``rows``
        resolved first. Caller holds ``_drain_lock``.

        Fast path: one ``store.stage`` (mostly prefetch hits) + one
        predict. A :class:`StagingOverflowError` — the batch's distinct
        miss set exceeds the staging area — falls back to chunks from
        ``split_for_staging``, each staged and served through the *same*
        plan (which pads each chunk to the bucket shape). Slower, never
        wrong.
        """
        store = self._staging_store
        if store is None:
            self._bump_mlp_quant(plan)
            return plan.predict(rows)
        try:
            store.stage(rows)
        except StagingOverflowError:
            self._mirror_store_stats()
            outs = []
            for chunk in store.split_for_staging(rows):
                store.stage(chunk)
                self._publish_env()
                self._bump_mlp_quant(plan)
                outs.append(plan.predict(chunk))
            self._mirror_store_stats()
            return np.concatenate(outs)
        self._publish_env()
        self._mirror_store_stats()
        self._bump_mlp_quant(plan)
        return plan.predict(rows)

    def _bump_mlp_quant(self, plan: InferencePlan) -> None:
        """Count one execution of a quantized-compute plan: every int8
        matmul in its graph dispatches once per plan call."""
        n = getattr(plan.stats, "mlp_quant_matmuls", 0)
        if n:
            with self.stats.lock:
                self.stats.mlp_quant_matmuls += n

    def _hint_upcoming(self, limit: int = 4096) -> None:
        """Hand the still-queued requests' ids (batch t+1 while batch t is
        about to compute) to the store's async prefetch worker."""
        store = self._staging_store
        if store is None:
            return
        with self._cv:
            upcoming = [row for _, row, _ in
                        itertools.islice(self._queue, limit)]
        if upcoming:
            store.prefetch_hint(np.stack(upcoming))

    def refresh_cache(self) -> None:
        """Re-admit hot rows from observed traffic into the store's cache.

        The store builds the new cache tensors on the side and swaps them
        in after a device sync; the engine then publishes them as its own
        set. Every compiled plan reads the store tensors as runtime
        inputs, so the **plan cache survives intact — a refresh never
        recompiles**. No-op for cacheless stores.
        """
        store = self.store
        if store is None or not store.refreshable:
            return
        # _drain_lock keeps the store's host-side admission state from
        # being rebuilt mid-observe when a refresh comes from outside the
        # drain loop (the runtime's shared admission, a manual call)
        with self._drain_lock:
            store.refresh()
            self._publish_env()
            with self.stats.lock:
                self.stats.emb_cache_refreshes = store.stats.refreshes
                self.stats.emb_cached_traffic_fraction = \
                    store.cached_traffic_fraction

    def _maybe_auto_refresh(self) -> None:
        if (self.refresh_every
                and self.stats.n_batches % self.refresh_every == 0):
            self.refresh_cache()

    # -- online deltas (live-trainer pushes) ----------------------------------
    def push_update(self, row_ids, new_rows) -> int:
        """Apply one batch of online ``(row_id, new_row)`` parameter
        deltas; returns how many (deduped) rows were applied.

        The store writes the deltas into fresh tensors on the side
        (``apply_deltas``: backing, cache and staging tiers, fp32 rows
        re-quantized for int8 stores) and swaps them in; the engine
        publishes them as its own set **stamped with the next
        ``emb_version``** — dict and version under one lock, so the
        version a step observes is monotonic (hard-asserted in
        ``_runtime_env``) and a step binds either the whole pre-push set
        or the whole post-push set. Zero recompiles.

        Requires a refreshable store (``CachedStore``/``HostBackedStore``)
        and raises ``ValueError`` otherwise, before touching the store:
        ``DenseStore`` tensors are not runtime inputs of the plans. An
        engine sharing its store with another engine keeps serving its
        own last publish after the *other* engine's pushes (see the
        module docstring for the host tier's caveat).
        """
        store = self.store
        if store is None or not store.refreshable:
            raise ValueError(
                "push_update needs a refreshable embedding store "
                "(CachedStore / HostBackedStore); this engine serves "
                f"{store.describe() if store is not None else 'no store'}, "
                "whose tensors are compiled into plans as constants — "
                "rebuild the model and re-compile to change them")
        with self._drain_lock:
            n = store.apply_deltas(row_ids, new_rows)
            if n == 0:
                return 0
            env = self.model.store_runtime_env(self.mesh)
            with self.stats.lock:
                self._env = env                       # publish
                self.stats.emb_version += 1
                self.stats.emb_delta_pushes += 1
                self.stats.emb_delta_rows += n
            return n

    def attach_delta_source(self, source) -> None:
        """Bind a :class:`~repro_torch.serving.updates.DeltaSource` this
        engine pulls from (``pull_updates``, or the runtime's
        ``delta_every`` cadence); its queue depth feeds the
        ``rows_behind`` / ``seconds_behind`` staleness gauges."""
        self._delta_source = source
        self.poll_staleness()

    def pull_updates(self, max_batches: int | None = None) -> int:
        """Drain the attached delta source (up to ``max_batches``)
        through :meth:`push_update`; returns total rows applied and
        refreshes the staleness gauges. 0 when no source is attached."""
        src = self._delta_source
        if src is None:
            return 0
        applied = 0
        pulled = 0
        while max_batches is None or pulled < max_batches:
            batch = src.next_batch()
            if batch is None:
                break
            pulled += 1
            applied += self.push_update(*batch)
        self.poll_staleness()
        return applied

    def poll_staleness(self) -> None:
        """Re-read the attached delta source's backlog into the
        ``rows_behind``/``seconds_behind`` gauges (no-op without a
        source)."""
        src = self._delta_source
        rows = src.pending_rows() if src is not None else 0
        age = src.oldest_pending_s() if src is not None else 0.0
        with self.stats.lock:
            self.stats.rows_behind = int(rows)
            self.stats.seconds_behind = float(age)

    # -- plan cache ----------------------------------------------------------
    def _plan_key(self, bucket: int) -> PlanKey:
        return plan_key_for(self.model, self.level, bucket,
                            self.branch_order, sharded=self.mesh is not None,
                            compute_dtype=self.compute_dtype)

    def plan_for(self, bucket: int) -> InferencePlan:
        """Fetch (or compile-and-cache) the plan for one batch bucket."""
        key = self._plan_key(bucket)
        with self._compile_lock:
            plan = self._plans.get(key)
            if plan is not None:
                with self.stats.lock:
                    self.stats.cache_hits += 1
                return plan
            plan = compile_plan(self.model, self.level, bucket,
                                device=self.device, mesh=self.mesh,
                                placed=self._placed,
                                branch_order=self.branch_order,
                                runtime_provider=self._runtime_env,
                                compute_dtype=self.compute_dtype)
            self._plans[key] = plan
            with self.stats.lock:
                self.stats.cache_misses += 1
                self.stats.compile_ms_per_bucket[int(bucket)] = \
                    plan.compile_ms
                for src, dst in _PLAN_MIRROR.items():
                    setattr(self.stats, dst,
                            getattr(self.stats, dst)
                            + getattr(plan.stats, src, 0))
        return plan

    @property
    def cached_plans(self) -> tuple[PlanKey, ...]:
        return tuple(self._plans)

    def warmup(self, buckets: Sequence[int] | None = None) -> None:
        """Compile every bucket the policy can emit (or an explicit list)."""
        with self._drain_lock:
            for b in (buckets if buckets is not None
                      else self.policy.buckets):
                self.plan_for(b)

    # -- request queue -------------------------------------------------------
    def submit(self, ids_row: np.ndarray) -> RequestFuture:
        """Queue one request (a per-field id vector of shape (k,));
        returns a future resolving to its score when its batch serves —
        or an already-failed future (:class:`QueueFullError`) when the
        queue is at ``max_queue_depth`` (backpressure)."""
        return self.submit_many([ids_row])[0]

    def submit_many(self, rows: Sequence[np.ndarray]) -> list[RequestFuture]:
        """Queue ``rows`` as one arrival: one ``t_submit`` for all of them,
        enqueued under one hold of the queue lock with one wake-up, so
        the worker never sees (or times) part of the call. Each row is
        still refused on its own at ``max_queue_depth``."""
        rows = [np.asarray(r, dtype=np.int32) for r in rows]
        t_submit = time.perf_counter()
        futs = [RequestFuture(t_submit) for _ in rows]
        with self._cv:
            for row, fut in zip(rows, futs):
                if (self.max_queue_depth is not None
                        and len(self._queue) >= self.max_queue_depth):
                    with self.stats.lock:
                        self.stats.n_rejected += 1
                    fut._fail(QueueFullError(
                        f"queue at max_queue_depth={self.max_queue_depth} "
                        f"({self.stats.n_rejected} rejected so far); the "
                        "device is not keeping up — shed load or raise "
                        "the bound"))
                    continue
                self._queue.append((t_submit, row, fut))
                with self.stats.lock:
                    self.stats.queue_depth = len(self._queue)
            self._cv.notify()
        # outside _cv: the scheduler's pick loop holds its own lock while
        # polling next_ready (which takes _cv) — notifying it from inside
        # _cv would invert that order and deadlock
        sched = self._scheduler
        if sched is not None:
            sched.notify()
        return futs

    def pending(self) -> int:
        with self._cv:
            return len(self._queue)

    # -- scheduler readiness view ---------------------------------------------
    def next_ready(self, now: float | None = None) -> ReadyBatch | None:
        """What this engine would dispatch next, and how urgent it is —
        the readiness view a :class:`~repro_torch.serving.DeviceScheduler`
        polls. Nothing is dequeued. A full bucket is due immediately
        (``slack_ms == 0``); a partial batch carries the slack left before
        its hold deadline — ``policy.partial_hold_ms``, or for policies
        without one the worker loop's grace (``8·worker_tick_ms``).
        Returns None when the queue is empty or the policy would decline
        even a forced partial.
        """
        now = time.perf_counter() if now is None else now
        with self._cv:
            pending = len(self._queue)
            if not pending:
                return None
            oldest_wait_ms = (now - self._queue[0][0]) * 1e3
        d = self.policy.decide(pending, oldest_wait_ms, allow_partial=False)
        if d is not None:
            return ReadyBatch(d.take, d.bucket, 0.0, False)
        hold = self.policy.partial_hold_ms
        if hold is None:
            hold = 8 * self.worker_tick_ms
        # would the policy emit this partial if its deadline had passed?
        d = self.policy.decide(pending, math.inf, allow_partial=True)
        if d is None:
            return None
        return ReadyBatch(d.take, d.bucket, hold - oldest_wait_ms, True)

    def _note_worker_error(self, exc: BaseException) -> None:
        """Record a drain error swallowed off the caller's thread (the
        batch's futures already failed): counted in ``n_worker_errors``,
        last one kept for ``stop()`` to re-raise."""
        self.worker_error = exc
        with self.stats.lock:
            self.stats.n_worker_errors += 1

    # -- background worker ----------------------------------------------------
    def start(self) -> "InferenceEngine":
        """Spawn the background worker: drains the queue through the
        batching policy without caller polling, resolving futures as
        batches complete. Idempotent; returns self for chaining."""
        with self._cv:
            if self._worker is not None:
                return self
            self._running = True
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True,
                name=f"engine-worker-{getattr(self.model.spec, 'name', '?')}")
            self._worker.start()
        return self

    def stop(self, flush: bool = True) -> None:
        """Stop the worker (joins the thread). With ``flush`` (default),
        force-drain whatever is still queued so no future is left
        unresolved. Re-raises the last error a background drain swallowed
        — cleared on raise, so the call stays idempotent."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        worker, self._worker = self._worker, None
        if worker is not None:
            worker.join()
        if flush:
            self.flush()
        err, self.worker_error = self.worker_error, None
        if err is not None:
            raise err

    @property
    def running(self) -> bool:
        return self._worker is not None

    def _worker_loop(self) -> None:
        """Drain full buckets the moment they form; give partial batches a
        grace window of one ``worker_tick_ms`` for more arrivals before
        offering them to the policy as partials, with an age backstop (8
        ticks) so arrivals delay a partial batch but cannot starve it;
        ``TimeoutBatch`` keeps gating partials on its own SLO."""
        tick = self.worker_tick_ms / 1e3
        while True:
            with self._cv:
                while self._running and not self._queue:
                    self._cv.wait()
                if not self._running:
                    return
            try:
                if self._serve(allow_partial=False, force=False).size:
                    continue                         # full buckets drained
                # nothing full: grace tick — drain partials once arrivals
                # pause (or the oldest request has waited long enough)
                with self._cv:
                    depth0 = len(self._queue)
                    if self._running and self._queue:
                        self._cv.wait(tick)
                    if not self._running:
                        return
                    grown = len(self._queue) > depth0
                    aged = bool(self._queue) and (
                        (time.perf_counter() - self._queue[0][0])
                        >= 8 * tick)
                if not grown or aged:
                    self._serve(allow_partial=True, force=False)
            except Exception as exc:                 # keep the loop alive;
                self._note_worker_error(exc)         # futures already failed

    # -- serving ---------------------------------------------------------------
    def serve_pending(self, allow_partial: bool = True) -> np.ndarray:
        """Drain the queue per the batching policy; scores in submit order.

        Requests the policy declines to batch stay queued untouched. With
        the background worker running this may return empty (the worker
        got there first); the futures from ``submit`` are the async
        surface.
        """
        return self._serve(allow_partial=allow_partial, force=False)

    def flush(self) -> np.ndarray:
        """Drain everything now, overriding any timeout hold-back."""
        return self._serve(allow_partial=True, force=True)

    def _serve(self, *, allow_partial: bool, force: bool) -> np.ndarray:
        out: list[np.ndarray] = []
        with self._drain_lock:
            while True:
                scores = self._serve_step(allow_partial=allow_partial,
                                          force=force)
                if scores is None:
                    break
                out.append(scores)
        return np.concatenate(out) if out else np.empty((0,))

    def _serve_step(self, *, allow_partial: bool, force: bool
                    ) -> np.ndarray | None:
        """Serve at most *one* policy decision (one device batch); None
        when the policy declines. The unit a shared-pool scheduler
        dispatches, and the loop body of ``_serve``. The decision runs
        against the queue as it is *now*, so requests that arrived since
        a scheduler's readiness poll coalesce in."""
        with self._drain_lock:
            with self._cv:
                if not self._queue:
                    return None
                oldest_wait_ms = (
                    math.inf if force else
                    (time.perf_counter() - self._queue[0][0]) * 1e3)
                decision = self.policy.decide(
                    len(self._queue), oldest_wait_ms,
                    allow_partial=allow_partial)
                if decision is None:
                    return None
                items = [self._queue.popleft()
                         for _ in range(decision.take)]
                with self.stats.lock:
                    self.stats.queue_depth = len(self._queue)
            t_submit = [it[0] for it in items]
            try:
                # inside the try: a malformed row (ragged shape) must
                # fail its batch's futures, not strand them unresolved
                rows = np.stack([it[1] for it in items])
                self._observe_traffic(rows)
                plan = self.plan_for(decision.bucket)
                # batch t+1's ids go to the async prefetch worker now, so
                # its host-side miss gather overlaps batch t's stage and
                # compute below (no-op for non-staging stores)
                self._hint_upcoming()
                t0 = time.perf_counter()
                # plan.predict pads to the bucket, slices the padding off
                # and copies the scores to the host: device time included
                scores = self._predict_staged(plan, rows)
                t1 = time.perf_counter()
            except Exception as exc:
                for _, _, fut in items:
                    fut._fail(exc)
                raise
            lat = [(t1 - ts) * 1e3 for ts in t_submit]
            st = self.stats
            with st.lock:
                st.n_requests += decision.take
                st.n_batches += 1
                st.batches_per_bucket[decision.bucket] = (
                    st.batches_per_bucket.get(decision.bucket, 0) + 1)
                st.padded_rows_total += decision.bucket - decision.take
                st.compute_ms_total += (t1 - t0) * 1e3
                st.latency_ms.extend(lat)
            # futures resolve in submit order (items popped FIFO)
            for (_, _, fut), score, l in zip(items, scores, lat):
                fut._resolve(float(score), l)
            self._maybe_auto_refresh()
            return scores

    # -- one-shot --------------------------------------------------------------
    def predict(self, ids) -> np.ndarray:
        """One-shot scores for ``ids`` ((k,) or (b, k)), bypassing the
        queue. Reuses the plan cache: the smallest covering bucket, with
        batches beyond the largest bucket chunked through it. Runs under
        ``_drain_lock`` (observe, staging and the step), so no refresh or
        push drops the tensors it reads."""
        ids = np.asarray(ids, dtype=np.int32)
        if ids.ndim == 1:
            ids = ids[None, :]
        b = ids.shape[0]
        largest = max(self.policy.buckets)
        if b > largest:
            return np.concatenate([self.predict(ids[i:i + largest])
                                   for i in range(0, b, largest)])
        bucket = min(bk for bk in self.policy.buckets if bk >= b)
        with self._drain_lock:
            self._observe_traffic(ids)
            return self._predict_staged(self.plan_for(bucket), ids)

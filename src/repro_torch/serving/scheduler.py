"""DeviceScheduler — cross-engine continuous batching on one device.

Counterpart of ``repro.serving.scheduler``, with the reference's pick,
claims and accounting.

The per-engine worker model (one drain thread per hosted
``InferenceEngine``) is fine for a handful of models, but the PCDF
sponsored-search setting hosts *hundreds* of scenario/market variants
behind one router: N worker threads then contend blindly for one device
with no global view of whose latency SLO is about to blow. This module
replaces them with the continuous-batching shape HugeCTR-style inference
servers use:

* **one shared worker pool** (``pool_size`` threads, typically 2) owns
  the device for every attached engine — hosting N models costs
  ``pool_size`` threads, not N;
* each engine exposes a **readiness view** instead of draining itself:
  :meth:`InferenceEngine.next_ready` returns its candidate batch plus
  the SLO slack derived from its ``BatchPolicy`` (full buckets are due
  now; ``TimeoutBatch`` partials carry ``max_wait_ms − oldest_wait``;
  ``FixedBatch``/``BucketedBatch`` partials get the same few-tick grace
  the per-engine worker loop applied);
* the pool picks the due candidate with the **least slack** — the most
  overdue deadline serves first, so a starved low-traffic model's SLO
  beats a high-traffic model's endless full buckets the moment it comes
  due;
* dispatch **coalesces** same-model requests across intake streams: the
  engine re-decides against its *current* queue at dispatch time, so
  everything submitted between the readiness poll and the pick — from
  any number of submitter threads — rides the same device batch
  (possibly upgrading it to a larger bucket);
* per-model **device-time accounting**: every dispatch's wall time is
  charged to its engine, published as ``stats.device_time_share``
  (shares over one scheduler's engines sum to 1), alongside
  ``sched_dispatches`` and ``sched_preempted_slack_ms`` (milliseconds a
  due batch sat past its deadline while other models held the device).

Each engine is claimed by at most one pool thread at a time, so its
queue still drains FIFO through the same ``_serve_step`` path, and each
request's score depends only on its own row (padding rows are zeros).
On the CPU that makes scores bit-exact with per-engine-worker mode. On a
card a score is bitwise only against a plan of the same bucket: cuBLAS
may pick another GEMM kernel (and split-K) for another batch size, and
which bucket serves a row depends on timing here — compare across modes
within ``rtol=1e-5, atol=1e-6``.

``device_ms`` is each dispatch's wall time, which includes its device
time: a step ends with its scores copied to the host.

Standalone::

    sched = DeviceScheduler(pool_size=2)
    sched.attach("deepfm", eng_a)
    sched.attach("dcnv2", eng_b)
    sched.start()
    ... eng_a.submit(row).result() ...
    sched.stop()

or, the usual way, behind the router: ``ServingRuntime`` attaches every
hosted engine and starts the pool on ``rt.start()`` (its default
``scheduler="shared"`` mode; ``scheduler="per-engine"`` keeps the old
one-thread-per-engine behaviour).
"""

from __future__ import annotations

import threading
import time

from .engine import InferenceEngine, ReadyBatch

__all__ = ["DeviceScheduler"]

#: Cap on how long a pool thread sleeps waiting for a deadline: submits
#: and busy-releases notify the pool anyway, this just bounds the damage
#: if a notification is ever lost.
_MAX_WAIT_S = 0.25


class DeviceScheduler:
    """Shared worker pool + SLO-slack device-time scheduler.

    Args:
        pool_size: worker threads sharing the device across every
            attached engine. 2 is usually right on one device: one
            thread blocks in device compute while the other forms and
            stages the next batch. Thread count is ``pool_size``
            regardless of how many engines attach.

    Attributes:
        n_dispatches: total batches dispatched across all engines.
        device_ms: per-engine accumulated dispatch wall time (a copy).
        shares: per-engine fraction of total dispatched device time
            (sums to 1 once anything has dispatched).
    """

    def __init__(self, *, pool_size: int = 2):
        if pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
        self.pool_size = pool_size
        self._engines: dict[str, InferenceEngine] = {}
        # guards _engines/_busy/_device_ms/n_dispatches and is the pool's
        # wait target; never held across a dispatch (device compute)
        self._cv = threading.Condition(threading.Lock())
        self._busy: set[str] = set()
        self._device_ms: dict[str, float] = {}
        self._workers: list[threading.Thread] = []
        self._running = False
        self.n_dispatches = 0

    # -- registry -------------------------------------------------------------
    def attach(self, name: str, engine: InferenceEngine) -> InferenceEngine:
        """Host ``engine`` under ``name``. Idempotent for the same
        (name, engine) pair; an attached engine's ``submit`` wakes the
        pool instead of relying on a per-engine worker."""
        with self._cv:
            have = self._engines.get(name)
            if have is engine:
                return engine
            if have is not None:
                raise ValueError(f"name {name!r} already attached to a "
                                 "different engine")
            if engine._scheduler is not None and engine._scheduler is not self:
                raise ValueError(f"engine {name!r} already attached to "
                                 "another scheduler")
            self._engines[name] = engine
            self._device_ms.setdefault(name, 0.0)
            engine._scheduler = self
            self._cv.notify_all()
        return engine

    @property
    def engines(self) -> tuple[str, ...]:
        with self._cv:
            return tuple(self._engines)

    @property
    def device_ms(self) -> dict[str, float]:
        with self._cv:
            return dict(self._device_ms)

    @property
    def shares(self) -> dict[str, float]:
        with self._cv:
            total = sum(self._device_ms.values())
            return {n: (ms / total if total else 0.0)
                    for n, ms in self._device_ms.items()}

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "DeviceScheduler":
        """Spawn the pool (idempotent). ``pool_size`` threads total — the
        whole point: thread count no longer scales with model count."""
        with self._cv:
            if self._running:
                return self
            self._running = True
            self._workers = [
                threading.Thread(target=self._pool_loop, daemon=True,
                                 name=f"device-sched-{i}")
                for i in range(self.pool_size)]
        for t in self._workers:
            t.start()
        return self

    def stop(self) -> None:
        """Stop and join the pool. In-flight dispatches finish; queued
        requests stay queued (drain them via the engines' ``flush``/
        ``stop`` — ``ServingRuntime.stop`` does). Idempotent."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        workers, self._workers = self._workers, []
        for t in workers:
            t.join()

    @property
    def running(self) -> bool:
        return bool(self._workers)

    def notify(self) -> None:
        """Wake the pool (an attached engine got a submit)."""
        with self._cv:
            self._cv.notify_all()

    # -- the drain loop -------------------------------------------------------
    def _pick(self, now: float):
        """Least-slack-first over every idle engine's readiness view.

        Returns ``(name, candidate, wait_ms)``: the due candidate with
        the least slack (most overdue first — TimeoutBatch deadlines are
        global priorities), or ``name=None`` with ``wait_ms`` = time
        until the soonest pending deadline (None = nothing queued
        anywhere, sleep until notified). Caller holds ``_cv``.
        """
        best_name, best = None, None
        wait_ms = None
        for name, eng in self._engines.items():
            if name in self._busy:
                continue
            c = eng.next_ready(now)
            if c is None:
                continue
            if c.slack_ms <= 0.0:
                if best is None or c.slack_ms < best.slack_ms:
                    best_name, best = name, c
            else:
                wait_ms = (c.slack_ms if wait_ms is None
                           else min(wait_ms, c.slack_ms))
        return best_name, best, wait_ms

    def _pool_loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if not self._running:
                        return
                    name, cand, wait_ms = self._pick(time.perf_counter())
                    if name is not None:
                        # claim: one pool thread per engine at a time, so
                        # the queue drains FIFO exactly as a dedicated
                        # worker would (same drain path, ordered futures)
                        self._busy.add(name)
                        break
                    timeout = (_MAX_WAIT_S if wait_ms is None
                               else min(max(wait_ms / 1e3, 1e-4),
                                        _MAX_WAIT_S))
                    self._cv.wait(timeout)
            eng = self._engines[name]
            served = False
            t0 = time.perf_counter()
            try:
                scores = eng._serve_step(allow_partial=cand.partial,
                                         force=False)
                served = scores is not None
            except Exception as exc:
                # same contract as the per-engine worker loop: the batch's
                # futures already failed; count it, keep the pool alive
                eng._note_worker_error(exc)
            dt_ms = (time.perf_counter() - t0) * 1e3
            with self._cv:
                self._busy.discard(name)
                if served:
                    self.n_dispatches += 1
                    self._device_ms[name] += dt_ms
                    self._publish_shares(name, cand)
                # a freed engine may already have the next due batch —
                # and other threads may be sleeping on a stale deadline
                self._cv.notify_all()

    def _publish_shares(self, served_name: str, cand: ReadyBatch) -> None:
        """Mirror device-time accounting into engine stats (holds _cv;
        engine stats locks nest strictly inside it)."""
        total = sum(self._device_ms.values())
        for name, eng in self._engines.items():
            with eng.stats.lock:
                eng.stats.device_time_share = (
                    self._device_ms[name] / total if total else 0.0)
        eng = self._engines[served_name]
        overdue = max(0.0, -cand.slack_ms) if cand.partial else 0.0
        with eng.stats.lock:
            eng.stats.sched_dispatches += 1
            eng.stats.sched_preempted_slack_ms += overdue

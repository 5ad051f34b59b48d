"""Pluggable batching policies for the InferenceEngine.

Counterpart of ``repro.serving.batching``, copied so that both packages'
engines take the same decisions on the same queue. A policy decides,
given the queue depth and the age of the oldest waiting request, *how
many* requests to dequeue and *which padded batch shape* ("bucket") to
run them through — one compiled
:class:`~repro_torch.core.plan.InferencePlan` exists per bucket, so the
set of buckets a policy can emit is exactly the engine's plan-cache
working set.

  FixedBatch     the classic pad-to-N loop (the old engine's behaviour).
  BucketedBatch  a ladder of padded shapes: full buckets drain largest-
                 first, the remainder pads into the smallest bucket that
                 covers it — bounding padding waste to < smallest bucket
                 per drain instead of < N.
  TimeoutBatch   latency-SLO wrapper: full buckets go immediately, partial
                 batches only once the oldest request has waited past the
                 deadline (or on an explicit ``flush``).
"""

from __future__ import annotations

import dataclasses

__all__ = ["BatchDecision", "BatchPolicy", "FixedBatch", "BucketedBatch",
           "TimeoutBatch"]


@dataclasses.dataclass(frozen=True)
class BatchDecision:
    """Dequeue ``take`` requests and run them padded to ``bucket`` rows."""
    take: int
    bucket: int

    def __post_init__(self):
        if not 0 < self.take <= self.bucket:
            raise ValueError(f"need 0 < take <= bucket, got {self}")


class BatchPolicy:
    """Interface: ``decide`` may be called repeatedly per drain — return
    None to stop draining (requests stay queued)."""

    @property
    def buckets(self) -> tuple[int, ...]:
        """Every batch shape this policy can emit (the plan-cache working
        set; engines warm these)."""
        raise NotImplementedError

    @property
    def partial_hold_ms(self) -> float | None:
        """How long a partial batch may wait for more arrivals before it
        becomes *due* — the deadline behind the engine's ``next_ready``
        readiness view (SLO slack = hold − oldest wait). ``None`` means
        the policy has no deadline of its own and the engine's default
        grace (a few worker ticks) applies; ``TimeoutBatch`` overrides
        this with its explicit ``max_wait_ms`` SLO."""
        return None

    def decide(self, pending: int, oldest_wait_ms: float, *,
               allow_partial: bool) -> BatchDecision | None:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedBatch(BatchPolicy):
    """Always pad to one fixed shape (the legacy pad-to-256 loop)."""
    size: int = 256

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"size must be >= 1, got {self.size}")

    @property
    def buckets(self) -> tuple[int, ...]:
        return (self.size,)

    def decide(self, pending: int, oldest_wait_ms: float, *,
               allow_partial: bool) -> BatchDecision | None:
        if pending >= self.size:
            return BatchDecision(self.size, self.size)
        if pending > 0 and allow_partial:
            return BatchDecision(pending, self.size)
        return None


@dataclasses.dataclass(frozen=True)
class BucketedBatch(BatchPolicy):
    """A ladder of padded batch shapes with one cached plan per bucket.

    Full buckets drain largest-first; a remainder smaller than the smallest
    bucket pads into it only when partial batches are allowed.
    """
    ladder: tuple[int, ...] = (32, 64, 128, 256)

    def __post_init__(self):
        ladder = tuple(sorted(set(int(b) for b in self.ladder)))
        if not ladder or ladder[0] < 1:
            raise ValueError(f"ladder must hold sizes >= 1, got {self.ladder}")
        object.__setattr__(self, "ladder", ladder)

    @property
    def buckets(self) -> tuple[int, ...]:
        return self.ladder

    def decide(self, pending: int, oldest_wait_ms: float, *,
               allow_partial: bool) -> BatchDecision | None:
        if pending <= 0:
            return None
        full = [b for b in self.ladder if b <= pending]
        if full:
            return BatchDecision(full[-1], full[-1])
        # pending < smallest bucket: partial into the smallest shape
        if allow_partial:
            return BatchDecision(pending, self.ladder[0])
        return None


@dataclasses.dataclass(frozen=True)
class TimeoutBatch(BatchPolicy):
    """Latency-SLO draining: run full buckets of ``inner`` immediately, but
    hold partial batches until the oldest request has waited
    ``max_wait_ms`` (engines force-drain by passing an infinite wait)."""
    inner: BatchPolicy = dataclasses.field(default_factory=BucketedBatch)
    max_wait_ms: float = 5.0

    @property
    def buckets(self) -> tuple[int, ...]:
        return self.inner.buckets

    @property
    def partial_hold_ms(self) -> float | None:
        return self.max_wait_ms

    def decide(self, pending: int, oldest_wait_ms: float, *,
               allow_partial: bool) -> BatchDecision | None:
        d = self.inner.decide(pending, oldest_wait_ms, allow_partial=False)
        if d is not None:
            return d
        if allow_partial and oldest_wait_ms >= self.max_wait_ms:
            return self.inner.decide(pending, oldest_wait_ms,
                                     allow_partial=True)
        return None

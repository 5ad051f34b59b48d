"""Serving substrate: plan-cached batched CTR engine + async runtime.

Counterpart of ``repro.serving``. ``generate`` drives an LM of
``repro_torch.models.lm`` (prefill, then greedy or sampled decode).
``compile_plan`` (repro_torch.core.plan) →
``InferencePlan`` → ``InferenceEngine`` (plan cache + pluggable batching
policy + futures-based async intake) → ``ServingRuntime`` (multi-model
router, shared admission cadence) draining through a ``DeviceScheduler``
(one shared worker pool serving every hosted engine least-SLO-slack-
first; per-engine worker threads remain as a compat mode). Online model
updates stream in through ``repro_torch.serving.updates``
(``DeltaSource``/``DeltaBuffer``/``SyntheticTrainer``) and land via
``push_update``'s versioned publish — plans never recompile.
"""

from .batching import (BatchDecision, BatchPolicy, BucketedBatch, FixedBatch,
                       TimeoutBatch)
from .engine import (EngineStats, InferenceEngine, QueueFullError,
                     ReadyBatch, RequestFuture)
from .generate import generate
from .runtime import RuntimeStats, ServingRuntime
from .scheduler import DeviceScheduler
from .updates import DeltaBuffer, DeltaSource, SyntheticTrainer

__all__ = [
    "generate",
    "InferenceEngine",
    "EngineStats",
    "RequestFuture",
    "ReadyBatch",
    "QueueFullError",
    "ServingRuntime",
    "RuntimeStats",
    "DeviceScheduler",
    "BatchPolicy",
    "BatchDecision",
    "FixedBatch",
    "BucketedBatch",
    "TimeoutBatch",
    "DeltaSource",
    "DeltaBuffer",
    "SyntheticTrainer",
]

"""InferencePlan — the immutable compiled artifact of the serving stack.

Counterpart of ``repro.core.plan``. :func:`compile_plan` turns
(model, level, batch shape, device) into an :class:`InferencePlan` once:
the fused ``OpGraph``, the breadth-first schedule, the ``ExecutorStats``
bookkeeping and a runnable step, run once on zeros before the plan is
returned so the first served request pays no first-call cost (cuBLAS
handles, stream creation, kernel build and load). ``compile_ms`` is that
whole preparation.

A refreshable store's tensors (``runtime_keys``) are per-call inputs of
the step, named by ``runtime_inputs``: each call reads them from the
``runtime_provider`` the plan was compiled with, so a store that swaps
its buffers (a cache refresh, an online delta) retargets every plan
without a rebuild. The default provider binds the tensors present at
compile time, as the reference's does.

``compute_dtype="int8"`` runs every MLP matmul as the int8 kernel
(K12): weights quantized per output channel once, when the graph is
built; activations per row at every step. It is part of the plan's
identity, and with a ``runtime_provider`` it combines with an int8-row
tiered store into one plan that no refresh rebuilds. Mesh placement and
CUDA-graph capture of the "dual" step come in later slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device

from .dual_parallel import (BRANCH_ORDERS, LEVELS, DualParallelExecutor,
                            ExecutorStats)
from .opgraph import OpGraph

__all__ = ["PlanKey", "InferencePlan", "compile_plan", "plan_key_for",
           "COMPUTE_DTYPES"]

#: dense-branch compute dtypes a plan can be compiled at: fp32 GEMMs, or
#: int8 matmuls with the dequant, bias and ReLU in the epilogue (K12)
COMPUTE_DTYPES = ("fp32", "int8")


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Cache identity of a compiled plan."""
    model: str
    level: str
    batch_size: int
    branch_order: str = "longer_first"
    store: str = "dense"
    compute_dtype: str = "fp32"


def _store_describe(model) -> str:
    coll = getattr(model, "embedding", None)
    store = getattr(coll, "store", None)
    return store.describe() if store is not None else "none"


def plan_key_for(model, level: str, batch_size: int,
                 branch_order: str = "longer_first",
                 compute_dtype: str = "fp32") -> PlanKey:
    """The single definition of plan identity."""
    return PlanKey(model=getattr(model.spec, "name", type(model).__name__),
                   level=level, batch_size=int(batch_size),
                   branch_order=branch_order, store=_store_describe(model),
                   compute_dtype=compute_dtype)


@dataclasses.dataclass(frozen=True)
class InferencePlan:
    """One compiled, batch-shape-specific inference artifact.

    ``step`` maps ``ids (batch_size, n_fields) int32`` on ``device`` to
    ``(batch_size, 1)`` logits.
    """
    key: PlanKey
    stats: ExecutorStats
    graph: OpGraph
    order: tuple[str, ...]
    step: Callable[[torch.Tensor], torch.Tensor]
    n_fields: int
    compile_ms: float
    device: torch.device
    runtime_inputs: tuple[str, ...] = ()

    @property
    def level(self) -> str:
        return self.key.level

    @property
    def batch_size(self) -> int:
        return self.key.batch_size

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        return self.step(ids)

    def predict(self, ids) -> np.ndarray:
        """Sigmoid scores for ``ids`` ((n_fields,) or (b, n_fields) with
        b ≤ batch_size); pads up to the plan's batch shape and slices the
        padding back off."""
        ids = np.asarray(ids, dtype=np.int32)
        if ids.ndim == 1:
            ids = ids[None, :]
        b = ids.shape[0]
        if b > self.batch_size:
            raise ValueError(
                f"{b} rows > plan batch_size {self.batch_size}; batch the "
                "requests or compile a bigger plan")
        if b < self.batch_size:
            pad = np.zeros((self.batch_size - b, ids.shape[1]),
                           dtype=ids.dtype)
            ids = np.concatenate([ids, pad])
        logits = self.step(torch.from_numpy(ids).to(self.device))
        return torch.sigmoid(logits.reshape(-1)).cpu().numpy()[:b]


def compile_plan(model, level: str = "dual", batch_size: int = 256, *,
                 device: torch.device | str | None = None,
                 branch_order: str = "longer_first",
                 runtime_provider: Callable[[], dict] | None = None,
                 compute_dtype: str = "fp32") -> InferencePlan:
    """Compile one (model, level, batch shape) into an InferencePlan.

    Args:
        model: a ``CTRModel`` (anything with ``spec.k``, ``device`` and
            ``build_graph(level)``), whose tensors live on ``device``.
        level: one of ``LEVELS`` (the Fig.-8 ladder).
        batch_size: the fixed batch shape this plan serves.
        device: where the plan runs; CUDA unless the caller says "cpu".
        branch_order: breadth-first head-branch policy (§V-H ablations).
        runtime_provider: zero-argument callable returning the current
            runtime store tensors (edge name -> tensor, the plan's
            ``runtime_inputs``), consulted on every step; pass
            ``model.store_runtime_env`` to serve whatever the store
            publishes. Default: the tensors present at compile time.
        compute_dtype: ``"fp32"`` or ``"int8"`` (one of
            ``COMPUTE_DTYPES``): the MLP matmuls' arithmetic. The cross
            and head GEMMs stay fp32 either way, as in the reference.
    """
    device = resolve_device(device)
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
    if branch_order not in BRANCH_ORDERS:
        raise ValueError(f"branch_order must be one of {BRANCH_ORDERS}, "
                         f"got {branch_order!r}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    if model.device.type != device.type:
        raise ValueError(f"model lives on {model.device}; compile_plan was "
                         f"asked for {device}")
    builder = model.build_graph
    if compute_dtype != "fp32":
        def builder(lvl, _build=model.build_graph):
            return _build(lvl, compute_dtype=compute_dtype)
    executor = DualParallelExecutor(builder, level=level,
                                    branch_order=branch_order)
    t0 = time.perf_counter()
    graph, order = executor.prepare()
    step_env = executor.make_step(graph, order, device)
    n_fields = model.spec.k
    runtime = model.store_runtime_env()
    provider = runtime_provider if runtime_provider is not None \
        else (lambda: runtime)
    if set(provider()) != set(runtime):
        raise ValueError(f"runtime_provider gives {sorted(provider())}; the "
                         f"graph takes {sorted(runtime)}")

    def step(ids: torch.Tensor) -> torch.Tensor:
        return step_env({"ids": ids}, provider())

    step(torch.zeros((batch_size, n_fields), dtype=torch.int32,
                     device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    compile_ms = (time.perf_counter() - t0) * 1e3

    stats = executor.stats
    stats.embedding_store = _store_describe(model)
    stats.compute_dtype = compute_dtype
    return InferencePlan(key=plan_key_for(model, level, batch_size,
                                          branch_order, compute_dtype),
                         stats=stats, graph=graph, order=tuple(order),
                         step=step, n_fields=n_fields,
                         compile_ms=compile_ms, device=device,
                         runtime_inputs=tuple(sorted(runtime)))

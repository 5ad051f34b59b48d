"""DualParallelExecutor — contribution C1, tying C2–C5 together.

Counterpart of ``repro.core.dual_parallel``. A CTR model exposes its
forward pass as an ``OpGraph`` with four modules: ``embedding`` →
(``explicit`` ∥ ``implicit``) → ``head``. The executor turns that graph
into a runnable step at one of the paper's four Fig.-8 levels:

  level "naive"      per-field serial embedding, op-by-op dispatch,
                     depth-first order             (PyTorch-A)
  level "fused_emb"  Alg.-1 fused mega-table lookup, rest op by op
                                                    (DPIFrame-A)
  level "fused_all"  + non-GEMM subgraph fusion (C5), each fused group
                     dispatched as one unit         (DPIFrame-B)
  level "dual"       + breadth-first interleaved branch queue (C4) launched
                     on two CUDA streams            (DPIFrame-C)

On CUDA the first three levels synchronize the device after every op,
so each op pays its own launch and round trip (the reference blocks on
every per-op jit). Level "dual" runs the embedding ops on the caller's
current stream, records an event, and launches the queue on two side
streams, ``S_explicit`` and ``S_implicit``, each waiting on that event;
the head waits on both branches' final events. On the CPU, "dual" runs
the same queue in order on the one CPU stream. Each step is built for
one device: its two side streams live there, and it runs with that card
current, so a mesh plan's batch shards each keep their own streams.

Every level computes the same function (paper Table I).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .opgraph import OpGraph, fuse_non_gemm, op_outputs
from .scheduler import (breadth_first_schedule, depth_first_schedule,
                        full_order)

__all__ = ["DualParallelExecutor", "ExecutorStats", "LEVELS", "BRANCH_ORDERS"]

LEVELS = ("naive", "fused_emb", "fused_all", "dual")
BRANCH_ORDERS = ("longer_first", "explicit_first", "implicit_first")
BRANCHES = ("explicit", "implicit")


@dataclasses.dataclass
class ExecutorStats:
    n_ops_before: int
    n_ops_after: int
    n_fused_groups: int
    kernels_used: tuple[str, ...]
    schedule_policy: str
    queue: tuple[str, ...]
    # identity of the embedding tier the plan was compiled against,
    # stamped by compile_plan
    embedding_store: str = "none"
    # dense-branch compute dtype of the graph, and the quantized-matmul
    # counters emit_mlp_ops records in OpGraph.meta (weight bytes are the
    # int8 codes plus one fp32 scale per channel; "saved" is against the
    # 4 B/element fp32 matrix)
    compute_dtype: str = "fp32"
    mlp_quant_matmuls: int = 0
    mlp_quant_weight_bytes: int = 0
    mlp_quant_weight_bytes_saved: int = 0


def _run(op, env: dict[str, Any]) -> None:
    res = op.fn(*[env[e] for e in op.inputs])
    outs = op_outputs(op)
    if len(outs) == 1:
        env[outs[0]] = res
    else:
        for name, val in zip(outs, res):
            env[name] = val


class DualParallelExecutor:
    """Builds and runs a dual-parallel inference step from a model graph.

    Args:
        graph_builder: callable ``(level) -> OpGraph``. Models build the
            graph differently per level only in the embedding module
            (serial vs fused lookup); fusion and scheduling happen here.
            ``compile_plan`` binds the compute dtype into it.
        level: one of LEVELS.
        branch_order: "longer_first" (paper default), "explicit_first",
            "implicit_first" (§V-H startup-sequence ablation).
    """

    def __init__(self, graph_builder: Callable[[str], OpGraph], *,
                 level: str = "dual", branch_order: str = "longer_first"):
        if level not in LEVELS:
            raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
        if branch_order not in BRANCH_ORDERS:
            raise ValueError(f"branch_order must be one of {BRANCH_ORDERS}, "
                             f"got {branch_order!r}")
        self.graph_builder = graph_builder
        self.level = level
        self.branch_order = branch_order
        self._stats: ExecutorStats | None = None

    # -- graph preparation ---------------------------------------------------
    def prepare(self) -> tuple[OpGraph, list[str]]:
        graph = self.graph_builder(self.level)
        n_before = graph.n_kernels()
        if self.level in ("fused_all", "dual"):
            graph = fuse_non_gemm(graph)
        explicit = graph.by_module("explicit")
        implicit = graph.by_module("implicit")
        if self.level == "dual":
            first = {"longer_first": "longer",
                     "explicit_first": "explicit",
                     "implicit_first": "implicit"}[self.branch_order]
            sched = breadth_first_schedule(explicit, implicit, first=first)
        else:
            sched = depth_first_schedule(explicit, implicit)
        order = full_order(graph, sched)
        fused_groups = [op for op in graph.ops if hasattr(op, "members")]
        self._stats = ExecutorStats(
            n_ops_before=n_before,
            n_ops_after=graph.n_kernels(),
            n_fused_groups=len(fused_groups),
            kernels_used=tuple(op.kernel for op in fused_groups
                               if getattr(op, "kernel", None)),
            schedule_policy=sched.policy,
            queue=tuple(sched.queue),
            compute_dtype=graph.meta.get("compute_dtype", "fp32"),
            mlp_quant_matmuls=graph.meta.get("mlp_quant_matmuls", 0),
            mlp_quant_weight_bytes=graph.meta.get(
                "mlp_quant_weight_bytes", 0),
            mlp_quant_weight_bytes_saved=graph.meta.get(
                "mlp_quant_weight_bytes_saved", 0),
        )
        return graph, order

    @property
    def stats(self) -> ExecutorStats:
        if self._stats is None:
            raise RuntimeError("call prepare() or build() first")
        return self._stats

    # -- runnable step ---------------------------------------------------------
    def build(self, device: torch.device) -> Callable[..., Any]:
        """Returns ``step(inputs_env) -> output`` at the configured level."""
        graph, order = self.prepare()
        return self.make_step(graph, order, device)

    def make_step(self, graph: OpGraph, order: list[str],
                  device: torch.device) -> Callable[..., Any]:
        """Turn a prepared (graph, order) into
        ``step(inputs_env, runtime_env=None) -> output`` on ``device``.

        ``inputs_env`` carries the per-request values (``ids``);
        ``runtime_env`` the runtime store tensors (empty for dense stores).
        """
        ops_in_order = [graph.op(n) for n in order]
        out_edge = ops_in_order[-1].output
        device = torch.device(device)

        if self.level == "dual" and device.type == "cuda":
            return _two_stream_step(ops_in_order, out_edge, device)

        sync = device.type == "cuda"

        def step(env, runtime_env=None):
            env = {**env, **(runtime_env or {})}
            for op in ops_in_order:
                _run(op, env)
                if sync:
                    torch.cuda.synchronize(device)
            return env[out_edge]
        return step


def _two_stream_step(ops_in_order: list, out_edge: str,
                     device: torch.device) -> Callable[..., Any]:
    """Level "dual" on CUDA: embedding ops on the caller's stream, the
    breadth-first queue on ``S_explicit`` / ``S_implicit``, head back on
    the caller's stream.

    Ordering is by events: both side streams wait on an event recorded
    after the embedding ops, and the caller's stream waits on each side
    stream's final event before the head. Branch outputs that the head
    reads were allocated on a side stream, so they are marked with
    ``record_stream`` for the caller's stream: the caching allocator then
    keeps their memory until the head's work on that stream is done.
    Tensors the caller's stream allocated and the branches read need no
    mark — the caller's stream waits for both branches before anything
    it runs later.
    """
    streams = {m: torch.cuda.Stream(device=device) for m in BRANCHES}
    pre = [op for op in ops_in_order if op.module == "embedding"]
    queue = [op for op in ops_in_order if op.module in streams]
    post = [op for op in ops_in_order
            if op.module != "embedding" and op.module not in streams]
    consumed_after = {e for op in post for e in op.inputs}
    crossing = [tuple(e for e in op_outputs(op) if e in consumed_after)
                for op in queue]

    def step(env, runtime_env=None):
        env = {**env, **(runtime_env or {})}
        with torch.cuda.device(device):
            main = torch.cuda.current_stream(device)
            for op in pre:
                _run(op, env)
            embedded = main.record_event()
            for s in streams.values():
                s.wait_event(embedded)
            for op, edges in zip(queue, crossing):
                with torch.cuda.stream(streams[op.module]):
                    _run(op, env)
                for e in edges:
                    env[e].record_stream(main)
            for s in streams.values():
                main.wait_event(s.record_event())
            for op in post:
                _run(op, env)
        return env[out_edge]

    return step

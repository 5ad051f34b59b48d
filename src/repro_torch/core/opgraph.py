"""Operator DAG + non-GEMM fusion pass (paper contribution C5).

DPIFrame "represents the model forward propagation by constructing a
directed acyclic graph, in which nodes are operators and edges are tensors.
Starting from the root node, we traverse the graph to mark all non-GEMM
nodes connected by edges … within a subgraph, we fuse the operators into a
new operator."  This module is that pass, backend-agnostically:

* ``Op``        one operator node (fn + named input/output edges).
* ``OpGraph``   the DAG; validates SSA form, checks topological orders.
* ``fuse_non_gemm``  merges every maximal run of same-module non-GEMM ops
  into a single ``FusedOp`` (multi-output when several of its values are
  consumed downstream); if all members carry the same ``fused_hint`` and the
  group is single-output, the registered CUDA kernel replaces the composed
  body.

Counterpart of ``repro.core.opgraph``, pure Python with the same
semantics, so fused-op names (``fused{id}[a+b]``), groups and queues
compare name for name with the reference. Execution engines (how a
schedule is *run*) live in dual_parallel.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

__all__ = ["Op", "FusedOp", "OpGraph", "register_fused_kernel",
           "fuse_non_gemm", "op_outputs"]


@dataclasses.dataclass(frozen=True)
class Op:
    """One operator node.

    Attributes:
        name:       unique node id.
        fn:         callable ``(*input_values) -> value`` (may close over
                    parameters — edges carry activations only).
        inputs:     names of the value edges consumed.
        output:     name of the produced value edge.
        is_gemm:    True for matrix products — never fused (the paper
                    fuses only non-GEMM ops).
        module:     model module tag ("embedding", "explicit", "implicit",
                    "head"); fusion never crosses module boundaries and
                    scheduling interleaves by module.
        fused_hint: optional pattern tag; a homogeneous fused group with a
                    registered hint dispatches to its kernel.
    """
    name: str
    fn: Callable[..., Any]
    inputs: tuple[str, ...]
    output: str
    is_gemm: bool = False
    module: str = ""
    fused_hint: str | None = None


@dataclasses.dataclass(frozen=True)
class FusedOp:
    """A fused group of non-GEMM ops executing as one dispatch unit."""
    name: str
    fn: Callable[..., Any]           # (*external_inputs) -> tuple(outputs)
    inputs: tuple[str, ...]          # external value edges
    outputs: tuple[str, ...]         # exposed value edges (usually 1)
    members: tuple[str, ...]         # names of the original ops
    module: str = ""
    kernel: str | None = None        # registered kernel used, if any
    is_gemm: bool = False

    @property
    def output(self) -> str:
        return self.outputs[-1]


def op_outputs(op: Op | FusedOp) -> tuple[str, ...]:
    return op.outputs if isinstance(op, FusedOp) else (op.output,)


# pattern registry: hint -> kernel with the same signature as the composed
# single-output subgraph.  Populated by repro_torch.models.ctr at import
# time (and by DCN per model instance and layer); global to the process.
_FUSED_KERNELS: dict[str, Callable[..., Any]] = {}


def register_fused_kernel(hint: str, fn: Callable[..., Any]) -> None:
    _FUSED_KERNELS[hint] = fn


class OpGraph:
    """A small SSA-form operator DAG (ops added in topological order)."""

    def __init__(self, graph_inputs: Sequence[str]):
        self.graph_inputs = tuple(graph_inputs)
        self.ops: list[Op | FusedOp] = []
        self._producers: dict[str, str] = {}   # value edge -> op name
        # structural facts the emitters record (e.g. emit_mlp_ops'
        # quantized-matmul counters), carried through fusion
        self.meta: dict[str, Any] = {}

    # -- construction ------------------------------------------------------
    def add_input(self, name: str) -> None:
        """Declare an extra graph input edge (e.g. a runtime store tensor
        a refreshable embedding tier feeds per call instead of baking)."""
        if name in self._producers:
            raise ValueError(f"value {name!r} already produced by "
                             f"{self._producers[name]!r}")
        if name not in self.graph_inputs:
            self.graph_inputs = self.graph_inputs + (name,)

    def add(self, op: Op | FusedOp) -> None:
        for out in op_outputs(op):
            if out in self._producers:
                raise ValueError(f"value {out!r} already produced by "
                                 f"{self._producers[out]!r}")
        for edge in op.inputs:
            if edge not in self._producers and edge not in self.graph_inputs:
                raise ValueError(f"op {op.name!r} consumes undefined value "
                                 f"{edge!r} (ops must be added in topo order)")
        for out in op_outputs(op):
            self._producers[out] = op.name
        self.ops.append(op)

    # -- queries -----------------------------------------------------------
    def by_module(self, module: str) -> list[Op | FusedOp]:
        return [op for op in self.ops if op.module == module]

    def consumers(self, edge: str) -> list[str]:
        return [op.name for op in self.ops if edge in op.inputs]

    def op(self, name: str) -> Op | FusedOp:
        for op in self.ops:
            if op.name == name:
                return op
        raise KeyError(name)

    def is_valid_order(self, order: Sequence[str]) -> bool:
        """True if ``order`` is a topological order of this graph."""
        if sorted(order) != sorted(op.name for op in self.ops):
            return False
        ready = set(self.graph_inputs)
        by_name = {op.name: op for op in self.ops}
        for name in order:
            op = by_name[name]
            if any(e not in ready for e in op.inputs):
                return False
            ready.update(op_outputs(op))
        return True

    # -- execution ---------------------------------------------------------
    def execute(self, env: dict[str, Any],
                order: Sequence[str] | None = None) -> dict[str, Any]:
        """Run ops (in graph order or an explicit schedule) over ``env``."""
        env = dict(env)
        ops = self.ops if order is None else [self.op(n) for n in order]
        for op in ops:
            res = op.fn(*[env[e] for e in op.inputs])
            if isinstance(op, FusedOp):
                if len(op.outputs) == 1:
                    env[op.outputs[0]] = res
                else:
                    for name, val in zip(op.outputs, res):
                        env[name] = val
            else:
                env[op.output] = res
        return env

    def n_kernels(self) -> int:
        """Device dispatches this graph costs (the paper's launch-overhead
        metric: strictly fewer after fusion)."""
        return len(self.ops)


def _compose(sub_ops: list[Op], external: tuple[str, ...],
             exposed: tuple[str, ...]) -> Callable[..., Any]:
    """Build one callable running a fused subgraph internally."""
    single = len(exposed) == 1

    def fused_fn(*args):
        env = dict(zip(external, args))
        for op in sub_ops:
            env[op.output] = op.fn(*[env[e] for e in op.inputs])
        if single:
            return env[exposed[0]]
        return tuple(env[e] for e in exposed)
    return fused_fn


def _emit_group(fused: OpGraph, graph: OpGraph, group: list[Op],
                group_id: int) -> None:
    """Add one fused group (or the single op) to the output graph."""
    if len(group) == 1:
        fused.add(group[0])
        return
    group_names = {r.name for r in group}
    group_outs = {r.output for r in group}
    # exposed = consumed by any op outside the group, or never consumed
    exposed: list[str] = []
    for r in group:
        outside = [c for c in graph.consumers(r.output)
                   if c not in group_names]
        if outside or not graph.consumers(r.output):
            exposed.append(r.output)
    external_inputs: list[str] = []
    for r in group:
        for e in r.inputs:
            if e not in group_outs and e not in external_inputs:
                external_inputs.append(e)
    hints = {r.fused_hint for r in group}
    kernel_name = None
    fn = _compose(group, tuple(external_inputs), tuple(exposed))
    if len(hints) == 1 and len(exposed) == 1:
        hint = next(iter(hints))
        if hint is not None and hint in _FUSED_KERNELS:
            fn = _FUSED_KERNELS[hint]
            kernel_name = hint
    fused.add(FusedOp(
        name=f"fused{group_id}[" + "+".join(r.name for r in group) + "]",
        fn=fn,
        inputs=tuple(external_inputs),
        outputs=tuple(exposed),
        members=tuple(r.name for r in group),
        module=group[0].module,
        kernel=kernel_name,
    ))


def _kernel_key(op: Op) -> str | None:
    """The op's hint if a kernel is registered for it, else None."""
    return op.fused_hint if op.fused_hint in _FUSED_KERNELS else None


def _segment_by_kernel_hint(run: list[Op]) -> list[list[Op]]:
    """Split a non-GEMM run into fusion groups.

    Contiguous ops sharing a *registered-kernel* hint become their own group
    (so the kernel can replace the composed body); everything else is
    coalesced maximally — the paper's whole-subgraph fusion.
    """
    segs: list[list[Op]] = []
    for op in run:
        if segs and _kernel_key(segs[-1][-1]) == _kernel_key(op):
            segs[-1].append(op)
        else:
            segs.append([op])
    return segs


def fuse_non_gemm(graph: OpGraph) -> OpGraph:
    """The paper's C5 pass: merge maximal non-GEMM runs per module.

    A *run* is a maximal sequence of consecutive (in topo order) non-GEMM
    ops of the same module; each run becomes one ``FusedOp`` (values
    consumed outside stay exposed, everything else is internal) — except
    that contiguous sub-runs carrying a registered-kernel hint are emitted
    as their own group so the kernel can serve them.
    """
    fused = OpGraph(graph.graph_inputs)
    fused.meta = dict(graph.meta)
    ops = graph.ops
    i = 0
    group_id = 0
    while i < len(ops):
        op = ops[i]
        if isinstance(op, FusedOp) or op.is_gemm:
            fused.add(op)
            i += 1
            continue
        # maximal same-module non-GEMM run
        j = i
        run: list[Op] = []
        while (j < len(ops) and not ops[j].is_gemm
               and not isinstance(ops[j], FusedOp)
               and ops[j].module == op.module):
            run.append(ops[j])  # type: ignore[arg-type]
            j += 1
        for seg in _segment_by_kernel_hint(run):
            _emit_group(fused, graph, seg, group_id)
            group_id += 1
        i = j
    return fused

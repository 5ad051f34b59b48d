"""Breadth-first stream scheduling (paper Algorithm 2, contribution C4).

Put the explicit/implicit interaction branches on two CUDA streams and
*interleave* operator launches breadth-first, longer branch first, so both
branches start executing as early as possible.

Counterpart of ``repro.core.scheduler``, pure Python with the same
semantics: this module builds the queue Q and the two stream lanes; the
executor (``dual_parallel.py``) launches Q on two real
``torch.cuda.Stream``s at level "dual".
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from .opgraph import FusedOp, Op, OpGraph

__all__ = ["LogicalStream", "breadth_first_schedule", "depth_first_schedule",
           "Schedule", "full_order"]


@dataclasses.dataclass
class LogicalStream:
    """An ordered launch lane: the ops one CUDA stream runs.

    Ops inside one stream are sequential; ops in different streams carry no
    ordering constraint beyond data dependence.
    """
    name: str
    ops: list[str] = dataclasses.field(default_factory=list)

    def add(self, ops: Sequence[str]) -> None:
        self.ops.extend(ops)


@dataclasses.dataclass
class Schedule:
    streams: dict[str, LogicalStream]
    queue: list[str]                  # launch order (the paper's Q)
    policy: str

    def stream_of(self, op_name: str) -> str:
        """The name of the stream ``op_name`` is queued on (KeyError when
        no stream holds it)."""
        for s in self.streams.values():
            if op_name in s.ops:
                return s.name
        raise KeyError(op_name)


def breadth_first_schedule(explicit: Sequence[Op | FusedOp],
                           implicit: Sequence[Op | FusedOp], *,
                           first: str = "longer") -> Schedule:
    """Literal transcription of Algorithm 2.

    Args:
        explicit: ops of the explicit interaction module (in branch order).
        implicit: ops of the implicit interaction module.
        first: which branch heads the queue — ``"longer"`` (Alg.-2 default:
            "the module that has more operators launches first … it can
            help hide the startup costs"; ties go to explicit),
            ``"shorter"`` (the flipped ablation), or ``"explicit"`` /
            ``"implicit"`` (the §V-H startup-sequence ablations,
            deterministic regardless of branch lengths — including
            equal-length branches).

    Returns:
        Schedule with S_explicit / S_implicit streams and interleaved Q.
    """
    ops_explicit = [op.name for op in explicit]          # line 1
    ops_implicit = [op.name for op in implicit]          # line 2
    n_explicit = len(ops_explicit)                       # line 3
    n_implicit = len(ops_implicit)                       # line 4
    s_explicit = LogicalStream("S_explicit")             # line 5
    s_implicit = LogicalStream("S_implicit")             # line 6
    s_explicit.add(ops_explicit)                         # line 7
    s_implicit.add(ops_implicit)                         # line 8
    queue: list[str] = []
    if first == "explicit":
        head, tail_b = ops_explicit, ops_implicit
    elif first == "implicit":
        head, tail_b = ops_implicit, ops_explicit
    elif first in ("longer", "shorter"):
        # line 9: the module with more operators launches first
        head, tail_b = ((ops_implicit, ops_explicit)
                        if n_implicit > n_explicit
                        else (ops_explicit, ops_implicit))
        if first == "shorter":
            head, tail_b = tail_b, head
    else:
        raise ValueError(f"first must be 'longer', 'shorter', 'explicit' "
                         f"or 'implicit', got {first!r}")
    for i in range(min(len(head), len(tail_b))):         # lines 9–13 / 18–22
        queue.append(head[i])
        queue.append(tail_b[i])
    tail = head if len(head) >= len(tail_b) else tail_b
    for j in range(min(len(head), len(tail_b)), len(tail)):  # 14–16 / 23–25
        queue.append(tail[j])
    return Schedule(streams={"S_explicit": s_explicit,
                             "S_implicit": s_implicit},
                    queue=queue, policy="breadth_first")


def depth_first_schedule(explicit: Sequence[Op | FusedOp],
                         implicit: Sequence[Op | FusedOp],
                         explicit_first: bool = True) -> Schedule:
    """The framework-default strawman: drain one stream, then the other."""
    ops_explicit = [op.name for op in explicit]
    ops_implicit = [op.name for op in implicit]
    s_explicit = LogicalStream("S_explicit", list(ops_explicit))
    s_implicit = LogicalStream("S_implicit", list(ops_implicit))
    queue = (ops_explicit + ops_implicit if explicit_first
             else ops_implicit + ops_explicit)
    return Schedule(streams={"S_explicit": s_explicit,
                             "S_implicit": s_implicit},
                    queue=queue, policy="depth_first")


def full_order(graph: OpGraph, schedule: Schedule) -> list[str]:
    """Embed the two-branch queue into the whole-graph execution order:
    embedding ops first (both branches consume the embedded features), then
    the interleaved queue, then head ops."""
    pre = [op.name for op in graph.ops if op.module == "embedding"]
    post = [op.name for op in graph.ops
            if op.module not in ("embedding", "explicit", "implicit")]
    order = pre + schedule.queue + post
    if not graph.is_valid_order(order):
        raise ValueError(
            f"{schedule.policy} queue is not a valid topological order — "
            "branch ops must be emitted in intra-branch dependence order")
    return order

"""repro_torch.core — DPIFrame's contribution as PyTorch modules.

  opgraph.py          C5: operator DAG + non-GEMM fusion pass
  scheduler.py        C4: breadth-first stream scheduling (Alg. 2)
  dual_parallel.py    C1: the dual-parallel executor (Fig.-8 levels)
  plan.py             compile_plan → InferencePlan

The C2 embedding path lives in ``repro_torch.embedding``.
"""

from .dual_parallel import (BRANCH_ORDERS, LEVELS, DualParallelExecutor,
                            ExecutorStats)
from .opgraph import (FusedOp, Op, OpGraph, fuse_non_gemm,
                      register_fused_kernel)
from .plan import (COMPUTE_DTYPES, InferencePlan, PlanKey, compile_plan,
                   plan_key_for)
from .scheduler import (breadth_first_schedule, depth_first_schedule,
                        full_order)

__all__ = [
    "LEVELS",
    "BRANCH_ORDERS",
    "COMPUTE_DTYPES",
    "DualParallelExecutor",
    "ExecutorStats",
    "InferencePlan",
    "PlanKey",
    "compile_plan",
    "plan_key_for",
    "Op",
    "FusedOp",
    "OpGraph",
    "fuse_non_gemm",
    "register_fused_kernel",
    "breadth_first_schedule",
    "depth_first_schedule",
    "full_order",
]

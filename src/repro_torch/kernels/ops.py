"""Public wrappers for the DPIFrame kernels, with strategy dispatch.

Counterpart of ``repro.kernels.ops``. Strategies for
``multi_table_lookup``:

  "auto"        the kernel wrapper: the CUDA gather for a CUDA tensor,
                its plain version for a CPU tensor
  "kernel"      the same wrapper, named explicitly        [C2+C3]
  "torch"       one ``index_select`` over the mega-table  [C2 in PyTorch]
  "serial"      per-field gathers + concat (the paper's PyTorch baseline)

The reference's "input_first" and "onehot" strategies wait for their
kernels. The fused-tail wrappers dispatch on the tensor's device the same
way: the kernel for CUDA tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from . import ref
from .fused_cross import fused_cross_v1, fused_cross_v2
from .fused_fm import fused_fm_second_order
from .multi_table_lookup import mtl_gather

__all__ = ["STRATEGIES", "multi_table_lookup", "fused_cross_v1",
           "fused_cross_v2", "fused_fm_second_order"]

STRATEGIES = ("auto", "kernel", "torch", "serial")


def multi_table_lookup(ids: torch.Tensor, mega_table: torch.Tensor,
                       offsets: torch.Tensor, *,
                       strategy: str = "auto") -> torch.Tensor:
    """Fused multi-table embedding lookup (paper Algorithm 1).

    Args:
        ids:        (b, k) int32 per-field local ids.
        mega_table: (N, d) concatenated tables.
        offsets:    (k,) int32 starting row of each table.
        strategy:   see module docstring.

    Returns:
        (b, k*d) embedding output.
    """
    if strategy in ("auto", "kernel"):
        return mtl_gather(ids, offsets, mega_table)
    if strategy == "torch":
        return ref.ref_multi_table_lookup(ids, mega_table, offsets,
                                          ids.shape[1])
    if strategy == "serial":
        cols = [mega_table.index_select(0, ids[:, i] + offsets[i])
                for i in range(ids.shape[1])]
        return torch.cat(cols, dim=1)
    raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                     f"{STRATEGIES}")

"""Output-first fused multi-table gather (Alg. 1) — ``csrc/mtl_gather.cu``.

Counterpart of ``repro.kernels.multi_table_lookup.mtl_gather``. The
reference kernel takes precomputed global rows; this one takes the
``(b, k)`` local ids plus the ``(k,)`` table offsets and adds them inside
the kernel (Alg. 1 lines 6–8), so no separate pass over the ids runs.

Global rows are clamped into ``[0, N)``: an out-of-range id reads some row
of the table, never memory past it. The plain version clamps the same way,
so kernel and plain version are bitwise equal on any input.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["mtl_gather", "mtl_gather_plain"]


def mtl_gather_plain(ids: torch.Tensor, offsets: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the same clamp, one gather)."""
    b, k = ids.shape
    rows = ids.to(torch.int64) + offsets.to(torch.int64)[None, :]
    rows = rows.clamp_(0, table.shape[0] - 1).reshape(-1)
    return table.index_select(0, rows).reshape(b, k * table.shape[1])


@functools.cache
def _kernel():
    fn = _build.library("mtl_gather").mtl_gather
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mtl_gather(ids: torch.Tensor, offsets: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    """Fused multi-table gather.

    Args:
        ids:     (b, k) int32 per-field local ids.
        offsets: (k,) int32 starting row of each field in ``table``.
        table:   (N, d) float32 mega-table.

    Returns:
        (b, k*d) float32: row ``s`` holds the k looked-up rows side by side.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream.
    """
    dev = table.device
    _build.check_tensor("ids", ids, torch.int32, 2, dev)
    _build.check_tensor("offsets", offsets, torch.int32, 1, dev)
    _build.check_tensor("table", table, torch.float32, 2, dev)
    b, k = ids.shape
    n_rows, d = table.shape
    if offsets.shape[0] != k:
        raise ValueError(f"offsets has {offsets.shape[0]} entries for "
                         f"{k} fields")
    if n_rows == 0:
        raise ValueError("table has no rows")
    if dev.type == "cpu":
        return mtl_gather_plain(ids, offsets, table)
    out = torch.empty((b, k * d), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    code = _kernel()(ids.data_ptr(), offsets.data_ptr(), table.data_ptr(),
                     out.data_ptr(), b, k, d, n_rows,
                     _build.current_stream(dev))
    _build.check_launch("mtl_gather", code)
    mtl_gather.launches += 1
    return out


mtl_gather.launches = 0

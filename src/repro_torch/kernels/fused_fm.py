"""Fused FM second-order term (DeepFM, C5) — ``csrc/fused_fm.cu``.

Counterpart of ``repro.kernels.fused_fm``:

    y_fm(b) = 0.5 * Σ_d [ (Σ_k v[b,k,d])² − Σ_k v[b,k,d]² ]

The kernel reads ``v`` once and keeps both sums in registers; it sums in
another order than ``torch.sum``, so it matches the plain version at a
tolerance, not bitwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import ref_fm_second_order

__all__ = ["fused_fm_second_order", "fused_fm_second_order_plain"]


def fused_fm_second_order_plain(v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (b, k, d) -> (b, 1)."""
    return ref_fm_second_order(v)[:, None]


@functools.cache
def _kernel():
    fn = _build.library("fused_fm").fused_fm_second_order
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_fm_second_order(v: torch.Tensor) -> torch.Tensor:
    """Fused FM 2nd-order term: (b, k, d) float32 -> (b, 1)."""
    dev = v.device
    _build.check_tensor("v", v, torch.float32, 3, dev)
    if dev.type == "cpu":
        return fused_fm_second_order_plain(v)
    b, k, d = v.shape
    out = torch.empty((b, 1), dtype=v.dtype, device=dev)
    if out.numel() == 0:
        return out
    code = _kernel()(v.data_ptr(), out.data_ptr(), b, k, d,
                     _build.current_stream(dev))
    _build.check_launch("fused_fm_second_order", code)
    fused_fm_second_order.launches += 1
    return out


fused_fm_second_order.launches = 0

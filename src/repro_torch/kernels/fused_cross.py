"""Fused DCN / DCNv2 cross-layer tails (C5) — ``csrc/fused_cross.cu``.

Counterpart of ``repro.kernels.fused_cross``:

  DCNv2:  out = x0 * (x_l W + b) + x_l      (``xw_plus`` = x_l W + b)
  DCNv1:  out = x0 * (x_l · w) + b + x_l    (``xlw`` is (b, 1) per-sample)

The kernels round in the plain versions' order without FMA contraction,
so on the card they are bitwise equal to them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import ref_cross_v1_elementwise, ref_cross_v2_elementwise

__all__ = ["fused_cross_v2", "fused_cross_v1", "fused_cross_v2_plain",
           "fused_cross_v1_plain"]

fused_cross_v2_plain = ref_cross_v2_elementwise
fused_cross_v1_plain = ref_cross_v1_elementwise


@functools.cache
def _v2_kernel():
    fn = _build.library("fused_cross").fused_cross_v2
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _v1_kernel():
    fn = _build.library("fused_cross").fused_cross_v1
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_shape(name: str, t: torch.Tensor, shape: tuple[int, ...]) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")


def fused_cross_v2(x0: torch.Tensor, xw_plus: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """DCNv2 cross tail ``x0 * xw_plus + x`` over three (b, D) float32
    tensors, in one pass."""
    dev = x0.device
    for name, t in (("x0", x0), ("xw_plus", xw_plus), ("x", x)):
        _build.check_tensor(name, t, torch.float32, 2, dev)
        _check_shape(name, t, tuple(x0.shape))
    if dev.type == "cpu":
        return fused_cross_v2_plain(x0, xw_plus, x)
    b, dim = x0.shape
    out = torch.empty_like(x0)
    if out.numel() == 0:
        return out
    code = _v2_kernel()(x0.data_ptr(), xw_plus.data_ptr(), x.data_ptr(),
                        out.data_ptr(), b, dim, _build.current_stream(dev))
    _build.check_launch("fused_cross_v2", code)
    fused_cross_v2.launches += 1
    return out


def fused_cross_v1(x0: torch.Tensor, xlw: torch.Tensor, bias: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """DCN cross tail ``x0 * xlw + bias + x``: x0/x (b, D), xlw (b, 1)
    broadcast over columns, bias (D,) over rows; float32."""
    dev = x0.device
    _build.check_tensor("x0", x0, torch.float32, 2, dev)
    b, dim = x0.shape
    _build.check_tensor("xlw", xlw, torch.float32, 2, dev)
    _check_shape("xlw", xlw, (b, 1))
    _build.check_tensor("bias", bias, torch.float32, 1, dev)
    _check_shape("bias", bias, (dim,))
    _build.check_tensor("x", x, torch.float32, 2, dev)
    _check_shape("x", x, (b, dim))
    if dev.type == "cpu":
        return fused_cross_v1_plain(x0, xlw, bias, x)
    out = torch.empty_like(x0)
    if out.numel() == 0:
        return out
    code = _v1_kernel()(x0.data_ptr(), xlw.data_ptr(), bias.data_ptr(),
                        x.data_ptr(), out.data_ptr(), b, dim,
                        _build.current_stream(dev))
    _build.check_launch("fused_cross_v1", code)
    fused_cross_v1.launches += 1
    return out


fused_cross_v2.launches = 0
fused_cross_v1.launches = 0

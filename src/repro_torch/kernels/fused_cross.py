"""Fused DCN / DCNv2 cross-layer tails (C5) — ``csrc/fused_cross.cu``.

Counterpart of ``repro.kernels.fused_cross``:

  DCNv2:  out = x0 * (x_l W + b) + x_l      (``xw_plus`` = x_l W + b)
  DCNv1:  out = x0 * (x_l · w) + b + x_l    (``xlw`` is (b, 1) per-sample)

The kernels read each input once in the shape :func:`cross_launch` gives
(pieces of 4 floats, 2 a thread, every load issued before any
arithmetic) and skip ``x``'s loads in layer 0, where ``x`` is ``x0``. They
round in the plain versions' order without FMA contraction, so on the
card they are bitwise equal to them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .multi_table_lookup import Launch, vector_words
from .ref import ref_cross_v1_elementwise, ref_cross_v2_elementwise

__all__ = ["fused_cross_v2", "fused_cross_v1", "fused_cross_v2_plain",
           "fused_cross_v1_plain", "CROSS_WORDS", "CROSS_THREADS",
           "cross_launch", "launch_args"]

fused_cross_v2_plain = ref_cross_v2_elementwise
fused_cross_v1_plain = ref_cross_v1_elementwise

#: pieces a thread and threads a block: within 3.5% of the best of 1, 2
#: and 4 pieces × 32-256 threads for K9 and K10 at b = 256 and 1024 in
#: ``chip_smoke.py``'s sweep on the H100 (32 threads: up to 30% slower); at
#: b = 1024 the grid's 1,248 blocks of 128 are one wave (16 blocks an SM)
CROSS_WORDS, CROSS_THREADS = 2, 128


def cross_launch(b: int, dim: int, aligned: bool) -> Launch:
    """K9's and K10's launch over ``(b, dim)`` operands: pieces of 4
    floats (``vec``) where ``dim % 4 == 0``, else of one float, loaded as
    one 16-byte ``word`` where every operand is 16-byte ``aligned`` and
    ``vec``, else 4 bytes at a time; ``rows``, the pieces a thread
    (``CROSS_WORDS``); ``CROSS_THREADS`` a block; a grid that covers the
    pieces once."""
    vec = dim % 4 == 0
    word = 16 if vec and aligned else 4
    pieces = b * dim // (4 if vec else 1)
    per_block = CROSS_WORDS * CROSS_THREADS
    return Launch(vec, 1, CROSS_WORDS, CROSS_THREADS,
                  max(1, math.ceil(pieces / per_block)), word)


def launch_args(launch: Launch) -> tuple[int, ...]:
    """The C entries' launch arguments, in their order after ``same``."""
    return (int(launch.vec), launch.word, launch.rows, launch.threads,
            launch.blocks)


@functools.cache
def _v2_kernel():
    fn = _build.library("fused_cross").fused_cross_v2
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _v1_kernel():
    fn = _build.library("fused_cross").fused_cross_v1
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 8 \
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
    tensors, in one pass; ``x`` may be ``x0`` itself (layer 0)."""
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
    same = x.data_ptr() == x0.data_ptr()
    launch = cross_launch(b, dim, vector_words(
        dim, x0.data_ptr(), xw_plus.data_ptr(), x.data_ptr()))
    with torch.cuda.device(dev):
        code = _v2_kernel()(x0.data_ptr(), xw_plus.data_ptr(), x.data_ptr(),
                            out.data_ptr(), b, dim, int(same),
                            *launch_args(launch), _build.current_stream(dev))
    _build.check_launch("fused_cross_v2", code)
    _build.count_launch(fused_cross_v2)
    return out


def fused_cross_v1(x0: torch.Tensor, xlw: torch.Tensor, bias: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """DCN cross tail ``x0 * xlw + bias + x``: x0/x (b, D), xlw (b, 1)
    broadcast over columns, bias (D,) over rows; float32. ``x`` may be
    ``x0`` itself (layer 0)."""
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
    same = x.data_ptr() == x0.data_ptr()
    launch = cross_launch(b, dim, vector_words(
        dim, x0.data_ptr(), bias.data_ptr(), x.data_ptr()))
    with torch.cuda.device(dev):
        code = _v1_kernel()(x0.data_ptr(), xlw.data_ptr(), bias.data_ptr(),
                            x.data_ptr(), out.data_ptr(), b, dim, int(same),
                            *launch_args(launch), _build.current_stream(dev))
    _build.check_launch("fused_cross_v1", code)
    _build.count_launch(fused_cross_v1)
    return out


fused_cross_v2.launches = 0
fused_cross_v1.launches = 0

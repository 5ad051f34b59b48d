"""Fused FM second-order term (DeepFM, C5) — ``csrc/fused_fm.cu``.

Counterpart of ``repro.kernels.fused_fm``:

    y_fm(b) = 0.5 * Σ_d [ (Σ_k v[b,k,d])² − Σ_k v[b,k,d]² ]

The kernel reads ``v`` once, a warp a row in the shape :func:`fm_launch`
gives: every piece of a row is copied (``cp.async``) before any is
summed, so a row costs one round trip to device memory. It sums in
another order than ``torch.sum``, so it matches the plain version at a
tolerance, not bitwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .multi_table_lookup import Launch, _grid, _lanes
from .ref import ref_fm_second_order

__all__ = ["fused_fm_second_order", "fused_fm_second_order_plain",
           "FM_THREADS", "fm_launch"]

#: threads a block (a warp a row): within 3% of the best of 32-256 at
#: b = 256 and 1024 in ``chip_smoke.py``'s sweep on the H100, and the one
#: size whose grid leaves no SM idle at b = 256 (256 blocks for 132 SMs)
FM_THREADS = 32


def fm_launch(b: int, d: int, aligned: bool) -> Launch:
    """K11's launch for ``v`` of shape ``(b, k, d)``, whatever k: 4 floats
    a lane as one 16-byte copy (``vec``) where ``d % 4 == 0`` and ``v`` is
    16-byte ``aligned``, else one float; ``lanes``, the power of two up to
    32 that covers a field's pieces, so a warp takes ``32 // lanes``
    fields at a time; a warp a row, ``FM_THREADS`` a block."""
    vec = aligned and d % 4 == 0
    lanes = _lanes(d // 4 if vec else d)
    return Launch(vec, lanes, 1, FM_THREADS, _grid(b * 32, FM_THREADS))


def fused_fm_second_order_plain(v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (b, k, d) -> (b, 1)."""
    return ref_fm_second_order(v)[:, None]


@functools.cache
def _kernel():
    fn = _build.library("fused_fm").fused_fm_second_order
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_fm_second_order(v: torch.Tensor) -> torch.Tensor:
    """Fused FM 2nd-order term: (b, k, d) float32 -> (b, 1).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream."""
    dev = v.device
    _build.check_tensor("v", v, torch.float32, 3, dev)
    if dev.type == "cpu":
        return fused_fm_second_order_plain(v)
    b, k, d = v.shape
    out = torch.empty((b, 1), dtype=v.dtype, device=dev)
    if out.numel() == 0:
        return out
    launch = fm_launch(b, d, v.data_ptr() % 16 == 0)
    code = _kernel()(v.data_ptr(), out.data_ptr(), b, k, d, int(launch.vec),
                     launch.lanes.bit_length() - 1, launch.threads,
                     launch.blocks, _build.current_stream(dev))
    _build.check_launch("fused_fm_second_order", code)
    _build.count_launch(fused_fm_second_order)
    return out


fused_fm_second_order.launches = 0

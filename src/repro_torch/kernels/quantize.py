"""Per-row int8 quantizer of the int8 MLP's activations —
``csrc/quantize_rows_q8.cu``.

    hscale = max(max|h| / 127, SCALE_EPS)        per row, (b, 1) fp32
    hq     = clip(round(h / hscale), -127, 127)  (b, fan_in) int8

No TPU kernel: the reference quantizes with jnp ops
(``repro.quant.absmax_scale`` and ``quantize``, called by
``repro.kernels.ops.dense_matmul_q8``) that XLA fuses under ``jit``. The
kernel is that fusion, one launch a layer in place of ten eager PyTorch
ops; its codes and scales are bitwise the plain version's
(``quant.absmax_scale`` then ``quant.quantize``) on finite inputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import quant
from . import _build

__all__ = ["quantize_rows_q8", "quantize_rows_q8_plain"]


def quantize_rows_q8_plain(h: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same argument and results)."""
    hscale = quant.absmax_scale(h, dim=-1)
    return quant.quantize(h, hscale), hscale


@functools.cache
def _kernel():
    fn = _build.library("quantize_rows_q8").quantize_rows_q8
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_rows_q8(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize activations per row.

    Args:
        h: (b, fan_in) float32, contiguous, fan_in >= 1.

    Returns:
        ``(hq, hscale)``: (b, fan_in) int8 codes and (b, 1) float32
        scales — the ``hq`` and ``hscale`` arguments of ``dmm_q8``.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream.
    """
    dev = h.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"h is on {dev}: the quantizer runs on the CPU "
                         "(plain version) or a CUDA card")
    _build.check_tensor("h", h, torch.float32, 2, dev)
    b, fan_in = h.shape
    if fan_in == 0:
        raise ValueError("h has no columns: a row's scale needs max|h|")
    if dev.type == "cpu":
        return quantize_rows_q8_plain(h)
    hq = torch.empty((b, fan_in), dtype=torch.int8, device=dev)
    hscale = torch.empty((b, 1), dtype=torch.float32, device=dev)
    if b == 0:
        return hq, hscale
    with torch.cuda.device(dev):
        code = _kernel()(h.data_ptr(), hq.data_ptr(), hscale.data_ptr(), b,
                         fan_in, _build.current_stream(dev))
    _build.check_launch("quantize_rows_q8", code)
    _build.count_launch(quantize_rows_q8)
    return hq, hscale


quantize_rows_q8.launches = 0

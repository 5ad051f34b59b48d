"""Symmetric int8 (absmax) quantization of embedding rows.

Counterpart of ``repro.quant`` (``quant.py:41-89``), on torch tensors.
Stores built with ``row_dtype="int8"`` hold their rows as int8 with one
fp32 scale per row; the tiered gathers dequantize inside the kernel
(``kernels/csrc/mtl_gather_tiered.cu``), so the fp32 row exists only in
registers.

Symmetric absmax: ``scale = max|x| / 127`` (the -128 code is never
emitted, so the grid is symmetric around an exact zero) and
``q = clip(round(x / scale), -127, 127)``. All-zero rows get the
``SCALE_EPS`` floor, so they quantize to ``q = 0`` and dequantize to
exactly ``0.0`` — the multi-hot masking zero row stays a true zero.
``torch.round`` rounds half to even, like ``jnp.round``, so codes and
scales are bitwise those of the reference on the same fp32 table.

The per-output-channel helpers of the reference (int8 MLP compute) come
with that slice.
"""

from __future__ import annotations

import torch

__all__ = ["QMAX", "SCALE_EPS", "absmax_scale", "quantize", "dequantize",
           "quantize_rows", "dequantize_rows"]

#: symmetric int8 range [-127, 127]; -128 is deliberately unused
QMAX = 127.0
#: floor for all-zero rows: q = 0 and dequant = 0 exactly
SCALE_EPS = 1e-12


def absmax_scale(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-slice symmetric scale ``max|x| / QMAX`` (keepdim), floored at
    ``SCALE_EPS`` so all-zero slices round-trip to exact zero."""
    # divide by a tensor on x's device: PyTorch's CUDA kernel turns a
    # division by a Python number into a multiply by its reciprocal, which
    # can round the last bit differently from the reference's division
    qmax = torch.tensor(QMAX, dtype=x.dtype, device=x.device)
    s = x.abs().amax(dim=dim, keepdim=True) / qmax
    return s.clamp_min(SCALE_EPS).to(torch.float32)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` as int8; ``scale``
    broadcasts (the keepdim output of :func:`absmax_scale`)."""
    return torch.round(x / scale).clamp_(-QMAX, QMAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale`` in float32."""
    return q.to(torch.float32) * scale


def quantize_rows(table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a (rows, d) table row-wise: ``(q, scale)`` with ``q``
    (rows, d) int8 and ``scale`` (rows, 1) float32."""
    scale = absmax_scale(table, dim=-1)
    return quantize(table, scale), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: (rows, d) int8 × (rows, 1) f32
    -> (rows, d) float32."""
    return dequantize(q, scale)

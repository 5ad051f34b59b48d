"""Symmetric int8 (absmax) quantization of embedding rows, MLP weights
and MLP activations.

Counterpart of ``repro.quant`` (``quant.py:41-111``), on torch tensors.
Stores built with ``row_dtype="int8"`` hold their rows as int8 with one
fp32 scale per row; the tiered gathers dequantize inside the kernel
(``kernels/csrc/mtl_gather_tiered.cu``), so the fp32 row exists only in
registers. Plans compiled with ``compute_dtype="int8"`` hold each MLP
weight as int8 with one fp32 scale per output channel
(:func:`quantize_channels`) and quantize activations per row at every
step (on a card in one kernel, ``kernels/csrc/quantize_rows_q8.cu``,
whose plain version is :func:`absmax_scale` then :func:`quantize`); the
int8 dense kernel (``kernels/csrc/dense_matmul_q8.cu``) dequantizes in its
epilogue.

Symmetric absmax: ``scale = max|x| / 127`` (the -128 code is never
emitted, so the grid is symmetric around an exact zero) and
``q = clip(round(x / scale), -127, 127)``. All-zero rows get the
``SCALE_EPS`` floor, so they quantize to ``q = 0`` and dequantize to
exactly ``0.0`` — the multi-hot masking zero row stays a true zero.
``torch.round`` rounds half to even, like ``jnp.round``, so codes and
scales are bitwise those of the reference on the same fp32 table.
"""

from __future__ import annotations

import torch

__all__ = ["QMAX", "SCALE_EPS", "absmax_scale", "quantize", "dequantize",
           "quantize_rows", "dequantize_rows", "quantize_channels",
           "dequantize_channels"]

#: symmetric int8 range [-127, 127]; -128 is deliberately unused
QMAX = 127.0
#: floor for all-zero rows: q = 0 and dequant = 0 exactly
SCALE_EPS = 1e-12


def absmax_scale(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-slice symmetric scale ``max|x| / QMAX`` (keepdim), floored at
    ``SCALE_EPS`` so all-zero slices round-trip to exact zero."""
    # divide by a tensor on x's device: PyTorch's CUDA kernel turns a
    # division by a Python number into a multiply by its reciprocal, which
    # can round the last bit differently from the reference's division.
    # A device fill, not torch.tensor: that would copy from pageable host
    # memory and hold the stream on every call (the stores quantize every
    # refresh and delta batch with it)
    qmax = torch.full((), QMAX, dtype=x.dtype, device=x.device)
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


def quantize_channels(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize a (fan_in, fan_out) dense weight per output channel (the
    column-wise twin of :func:`quantize_rows`): ``(q, scale)`` with ``q``
    (fan_in, fan_out) int8 and ``scale`` (1, fan_out) float32."""
    scale = absmax_scale(w, dim=0)
    return quantize(w, scale), scale


def dequantize_channels(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_channels`: (fan_in, fan_out) int8 ×
    (1, fan_out) f32 -> (fan_in, fan_out) float32."""
    return dequantize(q, scale)

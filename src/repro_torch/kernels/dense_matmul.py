"""Quantized dense layer with in-kernel dequant (int8 MLP compute) —
``csrc/dense_matmul_q8.cu``.

Counterpart of ``repro.kernels.dense_matmul``:

    out = relu?( (hq · wq) * hscale * wscale + bias )

int8 activations (one scale per row) times int8 weights (one scale per
output channel), summed in int32, then widened, scaled, biased and
rectified in the same pass. The kernel takes the weight transposed,
``wq_t`` (fan_out, fan_in), so that both operands are contiguous along
the summed axis (K-major, as int8 ``wgmma`` reads them); :func:`pack_weight`
makes it once, when the graph is built, as the reference bakes its int8
weight at compile time. The kernel's TMA copies need rows whose length
is a multiple of 16 bytes and a 16-byte-aligned base: :func:`pad_k`
copies any other operand once into a zero-padded buffer, which adds
nothing to the int32 sum.

The epilogue is ``fma(fp32(acc) * hscale, wscale, bias)`` with the
product rounded once and the multiply-add fused — what the reference's
jitted epilogue compiles to. The plain version computes it exactly: the
int32 sum as an fp64 product of the codes (exact below 2**53; fp32 is not,
since |acc| reaches 127² · fan_in > 2**24), and the fma in fp64, where the
product of two floats is exact and only the final sum rounds twice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import ref_dense_matmul_q8

__all__ = ["dmm_q8", "dmm_q8_plain", "pack_weight", "pad_k",
           "MAX_FAN_IN"]

#: largest fan_in whose int32 sum of int8 products cannot overflow
MAX_FAN_IN = (2**31 - 1) // (127 * 127)


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """The kernel's weight layout: (fan_in, fan_out) int8 codes ->
    (fan_out, fan_in), contiguous."""
    return wq.t().contiguous()


def pad_k(t: torch.Tensor, k_pad: int) -> torch.Tensor:
    """``t`` (rows, K) int8 as the kernel's TMA copies take it: contiguous
    rows of ``k_pad`` bytes (a multiple of 16, at least K) from a
    16-byte-aligned base. Returns ``t`` itself when it already is, else a
    copy whose columns past K are zero."""
    rows, k = t.shape
    if k == k_pad and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((rows, k_pad))
    out[:, :k] = t
    return out


def dmm_q8_plain(hq: torch.Tensor, hscale: torch.Tensor, wq_t: torch.Tensor,
                 wscale: torch.Tensor, bias: torch.Tensor, *,
                 relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments)."""
    return ref_dense_matmul_q8(hq, hscale, wq_t.t(), wscale, bias, relu=relu)


@functools.cache
def _kernel():
    fn = _build.library("dense_matmul_q8").dmm_q8
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 \
        + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_row(name: str, t: torch.Tensor, shape: tuple[int, int],
               dev: torch.device) -> None:
    _build.check_tensor(name, t, torch.float32, 2, dev)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")


def dmm_q8(hq: torch.Tensor, hscale: torch.Tensor, wq_t: torch.Tensor,
           wscale: torch.Tensor, bias: torch.Tensor, *,
           relu: bool = True) -> torch.Tensor:
    """Quantized dense layer.

    Args:
        hq:     (b, fan_in) int8 per-row quantized activations.
        hscale: (b, 1) float32 per-row activation scales.
        wq_t:   (fan_out, fan_in) int8 per-channel quantized weights, the
                transpose of the reference's ``wq`` (:func:`pack_weight`).
        wscale: (1, fan_out) float32 per-channel weight scales.
        bias:   (1, fan_out) float32.
        relu:   apply the ReLU epilogue (off for pre-logit layers).

    Returns:
        (b, fan_out) float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, at any shape (ragged ones through :func:`pad_k`).
    """
    dev = hq.device
    _build.check_tensor("hq", hq, torch.int8, 2, dev)
    _build.check_tensor("wq_t", wq_t, torch.int8, 2, dev)
    b, fan_in = hq.shape
    fan_out = wq_t.shape[0]
    if wq_t.shape[1] != fan_in:
        raise ValueError(f"wq_t has shape {tuple(wq_t.shape)} for fan_in "
                         f"{fan_in}")
    if fan_in > MAX_FAN_IN:
        raise ValueError(f"fan_in {fan_in} > {MAX_FAN_IN}: the int32 sum "
                         "could overflow")
    _check_row("hscale", hscale, (b, 1), dev)
    _check_row("wscale", wscale, (1, fan_out), dev)
    _check_row("bias", bias, (1, fan_out), dev)
    if dev.type == "cpu":
        return dmm_q8_plain(hq, hscale, wq_t, wscale, bias, relu=relu)
    out = torch.empty((b, fan_out), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    k_pad = max(16, -(-fan_in // 16) * 16)     # fan_in 0: a zero sum
    hq, wq_t = pad_k(hq, k_pad), pad_k(wq_t, k_pad)
    code = _kernel()(hq.data_ptr(), hscale.data_ptr(), wq_t.data_ptr(),
                     wscale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                     b, fan_out, k_pad, int(relu), _build.current_stream(dev))
    _build.check_launch("dmm_q8", code)
    _build.count_launch(dmm_q8)
    return out


dmm_q8.launches = 0

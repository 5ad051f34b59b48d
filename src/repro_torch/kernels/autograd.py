"""Autograd for the kernels on the CTR training path: K1, K9, K10, K11.

A kernel wrapper writes its output through ``ctypes`` into a tensor it
allocated, so on CUDA that output has no ``grad_fn``: a loss computed
through it would give no gradient, and raise no error, to anything
upstream of the kernel (the mega-table, the cross weights). Each
:class:`torch.autograd.Function` here runs the wrapper as its forward
(the kernel on CUDA, which launches or raises; the plain version on the
CPU) and a plain PyTorch formula as its backward. The reference has no
backward kernel either: JAX differentiates its jnp path.

The entry points (:func:`mtl_gather`, :func:`fused_cross_v2`,
:func:`fused_cross_v1`, :func:`fused_fm_second_order`) take the Function
when autograd is on and an input requires grad, on either device, and
call the wrapper directly otherwise, so serving pays nothing for them.
The wrappers' ``launches`` counters count forward launches only.

K1's table gradient sorts the b·k clamped rows the forward read
(stably) and sums each row's contributions in their original order with
``torch.segment_reduce`` (one thread a run and column): the first entry
of a row's run gets the run's sum, the others 0. Those b·k sums are then
added into a zero table with ``index_add_``: a row receives one sum and
zeros, and adding zeros is exact in any order, so two identical calls
give bitwise the same gradient, on the card and on the CPU alike, and a
resumed run equals an unbroken one. Adding the raw contributions with
``index_add_`` or ``index_put_(accumulate=True)`` would sum floats in an
order that changes from run to run (atomics on the card, threads on the
CPU). Every shape is fixed by b·k and the table, so the backward never
waits on the host.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from . import fused_cross as _cross
from . import fused_fm as _fm
from . import multi_table_lookup as _mtl

__all__ = ["mtl_gather", "fused_cross_v2", "fused_cross_v1",
           "fused_fm_second_order", "gather_table_grad", "GatherFunction",
           "CrossV2Function", "CrossV1Function", "FMSecondOrderFunction"]


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def gather_table_grad(ids: torch.Tensor, offsets: torch.Tensor,
                      grad: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The ``(n_rows, d)`` table gradient of K1 for the output gradient
    ``grad`` (b, k·d): zeros, and at every clamped row the forward read
    the sum of its (sample, field) slices of ``grad`` in (sample, field)
    order."""
    b, k = ids.shape
    rows = ids.to(torch.int64) + offsets.to(torch.int64)[None, :]
    rows, order = torch.sort(rows.clamp_(0, n_rows - 1).reshape(-1),
                             stable=True)
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    counts = torch.zeros(n_rows, dtype=torch.int64, device=rows.device)
    counts.index_add_(0, rows, torch.ones_like(rows))
    lengths = torch.where(first, counts[rows], 0)
    d = grad.shape[1] // k
    # unsafe: the lengths sum to b·k by construction; the checks would
    # read them on the host
    sums = torch.segment_reduce(grad.reshape(b * k, d)[order], "sum",
                                lengths=lengths, unsafe=True)
    out = torch.zeros((n_rows, d), dtype=grad.dtype, device=grad.device)
    return out.index_add_(0, rows, sums)


class GatherFunction(torch.autograd.Function):
    """K1 ``mtl_gather`` with the table's gradient."""

    @staticmethod
    def forward(ctx, ids, offsets, table):
        ctx.save_for_backward(ids, offsets)
        ctx.n_rows = table.shape[0]
        return _mtl.mtl_gather(ids, offsets, table)

    @staticmethod
    def backward(ctx, grad):
        ids, offsets = ctx.saved_tensors
        with record_function("mtl_gather_backward"):
            return None, None, gather_table_grad(ids, offsets, grad,
                                                 ctx.n_rows)


class CrossV2Function(torch.autograd.Function):
    """K9 ``x0 * xw_plus + x``: ``dx0 = g·xw_plus``, ``dxw = g·x0``,
    ``dx = g``. Given ``x0`` as ``x`` too (layer 0), autograd adds both
    of its gradients."""

    @staticmethod
    def forward(ctx, x0, xw_plus, x):
        ctx.save_for_backward(x0, xw_plus)
        return _cross.fused_cross_v2(x0, xw_plus, x)

    @staticmethod
    def backward(ctx, g):
        x0, xw_plus = ctx.saved_tensors
        return g * xw_plus, g * x0, g


class CrossV1Function(torch.autograd.Function):
    """K10 ``x0 * xlw + bias + x``: ``dx0 = g·xlw``, ``dxlw = Σ_D g·x0``,
    ``dbias = Σ_b g``, ``dx = g``."""

    @staticmethod
    def forward(ctx, x0, xlw, bias, x):
        ctx.save_for_backward(x0, xlw)
        return _cross.fused_cross_v1(x0, xlw, bias, x)

    @staticmethod
    def backward(ctx, g):
        x0, xlw = ctx.saved_tensors
        return (g * xlw, (g * x0).sum(dim=1, keepdim=True), g.sum(dim=0),
                g)


class FMSecondOrderFunction(torch.autograd.Function):
    """K11 ``0.5·Σ_d[(Σ_k v)² − Σ_k v²]`` (b, 1):
    ``dv[b, k, :] = g[b]·(Σ_k v[b, :, :] − v[b, k, :])``."""

    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return _fm.fused_fm_second_order(v)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return g[:, :, None] * (v.sum(dim=1, keepdim=True) - v)


def mtl_gather(ids: torch.Tensor, offsets: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    """K1, differentiable in ``table``."""
    if _needs_grad(table):
        return GatherFunction.apply(ids, offsets, table)
    return _mtl.mtl_gather(ids, offsets, table)


def fused_cross_v2(x0: torch.Tensor, xw_plus: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """K9, differentiable in every operand."""
    if _needs_grad(x0, xw_plus, x):
        return CrossV2Function.apply(x0, xw_plus, x)
    return _cross.fused_cross_v2(x0, xw_plus, x)


def fused_cross_v1(x0: torch.Tensor, xlw: torch.Tensor, bias: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """K10, differentiable in every operand."""
    if _needs_grad(x0, xlw, bias, x):
        return CrossV1Function.apply(x0, xlw, bias, x)
    return _cross.fused_cross_v1(x0, xlw, bias, x)


def fused_fm_second_order(v: torch.Tensor) -> torch.Tensor:
    """K11, differentiable in ``v``."""
    if _needs_grad(v):
        return FMSecondOrderFunction.apply(v)
    return _fm.fused_fm_second_order(v)

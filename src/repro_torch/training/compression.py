"""Gradient compression for the data-parallel reduction.

Counterpart of ``repro.training.compression``: an int8 block-quantized
mean over the ranks of a mesh axis. The ranks agree on one scale per
block of ``BLOCK`` values (the max over ranks of each rank's
``max|block| / QMAX``, taken before quantizing and floored at
``SCALE_EPS``), quantize locally to int8, sum the int8 codes widened to
int32 (the wire carries a quarter of fp32's bytes), and dequantize with
the shared scale divided by the rank count. 8-bit rounding error only:
within one quantization step of the exact mean per element.

The port drives every rank from one process (``repro_torch.distributed``
is single-controller): a rank is a position along the mesh axis, its
values live on that position's device, and the codes travel to the
first rank's device for the sum. The quantize and dequantize arithmetic
is ``repro_torch.quant``'s, the codepath of the int8 embedding rows.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from repro_torch import quant
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import P, Placed, place, tree_map

__all__ = ["compressed_psum_mean", "make_compressed_dp_step", "BLOCK"]

BLOCK = 256


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.to(torch.float32).reshape(-1)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK)) \
        .reshape(-1, BLOCK)


def compressed_psum_mean(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The mean of ``xs`` (one tensor of one shape per rank, each on its
    rank's device) through the int8 wire format, on the first rank's
    device, in the first tensor's dtype."""
    if not xs:
        raise ValueError("no ranks to reduce over")
    dev, dtype, shape = xs[0].device, xs[0].dtype, xs[0].shape
    blocks = [_blocks(x) for x in xs]
    scale = None
    for b in blocks:
        qmax = torch.full((), quant.QMAX, dtype=torch.float32,
                          device=b.device)
        local = (b.abs().amax(dim=1, keepdim=True) / qmax).to(dev)
        scale = local if scale is None else torch.maximum(scale, local)
    scale = scale.clamp_min(quant.SCALE_EPS)
    total = None
    for b in blocks:
        q = quant.quantize(b, scale.to(b.device)).to(torch.int32).to(dev)
        total = q if total is None else total + q
    ranks = torch.full((), float(len(xs)), dtype=torch.float32, device=dev)
    out = (quant.dequantize(total, scale) / ranks).reshape(-1)
    return out[:shape.numel()].reshape(shape).to(dtype)


def _flatten(tree: Any) -> list[torch.Tensor]:
    leaves: list = []
    tree_map(leaves.append, tree)
    return leaves


def _rebuild(tree: Any, leaves: list) -> Any:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _rank_rows(x, mesh: Mesh, pos: tuple[int, ...], r: int, n: int
               ) -> torch.Tensor:
    """Rank ``r``'s rows of a batch leaf on its device: a placed leaf's
    own shard, or the ``r``-th of ``n`` equal row blocks of a tensor."""
    if isinstance(x, Placed):
        return x.local(pos)
    rows = x.shape[0] // n
    if rows * n != x.shape[0]:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                         f"over {n} ranks")
    return x[r * rows:(r + 1) * rows].to(mesh.devices[pos])


def make_compressed_dp_step(loss_fn: Callable, mesh: Mesh,
                            axis: str = "data") -> Callable:
    """A data-parallel gradient step whose reduction is
    :func:`compressed_psum_mean`: ``step(params, batch) -> (loss, grads)``
    with ``params`` a tree of tensors (replicated: each rank's device gets
    its copy, none on the device that holds them), ``batch`` a tree of
    tensors split by rows over ``axis`` (or :class:`Placed` over it), and
    ``loss_fn(params, batch)`` a scalar. ``loss`` is the rank mean of the
    local losses, ``grads`` the compressed mean of the local gradients,
    both on the first rank's device."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    names = mesh.axis_names
    n = mesh.shape[axis]
    positions = [tuple(r if a == axis else 0 for a in names)
                 for r in range(n)]

    def step(params: Any, batch: Any) -> tuple[torch.Tensor, Any]:
        leaves = _flatten(params)
        placed = [place(p.detach(), mesh, P()) for p in leaves]
        losses, grads = [], []
        for r, pos in enumerate(positions):
            local = [p.local(pos).detach().requires_grad_(True)
                     for p in placed]
            rows = tree_map(lambda x: _rank_rows(x, mesh, pos, r, n),
                            batch)
            with torch.enable_grad():
                loss = loss_fn(_rebuild(params, local), rows)
                grads.append(torch.autograd.grad(loss, local))
            losses.append(loss.detach())
        dev = losses[0].device
        total = losses[0]
        for loss in losses[1:]:
            total = total + loss.to(dev)
        loss = total / torch.full((), float(n), dtype=total.dtype,
                                  device=dev)
        mean = [compressed_psum_mean([g[i] for g in grads])
                for i in range(len(leaves))]
        return loss, _rebuild(params, mean)
    return step

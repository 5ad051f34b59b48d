"""What the plain references share: the weight layout, the gather, the
matrix product at a stated precision, and scoring in blocks of rows.

Plain PyTorch, fp32. Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["Leaf", "table", "dense", "gather", "matmul", "round_tf32",
           "scores", "offsets"]

PRECISIONS = ("fp32", "tf32")


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One weight tensor: where it sits in the model's tree (``path``, as
    in ``"mlp.0.w"``), its shape, and the law it is drawn from: ``table``
    (normal with ``std``, rows from ``zero_row`` on set to 0) or ``dense``
    (normal with ``std``)."""
    path: str
    shape: tuple[int, ...]
    law: str
    std: float
    zero_row: int | None = None


def table(path: str, field_sizes, dim: int) -> Leaf:
    n = int(sum(field_sizes))
    return Leaf(path, (n + 1, dim), "table", 0.05, zero_row=n)


def dense(prefix: str, fan_in: int, fan_out: int) -> list[Leaf]:
    """A ``h @ w + b`` layer: Glorot-normal ``w``, small normal ``b``."""
    return [Leaf(f"{prefix}.w", (fan_in, fan_out), "dense",
                 math.sqrt(2.0 / (fan_in + fan_out))),
            Leaf(f"{prefix}.b", (fan_out,), "dense", 0.01)]


def offsets(field_sizes, device) -> torch.Tensor:
    off = np.concatenate([[0], np.cumsum(field_sizes)[:-1]])
    return torch.as_tensor(off, dtype=torch.int64, device=device)


def gather(tab: torch.Tensor, ids: torch.Tensor,
           off: torch.Tensor) -> torch.Tensor:
    """(b, k) ids -> (b, k, d) rows of the concatenated table."""
    return tab[ids.to(torch.int64) + off[None, :]]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), to nearest, ties to even."""
    i = x.contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + 0xFFF + lsb, ~0x1FFF)
    return i.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in fp32 (the caller has TF32 off), or in TF32: on a card
    by the library's own TF32 path, on the CPU with both operands rounded
    to TF32 and the products summed in fp32."""
    if precision == "fp32":
        return a @ b
    if precision != "tf32":
        raise ValueError(f"precision must be one of {PRECISIONS}")
    if a.is_cuda:
        flags = torch.backends.cuda.matmul
        before = flags.allow_tf32
        flags.allow_tf32 = True
        try:
            return a @ b
        finally:
            flags.allow_tf32 = before
    return round_tf32(a) @ round_tf32(b)


@torch.no_grad()
def scores(logits_fn, weights: dict, ids: np.ndarray, cfg: dict,
           precision: str = "fp32", block: int = 8192) -> np.ndarray:
    """Sigmoid scores of every row of ``ids``, ``block`` rows at a time."""
    dev = next(iter(weights.values())).device
    off = offsets(cfg["field_sizes"], dev)
    out = []
    for lo in range(0, len(ids), block):
        x = torch.from_numpy(np.ascontiguousarray(ids[lo:lo + block])).to(dev)
        logit = logits_fn(weights, x, off, cfg, precision)
        out.append(torch.sigmoid(logit.reshape(-1)).cpu().numpy())
    return np.concatenate(out) if out else np.empty((0,), np.float32)

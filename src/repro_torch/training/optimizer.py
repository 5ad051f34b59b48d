"""AdamW with dtype-configurable moment states and global-norm clipping.

Counterpart of ``repro.training.optimizer``, in the reference's order of
operations (``optimizer.py:70-102``): clip the gradients by their global
norm, update the moments in float32, ``mhat / (sqrt(vhat) + eps)``, add
the weight decay to that step, then ``p - lr·step``. Every divisor is a
0-d tensor on the leaf's device, so the card divides where the reference
divides (a Python divisor would become a multiply by its reciprocal).
``state_dtype="bfloat16"`` keeps the moments in bf16, as the reference
can. ``torch.optim.AdamW`` is not used: it rounds in another order and
has neither the bf16 state nor the clip in the same step.

A parameter tree is the reference's nesting of dicts and lists; its
leaves are tensors. :func:`adamw_update` writes the new parameters and
moments into the tree's own tensors (a model's buffers, from
``CTRModel.param_tree``) under ``torch.no_grad()``.

A split train step's leaves are ``Placed`` values
(``TensorParallel.param_tree``, the state laid out by the cell's
``state_specs``): the moments are placed as their parameters, each
distinct piece (one tensor a device and slice) is updated once with its
gradient piece on its own device, and the global norm sums each distinct
slice's squares once, in leaf order then slice order, on the mesh's
first device. The norm's partial sums and the clip scale move between
devices as 0-d tensors, outside ``TensorParallel.moved``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

import torch

from repro_torch.distributed.sharding import Placed, pieces

__all__ = ["AdamWConfig", "TrainState", "adamw_init", "adamw_update",
           "global_norm", "tree_flatten", "tree_map"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0
    state_dtype: str = "float32"     # "bfloat16" = optimizer-state compression


@dataclasses.dataclass
class TrainState:
    """``step`` is a 0-d int32 tensor on the CPU (the reference's int32
    scalar); ``params``, ``m`` and ``v`` are trees of the same shape."""
    step: torch.Tensor
    params: Any
    m: Any
    v: Any


def _children(tree: Any) -> list[tuple[Any, Any]] | None:
    """(key, subtree) pairs in JAX's flattening order — a ``TrainState``
    as ``(step, params, m, v)``, dict keys sorted, lists in order — or
    None for a leaf."""
    if isinstance(tree, TrainState):
        return list(enumerate((tree.step, tree.params, tree.m, tree.v)))
    if isinstance(tree, dict):
        return sorted(tree.items(), key=lambda kv: kv[0])
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def tree_flatten(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) for every leaf, in the reference's leaf order."""
    children = _children(tree)
    if children is None:
        yield path, tree
        return
    for key, sub in children:
        yield from tree_flatten(sub, path + (key,))


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, TrainState):
        return TrainState(*(tree_map(fn, *parts) for parts in zip(
            *[(t.step, t.params, t.m, t.v) for t in (tree, *rest)])))
    if isinstance(tree, dict):
        return {key: tree_map(fn, sub, *(r[key] for r in rest))
                for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def adamw_init(params: Any, cfg: AdamWConfig) -> TrainState:
    dt = getattr(torch, cfg.state_dtype)

    def zeros(p):
        if isinstance(p, Placed):
            return p.like(zeros, dt)
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params,
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _squares(x) -> Iterator[torch.Tensor]:
    """A leaf's fp32 sum of squares: a placed leaf's per distinct slice,
    slices in order, each on the mesh's first device."""
    if isinstance(x, Placed):
        for holders in x.holders().values():
            t = x.local(holders[0])
            yield torch.sum(torch.square(t.to(torch.float32))).to(
                x.mesh.first_device)
    else:
        yield torch.sum(torch.square(x.to(torch.float32)))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in leaf order) of each leaf's sum of
    squares, in float32."""
    return torch.sqrt(sum(sq for _, x in tree_flatten(tree)
                          for sq in _squares(x)))


def _f32(x: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def adamw_update(state: TrainState, grads: Any,
                 cfg: AdamWConfig) -> tuple[TrainState, dict]:
    """One AdamW step: writes the new parameters, ``m`` and ``v`` into
    ``state``'s tensors and returns the state at ``step + 1`` with
    ``{"grad_norm": ...}``."""
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.clamp_max(
        _f32(cfg.clip_norm, dev) / torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state.step + 1
    t = step.to(dev, torch.float32)
    bc1 = 1.0 - _f32(cfg.b1, dev) ** t
    bc2 = 1.0 - _f32(cfg.b2, dev) ** t

    def upd(p, g, m, v):
        dev = p.device
        g = g.to(torch.float32) * scale.to(dev)
        m32 = m.to(torch.float32) * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.to(torch.float32) * cfg.b2 + (1 - cfg.b2) * g * g
        mhat = m32 / bc1.to(dev)
        vhat = v32 / bc2.to(dev)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - cfg.lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    def upd_leaf(*leaves):
        for p, g, m, v in zip(*map(pieces, leaves), strict=True):
            upd(p, g, m, v)

    tree_map(upd_leaf, state.params, grads, state.m, state.v)
    return (dataclasses.replace(state, step=step), {"grad_norm": gnorm})

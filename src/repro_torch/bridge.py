"""Load a reference CTR parameter tree into a port model.

The reference keeps parameters as a nested tree of dicts and lists
(``{"emb": {"mega_table": ...}, "mlp": [{"w", "b"}, ...], ...}``); the
port keeps them as buffers of an ``nn.Module``. :func:`load_jax_params`
walks the tree — every leaf through ``np.asarray``, so any array type with
numpy conversion works — and copies each leaf into the buffer at the same
path: the first key names an embedding collection's store (``"emb"``,
``"fm_w"``, ``"wide"``) or a model attribute, and the rest walks
attributes and list indices. Every buffer of the model (the collections'
derived offsets aside) must be written exactly once, with the same shape.

Tests use this to hold the port against the reference on the same
parameters; the port's own weights come from ``CTRModel.init``.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["load_jax_params"]


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (i,))
    else:
        yield path, tree


def _target(model, path: tuple) -> torch.Tensor:
    head, *rest = path
    collections = model.embedding_collections()
    obj = collections[head].store if head in collections \
        else getattr(model, head)
    for key in rest:
        obj = obj[key] if isinstance(key, int) else getattr(obj, key)
    if not isinstance(obj, torch.Tensor):
        raise TypeError(f"parameter path {path} names a "
                        f"{type(obj).__name__}, not a tensor")
    return obj


@torch.no_grad()
def load_jax_params(model, params: dict):
    """Copy the reference parameter tree ``params`` into ``model``'s
    buffers (on whatever device the model lives). Returns ``model``."""
    derived = {id(c.offsets) for c in model.embedding_collections().values()}
    pending = {id(t): name for name, t in model.named_buffers()
               if id(t) not in derived}
    for path, leaf in _leaves(params):
        try:
            t = _target(model, path)
        except (AttributeError, IndexError, KeyError) as err:
            raise KeyError(f"reference parameter {path} has no counterpart "
                           f"in {type(model).__name__}") from err
        arr = np.asarray(leaf)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"parameter {path}: shape {arr.shape} != "
                             f"{tuple(t.shape)}")
        if pending.pop(id(t), None) is None:
            raise ValueError(f"parameter {path} written twice")
        t.copy_(torch.tensor(arr, dtype=t.dtype))
    if pending:
        raise ValueError(f"buffers missing from the reference tree: "
                         f"{sorted(pending.values())}")
    return model

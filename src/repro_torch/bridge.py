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
A ``CachedStore`` subtree (``backing``, ``cache``, ``slot_of_row``, and
for int8 rows ``backing_scale``/``cache_scale``) lands in the store's
buffers of the same names, int8 and int32 leaves included; each store
then re-derives its host state from what was loaded (``resync``), so a
cached store's ``observe`` and ``apply_deltas`` count against the loaded
index map. A ``HostBackedStore`` subtree (``cache``, ``slot_of_row``,
``staging``, ``staging_slot_of_row``, and for int8 rows ``cache_scale`` and
``staging_scale``) lands the same way, and the store's ``resync`` takes its
cache map and its staging area (rows, scales and map) from the loaded
buffers. The host backing is not a parameter in either package: hand it
over before loading, with ``store.adopt({"mega_table": table})`` from the
same dense table or from the reference store's ``host_view()``, or for
int8 rows ``store.adopt({"backing": host_view(), "backing_scale":
host_scale_view()})``.

:func:`load_lm_params` does the same for an LM of the zoo: the
reference stacks every layer's leaves along a leading L
(``layers``, ``mamba``, ``encoder``, ``decoder``), and each slice lands
in the module of that index of the model's ``nn.ModuleList`` of the same
name; the rest walks attributes (``shared.attn.wq``). Derived,
non-persistent buffers (an attention's RoPE table) are not parameters.
:func:`stacked_lm_tree` is the inverse: a port LM tree
(``param_tree()``, whose stacked groups are lists of per-layer dicts, or
a tree of its gradients) in the reference's stacked numpy layout. An LM
checkpoint of the port therefore keeps the port's per-layer layout; this
mapping is how its leaves meet the reference's.

Tests use these to hold the port against the reference on the same
parameters; the port's own weights come from each model's ``init``.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

__all__ = ["load_jax_params", "load_lm_params", "stacked_lm_tree"]


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (i,))
    else:
        yield path, tree


def _as_lists(tree: dict):
    """Nested dicts whose keys are all list indices become lists."""
    if not isinstance(tree, dict):
        return tree
    out = {key: _as_lists(sub) for key, sub in tree.items()}
    if out and all(key.isdigit() for key in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def _walk(obj, keys, path: tuple) -> torch.Tensor:
    """``obj`` down ``keys`` (attributes, list indices); ``path`` names the
    leaf in errors."""
    for key in keys:
        obj = obj[key] if isinstance(key, int) else getattr(obj, key)
    if not isinstance(obj, torch.Tensor):
        raise TypeError(f"parameter path {path} names a "
                        f"{type(obj).__name__}, not a tensor")
    return obj


def _target(model, path: tuple) -> torch.Tensor:
    head, *rest = path
    collections = model.embedding_collections()
    obj = collections[head].store if head in collections \
        else getattr(model, head)
    return _walk(obj, rest, path)


def _copy_once(pending: dict, path: tuple, t: torch.Tensor,
               arr: np.ndarray) -> None:
    """Copy ``arr`` into ``t``, which must have its shape and still be in
    ``pending`` (buffer ids not yet written)."""
    if tuple(arr.shape) != tuple(t.shape):
        raise ValueError(f"parameter {path}: shape {arr.shape} != "
                         f"{tuple(t.shape)}")
    if pending.pop(id(t), None) is None:
        raise ValueError(f"parameter {path} written twice")
    t.copy_(torch.tensor(arr, dtype=t.dtype))


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
        _copy_once(pending, path, t, np.asarray(leaf))
    if pending:
        raise ValueError(f"buffers missing from the reference tree: "
                         f"{sorted(pending.values())}")
    for coll in model.embedding_collections().values():
        coll.store.resync()
    return model


STACKED = ("layers", "mamba", "encoder", "decoder")


def _host_array(leaf) -> np.ndarray:
    arr = np.asarray(leaf)
    # numpy has no bfloat16 of its own (ml_dtypes' is not torch's): widen
    # to fp32, which the copy narrows back exactly
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


@torch.no_grad()
def load_lm_params(model, params: dict):
    """Copy the reference LM parameter tree ``params`` into ``model``'s
    buffers, unstacking the leading L of ``layers``, ``mamba``,
    ``encoder`` and ``decoder`` into the per-layer modules. Every
    parameter buffer is written exactly once. Returns ``model``."""
    pending = {id(t): name
               for name, t in model.state_dict(keep_vars=True).items()}
    for path, leaf in _leaves(params):
        arr = _host_array(leaf)
        try:
            if path[0] in STACKED:
                mods = getattr(model, path[0])
                if arr.shape[:1] != (len(mods),):
                    raise ValueError(f"parameter {path}: shape {arr.shape} "
                                     f"does not stack {len(mods)} layers")
                targets = [(_walk(m, path[1:], path), arr[i])
                           for i, m in enumerate(mods)]
            else:
                targets = [(_walk(model, path, path), arr)]
        except (AttributeError, IndexError, KeyError) as err:
            raise KeyError(f"reference parameter {path} has no counterpart "
                           f"in {type(model).__name__}") from err
        for t, a in targets:
            _copy_once(pending, path, t, a)
    if pending:
        raise ValueError(f"buffers missing from the reference tree: "
                         f"{sorted(pending.values())}")
    return model


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _nest(pairs) -> dict:
    """{path: leaf} back into nested dicts."""
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def stacked_lm_tree(tree: dict) -> dict:
    """A port LM tree in the reference's layout: each list of per-layer
    dicts under a ``STACKED`` key stacked along a leading L, every leaf a
    numpy array (bfloat16 widened to float32, exactly)."""
    out: dict = {}
    for key, sub in tree.items():
        if key in STACKED and isinstance(sub, list):
            per_layer = [dict(_leaves(layer)) for layer in sub]
            out[key] = _nest((path, np.stack([_numpy(layer[path])
                                              for layer in per_layer]))
                             for path in per_layer[0])
        elif isinstance(sub, dict):
            out[key] = _nest((path, _numpy(leaf))
                             for path, leaf in _leaves(sub))
        else:
            out[key] = _numpy(sub)
    return out

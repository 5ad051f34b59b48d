"""Step-atomic checkpointing in the reference's on-disk format.

Counterpart of ``repro.training.checkpoint``. Layout: ``<dir>/step_<N>/``
holding one ``leaf_XXXXX.npy`` per leaf, in the reference's leaf order
(dict keys sorted, lists in order, a ``TrainState`` as ``(step, params,
m, v)``), plus ``manifest.json`` (``step`` and, per leaf, ``key`` — the
"/"-joined path —, ``file``, ``shape``, ``dtype``). Writes go to
``<dir>/.tmp_step_<N>`` and are renamed into place, so a preempted writer
never corrupts the latest checkpoint. A checkpoint of either package
restores into the other. bfloat16 leaves are stored as the reference
stores them: 2-byte void ``.npy`` arrays whose manifest dtype says
"bfloat16".

:func:`restore_checkpoint` writes into the target's own tensors (a
model's buffers stay the model's), on whatever device they live.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from .optimizer import tree_flatten

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_BF16 = "bfloat16"


def _leaf_key(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    leaf = leaf.detach()
    if leaf.dtype == torch.bfloat16:
        return (leaf.view(torch.int16).cpu().numpy().view(np.dtype("V2")),
                _BF16)
    arr = leaf.cpu().numpy()
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomic write of ``tree`` under step ``step``. Returns final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(tree_flatten(tree)):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "key": _leaf_key(path), "file": fname,
            "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic on POSIX
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            # only count completed (manifest present) checkpoints
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                steps.append(int(name.split("_", 1)[1]))
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, step: int, target: Any) -> Any:
    """Copy checkpoint ``step`` into the tensors of ``target`` (a tree of
    the same keys and shapes, e.g. a ``TrainState``), casting to each
    tensor's dtype. Returns ``target``."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = list(tree_flatten(target))
    if len(manifest["leaves"]) != len(flat):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target has "
            f"{len(flat)} — structure mismatch")
    for meta, (tpath, tgt) in zip(manifest["leaves"], flat):
        if meta["key"] != _leaf_key(tpath):
            raise ValueError(f"checkpoint leaf {meta['key']!r} where the "
                             f"target has {_leaf_key(tpath)!r}")
        if not isinstance(tgt, torch.Tensor):
            raise TypeError(f"target leaf {meta['key']!r} is a "
                            f"{type(tgt).__name__}, not a tensor")
        arr = np.load(os.path.join(path, meta["file"]))
        if list(arr.shape) != list(tgt.shape):
            raise ValueError(f"leaf {meta['key']}: checkpoint shape "
                             f"{arr.shape} != target {tuple(tgt.shape)}")
        tgt.copy_(_to_tensor(arr, meta["dtype"]))
    return target

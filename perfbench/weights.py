"""Weights drawn from the seed on the device, in a few large calls.

Every table is one ``normal_`` call; every other tensor is a slice of one
flat normal draw, scaled by its law's ``std``. The draw fills either the
program's own buffers (``out``) or fresh tensors for the reference, in
the same order from the same generator, so both get the same values
without either reading the other's.
"""

from __future__ import annotations

import torch

from perfbench.ids import sub_seed

__all__ = ["draw", "flatten"]


def flatten(tree, prefix: str = "") -> dict:
    """``{"mlp": [{"w": t}]}`` -> ``{"mlp.0.w": t}``."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for key, sub in items:
        out.update(flatten(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


@torch.no_grad()
def draw(layout: list, seed: int, device, out: dict | None = None) -> dict:
    """``path -> tensor`` for every leaf of ``layout``, drawn from
    ``seed``. With ``out`` (``path -> tensor``, exactly the layout's
    paths and shapes), its tensors are filled in place and returned."""
    device = torch.device(device)
    if out is not None:
        want = {leaf.path: leaf.shape for leaf in layout}
        have = {p: tuple(t.shape) for p, t in out.items()}
        if want != have:
            raise ValueError(f"the program's tensors {sorted(have.items())} "
                             f"are not the layout {sorted(want.items())}")
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    result = {}
    for leaf in layout:
        if leaf.law != "table":
            continue
        t = out[leaf.path] if out is not None else torch.empty(
            leaf.shape, dtype=torch.float32, device=device)
        t.normal_(0.0, leaf.std, generator=gen)
        t[leaf.zero_row:] = 0.0
        result[leaf.path] = t
    rest = [leaf for leaf in layout if leaf.law != "table"]
    n = sum(torch.Size(leaf.shape).numel() for leaf in rest)
    flat = torch.empty(n, dtype=torch.float32, device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    pos = 0
    for leaf in rest:
        m = torch.Size(leaf.shape).numel()
        piece = flat[pos:pos + m].view(leaf.shape) * leaf.std
        pos += m
        if out is not None:
            out[leaf.path].copy_(piece)
            piece = out[leaf.path]
        result[leaf.path] = piece
    return result

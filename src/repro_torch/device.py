"""Device resolution shared by every entry point of the package."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: torch.device | str | None = None, *,
                   meta: bool = False) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says
    otherwise. Without a card, CUDA raises — the package never moves to
    the CPU on its own. ``meta=True`` also accepts ``"meta"``: shapes and
    dtypes with no storage, for the LM zoo's cells and production meshes
    (``launch/steps.py``), which allocate nothing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu") + (("meta",) if meta else ()):
        raise ValueError(f"unsupported device {dev}")
    return dev

"""Device resolution shared by every entry point of the package, and
:func:`cpu_trig`, the CPU's sine and cosine made safe on their first
call."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "cpu_trig"]

#: (function, dtype) pairs whose CPU kernel has run once on one thread
_TRIG_READY: set = set()


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


def cpu_trig(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for ``fn`` ``torch.sin`` or ``torch.cos``. On the CPU the
    process's first call of each, on a tensor large enough that ATen
    splits it over its threads, can return a few elements ~1e-4 off (the
    vector math library behind ATen's CPU sin and cos sets itself up
    lazily, and threads that enter it together race; a later call is
    right): the first call for each (function, dtype) here runs once on
    a single element, on this thread, before ``x``. Other devices call
    ``fn`` as it is."""
    if x.device.type == "cpu" and (fn, x.dtype) not in _TRIG_READY:
        fn(torch.zeros(1, dtype=x.dtype))
        _TRIG_READY.add((fn, x.dtype))
    return fn(x)

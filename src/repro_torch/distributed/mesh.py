"""Device meshes for the single-controller multi-device path.

Counterpart of ``repro.compat.make_mesh`` and
``repro.launch.mesh.make_test_mesh``. A :class:`Mesh` is an array of
explicit ``torch.device``\\ s with axis names, driven from one process:
one ``InferencePlan`` or ``InferenceEngine`` issues every position's work
itself, as the reference's single-controller ``jax.sharding.Mesh`` does.
Several positions may name the same device: a ``(1, 4)`` mesh of four
logical positions on ``cuda:0`` runs the sharded code on one card (the
counterpart of ``XLA_FLAGS=--xla_force_host_platform_device_count=8``),
and the CPU hosts any number of positions.

On CUDA the default is one visible card per position; a mesh with more
positions than cards raises, naming the count. Logical positions on one
card come only from an explicit ``devices=[torch.device("cuda:0")] * n``.
``devices="meta"`` puts every position on the meta device: a mesh that
holds no storage, as the LM zoo's production meshes
(``repro_torch.launch.mesh``) are for the dry run and ``Cell.lower()``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Mesh", "make_mesh", "make_test_mesh"]


def _indexed(dev: torch.device | str) -> torch.device:
    """``dev`` with an explicit card index (``cuda`` -> the current card),
    so positions compare equal exactly when they name one device."""
    dev = resolve_device(dev, meta=True)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """An ndarray of ``torch.device`` (``devices``) whose axes are named
    ``axis_names``. ``shape`` maps each axis name to its size, as the
    reference's ``mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_set(self) -> tuple[torch.device, ...]:
        """The distinct devices, in position order."""
        return tuple(dict.fromkeys(self.devices.flat))

    @property
    def first_device(self) -> torch.device:
        """Where a mesh plan gathers its outputs."""
        return self.devices.flat[0]

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.device_set)
        return f"Mesh({self.shape}, devices=[{devs}])"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Sequence[torch.device | str] | torch.device | str
              | None = None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.

    ``devices``: ``None`` puts one visible CUDA card on each position and
    raises when there are fewer cards than positions; a sequence gives
    each position its device in row-major order (repeat a device for
    logical positions on one card); ``"cpu"`` puts every position on the
    CPU and ``"meta"`` on the meta device (no storage).
    """
    shape = tuple(int(n) for n in shape)
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(
                f"a {shape} mesh needs {n} devices, found {have} CUDA "
                f"device(s); pass devices=[torch.device('cuda:0')] * {n} "
                "for logical positions on one card, or devices='cpu'")
        devs = [torch.device("cuda", i) for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        dev = _indexed(devices)
        if dev.type not in ("cpu", "meta"):
            raise ValueError(
                f"one device for every position is for the CPU or meta; "
                f"pass devices=[{str(dev)!r}] * {n} for logical positions "
                "on one card")
        devs = [dev] * n
    else:
        devs = [_indexed(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices for a {shape} mesh of "
                             f"{n} positions")
        if len({d.type for d in devs}) > 1:
            raise ValueError("a mesh's positions must all be CUDA, all "
                             "CPU or all meta")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int | None = None,
                   devices=None) -> Mesh:
    """Small ``(data, model)`` (or ``(pod, data, model)``) mesh for
    sharding tests; ``devices`` as for :func:`make_mesh`."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         devices)
    return make_mesh((data, model), ("data", "model"), devices)

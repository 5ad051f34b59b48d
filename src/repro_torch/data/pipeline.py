"""Deterministic, restartable input pipeline.

Counterpart of ``repro.data.pipeline``. ``loader(step)`` is a pure
function of the step, so a run restarted from a checkpoint at step S
replays exactly the stream from S, with no pipeline state to save.
Batches are drawn on the CPU and copied to the loader's device (see
``synthetic_batch``). With a ``mesh``, each batch is placed with its
rows split over the data (and pod) axes (``Placed`` values, each
position holding its rows on its own device), so no step moves rows
between devices.
"""

from __future__ import annotations

import collections
from typing import Iterator

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import P, place

from .synthetic import DatasetSchema, synthetic_batch

__all__ = ["CTRLoader"]


class CTRLoader:
    """Deterministic synthetic CTR stream on one device (CUDA unless the
    caller says "cpu"), or sharded over a mesh's ``batch_axes`` (on the
    mesh's devices: ``ids`` over ``P(batch, None)``, ``labels`` over
    ``P(batch)``)."""

    def __init__(self, schema: DatasetSchema, batch: int, mesh=None,
                 batch_axes: tuple[str, ...] = ("data",), *,
                 device: torch.device | str | None = None):
        self.schema = schema
        self.batch = batch
        self.mesh = mesh
        self.batch_axes = batch_axes
        if mesh is not None:
            device = mesh.first_device if device is None else device
            axis = batch_axes if len(batch_axes) > 1 else batch_axes[0]
            self._specs = {"ids": P(axis, None), "labels": P(axis)}
        self.device = resolve_device(device)

    def __call__(self, step: int) -> dict:
        out = synthetic_batch(self.schema, step, self.batch,
                              device=self.device)
        if self.mesh is not None:
            out = {k: place(v, self.mesh, self._specs[k])
                   for k, v in out.items()}
        return out

    def iter_prefetch(self, start_step: int, n_steps: int,
                      depth: int = 2) -> Iterator[tuple[int, dict]]:
        """Yield (step, batch), keeping ``depth`` batches made ahead."""
        queue: collections.deque = collections.deque()
        for step in range(start_step, start_step + min(depth, n_steps)):
            queue.append((step, self(step)))
        for step in range(start_step + depth, start_step + n_steps):
            yield queue.popleft()
            queue.append((step, self(step)))
        while queue:
            yield queue.popleft()

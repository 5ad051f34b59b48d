"""Deterministic, restartable input pipeline.

Counterpart of ``repro.data.pipeline``. ``loader(step)`` is a pure
function of the step, so a run restarted from a checkpoint at step S
replays exactly the stream from S, with no pipeline state to save.
Batches are drawn on the CPU and copied to the loader's device (see
``synthetic_batch``). Sharding the batch over a device mesh is the
multi-device slice (ROADMAP Queue A item 4).
"""

from __future__ import annotations

import collections
from typing import Iterator

import torch

from repro_torch.device import resolve_device

from .synthetic import DatasetSchema, synthetic_batch

__all__ = ["CTRLoader"]


class CTRLoader:
    """Deterministic synthetic CTR stream on one device (CUDA unless the
    caller says "cpu")."""

    def __init__(self, schema: DatasetSchema, batch: int, mesh=None, *,
                 device: torch.device | str | None = None):
        if mesh is not None:
            raise NotImplementedError(
                "CTRLoader(mesh=...) is not ported yet: sharding batches "
                "over a device mesh is ROADMAP Queue A item 4")
        self.schema = schema
        self.batch = batch
        self.device = resolve_device(device)

    def __call__(self, step: int) -> dict[str, torch.Tensor]:
        return synthetic_batch(self.schema, step, self.batch,
                               device=self.device)

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

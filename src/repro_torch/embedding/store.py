"""EmbeddingStore — the tier that holds the mega-table behind the lookup.

Counterpart of ``repro.embedding.store``. Here a store is an
``nn.Module`` that owns its tensors as buffers on an explicit device.
``DenseStore`` keeps the whole ``(rows, d)`` mega-table in device memory;
every lookup is one fused gather. The tiered stores come in later slices.

The ``runtime_keys`` contract carries over: a store that can swap its
tensors between calls lists them there, and graphs take them as runtime
inputs (edge names from :func:`runtime_edge`) instead of closing over
them. ``DenseStore`` lists none.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

from .spec import FusedEmbeddingSpec

__all__ = ["EmbeddingStore", "DenseStore", "runtime_edge"]


def runtime_edge(prefix: str, leaf: str) -> str:
    """Graph-input edge name of one runtime store tensor."""
    return f"{prefix}:{leaf}"


class EmbeddingStore(nn.Module):
    """Interface of the embedding parameter tier.

    Implementations must be bit-exact with each other: a store is a
    memory-system choice, never a numerics choice.
    """

    #: buffers that compiled plans take as per-call inputs (swappable);
    #: empty for stores that never swap their tensors
    runtime_keys: tuple = ()

    def __init__(self, spec: FusedEmbeddingSpec):
        super().__init__()
        self.spec = spec

    @torch.no_grad()
    def init_dense_table(self, table: torch.Tensor,
                         generator: torch.Generator) -> None:
        """The canonical mega-table init: normal × 0.05, with the zero row
        set to 0 (``store.py:198-209``)."""
        table.normal_(0.0, 0.05, generator=generator)
        table[self.spec.zero_row:] = 0.0

    def reset_parameters(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def dense_view(self) -> torch.Tensor:
        """The full (rows, d) table."""
        raise NotImplementedError

    def runtime_tensors(self) -> dict[str, torch.Tensor]:
        """Leaf name -> tensor for every ``runtime_keys`` buffer."""
        return {leaf: getattr(self, leaf) for leaf in self.runtime_keys}

    def lookup(self, ids: torch.Tensor, offsets: torch.Tensor, *,
               strategy: str = "auto",
               runtime: dict[str, torch.Tensor] | None = None
               ) -> torch.Tensor:
        """ids (b, k) -> (b, k*d). ``runtime`` overrides the
        ``runtime_keys`` buffers for this call."""
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError


class DenseStore(EmbeddingStore):
    """The monolithic mega-table: one ``mega_table`` buffer of shape
    ``(spec.rows, spec.dim)`` on ``device``."""

    def __init__(self, spec: FusedEmbeddingSpec, *,
                 device: torch.device | str | None = None):
        super().__init__(spec)
        device = resolve_device(device)
        self.register_buffer("mega_table", torch.zeros(
            (spec.rows, spec.dim), dtype=getattr(torch, spec.dtype),
            device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.init_dense_table(self.mega_table, generator)

    def dense_view(self) -> torch.Tensor:
        return self.mega_table

    def lookup(self, ids: torch.Tensor, offsets: torch.Tensor, *,
               strategy: str = "auto",
               runtime: dict[str, torch.Tensor] | None = None
               ) -> torch.Tensor:
        return kops.multi_table_lookup(ids, self.mega_table, offsets,
                                       strategy=strategy)

    def describe(self) -> str:
        return f"dense(rows={self.spec.rows},d={self.spec.dim})"

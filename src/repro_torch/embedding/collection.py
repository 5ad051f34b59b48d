"""FusedEmbeddingCollection — store-backed realization of paper Alg. 1.

Counterpart of ``repro.embedding.collection``. All k per-field tables are
concatenated row-wise into one mega-table; per-field ids become global
rows via static offsets, and one gather replaces k serial lookups (C2,
with C3's output-first allocation inside the kernel). Where the table
lives is the store's business.

The reference's ``apply(params, ids)`` is this module's ``forward(ids)``
(``nn.Module.apply`` means something else in PyTorch). The vocab-parallel
``apply_sharded`` comes with the multi-device slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops as kops

from .spec import FusedEmbeddingSpec
from .store import DenseStore, EmbeddingStore

__all__ = ["FusedEmbeddingCollection"]


class FusedEmbeddingCollection(nn.Module):
    """Lookup front-end over an :class:`EmbeddingStore` (a ``DenseStore``
    on ``device`` unless one is given)."""

    def __init__(self, spec: FusedEmbeddingSpec,
                 store: EmbeddingStore | None = None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        self.spec = spec
        self.store = store if store is not None else DenseStore(
            spec, device=device)
        if self.store.spec != spec:
            raise ValueError("store was built for a different embedding "
                             f"spec: {self.store.spec} != {spec}")
        table = self.store.dense_view()
        self.register_buffer("offsets", torch.as_tensor(
            spec.offsets, dtype=torch.int32, device=table.device))

    def dense_view(self) -> torch.Tensor:
        """The full (rows, d) table, whichever tier holds it."""
        return self.store.dense_view()

    def forward(self, ids: torch.Tensor, *, strategy: str = "auto",
                runtime: dict[str, torch.Tensor] | None = None
                ) -> torch.Tensor:
        """ids (b, k) int32 -> (b, k*d): one fused lookup."""
        return self.store.lookup(ids, self.offsets, strategy=strategy,
                                 runtime=runtime)

    def apply_serial(self, ids: torch.Tensor) -> torch.Tensor:
        """Baseline: k separate gathers + concat (PyTorch-A)."""
        return kops.multi_table_lookup(ids, self.store.dense_view(),
                                       self.offsets, strategy="serial")

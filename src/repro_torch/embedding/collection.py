"""FusedEmbeddingCollection — store-backed realization of paper Alg. 1.

Counterpart of ``repro.embedding.collection``. All k per-field tables are
concatenated row-wise into one mega-table; per-field ids become global
rows via static offsets, and one gather replaces k serial lookups (C2,
with C3's output-first allocation inside the kernel). Where the table
lives is the store's business.

The reference's ``apply(params, ids)`` is this module's ``forward(ids)``
and its ``apply_multihot`` is ``forward_multihot`` (``nn.Module.apply``
means something else in PyTorch). The vocab-parallel ``apply_sharded``
comes with the multi-device slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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
        # row_dtype is the store's wire-format choice, not part of the
        # model's schema: two specs differing only there are compatible
        if dataclasses.replace(self.store.spec, row_dtype=None) != \
                dataclasses.replace(spec, row_dtype=None):
            raise ValueError("store was built for a different embedding "
                             f"spec: {self.store.spec} != {spec}")
        self.register_buffer("offsets", torch.as_tensor(
            spec.offsets, dtype=torch.int32, device=self.store.device))

    def dense_view(self) -> torch.Tensor:
        """The full (rows, d) table, whichever tier holds it."""
        return self.store.dense_view()

    def forward(self, ids: torch.Tensor, *, strategy: str = "auto",
                runtime: dict[str, torch.Tensor] | None = None
                ) -> torch.Tensor:
        """ids (b, k) int32 -> (b, k*d): one fused lookup."""
        return self.store.lookup(ids, self.offsets, strategy=strategy,
                                 runtime=runtime)

    def forward_multihot(self, ids: torch.Tensor, mask: torch.Tensor, *,
                         strategy: str = "auto",
                         runtime: dict[str, torch.Tensor] | None = None
                         ) -> torch.Tensor:
        """ids/mask (b, k, h) -> (b, k*d) sum-pooled."""
        return self.store.lookup_multihot(ids, mask, self.offsets,
                                          strategy=strategy, runtime=runtime)

    def apply_serial(self, ids: torch.Tensor) -> torch.Tensor:
        """Baseline: k separate gathers + concat (PyTorch-A)."""
        return kops.multi_table_lookup(ids, self.store.dense_view(),
                                       self.offsets, strategy="serial")

    def observe(self, ids) -> None:
        """Feed served (b, k) id traffic (numpy or a tensor) to the store's
        admission counters, on the host."""
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.asarray(ids, dtype=np.int64)
        if ids.ndim == 1:
            ids = ids[None, :]
        self.store.observe(ids + self.spec.offsets[None, :])

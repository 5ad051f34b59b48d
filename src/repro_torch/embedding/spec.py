"""FusedEmbeddingSpec — static description of a CTR embedding module.

Counterpart of ``repro.embedding.spec`` (the layout every store is built
against): field sizes, embedding width, and the mega-table's height,
offsets and zero row.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FusedEmbeddingSpec"]


@dataclasses.dataclass(frozen=True)
class FusedEmbeddingSpec:
    """Static description of a CTR embedding module.

    Attributes:
        field_sizes: number of features n_i per field (len = k).
        dim:         shared embedding dimension d.
        dtype:       parameter dtype name (a ``torch`` attribute).
    """
    field_sizes: tuple[int, ...]
    dim: int
    dtype: str = "float32"

    @property
    def k(self) -> int:
        return len(self.field_sizes)

    @property
    def rows(self) -> int:
        """Mega-table height: all fields + 1 zero row."""
        return int(sum(self.field_sizes)) + 1

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate(
            [[0], np.cumsum(self.field_sizes)[:-1]]).astype(np.int32)

    @property
    def zero_row(self) -> int:
        return int(sum(self.field_sizes))

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
        multi_hot:   max ids per field (1 = one-hot fields).
        dtype:       parameter dtype name (a ``torch`` attribute).
        pad_rows_to: pad the mega-table height to a multiple (so a
                     mesh's model axis divides it).
        row_dtype:   wire dtype of stored rows: ``None`` keeps rows in
                     ``dtype`` (bit-exact); ``"int8"`` stores them
                     quantized with one fp32 scale per row
                     (``repro_torch.quant``), dequantized inside the
                     gather. A store-side choice: two specs differing
                     only here describe the same model.
    """
    field_sizes: tuple[int, ...]
    dim: int
    multi_hot: int = 1
    dtype: str = "float32"
    pad_rows_to: int = 1
    row_dtype: str | None = None

    def __post_init__(self):
        if self.row_dtype not in (None, "int8"):
            raise ValueError(f"row_dtype must be None or 'int8', "
                             f"got {self.row_dtype!r}")

    @property
    def k(self) -> int:
        return len(self.field_sizes)

    @property
    def rows(self) -> int:
        """Mega-table height: all fields + 1 zero row, padded up to a
        multiple of ``pad_rows_to`` (the padding rows are zero too)."""
        n = int(sum(self.field_sizes)) + 1
        return -(-n // self.pad_rows_to) * self.pad_rows_to

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate(
            [[0], np.cumsum(self.field_sizes)[:-1]]).astype(np.int32)

    @property
    def zero_row(self) -> int:
        return int(sum(self.field_sizes))

    @property
    def quantized(self) -> bool:
        """True when stored rows travel as int8 + per-row fp32 scale."""
        return self.row_dtype == "int8"

    @property
    def wire_row_bytes(self) -> int:
        """Bytes one row moves on a gather: ``4·d`` for fp32 rows,
        ``d + 4`` for int8 rows (payload + scale)."""
        if self.quantized:
            return self.dim + 4
        return self.dim * np.dtype(self.dtype).itemsize

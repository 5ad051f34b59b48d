"""Plain PyTorch versions of the functions this package's kernels compute.

Counterpart of ``repro.kernels.ref``, limited to the main inference path:
the multi-table lookup (Alg. 1 and its serial baseline), the DCN / DCNv2
cross tails and the FM second-order term. The kernel modules' plain
versions and the ``torch``/``serial`` lookup strategies are built on these.

``multi_table_lookup_alg1`` is a literal transcription of the paper's
Algorithm 1 in numpy scalar code, for tiny sizes only.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["multi_table_lookup_alg1", "ref_multi_table_lookup",
           "ref_serial_lookup", "ref_cross_v2_elementwise",
           "ref_cross_v1_elementwise", "ref_fm_second_order"]


# ---------------------------------------------------------------------------
# Algorithm 1 — multi-table lookup
# ---------------------------------------------------------------------------

def multi_table_lookup_alg1(ids: np.ndarray, tables: list[np.ndarray]) -> np.ndarray:
    """Literal transcription of DPIFrame Algorithm 1 (element-by-element).

    Args:
        ids:    (b, k) integer feature IDs; ``ids[s, i]`` indexes table ``i``.
        tables: list of k arrays, the i-th of shape (n_i, d).

    Returns:
        (b, k*d) lookup results, exactly the paper's ``EmbedOut``.
    """
    b, k = ids.shape
    d = tables[0].shape[1]
    ids_flat = ids.reshape(-1)                       # paper indexes IDs[row*k + table_id]
    total_elements = b * k * d                       # line 1
    row_width = k * d                                # line 2
    out = np.empty(total_elements, dtype=tables[0].dtype)
    for idx in range(total_elements):                # line 3
        row = idx // row_width                       # line 4
        col = idx % row_width                        # line 5
        table_id = col // d                          # line 6
        emb_row = ids_flat[row * k + table_id]       # line 7
        emb_col = col % d                            # line 8
        table = tables[table_id].reshape(-1)
        out[idx] = table[emb_row * d + emb_col]      # line 9
    return out.reshape(b, row_width)


def ref_multi_table_lookup(ids: torch.Tensor, mega_table: torch.Tensor,
                           offsets: torch.Tensor, k: int) -> torch.Tensor:
    """One gather over the concatenated mega-table.

    Args:
        ids:        (b, k) per-field IDs (local to each table).
        mega_table: (sum_i n_i, d) all k tables concatenated along rows.
        offsets:    (k,) row offset of each table inside ``mega_table``.
        k:          number of feature fields.

    Returns:
        (b, k*d) embedding output.
    """
    b = ids.shape[0]
    d = mega_table.shape[1]
    flat_rows = (ids + offsets[None, :]).reshape(-1)          # (b*k,) global rows
    return mega_table.index_select(0, flat_rows).reshape(b, k * d)


def ref_serial_lookup(ids: torch.Tensor,
                      tables: list[torch.Tensor]) -> torch.Tensor:
    """The baseline the paper accelerates: k independent lookups + concat,
    each field materializing its own (b, d) intermediate (a per-field
    ``nn.Embedding`` loop)."""
    cols = [tables[i].index_select(0, ids[:, i]) for i in range(len(tables))]
    return torch.cat(cols, dim=1)


# ---------------------------------------------------------------------------
# Fused non-GEMM tails (C5)
# ---------------------------------------------------------------------------

def ref_cross_v2_elementwise(x0, xw_plus, x):
    """DCNv2 cross-layer tail:  out = x0 * xw_plus + x."""
    return x0 * xw_plus + x


def ref_cross_v1_elementwise(x0, xlw, bias, x):
    """DCNv1 cross-layer tail:  out = x0 * xlw + bias + x, with ``xlw`` the
    (b, 1) per-sample ``x_l · w``."""
    return x0 * xlw + bias[None, :] + x


def ref_fm_second_order(v: torch.Tensor) -> torch.Tensor:
    """Factorization-machine 2nd-order term: (b, k, d) -> (b,)
    ``0.5 * sum_d [ (sum_k v)^2 - sum_k v^2 ]``."""
    s = v.sum(dim=1)                     # (b, d)
    sq = (v * v).sum(dim=1)              # (b, d)
    return 0.5 * (s * s - sq).sum(dim=-1)

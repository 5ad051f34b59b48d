"""Plain PyTorch versions of the functions this package's kernels compute.

Counterpart of ``repro.kernels.ref``, limited to the ported paths: the
multi-table lookup (Alg. 1 and its serial baseline), the multi-hot pooled
lookup, the two-level (cache + backing) gathers of the cached tier and
the three-level (cache / staging / zero) gathers of the host tier, in
fp32 and int8, the int8 dense layer, the DCN / DCNv2 cross tails and the
FM second-order term.
The kernel modules' plain versions and the ``torch``/``serial`` lookup
strategies are built on these.

``multi_table_lookup_alg1`` is a literal transcription of the paper's
Algorithm 1 in numpy scalar code, for tiny sizes only.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["multi_table_lookup_alg1", "ref_multi_table_lookup",
           "ref_serial_lookup", "ref_multi_hot_lookup",
           "ref_two_level_gather", "ref_two_level_gather_q8",
           "ref_three_level_gather", "ref_three_level_gather_q8",
           "ref_dense_matmul_q8", "ref_cross_v2_elementwise",
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


def ref_multi_hot_lookup(ids: torch.Tensor, weights: torch.Tensor,
                         mega_table: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """Multi-hot (sequence-feature) oracle: weighted sum over the hot axis.

    Args:
        ids:        (b, k, h) per-field IDs, h = max hot count.
        weights:    (b, k, h) 0/1 validity mask (or any pooling weights).
        mega_table: (N, d).
        offsets:    (k,).

    Returns:
        (b, k*d) pooled embedding output.
    """
    b, k, h = ids.shape
    d = mega_table.shape[1]
    rows = (ids.long() + offsets.long()[None, :, None]).reshape(-1)
    gathered = mega_table.index_select(0, rows).reshape(b, k, h, d)
    pooled = (gathered * weights[..., None].to(mega_table.dtype)).sum(dim=2)
    return pooled.reshape(b, k * d)


def _tier_select(flat_rows: torch.Tensor, slot_of_row: torch.Tensor,
                 n_cache: int):
    """Per row: whether it is a cache hit, its cache slot (0 on a miss)
    and its backing row (0 on a hit) — the not-taken tier is pinned to
    its row 0, as the reference's index maps pin it. A slot outside
    ``[0, n_cache)`` counts as a miss, so no map can send a read past
    the cache."""
    slots = slot_of_row.index_select(0, flat_rows).long()
    hit = (slots >= 0) & (slots < n_cache)
    return hit, torch.where(hit, slots, 0), torch.where(hit, 0, flat_rows)


def ref_two_level_gather(flat_rows: torch.Tensor, slot_of_row: torch.Tensor,
                         cache: torch.Tensor,
                         backing: torch.Tensor) -> torch.Tensor:
    """Two-level (cache + backing) gather oracle — the CachedStore lookup.

    Hits read their row from ``cache``, misses fall through to
    ``backing``. Cache rows are verbatim copies of backing rows, so the
    result is bitwise ``backing.index_select(0, flat_rows)``.

    Args:
        flat_rows:   (R,) global rows.
        slot_of_row: (N,) int32 cache slot per global row, -1 = uncached.
        cache:       (C, d) hot-row copies.
        backing:     (N, d) full mega-table.

    Returns:
        (R, d) gathered rows.
    """
    flat_rows = flat_rows.long()
    hit, slots, miss_rows = _tier_select(flat_rows, slot_of_row,
                                         cache.shape[0])
    return torch.where(hit[:, None], cache.index_select(0, slots),
                       backing.index_select(0, miss_rows))


def ref_two_level_gather_q8(flat_rows: torch.Tensor,
                            slot_of_row: torch.Tensor, cache: torch.Tensor,
                            cache_scale: torch.Tensor, backing: torch.Tensor,
                            backing_scale: torch.Tensor) -> torch.Tensor:
    """Quantized two-level gather oracle — the int8 CachedStore lookup:
    select the int8 payload and the fp32 scale by tier, then one dequant
    multiply (the kernel's arithmetic exactly, so the two are bitwise).

    Args:
        flat_rows:     (R,) global rows.
        slot_of_row:   (N,) int32 cache slot per global row, -1 = uncached.
        cache:         (C, d) int8 hot-row copies.
        cache_scale:   (C, 1) fp32 per-row scales.
        backing:       (N, d) int8 full mega-table.
        backing_scale: (N, 1) fp32 per-row scales.

    Returns:
        (R, d) float32 dequantized rows.
    """
    flat_rows = flat_rows.long()
    hit, slots, miss_rows = _tier_select(flat_rows, slot_of_row,
                                         cache.shape[0])
    q = torch.where(hit[:, None], cache.index_select(0, slots),
                    backing.index_select(0, miss_rows)).to(torch.float32)
    s = torch.where(hit[:, None], cache_scale.index_select(0, slots),
                    backing_scale.index_select(0, miss_rows))
    return q * s


def _three_tier_select(flat_rows: torch.Tensor, slot_of_row: torch.Tensor,
                       staging_slot_of_row: torch.Tensor, n_cache: int,
                       n_staging: int):
    """Per row: cache hit, staged (and not a cache hit), and the two
    slots to read (0 where that tier is not taken). The cache wins when a
    row is in both tiers; a slot outside its tier counts as absent, so no
    map can send a read past the cache or the staging buffer."""
    cslots = slot_of_row.index_select(0, flat_rows).long()
    sslots = staging_slot_of_row.index_select(0, flat_rows).long()
    cache_hit = (cslots >= 0) & (cslots < n_cache)
    staged = ~cache_hit & (sslots >= 0) & (sslots < n_staging)
    return (cache_hit, staged, torch.where(cache_hit, cslots, 0),
            torch.where(staged, sslots, 0))


def ref_three_level_gather(flat_rows: torch.Tensor, slot_of_row: torch.Tensor,
                           staging_slot_of_row: torch.Tensor,
                           cache: torch.Tensor,
                           staging: torch.Tensor) -> torch.Tensor:
    """Three-level (cache / staging / zero-guard) gather oracle — the
    HostBackedStore lookup.

    There is no device backing to fall through to: a row in neither the
    cache nor the staging buffer gathers zero (the guard). The serve path
    stages every miss before the lookup, so on a staged batch the result
    is bitwise the dense gather (both tiers hold verbatim backing rows).

    Args:
        flat_rows:           (R,) global rows.
        slot_of_row:         (N,) int32 cache slot per row, -1 = uncached.
        staging_slot_of_row: (N,) int32 staging slot per row, -1 = unstaged.
        cache:               (C, d) hot-row copies.
        staging:             (S, d) this batch's staged miss rows.

    Returns:
        (R, d) gathered rows (zero where neither tier resolves).
    """
    flat_rows = flat_rows.long()
    cache_hit, staged, cslots, sslots = _three_tier_select(
        flat_rows, slot_of_row, staging_slot_of_row, cache.shape[0],
        staging.shape[0])
    zero = torch.zeros((), dtype=cache.dtype)
    return torch.where(cache_hit[:, None], cache.index_select(0, cslots),
                       torch.where(staged[:, None],
                                   staging.index_select(0, sslots), zero))


def ref_three_level_gather_q8(flat_rows: torch.Tensor,
                              slot_of_row: torch.Tensor,
                              staging_slot_of_row: torch.Tensor,
                              cache: torch.Tensor, cache_scale: torch.Tensor,
                              staging: torch.Tensor,
                              staging_scale: torch.Tensor) -> torch.Tensor:
    """Quantized three-level gather oracle — the int8 HostBackedStore
    lookup: the int8 payload and the fp32 scale from the winning tier, one
    dequant multiply, and an exact 0.0 for a row in neither tier (the
    reference's q = 0 times any scale).

    Args:
        flat_rows:           (R,) global rows.
        slot_of_row:         (N,) int32 cache slot per row, -1 = uncached.
        staging_slot_of_row: (N,) int32 staging slot per row, -1 = unstaged.
        cache:               (C, d) int8 hot-row copies.
        cache_scale:         (C, 1) fp32 per-row scales.
        staging:             (S, d) int8 staged miss rows.
        staging_scale:       (S, 1) fp32 per-row scales.

    Returns:
        (R, d) float32 dequantized rows (zero where neither tier resolves).
    """
    flat_rows = flat_rows.long()
    cache_hit, staged, cslots, sslots = _three_tier_select(
        flat_rows, slot_of_row, staging_slot_of_row, cache.shape[0],
        staging.shape[0])
    hit, st = cache_hit[:, None], staged[:, None]
    q = torch.where(hit, cache.index_select(0, cslots),
                    staging.index_select(0, sslots)).to(torch.float32)
    s = torch.where(hit, cache_scale.index_select(0, cslots),
                    staging_scale.index_select(0, sslots))
    return torch.where(hit | st, q * s, torch.zeros((), dtype=torch.float32))


# ---------------------------------------------------------------------------
# Quantized dense layer (int8 MLP compute)
# ---------------------------------------------------------------------------

def ref_dense_matmul_q8(hq: torch.Tensor, hscale: torch.Tensor,
                        wq: torch.Tensor, wscale: torch.Tensor,
                        bias: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Quantized dense layer: int8 x int8 -> int32, then
    ``fma(fp32(acc) * hscale, wscale, bias)`` and an optional ReLU.

    The int32 sum is an fp64 product of the codes, exact below 2**53 (an
    fp32 one is not: |acc| reaches 127² · fan_in > 2**24) and usable on
    the card, where integer matmuls are not. The fma is emulated in fp64:
    the product of two floats is exact there, so only the final sum
    rounds twice, and that differs from one rounding only when the fp64
    sum lands on an fp32 midpoint.

    Args:
        hq:     (b, fan_in) int8 per-row quantized activations.
        hscale: (b, 1) float32 per-row scales.
        wq:     (fan_in, fan_out) int8 per-channel quantized weights.
        wscale: (1, fan_out) float32 per-channel scales.
        bias:   (1, fan_out) float32.

    Returns:
        (b, fan_out) float32.
    """
    f64 = torch.float64
    acc = (hq.to(f64) @ wq.to(f64)).to(torch.int32)
    out = ((acc.to(torch.float32) * hscale).to(f64) * wscale.to(f64)
           + bias.to(f64)).to(torch.float32)
    return out.clamp_min(0.0) if relu else out


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

"""Public wrappers for the DPIFrame kernels, with strategy dispatch.

Counterpart of ``repro.kernels.ops``. Strategies for
``multi_table_lookup``:

  "auto"        the kernel wrapper: the CUDA gather for a CUDA tensor,
                its plain version for a CPU tensor
  "kernel"      the same wrapper, named explicitly        [C2+C3]
  "torch"       one ``index_select`` over the mega-table  [C2 in PyTorch]
  "serial"      per-field gathers + concat (the paper's PyTorch baseline)
  "input_first" the Fig.-11 strawman: the K8 wrapper (field-major writes
                + transpose)

The multi-hot, cached-tier and host-tier lookups take "auto"/"kernel"
(the K2–K6 wrapper, which redirects masked slots to the table's zero row
``N - 1`` and reads the slot maps in the kernel; the reference's
"pallas") and "torch" (the reference's "jnp" oracle path: one gather,
then mask-multiply-sum for multi-hot); "input_first" is a dense-table
strategy only, as in the reference. The one-hot lookup over small padded
tables (K7) has its own entry, :func:`multi_table_lookup_onehot`: like
the reference's, ``multi_table_lookup`` has no "onehot" branch.
:func:`dense_matmul_q8` is the int8 MLP layer (K12). The fused-tail
wrappers dispatch on the tensor's device the same way: the kernel for
CUDA tensors, the plain version for CPU tensors. The fused-tail entries
and the "auto"/"kernel" dense lookup are differentiable
(``kernels/autograd.py``): with autograd on and an input requiring
grad, they run through a ``torch.autograd.Function`` around the kernel.
"""

from __future__ import annotations

import torch

from . import ref
from .autograd import (fused_cross_v1, fused_cross_v2, fused_fm_second_order,
                       mtl_gather)
from .dense_matmul import dmm_q8
from .multi_table_lookup import (mtl_gather_multihot,
                                 mtl_gather_three_level,
                                 mtl_gather_three_level_q8,
                                 mtl_gather_two_level,
                                 mtl_gather_two_level_q8, mtl_input_first,
                                 mtl_onehot)
from .quantize import quantize_rows_q8

__all__ = ["STRATEGIES", "POOLED_STRATEGIES", "multi_table_lookup",
           "multi_table_lookup_multihot", "multi_table_lookup_cached",
           "multi_table_lookup_cached_multihot",
           "multi_table_lookup_cached_q8",
           "multi_table_lookup_cached_q8_multihot",
           "multi_table_lookup_host", "multi_table_lookup_host_multihot",
           "multi_table_lookup_host_q8",
           "multi_table_lookup_host_q8_multihot",
           "multi_table_lookup_onehot", "dense_matmul_q8", "fused_cross_v1",
           "fused_cross_v2", "fused_fm_second_order"]

STRATEGIES = ("auto", "kernel", "torch", "serial", "input_first")
#: strategies of the multi-hot and cached-tier lookups
POOLED_STRATEGIES = ("auto", "kernel", "torch")


def multi_table_lookup(ids: torch.Tensor, mega_table: torch.Tensor,
                       offsets: torch.Tensor, *,
                       strategy: str = "auto") -> torch.Tensor:
    """Fused multi-table embedding lookup (paper Algorithm 1).

    Args:
        ids:        (b, k) int32 per-field local ids.
        mega_table: (N, d) concatenated tables.
        offsets:    (k,) int32 starting row of each table.
        strategy:   see module docstring.

    Returns:
        (b, k*d) embedding output.
    """
    if strategy in ("auto", "kernel"):
        return mtl_gather(ids, offsets, mega_table)
    if strategy == "torch":
        return ref.ref_multi_table_lookup(ids, mega_table, offsets,
                                          ids.shape[1])
    if strategy == "serial":
        cols = [mega_table.index_select(0, ids[:, i] + offsets[i])
                for i in range(ids.shape[1])]
        return torch.cat(cols, dim=1)
    if strategy == "input_first":
        return mtl_input_first(ids, offsets, mega_table)
    raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                     f"{STRATEGIES}")


def _unknown(strategy: str):
    return ValueError(f"unknown strategy {strategy!r}; expected one of "
                      f"{POOLED_STRATEGIES}")


def _global_rows(ids: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Alg. 1 lines 6–7 vectorized: local ids -> flat global rows
    ((b, k) or (b, k, h) ids)."""
    off = offsets.long()
    off = off[None, :] if ids.dim() == 2 else off[None, :, None]
    return (ids.long() + off).reshape(-1)


def _redirected_rows(ids: torch.Tensor, mask: torch.Tensor,
                     offsets: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Flat (b*k*h,) rows with masked slots sent to the zero row ``N-1``
    (``ops.py:189-191`` of the reference)."""
    return torch.where(mask.reshape(-1) != 0, _global_rows(ids, offsets),
                       n_rows - 1)


def _mask_pool(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The oracle's pooling: (b*k*h, d) values × mask, summed over h."""
    b, k, h = mask.shape
    d = vals.shape[-1]
    pooled = (vals.reshape(b, k, h, d)
              * mask[..., None].to(vals.dtype)).sum(dim=2)
    return pooled.reshape(b, k * d)


def multi_table_lookup_multihot(ids: torch.Tensor, mask: torch.Tensor,
                                mega_table: torch.Tensor,
                                offsets: torch.Tensor, *,
                                strategy: str = "auto") -> torch.Tensor:
    """Multi-hot (pooled) fused lookup.

    Args:
        ids:        (b, k, h) local ids; invalid slots arbitrary.
        mask:       (b, k, h) 1 for valid slots, 0 otherwise.
        mega_table: (N, d) with a trailing all-zero row at ``N - 1``.
        offsets:    (k,) table starts.

    Returns:
        (b, k*d) pooled output.
    """
    if strategy in ("auto", "kernel"):
        return mtl_gather_multihot(ids, mask.to(torch.float32), offsets,
                                   mega_table)
    if strategy == "torch":
        return ref.ref_multi_hot_lookup(ids, mask, mega_table, offsets)
    raise _unknown(strategy)


def multi_table_lookup_cached(ids: torch.Tensor, cache: torch.Tensor,
                              backing: torch.Tensor,
                              slot_of_row: torch.Tensor,
                              offsets: torch.Tensor, *,
                              strategy: str = "auto") -> torch.Tensor:
    """Fused lookup through a tiered (cache + backing) store: one
    two-level gather, bitwise equal to the dense lookup because cache rows
    are verbatim copies.

    Args:
        ids:         (b, k) int32 per-field local ids.
        cache:       (C, d) hot-row copies.
        backing:     (N, d) full mega-table.
        slot_of_row: (N,) int32 cache slot per global row, -1 = uncached.
        offsets:     (k,) int32 starting row of each table.

    Returns:
        (b, k*d) embedding output.
    """
    if strategy in ("auto", "kernel"):
        return mtl_gather_two_level(ids, offsets, slot_of_row, cache,
                                    backing)
    if strategy == "torch":
        b, k = ids.shape
        out = ref.ref_two_level_gather(_global_rows(ids, offsets),
                                       slot_of_row, cache, backing)
        return out.reshape(b, k * backing.shape[1])
    raise _unknown(strategy)


def multi_table_lookup_cached_multihot(ids: torch.Tensor, mask: torch.Tensor,
                                       cache: torch.Tensor,
                                       backing: torch.Tensor,
                                       slot_of_row: torch.Tensor,
                                       offsets: torch.Tensor, *,
                                       strategy: str = "auto"
                                       ) -> torch.Tensor:
    """Multi-hot (pooled) lookup through a tiered store; either strategy
    pools exactly as its dense twin does, so the two stores agree bitwise.

    Args:
        ids, mask:   (b, k, h) local ids and validity mask.
        cache:       (C, d) hot-row copies.
        backing:     (N, d) mega-table with a trailing all-zero row.
        slot_of_row: (N,) int32 index map.
        offsets:     (k,) table starts.

    Returns:
        (b, k*d) pooled output.
    """
    if strategy in ("auto", "kernel"):
        return mtl_gather_two_level(ids, offsets, slot_of_row, cache,
                                    backing, mask=mask.to(torch.float32))
    if strategy == "torch":
        vals = ref.ref_two_level_gather(_global_rows(ids, offsets),
                                        slot_of_row, cache, backing)
        return _mask_pool(vals, mask)
    raise _unknown(strategy)


def multi_table_lookup_cached_q8(ids: torch.Tensor, cache: torch.Tensor,
                                 cache_scale: torch.Tensor,
                                 backing: torch.Tensor,
                                 backing_scale: torch.Tensor,
                                 slot_of_row: torch.Tensor,
                                 offsets: torch.Tensor, *,
                                 strategy: str = "auto") -> torch.Tensor:
    """Quantized tiered lookup: int8 cache/backing rows with per-row fp32
    scales, dequantized inside the gather.

    Args:
        ids:           (b, k) int32 per-field local ids.
        cache:         (C, d) int8 hot-row copies.
        cache_scale:   (C, 1) fp32 per-row scales.
        backing:       (N, d) int8 full mega-table.
        backing_scale: (N, 1) fp32 per-row scales.
        slot_of_row:   (N,) int32 cache slot per global row, -1 = uncached.
        offsets:       (k,) int32 starting row of each table.

    Returns:
        (b, k*d) float32 embedding output.
    """
    if strategy in ("auto", "kernel"):
        return mtl_gather_two_level_q8(ids, offsets, slot_of_row, cache,
                                       cache_scale, backing, backing_scale)
    if strategy == "torch":
        b, k = ids.shape
        out = ref.ref_two_level_gather_q8(_global_rows(ids, offsets),
                                          slot_of_row, cache, cache_scale,
                                          backing, backing_scale)
        return out.reshape(b, k * backing.shape[1])
    raise _unknown(strategy)


def multi_table_lookup_cached_q8_multihot(ids: torch.Tensor,
                                          mask: torch.Tensor,
                                          cache: torch.Tensor,
                                          cache_scale: torch.Tensor,
                                          backing: torch.Tensor,
                                          backing_scale: torch.Tensor,
                                          slot_of_row: torch.Tensor,
                                          offsets: torch.Tensor, *,
                                          strategy: str = "auto"
                                          ) -> torch.Tensor:
    """Multi-hot (pooled) quantized tiered lookup. Masked slots read the
    zero row, whose int8 payload is 0, so they dequantize to an exact
    0.0; pooling is in fp32 after the per-row dequant.

    Args:
        ids, mask:     (b, k, h) local ids and validity mask.
        cache:         (C, d) int8 hot-row copies.
        cache_scale:   (C, 1) fp32 per-row scales.
        backing:       (N, d) int8 mega-table with a trailing zero row.
        backing_scale: (N, 1) fp32 per-row scales.
        slot_of_row:   (N,) int32 index map.
        offsets:       (k,) table starts.

    Returns:
        (b, k*d) float32 pooled output.
    """
    if strategy in ("auto", "kernel"):
        return mtl_gather_two_level_q8(ids, offsets, slot_of_row, cache,
                                       cache_scale, backing, backing_scale,
                                       mask=mask.to(torch.float32))
    if strategy == "torch":
        rows = _redirected_rows(ids, mask, offsets, backing.shape[0])
        vals = ref.ref_two_level_gather_q8(rows, slot_of_row, cache,
                                           cache_scale, backing,
                                           backing_scale)
        return _mask_pool(vals, mask)
    raise _unknown(strategy)


def multi_table_lookup_host(ids: torch.Tensor, cache: torch.Tensor,
                            staging: torch.Tensor, slot_of_row: torch.Tensor,
                            staging_slot_of_row: torch.Tensor,
                            offsets: torch.Tensor, *,
                            strategy: str = "auto") -> torch.Tensor:
    """Fused lookup through a host-backed (cache + staging) store: cached
    rows from ``cache``, this batch's staged misses from ``staging``,
    anything else zero (the guard; the serve path stages every miss
    first). Bitwise equal to the dense lookup on a staged batch.

    Args:
        ids:                 (b, k) int32 per-field local ids.
        cache:               (C, d) hot-row copies.
        staging:             (S, d) staged miss rows of this batch.
        slot_of_row:         (N,) int32 cache slot per row, -1 = uncached.
        staging_slot_of_row: (N,) int32 staging slot per row, -1 = unstaged.
        offsets:             (k,) int32 starting row of each table.

    Returns:
        (b, k*d) embedding output.
    """
    if strategy in ("auto", "kernel"):
        return mtl_gather_three_level(ids, offsets, slot_of_row,
                                      staging_slot_of_row, cache, staging)
    if strategy == "torch":
        b, k = ids.shape
        out = ref.ref_three_level_gather(_global_rows(ids, offsets),
                                         slot_of_row, staging_slot_of_row,
                                         cache, staging)
        return out.reshape(b, k * cache.shape[1])
    raise _unknown(strategy)


def multi_table_lookup_host_multihot(ids: torch.Tensor, mask: torch.Tensor,
                                     cache: torch.Tensor,
                                     staging: torch.Tensor,
                                     slot_of_row: torch.Tensor,
                                     staging_slot_of_row: torch.Tensor,
                                     offsets: torch.Tensor, *,
                                     strategy: str = "auto") -> torch.Tensor:
    """Multi-hot (pooled) lookup through a host-backed store. Masked slots
    read the zero row, which pools zero from any tier (every tier holds
    verbatim copies, and the guard gives zero when neither holds it).

    Args:
        ids, mask:           (b, k, h) local ids and validity mask.
        cache:               (C, d) hot-row copies.
        staging:             (S, d) staged miss rows of this batch.
        slot_of_row:         (N,) int32 cache index map.
        staging_slot_of_row: (N,) int32 staging index map.
        offsets:             (k,) table starts.

    Returns:
        (b, k*d) pooled output.
    """
    if strategy in ("auto", "kernel"):
        return mtl_gather_three_level(ids, offsets, slot_of_row,
                                      staging_slot_of_row, cache, staging,
                                      mask=mask.to(torch.float32))
    if strategy == "torch":
        rows = _redirected_rows(ids, mask, offsets, slot_of_row.shape[0])
        vals = ref.ref_three_level_gather(rows, slot_of_row,
                                          staging_slot_of_row, cache, staging)
        return _mask_pool(vals, mask)
    raise _unknown(strategy)


def multi_table_lookup_host_q8(ids: torch.Tensor, cache: torch.Tensor,
                               cache_scale: torch.Tensor,
                               staging: torch.Tensor,
                               staging_scale: torch.Tensor,
                               slot_of_row: torch.Tensor,
                               staging_slot_of_row: torch.Tensor,
                               offsets: torch.Tensor, *,
                               strategy: str = "auto") -> torch.Tensor:
    """Quantized host-backed lookup: int8 cache/staging rows with per-row
    fp32 scales, dequantized inside the gather; a row in neither tier
    gives an exact 0.0.

    Args:
        ids:                 (b, k) int32 per-field local ids.
        cache:               (C, d) int8 hot-row copies.
        cache_scale:         (C, 1) fp32 per-row scales.
        staging:             (S, d) int8 staged miss rows.
        staging_scale:       (S, 1) fp32 per-row scales.
        slot_of_row:         (N,) int32 cache slot per row, -1 = uncached.
        staging_slot_of_row: (N,) int32 staging slot per row, -1 = unstaged.
        offsets:             (k,) int32 starting row of each table.

    Returns:
        (b, k*d) float32 embedding output.
    """
    if strategy in ("auto", "kernel"):
        return mtl_gather_three_level_q8(ids, offsets, slot_of_row,
                                         staging_slot_of_row, cache,
                                         cache_scale, staging, staging_scale)
    if strategy == "torch":
        b, k = ids.shape
        out = ref.ref_three_level_gather_q8(
            _global_rows(ids, offsets), slot_of_row, staging_slot_of_row,
            cache, cache_scale, staging, staging_scale)
        return out.reshape(b, k * cache.shape[1])
    raise _unknown(strategy)


def multi_table_lookup_host_q8_multihot(ids: torch.Tensor, mask: torch.Tensor,
                                        cache: torch.Tensor,
                                        cache_scale: torch.Tensor,
                                        staging: torch.Tensor,
                                        staging_scale: torch.Tensor,
                                        slot_of_row: torch.Tensor,
                                        staging_slot_of_row: torch.Tensor,
                                        offsets: torch.Tensor, *,
                                        strategy: str = "auto"
                                        ) -> torch.Tensor:
    """Multi-hot (pooled) quantized host-backed lookup; masked slots read
    the zero row (int8 payload 0, or the guard), pooled in fp32 after the
    per-row dequant.

    Args:
        ids, mask:           (b, k, h) local ids and validity mask.
        cache:               (C, d) int8 hot-row copies.
        cache_scale:         (C, 1) fp32 per-row scales.
        staging:             (S, d) int8 staged miss rows.
        staging_scale:       (S, 1) fp32 per-row scales.
        slot_of_row:         (N,) int32 cache index map.
        staging_slot_of_row: (N,) int32 staging index map.
        offsets:             (k,) table starts.

    Returns:
        (b, k*d) float32 pooled output.
    """
    if strategy in ("auto", "kernel"):
        return mtl_gather_three_level_q8(ids, offsets, slot_of_row,
                                         staging_slot_of_row, cache,
                                         cache_scale, staging, staging_scale,
                                         mask=mask.to(torch.float32))
    if strategy == "torch":
        rows = _redirected_rows(ids, mask, offsets, slot_of_row.shape[0])
        vals = ref.ref_three_level_gather_q8(
            rows, slot_of_row, staging_slot_of_row, cache, cache_scale,
            staging, staging_scale)
        return _mask_pool(vals, mask)
    raise _unknown(strategy)


def multi_table_lookup_onehot(ids: torch.Tensor,
                              stacked_tables: torch.Tensor) -> torch.Tensor:
    """One-hot lookup for a group of small fields (K7).

    Args:
        ids:            (b, k) int32 per-field local ids.
        stacked_tables: (k, n_pad, d) float32 or bfloat16 tables padded to
                        one height.

    Returns:
        (b, k, d); zero rows for ids outside ``[0, n_pad)``.
    """
    return mtl_onehot(ids, stacked_tables)


def dense_matmul_q8(h: torch.Tensor, wq_t: torch.Tensor,
                    wscale: torch.Tensor, bias: torch.Tensor, *,
                    relu: bool = True) -> torch.Tensor:
    """Quantized dense layer: dynamic per-row int8 activations × static
    per-channel int8 weights, int32 sum, dequant + bias (+ ReLU) in the
    epilogue.

    Two launches on CUDA: the per-row activation quantizer
    (``quantize_rows_q8``, one fused kernel where the reference's jnp
    ``absmax_scale`` + ``quantize`` fuse under jit), then K12. The weight
    arrives quantized once at graph build (``quant.quantize_channels``)
    and laid out for the kernel (``dense_matmul.pack_weight``).

    Args:
        h:        (b, fan_in) float32 activations.
        wq_t:     (fan_out, fan_in) int8 per-channel quantized weights.
        wscale:   (1, fan_out) float32 per-channel scales.
        bias:     (fan_out,) float32.
        relu:     apply the ReLU epilogue.

    Returns:
        (b, fan_out) float32: K12 for a CUDA tensor, its plain version
        for a CPU tensor.
    """
    hq, hscale = quantize_rows_q8(h)
    return dmm_q8(hq, hscale, wq_t, wscale, bias.reshape(1, -1), relu=relu)

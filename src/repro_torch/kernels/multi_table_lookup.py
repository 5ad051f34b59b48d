"""Fused multi-table gathers (Alg. 1) and their pooled and tiered forms.

Counterparts of ``repro.kernels.multi_table_lookup``:

  K1 ``mtl_gather``               ``csrc/mtl_gather.cu``
  K2 ``mtl_gather_multihot``      ``csrc/mtl_gather_tiered.cu``
  K3 ``mtl_gather_two_level``     ``csrc/mtl_gather_tiered.cu``
  K4 ``mtl_gather_two_level_q8``  ``csrc/mtl_gather_tiered.cu``
  K5 ``mtl_gather_three_level``   ``csrc/mtl_gather_tiered.cu``
  K6 ``mtl_gather_three_level_q8`` ``csrc/mtl_gather_tiered.cu``
  K7 ``mtl_onehot``               ``csrc/mtl_onehot.cu``
  K8 ``mtl_input_first``          ``csrc/mtl_input_first.cu``

The reference kernels take precomputed global rows (and, for the tiered
ones, a slot vector gathered in a separate pass); these take the local
ids plus the ``(k,)`` table offsets and add them inside the kernel (Alg. 1
lines 6–8), and the tiered ones read ``slot_of_row[row]`` themselves. The
pooled forms take ``(b, k, h)`` ids and an optional ``(b, k, h)`` float32
mask; a masked slot reads the table's last row (the zero row), exactly as
the reference redirects it before its kernel.

Global rows are clamped into ``[0, N)`` and a slot outside ``[0, C)``
(or the staging buffer's ``[0, S)``) counts as a miss: an out-of-range id
reads some row of the table, never memory past it. K5/K6 have no backing
operand (the host tier keeps it in host memory); ``N`` is the length of
their two maps, and a row in neither tier reads zero. The plain versions
clamp, select and sum (in slot order) the same way, so kernel and plain
version are bitwise equal on any input.

K8 is the Fig.-11 strawman: the same lookup as K1 (the same ids,
offsets and clamp, bitwise the same result), but laid out by input — one
thread per (sample, field), writing a field-major ``(k, b, d)`` buffer
that a PyTorch transpose turns into ``(b, k*d)``. K1 and K8 copy 16-byte
words when ``d % 4 == 0`` and the table and output are 16-byte aligned,
else 4-byte words; :func:`gather_launch` and :func:`input_first_launch`
give their launch shapes as pure functions of the call. K2–K6 are one
kernel: it builds a row with a group of lanes in the shape
:func:`tiered_launch` gives, each lane taking 4 elements of a row --
loaded as one word (16 bytes of fp32 for K2, K3 and K5, 4 bytes of int8
codes for K4 and K6), or element by element from a table or tier view off
that alignment (:func:`tier_word`) -- or one element for ``d % 4 != 0``.
K7 is the
reference's one-hot lookup over small per-field tables stacked to one
padded height: a gather where an id outside ``[0, n_pad)`` gives a zero
row (the one-hot row matches nothing), not a clamped one. It takes K1's
layout, a group of lanes a row, with words of 16 bytes, 4 bytes or one
element (:func:`onehot_word`) in the shape :func:`onehot_launch` gives.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .ref import (ref_three_level_gather, ref_three_level_gather_q8,
                  ref_two_level_gather, ref_two_level_gather_q8)

__all__ = ["mtl_gather", "mtl_gather_plain", "mtl_gather_multihot",
           "mtl_gather_multihot_plain", "mtl_gather_two_level",
           "mtl_gather_two_level_plain", "mtl_gather_two_level_q8",
           "mtl_gather_two_level_q8_plain", "mtl_gather_three_level",
           "mtl_gather_three_level_plain", "mtl_gather_three_level_q8",
           "mtl_gather_three_level_q8_plain", "mtl_input_first",
           "mtl_input_first_plain", "mtl_onehot", "mtl_onehot_plain",
           "Launch", "GATHER_THREADS", "INPUT_FIRST_THREADS",
           "TIERED_THREADS", "ONEHOT_THREADS", "vector_words",
           "gather_launch", "input_first_launch", "tier_word",
           "tiered_launch", "onehot_word", "onehot_launch"]


# ---------------------------------------------------------------------------
# K1–K8 launch shapes: pure functions of the call, checked again by the C
# entries before they launch
# ---------------------------------------------------------------------------

#: threads a block: within 6% (K1) and 8% (K8) of the best of 32-256 at
#: every shape ``chip_smoke.py``'s launch sweep times on the H100 (Criteo
#: b = 256 and 1024 at d = 1 and 32, a misaligned view, Fig. 11's four)
GATHER_THREADS, INPUT_FIRST_THREADS = 128, 64
#: K2–K6: within 2% of the best block size at every shape of
#: ``chip_smoke.py``'s launch sweep on the H100 (Criteo b = 256 and 1024,
#: h = 1 and 5; K2, K3 and K5 over 64-256, K4 and K6 over 32-256) but one:
#: K2 at b = 256, h = 1, where 256 threads took 5-7% less
TIERED_THREADS = 128
#: K7: with one row a thread, within 2% of the best of 32-256 threads ×
#: 1-2 rows at every shape of ``chip_smoke.py``'s launch sweep on the H100
#: (b = 256 and 1024, fp32 and bf16 at d = 32, views 4 and 2 bytes in);
#: 128 threads took up to 27% more on the views
ONEHOT_THREADS = 256
_MAX_BLOCKS = 1 << 20      # the kernels stride over the rows past it


class Launch(NamedTuple):
    """How a launch covers its rows: ``vec`` wide words (K1, K7 and K8:
    16-byte words, else 4-byte or, K7, the element's; K2–K6: 4 elements
    a lane and a float4 store, else one element; K11: 4 floats a lane as
    one 16-byte load, else one float; K9/K10: pieces of 4 floats, else of
    one), ``lanes`` threads a row (K11: a field's row; 1 for K9/K10) and
    ``rows`` rows a thread (1 for K2–K8 and K11; K9/K10: pieces a
    thread), ``threads`` a block,
    ``blocks`` in the grid; K2–K7 and K9/K10 also ``word``, the bytes a
    load takes (:func:`tier_word`, :func:`onehot_word`,
    ``fused_cross.cross_launch``)."""
    vec: bool
    lanes: int
    rows: int
    threads: int
    blocks: int
    word: int = 0


def vector_words(d: int, *pointers: int) -> bool:
    """Whether rows of ``d`` float32 at these base addresses can move as
    16-byte words: ``d % 4 == 0`` and every pointer 16-byte aligned (a
    table view at a 4-byte storage offset is not)."""
    return d % 4 == 0 and all(ptr % 16 == 0 for ptr in pointers)


def _grid(work: int, threads: int) -> int:
    return min(_MAX_BLOCKS, max(1, math.ceil(work / threads)))


def _lanes(words: int) -> int:
    """Lanes a row: the power of two up to 32 that covers ``words``."""
    return min(32, 1 << max(0, words - 1).bit_length())


def gather_launch(b: int, k: int, d: int, vec: bool) -> Launch:
    """K1's launch: ``lanes``, the power of two up to 32 that covers a
    row's words; two rows a thread where the words are floats and a row
    takes a whole warp, else one; a grid with a group of lanes for every
    row (for every two rows)."""
    lanes = _lanes(d // 4 if vec else d)
    rows = 2 if not vec and lanes == 32 else 1
    return Launch(vec, lanes, rows, GATHER_THREADS,
                  _grid(math.ceil(b * k / rows) * lanes, GATHER_THREADS))


def input_first_launch(b: int, k: int, vec: bool) -> Launch:
    """K8's launch: one thread per (sample, field), 64 a block."""
    return Launch(vec, 1, 1, INPUT_FIRST_THREADS,
                  _grid(b * k, INPUT_FIRST_THREADS))


def tier_word(d: int, itemsize: int, *tiers: int) -> int:
    """The bytes a K2–K6 load takes from rows of ``d`` elements of
    ``itemsize`` bytes (4 fp32, 1 int8) at the tiers' base addresses
    ``tiers`` (K2's one table, K3–K6's two tiers): a word of 4 elements
    (16 bytes fp32, 4 int8) where ``d % 4 == 0`` and every tier is aligned
    to it, else one element (a view 4 bytes, or 1 byte, into its storage,
    or ``d % 4 != 0``)."""
    word = 4 * itemsize
    aligned = d % 4 == 0 and all(ptr % word == 0 for ptr in tiers)
    return word if aligned else itemsize


def tiered_launch(b: int, k: int, h: int, d: int, word: int) -> Launch:
    """K2–K6's launch for ``(b, k, h)`` ids and rows of ``d`` elements
    loaded ``word`` bytes at a time (:func:`tier_word`): 4 elements a lane
    (``vec``) where ``d % 4 == 0``, else one; ``lanes``, the power of two
    up to 32 that covers a row's pieces; one row a thread; a grid with a
    group of lanes for every row; the same for one-hot and pooled rows.
    In ``chip_smoke.py``'s sweep on the H100 a second row a thread and
    streaming stores paid at no shape, and 16-byte words of int8 codes
    only for pooled rows at b = 1024, which no served plan sends
    (``PERF.md``)."""
    vec = d % 4 == 0
    lanes = _lanes(d // 4 if vec else d)
    return Launch(vec, lanes, 1, TIERED_THREADS,
                  _grid(b * k * lanes, TIERED_THREADS), word)


def onehot_word(d: int, itemsize: int, table: int, out: int) -> int:
    """The bytes a K7 load takes from rows of ``d`` elements of
    ``itemsize`` bytes (4 fp32, 2 bf16), the stacked tables at address
    ``table`` and the output at ``out``: the largest of 16, 4 and
    ``itemsize`` that divides a row's bytes and both addresses (fp32 or
    bf16 at d = 32: 16; fp32 on a view 4 bytes in: 4; bf16 on a view 2
    bytes in, or at d = 3: 2)."""
    for word in (16, 4):
        if (d * itemsize) % word == 0 and table % word == 0 \
                and out % word == 0:
            return word
    return itemsize


def onehot_launch(b: int, k: int, d: int, word: int,
                  itemsize: int) -> Launch:
    """K7's launch for ``(b, k)`` ids and rows of ``d`` elements of
    ``itemsize`` bytes moved ``word`` bytes at a time
    (:func:`onehot_word`): ``lanes``, the power of two up to 32 that
    covers a row's words; one row a thread (in the sweep a second row
    paid only in blocks of 128 threads or fewer, and no more than 256
    threads did); ``ONEHOT_THREADS`` a block; a grid with a group of
    lanes for every row, striding over the rows past ``_MAX_BLOCKS``."""
    lanes = _lanes(d * itemsize // word)
    return Launch(word == 16, lanes, 1, ONEHOT_THREADS,
                  _grid(b * k * lanes, ONEHOT_THREADS), word)


def mtl_gather_plain(ids: torch.Tensor, offsets: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the same clamp, one gather)."""
    b, k = ids.shape
    rows = ids.to(torch.int64) + offsets.to(torch.int64)[None, :]
    rows = rows.clamp_(0, table.shape[0] - 1).reshape(-1)
    return table.index_select(0, rows).reshape(b, k * table.shape[1])


@functools.cache
def _kernel():
    fn = _build.library("mtl_gather").mtl_gather
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 \
        + [ctypes.c_int] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mtl_gather(ids: torch.Tensor, offsets: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    """Fused multi-table gather.

    Args:
        ids:     (b, k) int32 per-field local ids.
        offsets: (k,) int32 starting row of each field in ``table``.
        table:   (N, d) float32 mega-table.

    Returns:
        (b, k*d) float32: row ``s`` holds the k looked-up rows side by side.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream.
    """
    dev = table.device
    _build.check_tensor("ids", ids, torch.int32, 2, dev)
    _build.check_tensor("offsets", offsets, torch.int32, 1, dev)
    _build.check_tensor("table", table, torch.float32, 2, dev)
    b, k = ids.shape
    n_rows, d = table.shape
    if offsets.shape[0] != k:
        raise ValueError(f"offsets has {offsets.shape[0]} entries for "
                         f"{k} fields")
    if n_rows == 0:
        raise ValueError("table has no rows")
    if dev.type == "cpu":
        return mtl_gather_plain(ids, offsets, table)
    out = torch.empty((b, k * d), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    launch = gather_launch(
        b, k, d, vector_words(d, table.data_ptr(), out.data_ptr()))
    with torch.cuda.device(dev):
        code = _kernel()(ids.data_ptr(), offsets.data_ptr(), table.data_ptr(),
                         out.data_ptr(), b, k, d, n_rows, int(launch.vec),
                         launch.lanes.bit_length() - 1, launch.rows,
                         launch.threads, launch.blocks,
                         _build.current_stream(dev))
    _build.check_launch("mtl_gather", code)
    _build.count_launch(mtl_gather)
    return out


mtl_gather.launches = 0


# ---------------------------------------------------------------------------
# K2–K6: pooled, two-level and three-level gathers
# (csrc/mtl_gather_tiered.cu)
# ---------------------------------------------------------------------------

def _slot_rows(ids: torch.Tensor, offsets: torch.Tensor,
               mask: torch.Tensor | None, n_rows: int) -> torch.Tensor:
    """(b, k, h) global rows as the kernels compute them: id + offset,
    masked slots redirected to row ``n_rows - 1``, clamped into
    ``[0, n_rows)``."""
    rows = ids.to(torch.int64) + offsets.to(torch.int64)[None, :, None]
    if mask is not None:
        rows = torch.where(mask != 0, rows, n_rows - 1)
    return rows.clamp_(0, n_rows - 1)


def _shard_rows(rows: torch.Tensor, shard: tuple[int, int] | None,
                n_local: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Global rows -> rows of a row shard holding global rows
    ``[shard[0], shard[0] + n_local)``, indexed from 0, and which rows lie
    in it (``None``: the whole table, every row). Rows outside it read
    local row 0 and are zeroed by :func:`_in_shard`."""
    if shard is None:
        return rows, None
    local = rows - shard[0]
    valid = (local >= 0) & (local < n_local)
    return torch.where(valid, local, 0), valid


def _in_shard(vals: torch.Tensor, valid: torch.Tensor | None
              ) -> torch.Tensor:
    """(n, d) values with the rows outside the shard set to +0.0."""
    if valid is None:
        return vals
    return torch.where(valid.reshape(-1, 1), vals, 0.0)


def _check_shard(shard: tuple[int, int] | None, n_local: int
                 ) -> tuple[int, int]:
    """``(n_rows, row_lo)`` of a shard argument: the whole table's height
    and the shard's first global row (``None``: a whole table of
    ``n_local`` rows)."""
    if shard is None:
        return n_local, 0
    row_lo, n_rows = (int(v) for v in shard)
    if row_lo < 0 or row_lo + n_local > n_rows:
        raise ValueError(f"a shard of {n_local} rows from row {row_lo} does "
                         f"not fit a {n_rows}-row table")
    return n_rows, row_lo


def _pool(vals: torch.Tensor, b: int, k: int, h: int) -> torch.Tensor:
    """(b*k*h, d) slot values -> (b, k*d), summed over the h slots in slot
    order starting from slot 0 (the kernels' order, not ``sum``'s)."""
    d = vals.shape[-1]
    vals = vals.reshape(b, k, h, d)
    acc = vals[:, :, 0]
    for j in range(1, h):
        acc = acc + vals[:, :, j]
    return acc.reshape(b, k * d)


def _as_slots(ids: torch.Tensor) -> torch.Tensor:
    return ids if ids.dim() == 3 else ids.unsqueeze(-1)


def mtl_gather_multihot_plain(ids: torch.Tensor, mask: torch.Tensor | None,
                              offsets: torch.Tensor, table: torch.Tensor, *,
                              shard: tuple[int, int] | None = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of K2."""
    ids = _as_slots(ids)
    b, k, h = ids.shape
    n_local = table.shape[0]
    rows = _slot_rows(ids, offsets, mask,
                      _check_shard(shard, n_local)[0]).reshape(-1)
    rows, valid = _shard_rows(rows, shard, n_local)
    return _pool(_in_shard(table.index_select(0, rows), valid), b, k, h)


def mtl_gather_two_level_plain(ids: torch.Tensor, offsets: torch.Tensor,
                               slot_of_row: torch.Tensor,
                               cache: torch.Tensor, backing: torch.Tensor,
                               mask: torch.Tensor | None = None, *,
                               shard: tuple[int, int] | None = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of K3."""
    ids = _as_slots(ids)
    b, k, h = ids.shape
    n_local = backing.shape[0]
    rows = _slot_rows(ids, offsets, mask,
                      _check_shard(shard, n_local)[0]).reshape(-1)
    rows, valid = _shard_rows(rows, shard, n_local)
    return _pool(_in_shard(ref_two_level_gather(rows, slot_of_row, cache,
                                                backing), valid), b, k, h)


def mtl_gather_two_level_q8_plain(ids: torch.Tensor, offsets: torch.Tensor,
                                  slot_of_row: torch.Tensor,
                                  cache: torch.Tensor,
                                  cache_scale: torch.Tensor,
                                  backing: torch.Tensor,
                                  backing_scale: torch.Tensor,
                                  mask: torch.Tensor | None = None, *,
                                  shard: tuple[int, int] | None = None
                                  ) -> torch.Tensor:
    """Plain PyTorch version of K4."""
    ids = _as_slots(ids)
    b, k, h = ids.shape
    n_local = backing.shape[0]
    rows = _slot_rows(ids, offsets, mask,
                      _check_shard(shard, n_local)[0]).reshape(-1)
    rows, valid = _shard_rows(rows, shard, n_local)
    return _pool(_in_shard(ref_two_level_gather_q8(
        rows, slot_of_row, cache, cache_scale, backing, backing_scale),
        valid), b, k, h)


def mtl_gather_three_level_plain(ids: torch.Tensor, offsets: torch.Tensor,
                                 slot_of_row: torch.Tensor,
                                 staging_slot_of_row: torch.Tensor,
                                 cache: torch.Tensor, staging: torch.Tensor,
                                 mask: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of K5."""
    ids = _as_slots(ids)
    b, k, h = ids.shape
    rows = _slot_rows(ids, offsets, mask, slot_of_row.shape[0]).reshape(-1)
    return _pool(ref_three_level_gather(rows, slot_of_row,
                                        staging_slot_of_row, cache, staging),
                 b, k, h)


def mtl_gather_three_level_q8_plain(ids: torch.Tensor, offsets: torch.Tensor,
                                    slot_of_row: torch.Tensor,
                                    staging_slot_of_row: torch.Tensor,
                                    cache: torch.Tensor,
                                    cache_scale: torch.Tensor,
                                    staging: torch.Tensor,
                                    staging_scale: torch.Tensor,
                                    mask: torch.Tensor | None = None
                                    ) -> torch.Tensor:
    """Plain PyTorch version of K6."""
    ids = _as_slots(ids)
    b, k, h = ids.shape
    rows = _slot_rows(ids, offsets, mask, slot_of_row.shape[0]).reshape(-1)
    return _pool(ref_three_level_gather_q8(rows, slot_of_row,
                                           staging_slot_of_row, cache,
                                           cache_scale, staging,
                                           staging_scale), b, k, h)


@functools.cache
def _tiered(name: str, n_pointers: int, n_sizes: int):
    fn = getattr(_build.library("mtl_gather_tiered"), name)
    fn.argtypes = [ctypes.c_void_p] * n_pointers \
        + [ctypes.c_int64] * n_sizes + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_slots(ids: torch.Tensor, mask: torch.Tensor | None,
                 offsets: torch.Tensor, dev: torch.device
                 ) -> tuple[torch.Tensor, int, int, int]:
    """Check the id/mask/offset inputs of K2–K6; returns the ids as
    (b, k, h) with b, k, h."""
    if not isinstance(ids, torch.Tensor) or ids.dim() not in (2, 3):
        raise ValueError("ids must be a (b, k) or (b, k, h) tensor")
    _build.check_tensor("ids", ids, torch.int32, ids.dim(), dev)
    ids = _as_slots(ids)
    b, k, h = ids.shape
    _build.check_tensor("offsets", offsets, torch.int32, 1, dev)
    if offsets.shape[0] != k:
        raise ValueError(f"offsets has {offsets.shape[0]} entries for "
                         f"{k} fields")
    if mask is not None:
        _build.check_tensor("mask", mask, torch.float32, 3, dev)
        if tuple(mask.shape) != (b, k, h):
            raise ValueError(f"mask has shape {tuple(mask.shape)}, ids "
                             f"{(b, k, h)}")
    if h < 1:
        raise ValueError("ids need at least one slot per field")
    return ids, b, k, h


def _check_table(name: str, t: torch.Tensor, dtype: torch.dtype,
                 dev: torch.device, d: int | None = None) -> None:
    _build.check_tensor(name, t, dtype, 2, dev)
    if t.shape[0] == 0:
        raise ValueError(f"{name} has no rows")
    if d is not None and t.shape[1] != d:
        raise ValueError(f"{name} rows have width {t.shape[1]}, expected {d}")


def _check_scale(name: str, t: torch.Tensor, rows: int,
                 dev: torch.device) -> None:
    _build.check_tensor(name, t, torch.float32, 2, dev)
    if tuple(t.shape) != (rows, 1):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{(rows, 1)}")


def _check_map(slot_of_row: torch.Tensor, n_rows: int,
               dev: torch.device, name: str = "slot_of_row") -> None:
    _build.check_tensor(name, slot_of_row, torch.int32, 1, dev)
    if slot_of_row.shape[0] != n_rows:
        raise ValueError(f"{name} has {slot_of_row.shape[0]} entries "
                         f"for {n_rows} backing rows")


def _check_maps(slot_of_row: torch.Tensor, staging_slot_of_row: torch.Tensor,
                dev: torch.device) -> int:
    """Check K5/K6's two maps, which must have one entry per global row
    each; returns that row count."""
    _build.check_tensor("slot_of_row", slot_of_row, torch.int32, 1, dev)
    n_rows = slot_of_row.shape[0]
    if n_rows == 0:
        raise ValueError("slot_of_row has no entries")
    _check_map(staging_slot_of_row, n_rows, dev, "staging_slot_of_row")
    return n_rows


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _tiered_args(launch: Launch) -> tuple[int, ...]:
    """K2–K6's launch arguments, in their C entries' order."""
    return (int(launch.vec), launch.word, launch.lanes.bit_length() - 1,
            launch.threads, launch.blocks)


def mtl_gather_multihot(ids: torch.Tensor, mask: torch.Tensor | None,
                        offsets: torch.Tensor, table: torch.Tensor, *,
                        shard: tuple[int, int] | None = None
                        ) -> torch.Tensor:
    """K2: pooled (sum) gather of ``h`` ids per (row, field).

    Args:
        ids:     (b, k, h) int32 per-field local ids ((b, k) means h = 1).
        mask:    (b, k, h) float32, nonzero = valid slot; ``None`` = all
                 valid. A masked slot reads row ``N - 1``, the zero row.
        offsets: (k,) int32 starting row of each field in ``table``.
        table:   (N, d) float32 mega-table whose last row is all zero.
        shard:   optional ``(row_lo, n_rows)``: ``table`` holds only global
                 rows ``[row_lo, row_lo + table.shape[0])`` of an
                 ``n_rows``-row table (a vocab-parallel row shard); a slot
                 whose global row lies outside them adds +0.0.

    Returns:
        (b, k*d) float32 pooled rows.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream.
    """
    dev = table.device
    ids, b, k, h = _check_slots(ids, mask, offsets, dev)
    _check_table("table", table, torch.float32, dev)
    n_local, d = table.shape
    n_rows, row_lo = _check_shard(shard, n_local)
    if dev.type == "cpu":
        return mtl_gather_multihot_plain(ids, mask, offsets, table,
                                         shard=shard)
    out = torch.empty((b, k * d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    launch = tiered_launch(b, k, h, d, tier_word(d, 4, table.data_ptr()))
    with torch.cuda.device(dev):
        code = _tiered("mtl_gather_multihot", 5, 12)(
            ids.data_ptr(), _ptr(mask), offsets.data_ptr(),
            table.data_ptr(), out.data_ptr(), b, k, h, d, n_rows, row_lo,
            n_local, *_tiered_args(launch), _build.current_stream(dev))
    _build.check_launch("mtl_gather_multihot", code)
    _build.count_launch(mtl_gather_multihot)
    return out


def mtl_gather_two_level(ids: torch.Tensor, offsets: torch.Tensor,
                         slot_of_row: torch.Tensor, cache: torch.Tensor,
                         backing: torch.Tensor,
                         mask: torch.Tensor | None = None, *,
                         shard: tuple[int, int] | None = None
                         ) -> torch.Tensor:
    """K3: two-level gather — cache hits from ``cache``, misses from
    ``backing`` — pooled over ``h`` ids per (row, field) (h = 1 is the
    one-hot lookup).

    Args:
        ids:         (b, k) or (b, k, h) int32 per-field local ids.
        offsets:     (k,) int32 starting row of each field.
        slot_of_row: (N,) int32 cache slot per global row, -1 = uncached.
        cache:       (C, d) float32 hot-row copies.
        backing:     (N, d) float32 full mega-table (last row all zero).
        mask:        optional (b, k, h) float32; masked slots read row N-1.
        shard:       optional ``(row_lo, n_rows)``: ``backing`` and
                     ``slot_of_row`` hold only global rows ``[row_lo,
                     row_lo + backing.shape[0])`` of an ``n_rows``-row
                     table (a vocab-parallel row shard; ``cache`` whole); a
                     slot whose global row lies outside them adds +0.0.

    Returns:
        (b, k*d) float32.
    """
    dev = backing.device
    ids, b, k, h = _check_slots(ids, mask, offsets, dev)
    _check_table("backing", backing, torch.float32, dev)
    n_local, d = backing.shape
    n_rows, row_lo = _check_shard(shard, n_local)
    _check_table("cache", cache, torch.float32, dev, d)
    _check_map(slot_of_row, n_local, dev)
    if dev.type == "cpu":
        return mtl_gather_two_level_plain(ids, offsets, slot_of_row, cache,
                                          backing, mask, shard=shard)
    out = torch.empty((b, k * d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    launch = tiered_launch(b, k, h, d, tier_word(
        d, cache.element_size(), cache.data_ptr(), backing.data_ptr()))
    with torch.cuda.device(dev):
        code = _tiered("mtl_gather_two_level", 7, 13)(
            ids.data_ptr(), _ptr(mask), offsets.data_ptr(),
            slot_of_row.data_ptr(), cache.data_ptr(), backing.data_ptr(),
            out.data_ptr(), b, k, h, d, cache.shape[0], n_rows, row_lo,
            n_local, *_tiered_args(launch), _build.current_stream(dev))
    _build.check_launch("mtl_gather_two_level", code)
    _build.count_launch(mtl_gather_two_level)
    return out


def mtl_gather_two_level_q8(ids: torch.Tensor, offsets: torch.Tensor,
                            slot_of_row: torch.Tensor, cache: torch.Tensor,
                            cache_scale: torch.Tensor, backing: torch.Tensor,
                            backing_scale: torch.Tensor,
                            mask: torch.Tensor | None = None, *,
                            shard: tuple[int, int] | None = None
                            ) -> torch.Tensor:
    """K4: K3 on int8 rows, each dequantized (``q * scale``, the scale from
    the same tier) before the fp32 pool.

    Args:
        ids, offsets, slot_of_row, mask, shard: as
            :func:`mtl_gather_two_level` (a shard's ``backing_scale`` holds
            its rows' scales).
        cache:         (C, d) int8 hot-row copies.
        cache_scale:   (C, 1) float32 per-row scales.
        backing:       (N, d) int8 full mega-table.
        backing_scale: (N, 1) float32 per-row scales.

    Returns:
        (b, k*d) float32.
    """
    dev = backing.device
    ids, b, k, h = _check_slots(ids, mask, offsets, dev)
    _check_table("backing", backing, torch.int8, dev)
    n_local, d = backing.shape
    n_rows, row_lo = _check_shard(shard, n_local)
    _check_table("cache", cache, torch.int8, dev, d)
    _check_scale("backing_scale", backing_scale, n_local, dev)
    _check_scale("cache_scale", cache_scale, cache.shape[0], dev)
    _check_map(slot_of_row, n_local, dev)
    if dev.type == "cpu":
        return mtl_gather_two_level_q8_plain(ids, offsets, slot_of_row,
                                             cache, cache_scale, backing,
                                             backing_scale, mask,
                                             shard=shard)
    out = torch.empty((b, k * d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    launch = tiered_launch(b, k, h, d, tier_word(
        d, cache.element_size(), cache.data_ptr(), backing.data_ptr()))
    with torch.cuda.device(dev):
        code = _tiered("mtl_gather_two_level_q8", 9, 13)(
            ids.data_ptr(), _ptr(mask), offsets.data_ptr(),
            slot_of_row.data_ptr(), cache.data_ptr(),
            cache_scale.data_ptr(), backing.data_ptr(),
            backing_scale.data_ptr(), out.data_ptr(), b, k, h, d,
            cache.shape[0], n_rows, row_lo, n_local, *_tiered_args(launch),
            _build.current_stream(dev))
    _build.check_launch("mtl_gather_two_level_q8", code)
    _build.count_launch(mtl_gather_two_level_q8)
    return out


def mtl_gather_three_level(ids: torch.Tensor, offsets: torch.Tensor,
                           slot_of_row: torch.Tensor,
                           staging_slot_of_row: torch.Tensor,
                           cache: torch.Tensor, staging: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """K5: three-level gather — cache hits from ``cache``, staged misses
    from ``staging``, anything else zero (the guard) — pooled over ``h``
    ids per (row, field) (h = 1 is the one-hot lookup).

    Args:
        ids:                 (b, k) or (b, k, h) int32 per-field local ids.
        offsets:             (k,) int32 starting row of each field.
        slot_of_row:         (N,) int32 cache slot per global row, -1 =
                             uncached.
        staging_slot_of_row: (N,) int32 staging slot per global row, -1 =
                             unstaged.
        cache:               (C, d) float32 hot-row copies.
        staging:             (S, d) float32 staged miss rows.
        mask:                optional (b, k, h) float32; masked slots read
                             row N-1.

    Returns:
        (b, k*d) float32.
    """
    dev = cache.device
    ids, b, k, h = _check_slots(ids, mask, offsets, dev)
    _check_table("cache", cache, torch.float32, dev)
    d = cache.shape[1]
    _check_table("staging", staging, torch.float32, dev, d)
    n_rows = _check_maps(slot_of_row, staging_slot_of_row, dev)
    if dev.type == "cpu":
        return mtl_gather_three_level_plain(ids, offsets, slot_of_row,
                                            staging_slot_of_row, cache,
                                            staging, mask)
    out = torch.empty((b, k * d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    launch = tiered_launch(b, k, h, d, tier_word(
        d, cache.element_size(), cache.data_ptr(), staging.data_ptr()))
    with torch.cuda.device(dev):
        code = _tiered("mtl_gather_three_level", 8, 12)(
            ids.data_ptr(), _ptr(mask), offsets.data_ptr(),
            slot_of_row.data_ptr(), staging_slot_of_row.data_ptr(),
            cache.data_ptr(), staging.data_ptr(), out.data_ptr(), b, k, h,
            d, cache.shape[0], staging.shape[0], n_rows,
            *_tiered_args(launch), _build.current_stream(dev))
    _build.check_launch("mtl_gather_three_level", code)
    _build.count_launch(mtl_gather_three_level)
    return out


def mtl_gather_three_level_q8(ids: torch.Tensor, offsets: torch.Tensor,
                              slot_of_row: torch.Tensor,
                              staging_slot_of_row: torch.Tensor,
                              cache: torch.Tensor, cache_scale: torch.Tensor,
                              staging: torch.Tensor,
                              staging_scale: torch.Tensor,
                              mask: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """K6: K5 on int8 rows, each dequantized (``q * scale``, the scale
    from the winning tier) before the fp32 pool; a row in neither tier
    gives exactly 0.0.

    Args:
        ids, offsets, slot_of_row, staging_slot_of_row, mask: as
            :func:`mtl_gather_three_level`.
        cache:         (C, d) int8 hot-row copies.
        cache_scale:   (C, 1) float32 per-row scales.
        staging:       (S, d) int8 staged miss rows.
        staging_scale: (S, 1) float32 per-row scales.

    Returns:
        (b, k*d) float32.
    """
    dev = cache.device
    ids, b, k, h = _check_slots(ids, mask, offsets, dev)
    _check_table("cache", cache, torch.int8, dev)
    d = cache.shape[1]
    _check_table("staging", staging, torch.int8, dev, d)
    _check_scale("cache_scale", cache_scale, cache.shape[0], dev)
    _check_scale("staging_scale", staging_scale, staging.shape[0], dev)
    n_rows = _check_maps(slot_of_row, staging_slot_of_row, dev)
    if dev.type == "cpu":
        return mtl_gather_three_level_q8_plain(
            ids, offsets, slot_of_row, staging_slot_of_row, cache,
            cache_scale, staging, staging_scale, mask)
    out = torch.empty((b, k * d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    launch = tiered_launch(b, k, h, d, tier_word(
        d, cache.element_size(), cache.data_ptr(), staging.data_ptr()))
    with torch.cuda.device(dev):
        code = _tiered("mtl_gather_three_level_q8", 10, 12)(
            ids.data_ptr(), _ptr(mask), offsets.data_ptr(),
            slot_of_row.data_ptr(), staging_slot_of_row.data_ptr(),
            cache.data_ptr(), cache_scale.data_ptr(), staging.data_ptr(),
            staging_scale.data_ptr(), out.data_ptr(), b, k, h, d,
            cache.shape[0], staging.shape[0], n_rows, *_tiered_args(launch),
            _build.current_stream(dev))
    _build.check_launch("mtl_gather_three_level_q8", code)
    _build.count_launch(mtl_gather_three_level_q8)
    return out


mtl_gather_multihot.launches = 0
mtl_gather_two_level.launches = 0
mtl_gather_two_level_q8.launches = 0
mtl_gather_three_level.launches = 0
mtl_gather_three_level_q8.launches = 0


# ---------------------------------------------------------------------------
# K8: input-first gather (csrc/mtl_input_first.cu)
# ---------------------------------------------------------------------------

def _sample_major(out_fmajor: torch.Tensor) -> torch.Tensor:
    """(k, b, d) field-major -> (b, k*d): the transpose pass input-first
    designs pay for (a plain copy, as in the reference)."""
    k, b, d = out_fmajor.shape
    return out_fmajor.permute(1, 0, 2).reshape(b, k * d)


def mtl_input_first_plain(ids: torch.Tensor, offsets: torch.Tensor,
                          table: torch.Tensor, *,
                          field_major: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K8 (the same clamp, one gather into the
    field-major buffer)."""
    b, k = ids.shape
    rows = ids.to(torch.int64) + offsets.to(torch.int64)[None, :]
    rows = rows.clamp_(0, table.shape[0] - 1).t().reshape(-1)
    out = table.index_select(0, rows).reshape(k, b, table.shape[1])
    return out if field_major else _sample_major(out)


@functools.cache
def _input_first_kernel():
    fn = _build.library("mtl_input_first").mtl_input_first
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 \
        + [ctypes.c_int] * 2 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mtl_input_first(ids: torch.Tensor, offsets: torch.Tensor,
                    table: torch.Tensor, *,
                    field_major: bool = False) -> torch.Tensor:
    """K8: input-first multi-table gather (the Fig.-11 strawman).

    Args:
        ids:         (b, k) int32 per-field local ids.
        offsets:     (k,) int32 starting row of each field in ``table``.
        table:       (N, d) float32 mega-table.
        field_major: return the kernel's own (k, b, d) buffer, before the
                     transpose (to time the kernel alone).

    Returns:
        (b, k*d) float32, bitwise :func:`mtl_gather`'s (or (k, b, d)).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream, then transpose with PyTorch.
    """
    dev = table.device
    _build.check_tensor("ids", ids, torch.int32, 2, dev)
    _build.check_tensor("offsets", offsets, torch.int32, 1, dev)
    _build.check_tensor("table", table, torch.float32, 2, dev)
    b, k = ids.shape
    n_rows, d = table.shape
    if offsets.shape[0] != k:
        raise ValueError(f"offsets has {offsets.shape[0]} entries for "
                         f"{k} fields")
    if n_rows == 0:
        raise ValueError("table has no rows")
    if dev.type == "cpu":
        return mtl_input_first_plain(ids, offsets, table,
                                     field_major=field_major)
    out = torch.empty((k, b, d), dtype=table.dtype, device=dev)
    if out.numel() > 0:
        launch = input_first_launch(
            b, k, vector_words(d, table.data_ptr(), out.data_ptr()))
        with torch.cuda.device(dev):
            code = _input_first_kernel()(
                ids.data_ptr(), offsets.data_ptr(), table.data_ptr(),
                out.data_ptr(), b, k, d, n_rows, int(launch.vec),
                launch.threads, launch.blocks, _build.current_stream(dev))
        _build.check_launch("mtl_input_first", code)
        _build.count_launch(mtl_input_first)
    return out if field_major else _sample_major(out)


mtl_input_first.launches = 0


# ---------------------------------------------------------------------------
# K7: one-hot lookup over small padded tables (csrc/mtl_onehot.cu)
# ---------------------------------------------------------------------------

_ONEHOT_DTYPES = (torch.float32, torch.bfloat16)


def mtl_onehot_plain(ids: torch.Tensor,
                     stacked_tables: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: per field, the id's row of that
    field's table, or zeros for an id outside ``[0, n_pad)``."""
    k, n_pad, d = stacked_tables.shape
    ids = ids.to(torch.int64)
    valid = (ids >= 0) & (ids < n_pad)
    field = torch.arange(k, device=ids.device)[None, :]
    rows = stacked_tables[field, ids.clamp(0, n_pad - 1)]     # (b, k, d)
    return torch.where(valid[..., None], rows,
                       torch.zeros((), dtype=stacked_tables.dtype,
                                   device=ids.device))


@functools.cache
def _onehot_kernel():
    fn = _build.library("mtl_onehot").mtl_onehot
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 \
        + [ctypes.c_int] * 3 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _onehot_args(launch: Launch) -> tuple[int, ...]:
    """K7's launch arguments, in its C entry's order."""
    return (launch.word, launch.lanes, launch.rows, launch.threads,
            launch.blocks)


def mtl_onehot(ids: torch.Tensor, stacked_tables: torch.Tensor
               ) -> torch.Tensor:
    """K7: one-hot lookup for a group of small fields.

    Args:
        ids:            (b, k) int32 per-field local ids.
        stacked_tables: (k, n_pad, d) float32 or bfloat16, each field's
                        table padded to one height.

    Returns:
        (b, k, d) in the tables' dtype; a row is zero where the id lies
        outside ``[0, n_pad)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream.
    """
    dev = stacked_tables.device
    if stacked_tables.dtype not in _ONEHOT_DTYPES:
        raise TypeError(f"stacked_tables must be one of {_ONEHOT_DTYPES}, "
                        f"got {stacked_tables.dtype}")
    _build.check_tensor("stacked_tables", stacked_tables,
                        stacked_tables.dtype, 3, dev)
    _build.check_tensor("ids", ids, torch.int32, 2, dev)
    b, k = ids.shape
    k_t, n_pad, d = stacked_tables.shape
    if k_t != k:
        raise ValueError(f"stacked_tables has {k_t} fields, ids {k}")
    if n_pad == 0:
        raise ValueError("stacked_tables has no rows")
    if dev.type == "cpu":
        return mtl_onehot_plain(ids, stacked_tables)
    out = torch.empty((b, k, d), dtype=stacked_tables.dtype, device=dev)
    if out.numel() == 0:
        return out
    itemsize = stacked_tables.element_size()
    launch = onehot_launch(b, k, d, onehot_word(
        d, itemsize, stacked_tables.data_ptr(), out.data_ptr()), itemsize)
    with torch.cuda.device(dev):
        code = _onehot_kernel()(ids.data_ptr(), stacked_tables.data_ptr(),
                                out.data_ptr(), b, k, n_pad, d, itemsize,
                                *_onehot_args(launch),
                                _build.current_stream(dev))
    _build.check_launch("mtl_onehot", code)
    _build.count_launch(mtl_onehot)
    return out


mtl_onehot.launches = 0

"""Hand-written CUDA kernels of the ported paths, their wrappers and their
plain PyTorch versions.

  K1  mtl_gather               csrc/mtl_gather.cu         (multi_table_lookup.py)
  K2  mtl_gather_multihot      csrc/mtl_gather_tiered.cu  (multi_table_lookup.py)
  K3  mtl_gather_two_level     csrc/mtl_gather_tiered.cu  (multi_table_lookup.py)
  K4  mtl_gather_two_level_q8  csrc/mtl_gather_tiered.cu  (multi_table_lookup.py)
  K5  mtl_gather_three_level   csrc/mtl_gather_tiered.cu  (multi_table_lookup.py)
  K6  mtl_gather_three_level_q8 csrc/mtl_gather_tiered.cu (multi_table_lookup.py)
  K7  mtl_onehot               csrc/mtl_onehot.cu         (multi_table_lookup.py)
  K8  mtl_input_first          csrc/mtl_input_first.cu    (multi_table_lookup.py)
  K9  fused_cross_v2           csrc/fused_cross.cu        (fused_cross.py)
  K10 fused_cross_v1           csrc/fused_cross.cu        (fused_cross.py)
  K11 fused_fm_second_order    csrc/fused_fm.cu           (fused_fm.py)
  K12 dmm_q8                   csrc/dense_matmul_q8.cu    (dense_matmul.py)
      quantize_rows_q8         csrc/quantize_rows_q8.cu   (quantize.py)

K2–K6 are one CUDA kernel, ``tiered_kernel``, over a tier policy (K2's
one table, K3/K4's cache and backing, K5/K6's cache and staging area) and
the row's element type, with one launch rule (``tier_word``,
``tiered_launch``): a group of lanes builds a (sample, field) row, 4
elements a lane. K11 gives a batch row a warp and a field's row a group
of lanes (``fm_launch``), and copies a row's pieces into shared memory
(``cp.async``, up to 16 fields a group at a time) before it sums them. ``quantize_rows_q8`` has no TPU counterpart: it fuses the
reference's jnp activation quantizer, which feeds K12, into one launch.

K1, K9, K10 and K11 carry the training path too: ``autograd.py`` wraps
each in a ``torch.autograd.Function`` whose backward is a plain PyTorch
formula.

Each wrapper counts its launches in ``<wrapper>.launches`` through one
locked increment (``_build.count_launch``), so the count is exact when
several threads launch; a run can reset and read them all with
:func:`reset_launch_counts` and :func:`launch_counts`. Importing this package builds nothing: the CUDA
libraries are compiled at the first launch (``_build``).
"""

from . import _build
from .dense_matmul import dmm_q8
from .fused_cross import fused_cross_v1, fused_cross_v2
from .fused_fm import fused_fm_second_order
from .multi_table_lookup import (mtl_gather, mtl_gather_multihot,
                                 mtl_gather_three_level,
                                 mtl_gather_three_level_q8,
                                 mtl_gather_two_level,
                                 mtl_gather_two_level_q8, mtl_input_first,
                                 mtl_onehot)
from .quantize import quantize_rows_q8

KERNELS = {
    "mtl_gather": mtl_gather,
    "mtl_gather_multihot": mtl_gather_multihot,
    "mtl_gather_two_level": mtl_gather_two_level,
    "mtl_gather_two_level_q8": mtl_gather_two_level_q8,
    "mtl_gather_three_level": mtl_gather_three_level,
    "mtl_gather_three_level_q8": mtl_gather_three_level_q8,
    "mtl_onehot": mtl_onehot,
    "mtl_input_first": mtl_input_first,
    "fused_cross_v2": fused_cross_v2,
    "fused_cross_v1": fused_cross_v1,
    "fused_fm_second_order": fused_fm_second_order,
    "dmm_q8": dmm_q8,
    "quantize_rows_q8": quantize_rows_q8,
}


def launch_counts() -> dict[str, int]:
    with _build._count_lock:
        return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    with _build._count_lock:
        for fn in KERNELS.values():
            fn.launches = 0


__all__ = ["KERNELS", "launch_counts", "reset_launch_counts", "mtl_gather",
           "mtl_gather_multihot", "mtl_gather_two_level",
           "mtl_gather_two_level_q8", "mtl_gather_three_level",
           "mtl_gather_three_level_q8", "mtl_onehot", "mtl_input_first",
           "fused_cross_v2", "fused_cross_v1", "fused_fm_second_order",
           "dmm_q8", "quantize_rows_q8"]

"""Hand-written CUDA kernels of the main path, their wrappers and their
plain PyTorch versions.

  K1  mtl_gather             csrc/mtl_gather.cu   (multi_table_lookup.py)
  K9  fused_cross_v2         csrc/fused_cross.cu  (fused_cross.py)
  K10 fused_cross_v1         csrc/fused_cross.cu  (fused_cross.py)
  K11 fused_fm_second_order  csrc/fused_fm.cu     (fused_fm.py)

Each wrapper counts its launches in ``<wrapper>.launches``; a run can
reset and read them all with :func:`reset_launch_counts` and
:func:`launch_counts`. Importing this package builds nothing: the CUDA
libraries are compiled at the first launch (``_build``).
"""

from .fused_cross import fused_cross_v1, fused_cross_v2
from .fused_fm import fused_fm_second_order
from .multi_table_lookup import mtl_gather

KERNELS = {
    "mtl_gather": mtl_gather,
    "fused_cross_v2": fused_cross_v2,
    "fused_cross_v1": fused_cross_v1,
    "fused_fm_second_order": fused_fm_second_order,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["KERNELS", "launch_counts", "reset_launch_counts", "mtl_gather",
           "fused_cross_v2", "fused_cross_v1", "fused_fm_second_order"]

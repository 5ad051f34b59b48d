"""Training substrate: optimizer, checkpointing, loop, metrics.

Counterpart of ``repro.training``, with the int8-compressed
data-parallel reduction (``compression.py``).
"""

from .compression import (BLOCK, compressed_psum_mean,
                          make_compressed_dp_step)
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .metrics import logloss, roc_auc
from .optimizer import (AdamWConfig, TrainState, adamw_init, adamw_update,
                        global_norm)
from .train_loop import TrainLoopConfig, make_ctr_step, run_train_loop

__all__ = [
    "latest_step", "restore_checkpoint", "save_checkpoint",
    "logloss", "roc_auc",
    "AdamWConfig", "TrainState", "adamw_init", "adamw_update", "global_norm",
    "TrainLoopConfig", "make_ctr_step", "run_train_loop",
    "BLOCK", "compressed_psum_mean", "make_compressed_dp_step",
]

"""Training substrate: optimizer, checkpointing, loop, metrics.

Counterpart of ``repro.training``; gradient compression
(``compression.py``) belongs to the multi-device slice (ROADMAP Queue A
item 4).
"""

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
]

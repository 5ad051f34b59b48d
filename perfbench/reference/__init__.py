"""Plain PyTorch references, one module per model, found by the ``model``
key of a configuration file. Each gives ``layout(cfg)``, the weights and
the laws they are drawn from, and ``logits(weights, ids, offsets, cfg,
precision)``. They import nothing of the program."""

from __future__ import annotations

import importlib

__all__ = ["module"]


def module(model: str):
    return importlib.import_module(f"perfbench.reference.{model}")

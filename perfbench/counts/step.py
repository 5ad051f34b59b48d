"""The model's operations for one scored row, from its shapes alone, the
same whatever computes them: ``counts/flops_<model>.py`` for the
configuration's ``model``.

Every matrix product counts 2 FLOP a multiply-add. Bias adds, ReLUs and
elementwise tails (under 0.1% of a row) are left out unless a model's
file says otherwise.
"""

import importlib


def mlp(cfg: dict) -> int:
    """The implicit branch: the gathered rows through ``hidden``."""
    dims = (len(cfg["field_sizes"]) * cfg["embed_dim"], *cfg["hidden"])
    return sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def flops_per_row(cfg: dict) -> int:
    return importlib.import_module(
        f"perfbench.counts.flops_{cfg['model']}").flops_per_row(cfg)

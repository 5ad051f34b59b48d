"""DeepFM: the MLP and its head, and the explicit branch, which has no
product: its FM arithmetic counts one FLOP an operation."""

from perfbench.counts.step import mlp


def flops_per_row(cfg: dict) -> int:
    k, d = len(cfg["field_sizes"]), cfg["embed_dim"]
    head = 2 * cfg["hidden"][-1]
    # sum over fields, its square, the rows' squares and their sum over
    # fields, the difference, the sum over d and the halving
    fm = (k - 1) * d + d + k * d + (k - 1) * d + d + (d - 1) + 1
    linear = (k - 1) + 1            # the d = 1 rows' sum, the bias
    return mlp(cfg) + head + fm + linear + 2   # the two final adds

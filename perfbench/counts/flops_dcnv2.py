"""DCN-V2: the cross layers' (k d, k d) products, the MLP, and the head
over ``[x_L, h_n]``. The cross tails' multiply and add are left out."""

from perfbench.counts.step import mlp


def flops_per_row(cfg: dict) -> int:
    d_in = len(cfg["field_sizes"]) * cfg["embed_dim"]
    cross = cfg["cross_layers"] * 2 * d_in * d_in
    head = 2 * (d_in + cfg["hidden"][-1])
    return cross + mlp(cfg) + head

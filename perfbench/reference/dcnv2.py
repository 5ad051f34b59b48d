"""Plain reference of DCN-V2 (Wang et al., arXiv:2008.13535), as a
configuration file of ``model: dcnv2`` states it.

    x0 = [e_1, ..., e_k]                       the k rows, side by side
    x_{l+1} = x0 * (x_l W_l + b_l) + x_l       l < cross_layers
    h_{i+1} = relu(h_i W_i + b_i), h_0 = x0    every MLP layer, the last too
    logit = [x_L, h_n] W_head + b_head

fp32; the matrix products in ``precision``.
"""

from __future__ import annotations

import torch

from .common import dense, gather, matmul, table


def layout(cfg: dict) -> list:
    d_in = len(cfg["field_sizes"]) * cfg["embed_dim"]
    leaves = [table("emb.mega_table", cfg["field_sizes"], cfg["embed_dim"])]
    dims = (d_in, *cfg["hidden"])
    for i in range(len(cfg["hidden"])):
        leaves += dense(f"mlp.{i}", dims[i], dims[i + 1])
    leaves += dense("head", d_in + dims[-1], 1)
    for i in range(cfg["cross_layers"]):
        leaves += dense(f"cross.{i}", d_in, d_in)
    return leaves


def logits(w: dict, ids: torch.Tensor, off: torch.Tensor, cfg: dict,
           precision: str) -> torch.Tensor:
    x0 = gather(w["emb.mega_table"], ids, off).reshape(ids.shape[0], -1)
    x = x0
    for i in range(cfg["cross_layers"]):
        x = x0 * (matmul(x, w[f"cross.{i}.w"], precision)
                  + w[f"cross.{i}.b"]) + x
    h = x0
    for i in range(len(cfg["hidden"])):
        h = torch.relu(matmul(h, w[f"mlp.{i}.w"], precision)
                       + w[f"mlp.{i}.b"])
    return matmul(torch.cat([x, h], dim=1), w["head.w"], precision) \
        + w["head.b"]

"""Plain reference of DeepFM (Guo et al., arXiv:1703.04247), as a
configuration file of ``model: deepfm`` states it.

    v = (e_1, ..., e_k)                         the k rows of width d
    linear = sum_i w_i + bias                   w_i: the d = 1 table's row
    second = 0.5 * sum_d[(sum_i v_i)^2 - sum_i v_i^2]
    deep = relu(... relu(x0 W_0 + b_0) ...) W_head + b_head
    logit = (linear + second) + deep

fp32; the matrix products in ``precision``.
"""

from __future__ import annotations

import torch

from .common import Leaf, dense, gather, matmul, table


def layout(cfg: dict) -> list:
    d_in = len(cfg["field_sizes"]) * cfg["embed_dim"]
    leaves = [table("emb.mega_table", cfg["field_sizes"], cfg["embed_dim"]),
              table("fm_w.mega_table", cfg["field_sizes"], 1),
              Leaf("fm_bias", (1,), "dense", 0.01)]
    dims = (d_in, *cfg["hidden"])
    for i in range(len(cfg["hidden"])):
        leaves += dense(f"mlp.{i}", dims[i], dims[i + 1])
    leaves += dense("deep_head", dims[-1], 1)
    return leaves


def logits(w: dict, ids: torch.Tensor, off: torch.Tensor, cfg: dict,
           precision: str) -> torch.Tensor:
    b = ids.shape[0]
    v = gather(w["emb.mega_table"], ids, off)                  # (b, k, d)
    linear = gather(w["fm_w.mega_table"], ids, off).reshape(b, -1) \
        .sum(dim=1, keepdim=True) + w["fm_bias"]
    s = v.sum(dim=1)
    second = 0.5 * (s * s - (v * v).sum(dim=1)).sum(dim=-1, keepdim=True)
    h = v.reshape(b, -1)
    for i in range(len(cfg["hidden"])):
        h = torch.relu(matmul(h, w[f"mlp.{i}.w"], precision)
                       + w[f"mlp.{i}.b"])
    deep = matmul(h, w["deep_head.w"], precision) + w["deep_head.b"]
    return (linear + second) + deep

"""DCNv2 (Wang et al. 2021): cross network with full-matrix projection.

Explicit branch: x_{l+1} = x0 ⊙ (W_l x_l + b_l) + x_l — the W_l GEMM feeds
the elementwise tail fused by C5 into the ``cross_v2_tail`` kernel (bias
lives inside the GEMM op, so one global hint serves every layer).
Implicit branch: deep MLP. Head: concat → linear → logit.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import Op, OpGraph

from .common import CTRModel, Dense, emit_embedding_ops, emit_mlp_ops, \
    mlp_layers


class DCNv2(CTRModel):
    def __init__(self, spec, *, device=None):
        super().__init__(spec, device=device)
        kw = dict(device=self.device, dtype=self.dtype)
        d_in = spec.input_dim
        self.mlp = mlp_layers((d_in, *spec.hidden), **kw)
        self.head = Dense(d_in + spec.hidden[-1], 1, **kw)
        self.cross = nn.ModuleList(Dense(d_in, d_in, **kw)
                                   for _ in range(spec.cross_layers))

    def build_graph(self, level: str) -> OpGraph:
        g = OpGraph(["ids"])
        emit_embedding_ops(g, self.embedding, level)

        # explicit: cross network v2
        cur = "x_embed"
        n_layers = len(self.cross)
        for li, layer in enumerate(self.cross):
            w, b = layer.w, layer.b
            g.add(Op(f"cross_gemm{li}",
                     lambda x, _w=w, _b=b: x @ _w + _b,
                     (cur,), f"xw{li}", is_gemm=True, module="explicit"))
            out_edge = ("explicit_out" if li == n_layers - 1
                        else f"x_cross{li}")
            g.add(Op(f"cross_mul{li}",
                     lambda x0, xw: x0 * xw,
                     ("x_embed", f"xw{li}"), f"cm{li}",
                     module="explicit", fused_hint="cross_v2_tail"))
            g.add(Op(f"cross_res{li}",
                     lambda m, x: m + x,
                     (f"cm{li}", cur), out_edge,
                     module="explicit", fused_hint="cross_v2_tail"))
            cur = out_edge

        # implicit: deep MLP
        deep_out = emit_mlp_ops(g, self.mlp, "x_embed", "implicit",
                                prefix="deep", final_act=True)

        # head
        hw, hb = self.head.w, self.head.b
        g.add(Op("head_concat",
                 lambda a, b_: torch.cat([a, b_], dim=1),
                 ("explicit_out", deep_out), "stacked", module="head"))
        g.add(Op("head_gemm", lambda h: h @ hw + hb, ("stacked",),
                 "logit", is_gemm=True, module="head"))
        return g

"""DCN (Deep & Cross Network, Wang et al. 2017) — the paper's Figure-1 example.

Explicit branch: cross network v1,  x_{l+1} = x0 · (x_l ⊤ w_l) + b_l + x_l
(the (x_l·w_l) contraction is the GEMM; the remaining elementwise chain is
the non-GEMM tail that C5 fuses — the per-layer ``fused_cross_v1`` kernel).
Implicit branch: deep MLP. Head: concat → linear → logit.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core import Op, OpGraph
from repro_torch.core.opgraph import register_fused_kernel
from repro_torch.kernels import ops as kops

from .common import CTRModel, Dense, emit_embedding_ops, emit_mlp_ops, \
    mlp_layers


class CrossV1(nn.Module):
    """One DCN cross layer's parameters: w (d_in, 1), b (d_in,)."""

    def __init__(self, d_in: int, *, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        self.register_buffer("w", torch.zeros((d_in, 1), dtype=dtype,
                                              device=device))
        self.register_buffer("b", torch.zeros((d_in,), dtype=dtype,
                                              device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal / √d_in weights, zero bias (``dcn.py:38-41``)."""
        self.w.normal_(0.0, 1.0 / math.sqrt(self.w.shape[0]),
                       generator=generator)
        self.b.zero_()


class DCN(CTRModel):
    def __init__(self, spec, *, device=None):
        super().__init__(spec, device=device)
        kw = dict(device=self.device, dtype=self.dtype)
        d_in = spec.input_dim
        self.mlp = mlp_layers((d_in, *spec.hidden), **kw)
        self.head = Dense(d_in + spec.hidden[-1], 1, **kw)
        self.cross = nn.ModuleList(CrossV1(d_in, **kw)
                                   for _ in range(spec.cross_layers))

    def build_graph(self, level: str) -> OpGraph:
        g = OpGraph(["ids"])
        emit_embedding_ops(g, self.embedding, level)

        # explicit: cross network v1
        cur = "x_embed"
        n_layers = len(self.cross)
        for li, layer in enumerate(self.cross):
            w, b = layer.w, layer.b
            g.add(Op(f"cross_gemm{li}", lambda x, _w=w: x @ _w,
                     (cur,), f"xlw{li}", is_gemm=True, module="explicit"))
            # one hint per model instance and layer: the bias is a
            # parameter of the kernel closure, not a graph edge
            hint = f"dcn_v1_tail_{id(self)}_{li}"
            register_fused_kernel(hint, _make_v1_kernel(b))
            out_edge = ("explicit_out" if li == n_layers - 1
                        else f"x_cross{li}")
            g.add(Op(f"cross_mul{li}",
                     lambda x0, xlw: x0 * xlw,
                     ("x_embed", f"xlw{li}"), f"cm{li}",
                     module="explicit", fused_hint=hint))
            g.add(Op(f"cross_addres{li}",
                     lambda m, x, _b=b: m + _b[None, :] + x,
                     (f"cm{li}", cur), out_edge,
                     module="explicit", fused_hint=hint))
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


def _make_v1_kernel(bias):
    """Per-layer closure over the layer's bias.

    Composed-subgraph signature after fusion: layer 0 receives (x0, xlw)
    because x_l == x0 is deduplicated; later layers receive (x0, xlw, x_l).
    """
    def f(x0, xlw, x=None):
        if x is None:
            x = x0
        return kops.fused_cross_v1(x0, xlw, bias, x)
    return f

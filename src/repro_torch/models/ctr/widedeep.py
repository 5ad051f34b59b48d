"""Wide&Deep (Cheng et al. 2016).

Explicit (wide) branch: per-field linear weights — a d=1 fused lookup plus a
reduce-sum (pure embedding work, which is why the paper sees its largest
speedups here). Implicit branch: deep MLP. Head: wide_logit + deep_logit.
"""

from __future__ import annotations

import torch

from repro_torch.core import Op, OpGraph
from repro_torch.embedding import FusedEmbeddingCollection

from .common import CTRModel, Dense, emit_embedding_ops, emit_mlp_ops, \
    mlp_layers


class WideDeep(CTRModel):
    def __init__(self, spec, *, device=None):
        super().__init__(spec, device=device)
        kw = dict(device=self.device, dtype=self.dtype)
        # wide d=1 tables are tiny — always dense, never worth tiering
        self.wide_embedding = FusedEmbeddingCollection(spec.wide_spec(),
                                                       device=self.device)
        self.register_buffer("wide_bias", torch.zeros((1,), **kw))
        self.mlp = mlp_layers((spec.input_dim, *spec.hidden), **kw)
        self.deep_head = Dense(spec.hidden[-1], 1, **kw)

    def embedding_collections(self) -> dict:
        return {self.main_embedding_key: self.embedding,
                "wide": self.wide_embedding}

    def build_graph(self, level: str) -> OpGraph:
        g = OpGraph(["ids"])
        emit_embedding_ops(g, self.embedding, level)

        # explicit (wide): d=1 lookup + sum — entirely embedding-style work.
        # naive level keeps it per-field; fused levels use the mega-table.
        wb = self.wide_bias
        if level == "naive":
            offs = self.wide_embedding.spec.offsets
            wide_table = self.wide_embedding.dense_view()
            for i in range(self.spec.k):
                g.add(Op(f"wide_lookup_{i}",
                         lambda ids, _i=i, _o=int(offs[i]):
                             wide_table.index_select(0, ids[:, _i] + _o),
                         ("ids",), f"wide_f{i}", module="explicit"))
            g.add(Op("wide_concat",
                     lambda *cols: torch.cat(cols, dim=1),
                     tuple(f"wide_f{i}" for i in range(self.spec.k)),
                     "wide_terms", module="explicit"))
        else:
            g.add(Op("wide_fused", lambda ids: self.wide_embedding(ids),
                     ("ids",), "wide_terms", module="explicit"))
        g.add(Op("wide_sum",
                 lambda t, _b=wb: t.sum(dim=1, keepdim=True) + _b,
                 ("wide_terms",), "explicit_out", module="explicit"))

        # implicit: deep MLP + its own head GEMM to a logit
        deep_out = emit_mlp_ops(g, self.mlp, "x_embed", "implicit",
                                prefix="deep", final_act=True)
        hw, hb = self.deep_head.w, self.deep_head.b
        g.add(Op("deep_head", lambda h: h @ hw + hb, (deep_out,),
                 "implicit_out", is_gemm=True, module="implicit"))

        # head: sum of branch logits
        g.add(Op("head_add", lambda a, b: a + b,
                 ("explicit_out", "implicit_out"), "logit", module="head"))
        return g

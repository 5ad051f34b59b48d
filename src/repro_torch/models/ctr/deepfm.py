"""DeepFM (Guo et al. 2017).

Explicit branch: factorization machine — first-order d=1 lookup-sum plus the
second-order term 0.5·Σ_d[(Σ_k v)²−Σ_k v²] emitted as a fine-grained
non-GEMM chain (square/sum/sub/scale) that C5 fuses into the
``fused_fm_second_order`` kernel. Implicit branch: deep MLP sharing the
same embeddings. Head: fm_linear + fm_second + deep_logit.
"""

from __future__ import annotations

import torch

from repro_torch.core import Op, OpGraph
from repro_torch.embedding import FusedEmbeddingCollection

from .common import CTRModel, Dense, emit_embedding_ops, emit_mlp_ops, \
    mlp_layers


class DeepFM(CTRModel):
    def __init__(self, spec, *, device=None):
        super().__init__(spec, device=device)
        kw = dict(device=self.device, dtype=self.dtype)
        # FM first-order d=1 tables are tiny — always dense
        self.wide_embedding = FusedEmbeddingCollection(spec.wide_spec(),
                                                       device=self.device)
        self.register_buffer("fm_bias", torch.zeros((1,), **kw))
        self.mlp = mlp_layers((spec.input_dim, *spec.hidden), **kw)
        self.deep_head = Dense(spec.hidden[-1], 1, **kw)

    def embedding_collections(self) -> dict:
        return {self.main_embedding_key: self.embedding,
                "fm_w": self.wide_embedding}

    def build_graph(self, level: str) -> OpGraph:
        spec = self.spec
        g = OpGraph(["ids"])
        emit_embedding_ops(g, self.embedding, level)

        # explicit (FM): first-order linear term — the d=1 fused lookup
        # at every level
        fb = self.fm_bias
        g.add(Op("fm_lin_lookup", lambda ids: self.wide_embedding(ids),
                 ("ids",), "fm_lin_terms", module="explicit"))
        g.add(Op("fm_lin_sum",
                 lambda t, _b=fb: t.sum(dim=1, keepdim=True) + _b,
                 ("fm_lin_terms",), "fm_linear", module="explicit"))

        # second-order term as a fine-grained non-GEMM chain (fused by C5
        # into the FM kernel — all ops share one hint)
        k, d = spec.k, spec.embed_dim
        # (reshape is deliberately *not* hinted: the kernel's signature is
        # (b, k, d), so the hinted group starts at fm_sum_k)
        g.add(Op("fm_reshape",
                 lambda x: x.reshape(x.shape[0], k, d),
                 ("x_embed",), "v", module="explicit"))
        g.add(Op("fm_sum_k", lambda v: v.sum(dim=1),
                 ("v",), "s", module="explicit",
                 fused_hint="fm_second_order"))
        g.add(Op("fm_sq_s", lambda s: s * s, ("s",), "ss",
                 module="explicit", fused_hint="fm_second_order"))
        g.add(Op("fm_sq_v", lambda v: v * v, ("v",), "v2",
                 module="explicit", fused_hint="fm_second_order"))
        g.add(Op("fm_sum_v2", lambda v2: v2.sum(dim=1),
                 ("v2",), "sv2", module="explicit",
                 fused_hint="fm_second_order"))
        g.add(Op("fm_final",
                 lambda ss, sv2: 0.5 * (ss - sv2).sum(dim=-1, keepdim=True),
                 ("ss", "sv2"), "fm_second", module="explicit",
                 fused_hint="fm_second_order"))
        g.add(Op("fm_add", lambda a, b: a + b, ("fm_linear", "fm_second"),
                 "explicit_out", module="explicit"))

        # implicit: deep MLP
        deep_out = emit_mlp_ops(g, self.mlp, "x_embed", "implicit",
                                prefix="deep", final_act=True)
        hw, hb = self.deep_head.w, self.deep_head.b
        g.add(Op("deep_head", lambda h: h @ hw + hb, (deep_out,),
                 "implicit_out", is_gemm=True, module="implicit"))

        # head
        g.add(Op("head_add", lambda a, b: a + b,
                 ("explicit_out", "implicit_out"), "logit", module="head"))
        return g

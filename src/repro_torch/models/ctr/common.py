"""Shared pieces of the CTR model zoo: inits, MLP op emission, kernel hooks.

Counterpart of ``repro.models.ctr.common``. Every model is an
``nn.Module`` holding its tensors as buffers on one device, with:

  spec                 CTRModelSpec (embedding schema + net sizes)
  init(generator)      fill every tensor with the reference's
                       distributions, drawn from ``generator``
  build_graph(level)   -> OpGraph (consumed by DualParallelExecutor)
  forward(ids)         -> logits (b, 1): the graph in its own order

Graph modules: "embedding" -> ("explicit" ∥ "implicit") -> "head", with
GEMMs flagged and non-GEMM tails carrying ``fused_hint`` so the C5 pass
can swap in the CUDA kernels. Op names, modules and hints are those of
the reference, so the two packages' schedules compare name for name.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.core import Op, OpGraph
from repro_torch.core.opgraph import register_fused_kernel
from repro_torch.device import resolve_device
from repro_torch.embedding import (FusedEmbeddingCollection,
                                   FusedEmbeddingSpec, runtime_edge)
from repro_torch.kernels import ops as kops

__all__ = ["CTRModelSpec", "CTRModel", "Dense", "mlp_layers",
           "emit_embedding_ops", "emit_mlp_ops"]


@dataclasses.dataclass(frozen=True)
class CTRModelSpec:
    """Static CTR model description (paper §V-A configuration space)."""
    name: str
    field_sizes: tuple[int, ...]
    embed_dim: int = 16                      # paper: 16 / 32
    hidden: tuple[int, ...] = (256, 256, 256)  # paper: 256/512/1024 ×3
    cross_layers: int = 3                    # paper: 3 (DCN/DCNv2)
    dtype: str = "float32"

    @property
    def k(self) -> int:
        return len(self.field_sizes)

    @property
    def input_dim(self) -> int:
        return self.k * self.embed_dim

    def embedding_spec(self) -> FusedEmbeddingSpec:
        return FusedEmbeddingSpec(field_sizes=self.field_sizes,
                                  dim=self.embed_dim, dtype=self.dtype)

    def wide_spec(self) -> FusedEmbeddingSpec:
        """d=1 tables for linear terms (Wide&Deep / FM first order)."""
        return FusedEmbeddingSpec(field_sizes=self.field_sizes, dim=1,
                                  dtype=self.dtype)


# ---------------------------------------------------------------------------
# dense layers
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    """``h @ w + b`` with the reference's (fan_in, fan_out) weight layout."""

    def __init__(self, fan_in: int, fan_out: int, *, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        self.register_buffer("w", torch.zeros((fan_in, fan_out),
                                              dtype=dtype, device=device))
        self.register_buffer("b", torch.zeros((fan_out,), dtype=dtype,
                                              device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Glorot-normal weights, zero bias (``common.py:70-73``)."""
        fan_in, fan_out = self.w.shape
        self.w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                       generator=generator)
        self.b.zero_()

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.w + self.b


def mlp_layers(dims: tuple[int, ...], *, device: torch.device,
               dtype: torch.dtype) -> nn.ModuleList:
    return nn.ModuleList(Dense(dims[i], dims[i + 1], device=device,
                               dtype=dtype)
                         for i in range(len(dims) - 1))


# ---------------------------------------------------------------------------
# graph emission helpers
# ---------------------------------------------------------------------------

def emit_embedding_ops(g: OpGraph, emb: FusedEmbeddingCollection,
                       level: str, *, out: str = "x_embed",
                       prefix: str = "emb") -> None:
    """Embedding module ops.

    ``naive`` = k per-field ``index_select`` gathers + concat off the
    store's dense view — the paper's PyTorch baseline, plain PyTorch at
    every device; otherwise ONE fused lookup through the store (the K1
    kernel on CUDA). A store's ``runtime_keys`` tensors become extra
    graph inputs (edge names from :func:`runtime_edge`) instead of
    closed-over constants.
    """
    if level == "naive":
        k = emb.spec.k
        offs = emb.spec.offsets
        table = emb.dense_view()
        for i in range(k):
            def one_field(ids, _i=i, _o=int(offs[i])):
                return table.index_select(0, ids[:, _i] + _o)
            g.add(Op(f"{prefix}_lookup_{i}", one_field, ("ids",),
                     f"{prefix}_f{i}", module="embedding"))
        g.add(Op(f"{prefix}_concat",
                 lambda *cols: torch.cat(cols, dim=1),
                 tuple(f"{prefix}_f{i}" for i in range(k)),
                 out, module="embedding"))
        return
    rt = tuple(emb.store.runtime_keys)
    if rt:
        edges = tuple(runtime_edge(prefix, leaf) for leaf in rt)
        for e in edges:
            g.add_input(e)

        def fused_runtime(ids, *leaves):
            return emb(ids, runtime=dict(zip(rt, leaves)))

        g.add(Op(f"{prefix}_fused", fused_runtime, ("ids",) + edges,
                 out, module="embedding"))
    else:
        g.add(Op(f"{prefix}_fused", lambda ids: emb(ids),
                 ("ids",), out, module="embedding"))


def emit_mlp_ops(g: OpGraph, layers: nn.ModuleList, src: str, module: str,
                 prefix: str = "mlp", final_act: bool = False) -> str:
    """Per-layer GEMM (flagged) + ReLU (non-GEMM, fusable)."""
    cur = src
    n = len(layers)
    for li, layer in enumerate(layers):
        w, b = layer.w, layer.b
        act = li < n - 1 or final_act
        g.add(Op(f"{prefix}_gemm{li}",
                 lambda h, _w=w, _b=b: h @ _w + _b,
                 (cur,), f"{prefix}_h{li}", is_gemm=True, module=module))
        cur = f"{prefix}_h{li}"
        if act:
            g.add(Op(f"{prefix}_relu{li}", torch.relu,
                     (cur,), f"{prefix}_a{li}", module=module,
                     fused_hint="relu"))
            cur = f"{prefix}_a{li}"
    return cur


# ---------------------------------------------------------------------------
# kernel registration for the C5 pattern registry
# ---------------------------------------------------------------------------

def _cross_v2_tail(x0, xw, x=None):
    # layer 0 dedups x_l == x0 into a 2-arg call
    if x is None:
        x = x0
    return kops.fused_cross_v2(x0, xw, x)


register_fused_kernel("cross_v2_tail", _cross_v2_tail)
register_fused_kernel("fm_second_order", kops.fused_fm_second_order)


# ---------------------------------------------------------------------------
# model base
# ---------------------------------------------------------------------------

class CTRModel(nn.Module):
    """Base: the main embedding collection, init and the forward pass.

    Each embedding subtree of the reference's parameter tree is one
    :class:`FusedEmbeddingCollection` here (``embedding`` for the main
    table, keyed ``"emb"``; wide/FM variants add their own).
    """

    #: reference parameter-tree key of the main embedding subtree
    main_embedding_key = "emb"

    def __init__(self, spec: CTRModelSpec, *,
                 device: torch.device | str | None = None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.embedding = FusedEmbeddingCollection(spec.embedding_spec(),
                                                  device=device)

    @property
    def device(self) -> torch.device:
        return self.embedding.dense_view().device

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.spec.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "CTRModel":
        """Fill every tensor from ``generator`` (on the model's device):
        tables normal × 0.05 with the zero/padding rows 0, dense layers
        Glorot-normal with zero bias, loose biases 0. Returns ``self``."""
        for buf in self.buffers(recurse=False):
            buf.zero_()
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)
        return self

    def build_graph(self, level: str) -> OpGraph:
        raise NotImplementedError

    def embedding_collections(self) -> dict[str, FusedEmbeddingCollection]:
        """Reference param-tree key -> collection, for every embedding
        subtree this model owns."""
        return {self.main_embedding_key: self.embedding}

    def store_runtime_env(self) -> dict[str, torch.Tensor]:
        """Edge name -> tensor for every runtime store input this model's
        graphs declare. Empty for all-dense models."""
        env = {}
        for key, coll in self.embedding_collections().items():
            for leaf, t in coll.store.runtime_tensors().items():
                env[runtime_edge(key, leaf)] = t
        return env

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """Logits (b, 1): the "dual" graph run in its own op order."""
        g = self.build_graph("dual")
        env = g.execute({"ids": ids, **self.store_runtime_env()})
        return env["logit"]

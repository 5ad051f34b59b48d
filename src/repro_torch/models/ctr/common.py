"""Shared pieces of the CTR model zoo: inits, MLP op emission, kernel hooks.

Counterpart of ``repro.models.ctr.common``. Every model is an
``nn.Module`` holding its tensors as buffers on one device, with:

  spec                 CTRModelSpec (embedding schema + net sizes)
  init(generator)      fill every tensor with the reference's
                       distributions, drawn from ``generator``
  build_graph(level, compute_dtype="fp32")
                       -> OpGraph (consumed by DualParallelExecutor);
                       "int8" runs the MLP's matmuls in int8 (K12)
  compile(level="dual", batch_size=256, **kw)
                       -> InferencePlan (``core.compile_plan``), the
                       serving path: ``model.compile().predict(ids)``
  forward(ids)         -> logits (b, 1): the "dual" graph, tails fused,
                       in its own order; differentiable (the training
                       path)
  loss(batch)          -> mean binary cross entropy of the logits
  param_tree()         -> the reference's parameter tree over the
                       model's own buffers (a trainer's ``params``)
  tensor_tree()        -> the same tree for any store (no grad marks)
  partition_spec(model_axis)
                       -> its placement over a mesh: embedding subtrees
                       per their store, everything else replicated

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

from repro_torch.bridge import _as_lists, _leaves
from repro_torch.core import COMPUTE_DTYPES, Op, OpGraph
from repro_torch.core.opgraph import fuse_non_gemm, register_fused_kernel
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import P, tree_map
from repro_torch.embedding import (DenseStore, FusedEmbeddingCollection,
                                   FusedEmbeddingSpec, runtime_edge)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.dense_matmul import pack_weight
from repro_torch.quant import quantize_channels

__all__ = ["CTRModelSpec", "CTRModel", "Dense", "mlp_layers",
           "emit_embedding_ops", "emit_mlp_ops", "bce_loss"]


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
                 prefix: str = "mlp", final_act: bool = False,
                 compute_dtype: str = "fp32") -> str:
    """Per-layer GEMM (flagged) + ReLU (non-GEMM, fusable).

    ``compute_dtype="int8"`` makes each GEMM + ReLU pair ONE quantized op
    (``kops.dense_matmul_q8``, the K12 kernel on CUDA) with the same edge
    names: the weight is quantized per output channel here, once at graph
    build, and laid out for the kernel, so the fp32 weight is never read
    at serve time and no store refresh touches it; activations quantize
    per row inside the op. The counters land in ``g.meta`` and surface as
    the ``mlp_quant_*`` fields of ``ExecutorStats``, counted as the
    reference counts them.
    """
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
    cur = src
    n = len(layers)
    for li, layer in enumerate(layers):
        w, b = layer.w, layer.b
        act = li < n - 1 or final_act
        if compute_dtype == "int8":
            qw, wscale = quantize_channels(w)
            out_edge = f"{prefix}_a{li}" if act else f"{prefix}_h{li}"
            g.add(Op(f"{prefix}_q8gemm{li}",
                     lambda h, _qw=pack_weight(qw), _ws=wscale, _b=b,
                     _act=act: kops.dense_matmul_q8(h, _qw, _ws, _b,
                                                    relu=_act),
                     (cur,), out_edge, is_gemm=True, module=module))
            cur = out_edge
            fan_in, fan_out = w.shape
            # int8 payload + one fp32 scale per output channel, vs 4 B/elt
            q8_bytes = fan_in * fan_out + 4 * fan_out
            g.meta["compute_dtype"] = "int8"
            g.meta["mlp_quant_matmuls"] = \
                g.meta.get("mlp_quant_matmuls", 0) + 1
            g.meta["mlp_quant_weight_bytes"] = \
                g.meta.get("mlp_quant_weight_bytes", 0) + q8_bytes
            g.meta["mlp_quant_weight_bytes_saved"] = \
                g.meta.get("mlp_quant_weight_bytes_saved", 0) \
                + 4 * fan_in * fan_out - q8_bytes
            continue
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
# loss
# ---------------------------------------------------------------------------

def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable binary cross entropy from logits
    (``common.py:193-199`` of the reference)."""
    logits = logits.reshape(-1).to(torch.float32)
    labels = labels.reshape(-1).to(torch.float32)
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


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
    table, keyed ``"emb"``; wide/FM variants add their own). Pass
    ``store=`` (e.g. a ``CachedStore``) to tier the main table; the
    default is a ``DenseStore`` on ``device``. A given store fixes the
    device.
    """

    #: reference parameter-tree key of the main (tierable) embedding
    #: subtree — the one ``store=``/``use_store`` operate on
    main_embedding_key = "emb"

    def __init__(self, spec: CTRModelSpec, store=None, *,
                 device: torch.device | str | None = None):
        super().__init__()
        if store is None:
            device = resolve_device(device)
        elif (device is not None
              and resolve_device(device).type != store.device.type):
            raise ValueError(f"store lives on {store.device}, the model was "
                             f"asked for {device}")
        self.spec = spec
        self.embedding = FusedEmbeddingCollection(spec.embedding_spec(),
                                                  store=store, device=device)

    @property
    def device(self) -> torch.device:
        # the store's own device: no table is read, so an int8 store is
        # never dequantized to answer
        return self.embedding.store.device

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

    def build_graph(self, level: str,
                    compute_dtype: str = "fp32") -> OpGraph:
        raise NotImplementedError

    def embedding_collections(self) -> dict[str, FusedEmbeddingCollection]:
        """Reference param-tree key -> collection, for every embedding
        subtree this model owns."""
        return {self.main_embedding_key: self.embedding}

    def store_runtime_env(self, mesh=None, model_axis: str = "model"
                          ) -> dict:
        """Edge name -> tensor for every runtime store input this model's
        graphs declare. Empty for all-dense models. With a ``mesh``, each
        tensor placed over it as its store places it (``Placed``)."""
        env = {}
        for key, coll in self.embedding_collections().items():
            tensors = coll.store.runtime_tensors()
            if mesh is not None and tensors:
                tensors = coll.store.place(tensors, mesh, model_axis)
            for leaf, t in tensors.items():
                env[runtime_edge(key, leaf)] = t
        return env

    def partition_spec(self, model_axis: str | None = "model") -> dict:
        """Mesh placement of :meth:`tensor_tree`: embedding subtrees per
        their store's ``partition_spec`` (vocab-parallel tables,
        replicated cache tiers), everything else replicated (CTR dense
        nets are latency-bound)."""
        specs = tree_map(lambda _: P(), self.tensor_tree())
        for key, coll in self.embedding_collections().items():
            specs[key] = coll.partition_spec(model_axis)
        return specs

    @torch.no_grad()
    def use_store(self, store) -> "CTRModel":
        """Swap the main table's store: ``store`` adopts the current
        store's tensors bit for bit (see ``EmbeddingStore.adopt``) and the
        main collection is rebound to it. Returns ``self``. Plans compiled
        before the swap keep the old collection."""
        if store.device.type != self.device.type:
            raise ValueError(f"store lives on {store.device}, the model on "
                             f"{self.device}")
        store.adopt(dict(self.embedding.store.named_buffers()))
        self.embedding = FusedEmbeddingCollection(self.spec.embedding_spec(),
                                                  store=store)
        return self

    def compile(self, level: str = "dual", batch_size: int = 256, **kwargs):
        """Compile this model into an ``InferencePlan`` (the serving-side
        artifact): ``plan = model.compile(); plan.predict(ids)``. Thin
        delegation to :func:`repro_torch.core.compile_plan` (``kwargs``:
        ``device``, ``mesh``, ``runtime_provider``, ``compute_dtype``,
        ...); serving holds plans or an ``InferenceEngine`` rather than
        calling :meth:`forward` per request."""
        from repro_torch.core.plan import compile_plan
        return compile_plan(self, level, batch_size, **kwargs)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """Logits (b, 1): the "dual" graph with its non-GEMM tails fused
        (C5), run in its own op order — on CUDA the K1 gather and the
        fused-tail kernels. Each kernel is differentiable
        (``kernels/autograd.py``), so this is the training path, as the
        reference's ``apply`` is; serving goes through ``compile_plan``."""
        g = fuse_non_gemm(self.build_graph("dual"))
        env = g.execute({"ids": ids, **self.store_runtime_env()})
        return env["logit"]

    def predict_proba(self, ids: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self(ids).reshape(-1))

    def _dense_stores(self) -> None:
        for key, coll in self.embedding_collections().items():
            if not isinstance(coll.store, DenseStore):
                raise TypeError(
                    f"training needs a DenseStore; {key!r} is held by "
                    f"{coll.store.describe()} (tiered stores serve, the "
                    "reference trains only the dense table)")

    def loss(self, batch: dict) -> torch.Tensor:
        """Mean binary cross entropy of ``self(batch["ids"])`` against
        ``batch["labels"]``. With autograd on, every embedding table must
        be a ``DenseStore``'s."""
        if torch.is_grad_enabled():
            self._dense_stores()
        return bce_loss(self(batch["ids"]), batch["labels"])

    def n_params(self, params: dict) -> int:
        """Elements over the leaves of a parameter tree
        (``param_tree()``)."""
        return sum(t.numel() for _, t in _leaves(params))

    def param_tree(self) -> dict:
        """The reference's parameter tree (``{"emb": {"mega_table": t},
        "mlp": [{"w", "b"}, ...], ...}``) whose leaves are this model's
        own buffers, each marked ``requires_grad`` for training. A trainer
        updates them in place; the tree holds the buffers present now, so
        take it again after a store swap. Needs ``DenseStore`` tables."""
        self._dense_stores()
        tree = self.tensor_tree()
        for _, t in _leaves(tree):
            t.requires_grad_(True)
        return tree

    def tensor_tree(self) -> dict:
        """The reference's parameter tree over this model's own buffers,
        whatever its stores: each embedding subtree is its store's
        buffers by name (``mega_table``; ``backing``, ``cache``,
        ``slot_of_row``, ...), the rest the dense layers'."""
        collections = self.embedding_collections()
        tree: dict = {key: coll.store.device_tensors()
                      for key, coll in collections.items()}
        owned = {id(t) for coll in collections.values()
                 for t in coll.buffers()}
        for name, t in self.named_buffers():
            if id(t) in owned:
                continue
            *parents, leaf = name.split(".")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = t
        return _as_lists(tree)

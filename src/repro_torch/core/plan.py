"""InferencePlan — the immutable compiled artifact of the serving stack.

Counterpart of ``repro.core.plan``. :func:`compile_plan` turns
(model, level, batch shape, device) into an :class:`InferencePlan` once:
the fused ``OpGraph``, the breadth-first schedule, the ``ExecutorStats``
bookkeeping and a runnable step, run once on zeros before the plan is
returned so the first served request pays no first-call cost (cuBLAS
handles, stream creation, kernel build and load). ``compile_ms`` is that
whole preparation.

A refreshable store's tensors (``runtime_keys``) are per-call inputs of
the step, named by ``runtime_inputs``: each call reads them from the
``runtime_provider`` the plan was compiled with, so a store that swaps
its buffers (a cache refresh, an online delta) retargets every plan
without a rebuild. The default provider binds the tensors present at
compile time, as the reference's does.

``compute_dtype="int8"`` runs every MLP matmul as the int8 kernel
(K12): weights quantized per output channel once, when the graph is
built; activations per row at every step. It is part of the plan's
identity, and with a ``runtime_provider`` it combines with an int8-row
tiered store into one plan that no refresh rebuilds. CUDA-graph capture
of the "dual" step comes in a later slice.

``mesh=`` (a ``repro_torch.distributed.Mesh``) compiles a plan for many
devices, driven from this one process. The model's tensors are placed
once (:func:`place_params`: tables row-sharded over ``model_axis``,
cache tiers and dense layers replicated), the ids are split over the
mesh's data axis (``input_shardings``; a batch the axis does not divide
stays whole, on the first batch shard), and each batch shard runs the
graph on its own device over its own copy of the model, whose embedding
lookups are the vocab-parallel :class:`~repro_torch.embedding.GroupLookup`
over that shard's positions. The scores are gathered onto the mesh's
first device in batch order. The store tensors of each call
(``runtime_shardings``) are placed too: a provider that hands out placed
tensors (an engine on a mesh) costs nothing here, and a raw one is
placed on every call.

A plan never records an autograd graph: its step runs under
``torch.no_grad()``, so a model whose buffers require grad (a trainer's
``param_tree()``) serves through it without building a graph or holding
activations, and its outputs do not require grad.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import (P, NamedSharding,
                                              data_groups, fit_spec,
                                              input_shardings, place,
                                              place_tree, tree_map)

from .dual_parallel import (BRANCH_ORDERS, LEVELS, DualParallelExecutor,
                            ExecutorStats)
from .opgraph import OpGraph

__all__ = ["PlanKey", "InferencePlan", "compile_plan", "plan_key_for",
           "place_params", "COMPUTE_DTYPES"]

#: dense-branch compute dtypes a plan can be compiled at: fp32 GEMMs, or
#: int8 matmuls with the dequant, bias and ReLU in the epilogue (K12)
COMPUTE_DTYPES = ("fp32", "int8")


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Cache identity of a compiled plan."""
    model: str
    level: str
    batch_size: int
    branch_order: str = "longer_first"
    sharded: bool = False
    store: str = "dense"
    compute_dtype: str = "fp32"


def _store_describe(model) -> str:
    coll = getattr(model, "embedding", None)
    store = getattr(coll, "store", None)
    return store.describe() if store is not None else "none"


def plan_key_for(model, level: str, batch_size: int,
                 branch_order: str = "longer_first",
                 sharded: bool = False,
                 compute_dtype: str = "fp32") -> PlanKey:
    """The single definition of plan identity."""
    return PlanKey(model=getattr(model.spec, "name", type(model).__name__),
                   level=level, batch_size=int(batch_size),
                   branch_order=branch_order, sharded=sharded,
                   store=_store_describe(model),
                   compute_dtype=compute_dtype)


@dataclasses.dataclass(frozen=True)
class InferencePlan:
    """One compiled, batch-shape-specific inference artifact.

    ``step`` maps ``ids (batch_size, n_fields) int32`` on ``device`` to
    ``(batch_size, 1)`` logits. A mesh plan records its ``mesh``, the
    ``input_shardings`` of its ids and the ``runtime_shardings`` of its
    store tensors; its ``device`` is the mesh's first device.
    """
    key: PlanKey
    stats: ExecutorStats
    graph: OpGraph
    order: tuple[str, ...]
    step: Callable[[torch.Tensor], torch.Tensor]
    n_fields: int
    compile_ms: float
    device: torch.device
    runtime_inputs: tuple[str, ...] = ()
    mesh: Mesh | None = None
    input_shardings: dict = dataclasses.field(default_factory=dict)
    runtime_shardings: dict = dataclasses.field(default_factory=dict)

    @property
    def level(self) -> str:
        return self.key.level

    @property
    def batch_size(self) -> int:
        return self.key.batch_size

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        return self.step(ids)

    def predict(self, ids) -> np.ndarray:
        """Sigmoid scores for ``ids`` ((n_fields,) or (b, n_fields) with
        b ≤ batch_size); pads up to the plan's batch shape and slices the
        padding back off."""
        ids = np.asarray(ids, dtype=np.int32)
        if ids.ndim == 1:
            ids = ids[None, :]
        b = ids.shape[0]
        if b > self.batch_size:
            raise ValueError(
                f"{b} rows > plan batch_size {self.batch_size}; batch the "
                "requests or compile a bigger plan")
        if b < self.batch_size:
            pad = np.zeros((self.batch_size - b, ids.shape[1]),
                           dtype=ids.dtype)
            ids = np.concatenate([ids, pad])
        logits = self.step(torch.from_numpy(ids).to(self.device))
        return torch.sigmoid(logits.reshape(-1)).cpu().numpy()[:b]


def _shard_params(params: Any, mesh: Mesh, model_axis: str | None,
                  specs: Any = None) -> Any:
    """Place a tree of tensors on ``mesh`` per a spec tree (``None``:
    everything replicated). A leaf row-sharded over ``model_axis`` whose
    height the axis does not divide replicates instead."""
    if specs is None:
        return place_tree(params, mesh, tree_map(lambda _: P(), params))
    n_shards = mesh.shape.get(model_axis, 1)

    def put(t, spec):
        dims = tuple(spec)
        if dims and dims[0] == model_axis and (
                t.ndim == 0 or t.shape[0] % n_shards):
            spec = P()
        return place(t, mesh, spec)
    return tree_map(put, params, specs)


def place_params(model, mesh: Mesh, model_axis: str = "model") -> Any:
    """The model's tensors (``model.tensor_tree()``) placed on ``mesh``
    per its ``partition_spec``: tables row-sharded over ``model_axis``
    (vocab-parallel), cache tiers and dense layers replicated. On a mesh
    without that axis every table replicates. The one placement entry
    point of :func:`compile_plan` and ``InferenceEngine``; a slice on the
    device that already holds its tensor is a view of it."""
    axis = model_axis if model_axis in mesh.axis_names else None
    return _shard_params(model.tensor_tree(), mesh, axis,
                         model.partition_spec(axis))


def _leaf_list(tree: Any) -> list:
    leaves: list = []
    tree_map(leaves.append, tree)
    return leaves


def _shard_model(model, mesh: Mesh, group: list, placed: dict):
    """A copy of ``model`` for one batch shard: its dense tensors are the
    placed copies at the shard's first position (the model's own tensors
    where that is their device) and each embedding collection is a
    :class:`GroupLookup` over the shard's positions. ``placed`` maps
    ``id(tensor)`` of the model's tensors to their placed values."""
    from repro_torch.embedding import GroupLookup
    pos = group[0]
    dev = mesh.devices[pos]
    memo: dict = {}
    for coll in model.embedding_collections().values():
        rt = set(coll.store.runtime_keys)
        static = {name: placed[id(t)]
                  for name, t in coll.store.device_tensors().items()
                  if name not in rt}
        memo[id(coll)] = GroupLookup(coll, group, static, dev)
    for t in model.buffers():
        if id(t) in placed:
            memo[id(t)] = placed[id(t)].local(pos)
    return copy.deepcopy(model, memo)


def compile_plan(model, level: str = "dual", batch_size: int = 256, *,
                 device: torch.device | str | None = None,
                 mesh: Mesh | None = None, model_axis: str = "model",
                 placed: Any = None,
                 branch_order: str = "longer_first",
                 runtime_provider: Callable[[], dict] | None = None,
                 compute_dtype: str = "fp32") -> InferencePlan:
    """Compile one (model, level, batch shape) into an InferencePlan.

    Args:
        model: a ``CTRModel`` (anything with ``spec.k``, ``device`` and
            ``build_graph(level)``), whose tensors live on ``device``.
        level: one of ``LEVELS`` (the Fig.-8 ladder).
        batch_size: the fixed batch shape this plan serves.
        device: where the plan runs; CUDA unless the caller says "cpu".
            With a ``mesh``, its first device (or leave it ``None``).
        mesh: a device mesh to run over (see the module docstring).
        model_axis: the mesh axis the tables split over.
        placed: the model's tensors already placed on ``mesh``
            (:func:`place_params`; an engine places them once for all its
            plans). Default: placed here.
        branch_order: breadth-first head-branch policy (§V-H ablations).
        runtime_provider: zero-argument callable returning the current
            runtime store tensors (edge name -> tensor, the plan's
            ``runtime_inputs``), consulted on every step; pass
            ``model.store_runtime_env`` to serve whatever the store
            publishes. Default: the tensors present at compile time.
        compute_dtype: ``"fp32"`` or ``"int8"`` (one of
            ``COMPUTE_DTYPES``): the MLP matmuls' arithmetic. The cross
            and head GEMMs stay fp32 either way, as in the reference.
    """
    if mesh is not None:
        first = mesh.first_device
        if device is not None and resolve_device(device) not in (
                first, torch.device(first.type)):
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {first}")
        device = first
    device = resolve_device(device)
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
    if branch_order not in BRANCH_ORDERS:
        raise ValueError(f"branch_order must be one of {BRANCH_ORDERS}, "
                         f"got {branch_order!r}")
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    if model.device.type != device.type:
        raise ValueError(f"model lives on {model.device}; compile_plan was "
                         f"asked for {device}")
    def builder_of(m):
        if compute_dtype == "fp32":
            return m.build_graph
        return lambda lvl: m.build_graph(lvl, compute_dtype=compute_dtype)

    t0 = time.perf_counter()
    n_fields = model.spec.k
    runtime = model.store_runtime_env()
    provider = runtime_provider if runtime_provider is not None \
        else (lambda: runtime)
    if set(provider()) != set(runtime):
        raise ValueError(f"runtime_provider gives {sorted(provider())}; the "
                         f"graph takes {sorted(runtime)}")
    in_shardings: dict = {}
    rt_shardings: dict = {}
    if mesh is None:
        executor = DualParallelExecutor(builder_of(model), level=level,
                                        branch_order=branch_order)
        graph, order = executor.prepare()
        step_env = executor.make_step(graph, order, device)

        def run(ids: torch.Tensor) -> torch.Tensor:
            return step_env({"ids": ids}, provider())
    else:
        run, executor, graph, order, in_shardings, rt_shardings = \
            _mesh_step(model, mesh, model_axis, placed, batch_size,
                       builder_of, level, branch_order, provider)

    @torch.no_grad()
    def step(ids: torch.Tensor) -> torch.Tensor:
        return run(ids)

    step(torch.zeros((batch_size, n_fields), dtype=torch.int32,
                     device=device))
    for dev in (mesh.device_set if mesh is not None else (device,)):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    compile_ms = (time.perf_counter() - t0) * 1e3

    stats = executor.stats
    stats.embedding_store = _store_describe(model)
    stats.compute_dtype = compute_dtype
    return InferencePlan(key=plan_key_for(model, level, batch_size,
                                          branch_order,
                                          sharded=mesh is not None,
                                          compute_dtype=compute_dtype),
                         stats=stats, graph=graph, order=tuple(order),
                         step=step, n_fields=n_fields,
                         compile_ms=compile_ms, device=device,
                         runtime_inputs=tuple(sorted(runtime)), mesh=mesh,
                         input_shardings=in_shardings,
                         runtime_shardings=rt_shardings)


def _mesh_step(model, mesh: Mesh, model_axis: str, placed: Any,
               batch_size: int, builder_of, level: str, branch_order: str,
               provider: Callable[[], dict]):
    """The pieces of a mesh plan: its step over the batch shards, the
    first shard's executor, graph and order (every shard's are alike),
    and the resolved input and runtime shardings."""
    from repro_torch.embedding import runtime_edge
    if model.device.type != mesh.first_device.type:
        raise ValueError(f"model lives on {model.device}; the mesh on "
                         f"{mesh.first_device.type}")
    axis = model_axis if model_axis in mesh.axis_names else None
    if placed is None:
        placed = place_params(model, mesh, model_axis)
    by_id = {id(t): p for t, p in zip(_leaf_list(model.tensor_tree()),
                                      _leaf_list(placed))}
    in_shardings = input_shardings(mesh, {"ids": torch.empty(
        (batch_size, model.spec.k), dtype=torch.int32, device="meta")})
    groups = data_groups(mesh, model_axis)
    if in_shardings["ids"].spec[0] is None:
        groups = groups[:1]             # the batch stays whole
    rt_shardings = {}
    for key, coll in model.embedding_collections().items():
        specs = coll.store.partition_spec(axis)
        for leaf, t in coll.store.runtime_tensors().items():
            rt_shardings[runtime_edge(key, leaf)] = NamedSharding(
                mesh, fit_spec(mesh, specs[leaf], t.shape))
    runs, first = [], None
    for group in groups:
        replica = _shard_model(model, mesh, group, by_id)
        executor = DualParallelExecutor(builder_of(replica), level=level,
                                        branch_order=branch_order)
        graph, order = executor.prepare()
        runs.append((mesh.devices[group[0]],
                     executor.make_step(graph, order,
                                        mesh.devices[group[0]])))
        if first is None:
            first = executor, graph, order
    out_dev = mesh.first_device
    rows = batch_size // len(groups)

    def run(ids: torch.Tensor) -> torch.Tensor:
        env = {k: place(v, mesh, rt_shardings[k].spec)
               for k, v in provider().items()}
        outs = [step_env({"ids": ids[i * rows:(i + 1) * rows].to(dev)},
                         env)
                for i, (dev, step_env) in enumerate(runs)]
        if len(outs) == 1:
            return outs[0].to(out_dev)
        return torch.cat([o.to(out_dev) for o in outs])
    return run, *first, in_shardings, rt_shardings

"""Uniform step functions per (arch × shape kind), mesh-aware.

Counterpart of ``repro.launch.steps``. A :class:`Cell` holds everything
one (arch × shape × mesh) cell needs: the sharding policy, the model with
its ``shard`` hook and, for a decode cell of an attention family, its
``DecodeShardCtx``; the spec trees of the parameters, the optimizer
state and the inputs; the AdamW settings and the microbatch count; and
the step functions ``train_step_fn``, ``prefill_fn`` and ``decode_fn``
over ``configs.input_specs``' calling convention (the model owns its
tensors, so a step takes the inputs alone, or the ``TrainState`` over
the model's ``param_tree()`` and the batch).

On the port's single-controller mesh the spec trees are computed, fitted
and held equal to the reference's. A cell's weights stay whole on the
mesh's first device (the ``shard`` hook changes no value) until
:meth:`Cell.place_params` splits its parameters by ``pspecs``
(``distributed.tensor_parallel``; the reference hands them to its
compiled step as ``in_shardings``): a serving cell's prefill and decode,
and an attention family's train step, whose parameters, moments and
gradients are then placed pieces (``state_specs``). What runs per
position either way is the reference's own ``shard_map``: the decode
cell places its KV caches by ``cache_specs`` (batch over the batch axes,
sequence over ``model``) and attends through
``layers.flash_decode_sharded``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
import weakref
from collections import Counter
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.analytic import leaf_bytes
from repro_torch.analysis.roofline import gemm_flops
from repro_torch.bridge import _leaves
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.mesh import Mesh, make_mesh
from repro_torch.distributed.tensor_parallel import (KINDS, RowsNotAlike,
                                                      TensorParallel)
from repro_torch.models.lm import layers as L
from repro_torch.models.lm import make_lm_model
from repro_torch.training.optimizer import (AdamWConfig, TrainState,
                                            adamw_init)
from repro_torch.training.train_loop import make_train_step

__all__ = ["build_cell", "Cell", "Lowered", "Trace"]

#: the cache leaves a decode cell places over its mesh: the attention
#: caches that ``flash_decode_sharded`` reads per position (recurrent
#: states are placed with the split weights, ``Cell.place_params``)
KV_LEAVES = ("k", "v", "xk", "xv")


@dataclasses.dataclass
class Lowered:
    """One trace of a cell's step on ``meta`` tensors (``Cell.lower``):
    the ATen ops it dispatched by name (views excluded), the step's
    outputs (``meta`` tensors; a train step's new ``params``, ``m``, ``v``
    and metrics) and the host seconds the trace took.

    ``trace`` says which step ran: ``"split"``, the parameters placed by
    ``pspecs`` (``Cell.place_params``), ``rows_traced`` of the mesh's
    ``rows`` batch rows run and the others counted by symmetry
    (``distributed.tensor_parallel``); or ``"unplaced"``, the step on
    whole weights (a mesh of one position, and ``Cell._lower("unplaced")``
    asked for by name), whose one copy between positions is a sharded
    decode's merge (``DecodeShardCtx.moved``, under ``merge``).

    What the reference reads from XLA, the port counts in the same pass:
    ``flops``, 2·M·N·K of every GEMM-like op the step dispatched
    (``analysis.roofline.gemm_flops``; ``parse_hlo``'s ``dot_flops``),
    for the global step: a one-row trace's per-row GEMMs count once for
    each row; ``peak_live_bytes``, the peak over the trace of the bytes
    held by the storages its ops created (inputs, parameters and
    optimizer state left out; ``memory_analysis().temp_size_in_bytes``),
    a one-row trace's each counted once for each row: an estimate for the
    global step, the rows' temporaries held together as a mesh's rows
    run in step (a trace of every row runs them one after another on one
    host and frees a row's before the next's, so its peak is lower: 1.0
    to 7.0 times it on ``tests/test_torch_lm_dryrun_split.py``'s cells),
    so the mean position's at the traced row's peak, not the busiest's;
    ``moved``, every position's bytes sent and received by ``(kind,
    position)`` (``TensorParallel.moved``, every row's), and
    ``moved_by_kind``, the busiest position's by kind (nonzero kinds),
    whose total is ``moved_bytes`` (the HLO's collective bytes); and, per
    position by the fitted spec trees, ``arg_bytes`` (parameters,
    optimizer state, inputs) and ``out_bytes`` (the outputs). All but the
    per-position bytes are for the global step."""
    ops: Counter
    outputs: Any
    seconds: float
    flops: int = 0
    peak_live_bytes: int = 0
    moved_bytes: int = 0
    arg_bytes: int = 0
    out_bytes: int = 0
    moved: Counter = dataclasses.field(default_factory=Counter)
    moved_by_kind: dict = dataclasses.field(default_factory=dict)
    trace: str = "split"
    rows: int = 1
    rows_traced: int = 1

    @property
    def n_ops(self) -> int:
        return sum(self.ops.values())


class _LiveBytes:
    """Bytes held by the storages that ops created, and their peak: a
    storage counts once, from the op that made it until it is freed
    (a ``weakref.finalize`` on the storage, whose Python object lives as
    long as the storage does)."""

    def __init__(self):
        self.now = self.peak = 0
        self.on = True
        self._held: set[int] = set()

    def add(self, out, k: int = 1) -> None:
        """Hold ``out``'s new storages, each ``k`` times."""
        if not self.on:
            return
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held:
                continue
            n = st.nbytes() * k
            self._held.add(key)
            self.now += n
            self.peak = max(self.peak, self.now)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._held.discard(key)
        self.now -= n


class Trace(TorchDispatchMode):
    """While active, counts every ATen op dispatched that is not a view
    (``ops``, by name), their GEMM FLOPs (``flops``, by
    ``analysis.roofline.gemm_flops``) and the live bytes of the storages
    they create (``live``: ``live.peak``; ops that return an input or a
    view of one create none). Set ``live.on`` False around work whose
    storages are the step's arguments, not its temporaries. ``scale``, a
    callable, gives the number of times each op stands for (a one-row
    trace's rows), by which its FLOPs and bytes are multiplied."""

    def __init__(self, scale: Callable[[], int] | None = None):
        super().__init__()
        self.ops: Counter = Counter()
        self.flops = 0
        self.live = _LiveBytes()
        self.scale = scale or (lambda: 1)
        self._fresh: dict = {}      # op -> its outputs are new storages

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.ops[func.overloadpacket.__name__] += 1
            k = self.scale()
            self.flops += k * gemm_flops(func, args, kwargs, out)
            new = self._fresh.get(func)
            if new is None:
                new = self._fresh[func] = all(
                    r.alias_info is None for r in func._schema.returns)
            if new:
                self.live.add(out, k)
        return out


def position_bytes(mesh: Mesh, specs: Any, tree: Any) -> int:
    """The bytes one position holds of ``tree``: each leaf's bytes over
    the product of the mesh axes its spec (in ``specs``, the same
    structure) names."""
    def split(spec, x):
        n = math.prod(mesh.shape[a] for e in spec for a in shd._axes(e))
        return leaf_bytes(x) // n
    return sum(n for _, n in _leaves(shd.tree_map(split, specs, tree)))


def _place_kv_leaves(node: dict, specs: dict, mesh: Mesh) -> None:
    for key, sub in node.items():
        if isinstance(sub, dict):
            _place_kv_leaves(sub, specs[key], mesh)
        elif key in KV_LEAVES:
            node[key] = shd.place(sub, mesh, specs[key])


def _meta_mesh(mesh: Mesh) -> Mesh:
    return make_mesh(mesh.devices.shape, mesh.axis_names, "meta")


class Cell:
    """Everything needed to run or trace one (arch × shape × mesh) cell.

    ``device`` is where the cell's model lives: the mesh's first device
    by default, ``"meta"`` for a cell that only computes specs or traces.
    The model's tensors are zero until ``cell.model.init(generator)`` or
    ``bridge.load_lm_params``; parameter shapes come from a ``meta``
    model.
    """

    def __init__(self, arch: str, shape: str, mesh: Mesh,
                 policy: str = "auto", *, device=None):
        self.arch = arch
        self.shape = shape
        self.mesh = mesh
        self.cfg = get_config(arch)
        self.cell = SHAPES[shape]
        if policy == "auto":
            # dense-family training under pure FSDP where the reference
            # measured it to fit (steps.py:36-45)
            fsdp_ok = arch in ("granite-8b", "smollm-360m", "whisper-small")
            grid = mesh.shape.get("data", 1) * mesh.shape.get("model", 1)
            policy = ("fsdp" if fsdp_ok and self.cell.kind == "train"
                      and self.cell.batch % grid == 0 else "tp_fsdp")
        self.policy = policy
        self.shard = shd.make_shard_fn(mesh, policy)
        self.device = mesh.first_device if device is None \
            else torch.device(device)
        self.model = make_lm_model(self.cfg, self.shard, device=self.device)
        self.inputs_sds = input_specs(arch, shape)

        # RWKV6 has no attention: its split decode needs no context but
        # the placed parameters' (``place_params``)
        if self.cell.kind == "decode" and self.cfg.family != "ssm":
            self.model.decode_ctx = L.DecodeShardCtx(
                mesh=mesh, batch_axes=self._batch_split(
                    shd.mesh_batch_axes(mesh)), seq_axis="model")

        meta = self.model if self.device.type == "meta" \
            else make_lm_model(self.cfg, device="meta")
        self.param_shapes = meta.tensor_tree()
        pspecs = shd.param_specs(self.cfg.family, self.param_shapes,
                                 self.cfg)
        if self.policy == "fsdp":
            pspecs = shd.fsdp_param_specs(pspecs)
        leaves = [t for _, t in _leaves(self.param_shapes)]
        if self.cell.kind == "decode":
            # serving keeps weights TP-only unless a model shard would
            # exceed 8 GiB (steps.py:66-76)
            pbytes = sum(t.numel() * t.element_size() for t in leaves)
            if pbytes / mesh.shape.get("model", 1) <= 8 * 2**30:
                pspecs = shd.drop_axis(pspecs, "data")
        self.pspecs = shd.fit_spec_tree(mesh, pspecs, self.param_shapes)

        # optimizer-state compression for the very large archs
        big = sum(t.numel() for t in leaves) > 30_000_000_000
        self.opt_cfg = AdamWConfig(
            state_dtype="bfloat16" if big else "float32")
        self.n_micro = self._choose_microbatches()

    @property
    def decode_ctx(self) -> L.DecodeShardCtx | None:
        return getattr(self.model, "decode_ctx", None)

    def _choose_microbatches(self) -> int:
        """Gradient-accumulation depth so the rematerialised activation
        carry stays near 4 GiB (b·s·d·2 B·L) a position: a power of two
        dividing the per-position batch."""
        if self.cell.kind != "train":
            return 1
        cfg, cell = self.cfg, self.cell
        data_shards = 1
        for a in self._batch_axes():
            data_shards *= self.mesh.shape[a]
        local_b = max(cell.batch // data_shards, 1)
        l_eff = cfg.n_layers + cfg.encoder_layers   # enc-dec counts both
        carry_bytes = (local_b * cell.seq * cfg.d_model * 2
                       * max(l_eff, 1))
        n = 1
        while (carry_bytes / n > 4 * 2**30 and n < local_b
               and local_b % (n * 2) == 0):
            n *= 2
        return n

    # -- shardings --------------------------------------------------------------
    def state_shapes(self) -> TrainState:
        """The optimizer state over the ``meta`` parameter shapes."""
        return adamw_init(self.param_shapes, self.opt_cfg)

    def state_specs(self) -> TrainState:
        return TrainState(step=shd.P(), params=self.pspecs,
                          m=self.pspecs, v=self.pspecs)

    def _batch_split(self, baxes: tuple[str, ...]):
        """The batch's split over ``baxes`` as a spec entry (one axis or
        the tuple), or None where there are none or the cell's batch does
        not divide over them (the reference's rule, steps.py:55-60)."""
        nb = math.prod(self.mesh.shape[a] for a in baxes)
        if not baxes or self.cell.batch % nb:
            return None
        return baxes if len(baxes) > 1 else baxes[0]

    def _batch_axes(self) -> tuple[str, ...]:
        if self.policy == "fsdp":
            return tuple(a for a in ("data", "model")
                         if a in self.mesh.axis_names)
        return shd.mesh_batch_axes(self.mesh)

    def input_shardspecs(self, inputs: dict | None = None) -> dict:
        """The spec of every step input (``configs.input_specs``, or the
        given ``inputs`` of the same keys), fitted to its shape: a cache
        by ``cache_specs``, every other input's leading dim over the
        batch axes."""
        inputs = self.inputs_sds if inputs is None else inputs
        baxes = self._batch_axes()
        b = baxes if len(baxes) > 1 else baxes[0]
        specs = {}
        for k, v in inputs.items():
            if k == "cache":
                specs[k] = shd.cache_specs(self.cfg.family, self.mesh, v)
            else:
                specs[k] = shd.tree_map(
                    lambda x: shd.P(*([b] + [None] * (x.ndim - 1))), v)
            specs[k] = shd.fit_spec_tree(self.mesh, specs[k], v)
        return specs

    def place_cache(self, cache: dict) -> dict:
        """A decode cell's cache with its KV leaves (``KV_LEAVES``, at any
        depth: Zamba2's ``shared``) placed over the mesh by their fitted
        ``cache_specs`` and, once the parameters are split
        (:meth:`place_params`), the recurrent families' states too
        (``TensorParallel.place_states``); written into ``cache`` itself
        and returned. Cells without a ``decode_ctx`` or split weights keep
        every leaf whole."""
        if self.decode_ctx is not None:
            _place_kv_leaves(cache, self.input_shardspecs(
                {"cache": cache})["cache"], self.mesh)
        if self.tp is not None and self.cfg.family in ("ssm", "hybrid"):
            self.model.place_states(cache)
        return cache

    def place_params(self) -> TensorParallel:
        """Split this cell's parameters over its mesh by ``pspecs`` and
        run its steps on the split weights from now on (port-only; the
        reference's ``jax.jit(step, in_shardings=(named(pspecs), ...))``,
        and for a train cell ``in_shardings=(named(state_specs), ...)``).

        ``model.tensor_tree()`` is placed with ``place_tree``: a position
        on the weights' own device gets views, each other device one copy
        however many positions share it, taken now (place the parameters
        after they are loaded); the placed tree is the model's ``tp``
        (``distributed.tensor_parallel.TensorParallel``), whose ``moved``
        counts the copies between positions. The recurrent families'
        state caches are then placed by ``cache_specs`` when a step first
        sees them (:meth:`place_cache`, or the model's own ``prefill`` and
        ``decode_step``) and written in place, each position its slice.

        A train cell (every family) trains the placed pieces:
        :meth:`train_state` is the state over ``tp.tree``, and
        ``train_step_fn()`` gathers, reduces and updates them
        (``training.make_train_step``). The model's buffers stop requiring
        grad: the pieces on their device are views of them. The batch
        splits over ``_batch_axes()`` (``data``; under the ``fsdp`` policy
        ``data`` and ``model``, with no tensor parallelism). rwkv6's and
        zamba2's losses run each recurrent layer from zero states made
        where they are read, and place no state cache."""
        return self._place(one_row=False)

    def _place(self, one_row: bool) -> TensorParallel:
        """:meth:`place_params`; ``one_row``: batch row 0's work alone, the
        others counted by symmetry (a meta trace, :meth:`lower`)."""
        if self.cell.kind == "train":
            tree = self.model.tensor_tree()
            for _, t in _leaves(tree):
                t.requires_grad_(False)
        b_ax = self.decode_ctx.batch_axes if self.decode_ctx is not None \
            else self._batch_split(self._batch_axes())
        self.model.tp = TensorParallel(
            self.mesh, self.model.tensor_tree(), self.pspecs, b_ax,
            train=self.cell.kind == "train", one_row=one_row)
        return self.model.tp

    def train_state(self) -> TrainState:
        """A fresh ``TrainState`` for ``train_step_fn()``: over the placed
        pieces once :meth:`place_params` has run (moments placed as their
        parameters, by ``state_specs``), else over
        ``model.param_tree()``."""
        params = self.tp.tree if self.tp is not None \
            else self.model.param_tree()
        return adamw_init(params, self.opt_cfg)

    @property
    def tp(self) -> TensorParallel | None:
        """The placed parameters (:meth:`place_params`), or None."""
        return getattr(self.model, "tp", None)

    # -- step functions -----------------------------------------------------------
    def train_step_fn(self) -> Callable:
        """``step(state, batch) -> (state, {"loss", "grad_norm"})`` over
        ``state = cell.train_state()``: fp32 gradients accumulated over
        ``n_micro`` microbatches of the global batch, the loss sum and the
        gradients divided by ``n_micro``, then one AdamW update in place;
        on split weights (:meth:`place_params`) each microbatch splits
        over the batch axes and every part works on the pieces."""
        return make_train_step(self.model, self.opt_cfg,
                               n_micro=self.n_micro)

    def prefill_fn(self) -> Callable:
        """``prefill(inputs) -> (last logits, cache)``: a new cache of the
        cell's sequence length (whisper's memory of the frames' length,
        pixtral's of the image and text rows, none for RWKV6) filled by
        the family's ``prefill``."""
        model, cfg, cell = self.model, self.cfg, self.cell

        def prefill(inputs: dict):
            tokens = inputs["tokens"]
            b = tokens.shape[0]
            if cfg.family == "encdec":
                cache = model.init_cache(b, cell.seq,
                                         inputs["frames"].shape[1])
                return model.prefill(tokens, inputs["frames"], cache)
            if cfg.family == "vlm":
                s_total = tokens.shape[1] + inputs["patch_embeds"].shape[1]
                cache = model.init_cache(b, s_total)
                return model.prefill(tokens, cache,
                                     patch_embeds=inputs["patch_embeds"])
            if cfg.family == "ssm":
                return model.prefill(tokens, model.init_cache(b, 0))
            return model.prefill(tokens, model.init_cache(b, cell.seq))
        return prefill

    def decode_fn(self) -> Callable:
        """``serve_step(inputs) -> (logits, cache)``: the cache placed by
        :meth:`place_cache`, then one ``decode_step`` (through the
        sequence-parallel flash decode where the cell has a
        ``decode_ctx``)."""
        model = self.model

        def serve_step(inputs: dict):
            return model.decode_step(inputs["tokens"],
                                     self.place_cache(inputs["cache"]))
        return serve_step

    # -- tracing ------------------------------------------------------------------
    def lower(self) -> tuple[Lowered, str]:
        """Run the cell's step once on ``meta`` tensors of its full
        shapes and return ``(record, kind)``.

        There is no eager counterpart of the reference's ``jit(...)
        .lower()``: nothing is compiled. The step runs as it would on a
        card, over a ``meta`` twin of this cell (its config, policy and
        inputs, on a mesh of the same shape on the meta device), so every
        op dispatches with its real shapes and nothing is allocated. As
        the reference lowers the partitioned step, the twin's parameters
        are placed by ``pspecs`` (:meth:`place_params`) and the split
        step runs: batch row 0's work alone, every other row counted by
        symmetry (``TensorParallel``'s ``one_row``), or, where the rows
        do not work alike (a train step's MoE routing unit spanning every
        row), every row. In a one-row trace rwkv6's and zamba2's head
        sites of a row scan as one (``TensorParallel.scan_sites``), so
        their recurrences dispatch about the unplaced step's ops. Only a
        mesh of one position traces the unplaced step: it has nothing to
        split (there the split step's remat, the reentrant checkpoint of
        ``layers._remat_split``, would recompute each block's last
        product too). The analysis and the dry run take their FLOPs, live
        bytes and bytes between positions from this trace
        (:class:`Lowered`), counted in the same pass as the ops."""
        if self.mesh.size == 1:
            return self._lower("unplaced")
        try:
            return self._lower("one_row")
        except RowsNotAlike:
            return self._lower("all_rows")

    def _meta_twin(self) -> "Cell":
        """This cell on a ``meta`` mesh of the same shape: its config,
        shape, policy, specs, inputs and microbatches, a new ``meta``
        model with nothing placed."""
        twin = copy.copy(self)
        twin.mesh = _meta_mesh(self.mesh)
        twin.device = torch.device("meta")
        twin.shard = shd.make_shard_fn(twin.mesh, self.policy)
        twin.model = make_lm_model(self.cfg, twin.shard, device="meta")
        if self.decode_ctx is not None:
            twin.model.decode_ctx = L.DecodeShardCtx(
                mesh=twin.mesh, batch_axes=self.decode_ctx.batch_axes,
                seq_axis=self.decode_ctx.seq_axis)
        return twin

    def _lower(self, how: str) -> tuple[Lowered, str]:
        """:meth:`lower`'s trace of one step: ``how`` is ``"one_row"``,
        ``"all_rows"`` (the split step) or ``"unplaced"``."""
        cell = self._meta_twin()
        kind = cell.cell.kind
        mesh = cell.mesh
        tp = None if how == "unplaced" else cell._place(how == "one_row")
        # the decode step places and writes its cache in the dict it is
        # given: a copy of the dicts keeps the cell's inputs as they are
        inputs = shd.tree_map(lambda x: x, cell.inputs_sds)
        arg_bytes = position_bytes(mesh, cell.input_shardspecs(), inputs) \
            + position_bytes(mesh, cell.pspecs, cell.param_shapes)
        t0 = time.perf_counter()
        with Trace(None if tp is None else tp.op_rows) as tr:
            # what the reference takes as arguments (the optimizer state,
            # a placed cache) is made before the live bytes count
            tr.live.on = False
            if kind == "train":
                state = cell.train_state()
                arg_bytes += 4 + sum(position_bytes(mesh, cell.pspecs, t)
                                     for t in (state.m, state.v))
                tr.live.on = True
                state, metrics = cell.train_step_fn()(state, inputs)
                outputs = {"params": state.params, "m": state.m,
                           "v": state.v, **metrics}
                out_bytes = sum(position_bytes(mesh, cell.pspecs, t)
                                for t in (state.params, state.m, state.v)) \
                    + sum(leaf_bytes(x) for x in metrics.values())
            else:
                if kind == "decode":
                    cell.place_cache(inputs["cache"])
                tr.live.on = True
                fn = cell.prefill_fn() if kind == "prefill" \
                    else cell.decode_fn()
                outputs = fn(inputs)
                logits, cache = outputs
                out_bytes = position_bytes(
                    mesh, cell.input_shardspecs(
                        {"logits": logits, "cache": cache}),
                    {"logits": logits, "cache": cache})
        seconds = time.perf_counter() - t0
        low = Lowered(tr.ops, outputs, seconds, flops=tr.flops,
                      peak_live_bytes=tr.live.peak, arg_bytes=arg_bytes,
                      out_bytes=out_bytes, trace="unplaced")
        if tp is not None:
            tp.fold()
            per_pos = tp.by_position()
            busiest = max(sorted(per_pos), key=per_pos.__getitem__,
                          default=None)
            low.trace = "split"
            low.moved = Counter(tp.moved)
            low.moved_by_kind = {k: tp.moved[k, busiest] for k in KINDS
                                 if tp.moved[k, busiest]}
            low.moved_bytes = per_pos[busiest] if per_pos else 0
            low.rows = tp.n_rows
            low.rows_traced = len(tp.rows)
        elif cell.decode_ctx is not None and cell.decode_ctx.moved:
            # the unplaced decode's one copy between positions: the flash
            # decode's merge over the cache's shards (DecodeShardCtx)
            low.moved = Counter({("merge", pos): n for pos, n
                                 in cell.decode_ctx.moved.items()})
            low.moved_bytes = max(cell.decode_ctx.moved.values())
            low.moved_by_kind = {"merge": low.moved_bytes}
        return low, kind


def build_cell(arch: str, shape: str, mesh: Mesh, **kwargs) -> Cell:
    return Cell(arch, shape, mesh, **kwargs)

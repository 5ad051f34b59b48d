"""Fault-tolerant training loop: checkpoint/restart, deterministic replay,
straggler surfacing, preemption-safe writes.

Counterpart of ``repro.training.train_loop``. The loop holds no state
outside (step, ``TrainState``): data is step-indexed, so a restart
replays nothing, and checkpoints are atomic. ``resume="auto"`` continues
from the newest intact checkpoint. Per-step wall times are logged, and
steps slower than ``straggler_factor`` × the running median are flagged.
Reading each step's metrics as Python floats waits for the device, as
``jax.block_until_ready`` does in the reference.

:func:`make_train_step` is the step the reference's drivers write inline
(``jax.value_and_grad(model.loss)`` then ``adamw_update``):
``loss.backward()`` through the model's own buffers, then
:func:`adamw_update`. It serves any model with ``loss(batch)`` and a
``param_tree()``: the CTR models (``make_ctr_step`` is its CTR name) and
the LM zoo (``launch/train.py``, and ``launch/steps.py``'s cells with
their gradient accumulation over ``n_micro`` microbatches).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.distributed.sharding import Placed, pieces

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .optimizer import AdamWConfig, TrainState, adamw_update, tree_map

__all__ = ["TrainLoopConfig", "run_train_loop", "make_train_step",
           "make_ctr_step", "loss_and_grads"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_ckpt"))
    resume: str = "auto"                # "auto" | "none"
    log_every: int = 10
    straggler_factor: float = 3.0
    keep_ckpts: int = 2


def make_train_step(model, cfg: AdamWConfig, n_micro: int = 1) -> Callable:
    """``step_fn(state, batch) -> (state, {"loss", "grad_norm"})`` for a
    model (a ``CTRModel``, an LM of the zoo) whose buffers are
    ``state.params`` (its ``param_tree()``): ``model.loss(batch)`` and its
    gradients by autograd (:func:`loss_and_grads`), then one AdamW update
    in place. Every parameter must receive a gradient: one that gets none
    (a kernel output outside autograd) raises. The three parts run inside
    profiler ranges ``train/forward``, ``train/backward`` and
    ``train/optimizer``.

    ``n_micro`` > 1 accumulates, as the reference's cell step does
    (``launch/steps.py:117-141``): the batch's leading dim is cut into
    ``n_micro`` consecutive microbatches (it must divide), each one's
    gradients are added in fp32 to zeros, and the summed loss and
    gradients are divided by ``n_micro`` before the update.

    On split weights (an LM whose ``tp`` is set: ``Cell.place_params`` of
    a train cell) ``state.params`` is ``model.tp.tree``, the
    placed pieces, and so are the gradients, the fp32 accumulators and
    the moments: each microbatch's forward and backward run on the split
    weights and ``TensorParallel.grads`` reduces its gradients to their
    pieces before they are added."""
    if n_micro < 1:
        raise ValueError(f"n_micro must be at least 1, not {n_micro}")

    def step_fn(state: TrainState, batch: dict):
        loss, grads = loss_and_grads(model, state.params, batch, n_micro)
        with record_function("train/optimizer"):
            state, metrics = adamw_update(state, grads, cfg)
        return state, {"loss": loss, **metrics}
    return step_fn


def loss_and_grads(model, params: Any, batch: dict,
                   n_micro: int = 1) -> tuple[torch.Tensor, Any]:
    """``model.loss`` over ``batch`` (``n_micro`` microbatches) and the
    gradients of ``params`` (the model's ``param_tree()``, or on split
    weights ``model.tp.tree``): a tree of the same structure, the
    leaves in the parameters' dtype for one microbatch, else the fp32
    mean over the microbatches."""
    tp = getattr(model, "tp", None)
    leaves = _tensors(params)
    if tp is not None and not all(isinstance(p, Placed) for p in leaves):
        raise TypeError("a split step takes the state over the placed "
                        "pieces: adamw_init(model.tp.tree, cfg)")

    def backward(batch: dict):
        # on split weights the gathered weights of one part are never
        # another's: the backward regathers what it recomputes
        if tp is not None:
            tp.release()
        with record_function("train/forward"):
            loss = model.loss(batch)
        if tp is not None:
            tp.release()
        with record_function("train/backward"):
            loss.backward()
        if tp is not None:
            tp.release()
            return loss.detach(), tp.grads()
        missing = [tuple(p.shape) for p in leaves if p.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached parameters of shapes "
                               f"{missing}")
        grads = tree_map(lambda p: p.grad, params)
        for p in leaves:
            p.grad = None
        return loss.detach(), grads

    if n_micro == 1:
        return backward(batch)
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"a batch of {b} does not cut into "
                         f"{n_micro} microbatches")
    mb = b // n_micro
    acc = tree_map(_like(lambda t: torch.zeros(
        t.shape, dtype=torch.float32, device=t.device), torch.float32),
        params)
    loss = None
    for i in range(n_micro):
        li, gi = backward({k: v[i * mb:(i + 1) * mb]
                           for k, v in batch.items()})
        with torch.no_grad():
            tree_map(_add, acc, gi)
        loss = li if loss is None else loss + li
    return loss / n_micro, tree_map(_like(lambda g: g / n_micro), acc)


def _like(fn: Callable, dtype: torch.dtype | None = None) -> Callable:
    """``fn`` on a tensor leaf, and on each distinct piece of a placed
    one."""
    return lambda x: x.like(fn, dtype) if isinstance(x, Placed) else fn(x)


def _add(acc, g) -> None:
    for a, b in zip(pieces(acc), pieces(g), strict=True):
        a.add_(b.float())


#: the CTR drivers' name for the step (``launch/train_ctr.py``)
make_ctr_step = make_train_step


def _tensors(tree: Any) -> list:
    """The leaves of ``tree`` in order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def run_train_loop(step_fn: Callable, state: Any, batch_fn: Callable,
                   cfg: TrainLoopConfig) -> tuple[Any, list[dict]]:
    """Run ``total_steps`` of ``step_fn(state, batch) -> (state, metrics)``.

    batch_fn(step) must be a pure function of the step index.
    Returns (final_state, history).
    """
    start = 0
    if cfg.resume == "auto":
        last = latest_step(cfg.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(cfg.ckpt_dir, last, state)
            start = last
            print(f"[train] resumed from step {start}")
    history: list[dict] = []
    durations: list[float] = []
    for step in range(start, cfg.total_steps):
        t0 = time.perf_counter()
        batch = batch_fn(step)
        state, metrics = step_fn(state, batch)
        values = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        durations.append(dt)
        med = float(np.median(durations[-50:]))
        if len(durations) > 5 and dt > cfg.straggler_factor * med:
            print(f"[train] STRAGGLER step {step}: {dt*1e3:.1f}ms "
                  f"(median {med*1e3:.1f}ms)")
        rec = {"step": step + 1, "sec": dt, **values}
        history.append(rec)
        if (step + 1) % cfg.log_every == 0:
            print(f"[train] step {rec['step']} "
                  + " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                             if k != "step"))
        if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.total_steps:
            save_checkpoint(cfg.ckpt_dir, step + 1, state)
            _gc_checkpoints(cfg.ckpt_dir, cfg.keep_ckpts)
    return state, history


def _gc_checkpoints(ckpt_dir: str, keep: int) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_", 1)[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_")
        and os.path.exists(os.path.join(ckpt_dir, n, "manifest.json")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)

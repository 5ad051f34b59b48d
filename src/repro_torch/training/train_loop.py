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

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .optimizer import AdamWConfig, TrainState, adamw_update, tree_map

__all__ = ["TrainLoopConfig", "run_train_loop", "make_train_step",
           "make_ctr_step"]


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
    gradients by autograd, then one AdamW update in place. Every
    parameter must receive a gradient: one that gets none (a kernel
    output outside autograd) raises. The three parts run inside profiler
    ranges ``train/forward``, ``train/backward`` and ``train/optimizer``.

    ``n_micro`` > 1 accumulates, as the reference's cell step does
    (``launch/steps.py:117-141``): the batch's leading dim is cut into
    ``n_micro`` consecutive microbatches (it must divide), each one's
    gradients are added in fp32 to zeros, and the summed loss and
    gradients are divided by ``n_micro`` before the update."""
    if n_micro < 1:
        raise ValueError(f"n_micro must be at least 1, not {n_micro}")

    def backward(params: list, batch: dict):
        with record_function("train/forward"):
            loss = model.loss(batch)
        with record_function("train/backward"):
            loss.backward()
        missing = [tuple(p.shape) for p in params if p.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached parameters of shapes "
                               f"{missing}")
        return loss.detach()

    def step_fn(state: TrainState, batch: dict):
        params = _tensors(state.params)
        if n_micro == 1:
            loss = backward(params, batch)
            grads = tree_map(lambda p: p.grad, state.params)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_micro:
                raise ValueError(f"a batch of {b} does not cut into "
                                 f"{n_micro} microbatches")
            mb = b // n_micro
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = None
            for i in range(n_micro):
                li = backward(params, {k: v[i * mb:(i + 1) * mb]
                                       for k, v in batch.items()})
                with torch.no_grad():
                    tree_map(lambda g, p: g.add_(p.grad.float()), grads,
                             state.params)
                for p in params:
                    p.grad = None
                loss = li if loss is None else loss + li
            loss = loss / n_micro
            grads = tree_map(lambda g: g / n_micro, grads)
        with record_function("train/optimizer"):
            state, metrics = adamw_update(state, grads, cfg)
        for p in params:
            p.grad = None
        return state, {"loss": loss, **metrics}
    return step_fn


#: the CTR drivers' name for the step (``launch/train_ctr.py``)
make_ctr_step = make_train_step


def _tensors(tree: Any) -> list:
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

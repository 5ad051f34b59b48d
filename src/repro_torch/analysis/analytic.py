"""Closed-form cost model per (arch × shape): MODEL_FLOPS and the HBM-traffic
estimate that feeds the roofline memory term.

Counterpart of ``repro.analysis.analytic``, with the same arithmetic.
MODEL_FLOPS: 6·N·D for training (N = active non-embedding params, D =
tokens), 2·N·D for prefill, 2·N·B for one decode step. The HBM model is
a lower-bound estimate (weights traffic + optimizer traffic +
activation-carry IO + KV/state traffic).

Where the reference reads shapes from ``jax.eval_shape``, the port reads
them from a ``meta`` model (``make_lm_model(cfg, device="meta")``),
whose stacked groups are lists of per-layer dicts.
"""

from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.bridge import _leaves
from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.models.lm import make_lm_model

__all__ = ["param_stats", "model_flops", "hbm_bytes_per_device",
           "AnalyticCost", "analytic_cost"]

_DT = {"float32": 4, "bfloat16": 2, "float16": 2}
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
# the reference's cache ``index`` is a 0-d int32 array; the port's a
# Python int, counted as those 4 bytes
_INDEX_BYTES = 4


def param_stats(arch: str) -> dict:
    """total / active / embedding parameter counts (exact, from a ``meta``
    model). ``active`` counts ``top_k / n_experts`` of the expert
    weights (``w_gate``/``w_up``/``w_down`` of every layer that holds
    them)."""
    cfg = get_config(arch)
    total, active, embed = _counts(cfg)
    return {"total": total, "active": active, "embed": embed,
            "param_bytes": total * _DT[cfg.dtype]}


# one entry per config: every cell of the grid asks for its arch's counts
# several times, and a meta model of llama4-maverick takes a second
@functools.lru_cache(maxsize=None)
def _counts(cfg) -> tuple[int, int, int]:
    tree = make_lm_model(cfg, device="meta").tensor_tree()
    total = embed = expert = 0
    for path, t in _leaves(tree):
        n = t.numel()
        total += n
        if len(path) == 1 and path[0] in ("embed", "lm_head", "pos_dec"):
            embed += n
        if "moe" in path and path[-1] in _EXPERT_LEAVES:
            expert += n
    active = total
    if cfg.n_experts:
        active = total - expert + int(expert * cfg.top_k / cfg.n_experts)
    return total, active, embed


def model_flops(arch: str, shape: str) -> float:
    """Global MODEL_FLOPS for one step of this cell."""
    cell = SHAPES[shape]
    st = param_stats(arch)
    n = st["active"] - st["embed"]
    if cell.kind == "train":
        return 6.0 * n * cell.batch * cell.seq
    if cell.kind == "prefill":
        return 2.0 * n * cell.batch * cell.seq
    return 2.0 * n * cell.batch               # decode: one token per row


@dataclasses.dataclass
class AnalyticCost:
    model_flops: float            # global
    hbm_bytes_per_device: float   # per device per step
    components: dict


def hbm_bytes_per_device(arch: str, shape: str, chips: int,
                         n_micro: int = 1,
                         opt_state_bytes_per_param: int = 8) -> AnalyticCost:
    cfg = get_config(arch)
    cell = SHAPES[shape]
    st = param_stats(arch)
    pb = st["param_bytes"]
    act_dt = _DT[cfg.dtype]
    d = cfg.d_model
    L = cfg.n_layers + cfg.encoder_layers
    comp: dict[str, float] = {}

    if cell.kind == "train":
        # weights: fwd + remat-fwd + bwd ≈ 3 reads per microbatch
        comp["weights_read"] = 3.0 * n_micro * pb / chips
        # optimizer: read+write m, v (state dtype) + read+write params
        comp["optimizer"] = (2 * 2 * st["total"] * opt_state_bytes_per_param / 2
                             + 2 * pb) / chips
        comp["grads"] = 2 * st["total"] * 4 / chips       # f32 accum rw
        # activation carry: written fwd, read bwd, once per layer over the
        # whole global batch (microbatching doesn't change the total)
        comp["activations"] = 2.0 * L * cell.batch * cell.seq * d * act_dt / chips
    elif cell.kind == "prefill":
        comp["weights_read"] = pb / chips
        comp["activations"] = 2.0 * L * cell.batch * cell.seq * d * act_dt / chips
        comp["kv_write"] = _cache_bytes(arch, cell) / chips
    else:  # decode
        comp["weights_read"] = _decode_weight_bytes(arch) / chips
        cb = _cache_bytes(arch, cell)
        comp["cache_read"] = cb / chips
        comp["cache_write"] = min(cb / chips, 1e7)  # one-slot update
        comp["activations"] = 2.0 * L * cell.batch * d * act_dt / chips
    return AnalyticCost(model_flops=model_flops(arch, shape),
                        hbm_bytes_per_device=float(sum(comp.values())),
                        components=comp)


def leaf_bytes(x) -> int:
    """A leaf's bytes: a tensor's or a ``Placed`` value's whole; a
    cache's Python ``index`` counts as the reference's 0-d int32."""
    if isinstance(x, int):
        return _INDEX_BYTES
    return math.prod(x.shape) * x.dtype.itemsize


def _cache_bytes(arch: str, cell) -> float:
    """KV / SSM state bytes for the full cache at this cell's shape."""
    cfg = get_config(arch)
    if cell.kind == "decode":
        cache = input_specs(arch, cell.name)["cache"]
        return float(sum(leaf_bytes(x) for _, x in _leaves(cache)))
    # prefill: KV written for (batch, seq); layers that actually hold KV
    if cfg.attention == "none":
        return 0.0
    if cfg.family == "hybrid":
        layers_kv = make_lm_model(cfg, device="meta").n_shared()
    elif cfg.family == "encdec":
        layers_kv = 2 * cfg.n_layers           # self + cross per dec layer
    else:
        layers_kv = cfg.n_layers
    kv = 2 * (layers_kv * cell.batch * cell.seq
              * cfg.n_kv_heads * cfg.hd) * _DT[cfg.dtype]
    return float(kv)


def _decode_weight_bytes(arch: str) -> float:
    """Weights actually read per decode step (MoE reads routed experts only
    when batch << experts; with batch ≥ experts assume all touched)."""
    st = param_stats(arch)
    return float(st["param_bytes"])


def analytic_cost(arch: str, shape: str, chips: int,
                  n_micro: int = 1) -> AnalyticCost:
    return hbm_bytes_per_device(arch, shape, chips, n_micro)

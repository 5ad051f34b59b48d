"""Roofline assembly: three terms per (arch × shape × mesh) from one meta
trace of the cell's step (``Cell.lower``) and the analytic model.

Counterpart of ``repro.analysis.roofline``, with H100 constants
(``hw``):

  compute_s    = per-position GEMM FLOPs / 989 TF/s (bf16 tensor cores)
  memory_s     = analytic per-position HBM bytes / 3.35 TB/s
  collective_s = busiest position's bytes between positions / 450 GB/s
                 (NVLink, one direction)

The reference reads its FLOPs, collective bytes and memory from XLA (the
loop-corrected HLO of the compiled step and its ``memory_analysis``);
the port compiles nothing and takes each from the trace instead
(:class:`repro_torch.launch.steps.Lowered`): FLOPs by
:func:`gemm_flops` over every op the step dispatched, the bytes
``layers.flash_decode_sharded`` sends between positions, the peak of the
live bytes the step's ops created, and the per-position bytes of the
parameters, optimizer state, inputs and outputs by their fitted specs.
The trace unrolls every Python loop and re-runs each checkpointed block
under backward, so its FLOPs need no loop correction. The MODEL_FLOPS /
traced-FLOPs ratio surfaces remat and redundancy waste (remat alone puts
it near 3/4 for training: 6ND useful vs ~8ND executed).
"""

from __future__ import annotations

import dataclasses
import json

from torch.utils.flop_counter import flop_registry

from . import hw
from .analytic import analytic_cost

__all__ = ["RooflineReport", "analyze_cell", "gemm_flops"]

#: what the port does not model, in every record
NOTE = ("port: FLOPs, bytes between positions and live bytes from one "
        "meta trace of the step (no compiler, no partitioner); weights "
        "stay whole on the first position (not split across cards)")


def gemm_flops(func, args, kwargs, out) -> int:
    """2·M·N·K of one dispatched ATen op that ``torch.utils.flop_counter``
    knows (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions, the
    fused attentions; ``matmul`` and ``einsum`` lower to them), else 0.
    The counterpart of ``parse_hlo``'s ``dot_flops``: the bias of an
    ``addmm`` and every elementwise op count nothing."""
    f = flop_registry.get(func.overloadpacket)
    return 0 if f is None else int(f(*args, **kwargs, out_val=out))


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # three terms (seconds per step)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # accounting
    hlo_dot_flops_per_device: float
    raw_cost_analysis_flops: float
    model_flops_global: float
    useful_ratio: float             # MODEL_FLOPS / traced FLOPs
    collective_bytes_per_device: float
    collective_breakdown: dict
    hbm_bytes_per_device: float
    hbm_components: dict
    # memory feasibility, per position
    arg_bytes: int
    temp_bytes: int
    out_bytes: int
    fits_hbm: bool
    n_micro: int
    note: str = ""
    # int8 companion terms (quantized compute): the tensor cores' int8
    # peak doubles bf16, and the weights-read HBM component shrinks to
    # ~1/4 (int8 payload + per-channel scales). Arithmetic intensity
    # (FLOP per HBM byte) for both dtypes locates each cell against the
    # machine balance point (PEAK / HBM_BW).
    compute_s_int8: float = 0.0
    memory_s_int8: float = 0.0
    arith_intensity: float = 0.0
    arith_intensity_int8: float = 0.0

    def step_time_bound_s(self) -> float:
        """Roofline lower bound on step time (no overlap assumption)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """compute_term / max-term: 1.0 = perfectly compute-bound."""
        t = self.step_time_bound_s()
        return self.compute_s / t if t > 0 else 0.0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1, default=str)


def analyze_cell(arch: str, shape: str, mesh_name: str, chips: int,
                 lowered, n_micro: int = 1) -> RooflineReport:
    """The roofline record of one cell from its trace (``lowered``, a
    ``Lowered``) on ``chips`` positions. The trace is the global step;
    its FLOPs split evenly over the positions, as the spec trees
    describe, and so does its peak of live bytes."""
    an = analytic_cost(arch, shape, chips, n_micro)
    dot_flops = lowered.flops / chips
    moved = float(lowered.moved_bytes)

    compute_s = dot_flops / hw.PEAK_FLOPS_BF16
    memory_s = an.hbm_bytes_per_device / hw.HBM_BW
    collective_s = moved / hw.NVLINK_BW

    # int8 twin: GEMMs at the doubled tensor-core peak, weight reads at
    # ~1/4 the bytes (the only HBM component quantized compute shrinks)
    w_read = float(an.components.get("weights_read", 0.0))
    hbm_int8 = an.hbm_bytes_per_device - 0.75 * w_read
    compute_s_int8 = dot_flops / hw.PEAK_OPS_INT8
    memory_s_int8 = hbm_int8 / hw.HBM_BW
    ai = (dot_flops / an.hbm_bytes_per_device
          if an.hbm_bytes_per_device else 0.0)
    ai_int8 = dot_flops / hbm_int8 if hbm_int8 else 0.0
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)

    per_dev_model = an.model_flops / chips
    useful = per_dev_model / dot_flops if dot_flops else 0.0

    temp = lowered.peak_live_bytes // chips
    live = lowered.arg_bytes + temp + lowered.out_bytes
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        hlo_dot_flops_per_device=dot_flops,
        raw_cost_analysis_flops=float(lowered.flops),
        model_flops_global=an.model_flops,
        useful_ratio=useful,
        collective_bytes_per_device=moved,
        collective_breakdown={"flash_decode_merge": moved},
        hbm_bytes_per_device=an.hbm_bytes_per_device,
        hbm_components=an.components,
        arg_bytes=lowered.arg_bytes,
        temp_bytes=temp,
        out_bytes=lowered.out_bytes,
        fits_hbm=live <= hw.HBM_BYTES,
        n_micro=n_micro,
        note=NOTE,
        compute_s_int8=compute_s_int8,
        memory_s_int8=memory_s_int8,
        arith_intensity=ai,
        arith_intensity_int8=ai_int8,
    )

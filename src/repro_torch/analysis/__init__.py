"""Roofline analysis from meta traces of the cells' steps: the H100
constants (``hw``), the closed-form cost model (``analytic``) and the
per-cell roofline record (``roofline``). Counterpart of
``repro.analysis``; the reference's HLO parser has no twin, since the
port's FLOPs come from the trace (``roofline.gemm_flops``)."""

from . import hw
from .analytic import analytic_cost, model_flops, param_stats
from .roofline import RooflineReport, analyze_cell, gemm_flops

__all__ = ["hw", "analytic_cost", "model_flops", "param_stats",
           "RooflineReport", "analyze_cell", "gemm_flops"]

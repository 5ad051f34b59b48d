"""Architecture registry: the 10 assigned LM architectures and the paper's
CTR configs.

Counterpart of ``repro.configs``. Every LM arch lives in its own module
(the exact published config, with ``[source; tier]`` provenance), copied
as the reference has it. ``input_specs`` (the dry run's input stand-ins)
is still to be ported.

Shape cells (LM):
    train_4k     seq 4096   global_batch 256   train step
    prefill_32k  seq 32768  global_batch 32    prefill
    decode_32k   seq 32768  global_batch 128   one decode token, KV cache
                                               of seq length
    long_500k    seq 524288 global_batch 1     decode; SSM/hybrid only —
                                               dense-attention archs skip
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.data.synthetic import AVAZU, CRITEO
from repro_torch.models.ctr.common import CTRModelSpec
from repro_torch.models.lm.config import LMConfig

__all__ = ["ctr_spec", "ShapeCell", "SHAPES", "ARCH_NAMES", "get_config",
           "get_source", "applicable_shapes"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq: int
    batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

_ARCH_MODULES = {
    "granite-8b": "granite_8b",
    "smollm-360m": "smollm_360m",
    "llama3-8b": "llama3_8b",
    "qwen3-4b": "qwen3_4b",
    "whisper-small": "whisper_small",
    "rwkv6-7b": "rwkv6_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "pixtral-12b": "pixtral_12b",
    "zamba2-1.2b": "zamba2_12b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> LMConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def get_source(name: str) -> str:
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.SOURCE


def applicable_shapes(name: str) -> dict[str, str]:
    """shape -> "run" or a skip reason (the 40-cell grid bookkeeping)."""
    cfg = get_config(name)
    out = {}
    for s in SHAPES:
        if s == "long_500k" and cfg.attention == "full":
            out[s] = ("SKIP: pure full-attention arch - 524k dense KV "
                      "decode reserved for sub-quadratic archs per "
                      "assignment (DESIGN.md S4)")
        else:
            out[s] = "run"
    return out


# ---------------------------------------------------------------------------
# paper CTR configs (§V-A: 4 models × {16, 32} × {256, 512, 1024})
# ---------------------------------------------------------------------------

def ctr_spec(model: str, dataset: str, embed_dim: int = 16,
             hidden: int = 256, max_field: int | None = None) -> CTRModelSpec:
    schema = {"avazu": AVAZU, "criteo": CRITEO}[dataset]
    if max_field:
        schema = schema.scaled(max_field)
    return CTRModelSpec(
        name=f"{model}_{dataset}_{embed_dim}_{hidden}",
        field_sizes=schema.field_sizes,
        embed_dim=embed_dim,
        hidden=(hidden,) * 3,
        cross_layers=3)

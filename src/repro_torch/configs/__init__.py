"""Architecture registry: the 10 assigned LM architectures and the paper's
CTR configs.

Counterpart of ``repro.configs``. Every LM arch lives in its own module
(the exact published config, with ``[source; tier]`` provenance), copied
as the reference has it. ``input_specs(arch, shape)`` gives every step
input of a cell as a ``meta`` tensor (shape and dtype, no storage), in
place of the reference's ``ShapeDtypeStruct``.

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

import torch

from repro_torch.data.synthetic import AVAZU, CRITEO
from repro_torch.models.ctr.common import CTRModelSpec
from repro_torch.models.lm.config import LMConfig

__all__ = ["ctr_spec", "ShapeCell", "SHAPES", "ARCH_NAMES", "get_config",
           "get_source", "applicable_shapes", "input_specs"]


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
# input specs (meta tensors, no allocation)
# ---------------------------------------------------------------------------

def _meta(shape, dtype: str | torch.dtype) -> torch.Tensor:
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(name: str, shape: str) -> dict:
    """Step-function inputs for (arch, shape) as ``meta`` tensors: int32
    tokens, the frontend stubs (whisper's frames, pixtral's patch
    embeddings; a quarter of the sequence is image), and for decode
    cells the cache, from the family's ``init_cache`` on a ``meta`` model
    (its ``index`` a Python int, as a real cache's is)."""
    from repro_torch.models.lm import make_lm_model

    cfg = get_config(name)
    cell = SHAPES[shape]
    gb, s = cell.batch, cell.seq
    d = cfg.d_model
    tok = torch.int32

    if cell.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            return {"tokens": _meta((gb, s), tok),
                    "frames": _meta((gb, s, d), cfg.dtype)}
        if cfg.family == "vlm":
            s_img = s // 4
            return {"tokens": _meta((gb, s - s_img), tok),
                    "patch_embeds": _meta((gb, s_img, d), cfg.dtype)}
        return {"tokens": _meta((gb, s), tok)}
    model = make_lm_model(cfg, device="meta")
    if cfg.family == "encdec":
        # one token + a self-cache of length s + the cross memory cache
        cache = model.init_cache(gb, s, s)
    else:
        cache = model.init_cache(gb, 0 if cfg.family == "ssm" else s)
    return {"tokens": _meta((gb, 1), tok), "cache": cache}


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

"""Paper CTR configurations (§V-A: 4 models × {16, 32} × {256, 512, 1024}).

Counterpart of ``repro.configs.ctr_spec``.
"""

from __future__ import annotations

from repro_torch.data.synthetic import AVAZU, CRITEO
from repro_torch.models.ctr.common import CTRModelSpec

__all__ = ["ctr_spec"]


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

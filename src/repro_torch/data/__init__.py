"""Dataset schemas, numpy-seeded id samplers, the labelled training batch
and its loader."""

from .pipeline import CTRLoader
from .synthetic import (AVAZU, CRITEO, SKEWS, DatasetSchema, make_schema,
                        planted_effect, planted_labels, sample_ids,
                        skewed_ids_from_uniform, synthetic_batch, zipf_ids,
                        zipf_ids_from_uniform)

__all__ = ["DatasetSchema", "AVAZU", "CRITEO", "SKEWS", "make_schema",
           "sample_ids", "zipf_ids", "zipf_ids_from_uniform", "skewed_ids_from_uniform",
           "planted_effect", "planted_labels", "synthetic_batch",
           "CTRLoader"]

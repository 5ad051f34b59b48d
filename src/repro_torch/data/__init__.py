"""Dataset schemas and numpy-seeded id samplers."""

from .synthetic import (AVAZU, CRITEO, SKEWS, DatasetSchema, sample_ids,
                        zipf_ids, zipf_ids_from_uniform)

__all__ = ["DatasetSchema", "AVAZU", "CRITEO", "SKEWS", "sample_ids",
           "zipf_ids", "zipf_ids_from_uniform"]

"""Dataset schemas and a numpy-seeded id sampler."""

from .synthetic import AVAZU, CRITEO, SKEWS, DatasetSchema, sample_ids

__all__ = ["DatasetSchema", "AVAZU", "CRITEO", "SKEWS", "sample_ids"]

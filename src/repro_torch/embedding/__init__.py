"""Embedding tier: spec, stores, and the fused lookup collection."""

from .cached import CachedStore
from .collection import FusedEmbeddingCollection
from .spec import FusedEmbeddingSpec
from .store import (DenseStore, EmbeddingStore, StoreStats, runtime_edge,
                    validate_deltas)

__all__ = ["FusedEmbeddingSpec", "EmbeddingStore", "DenseStore",
           "CachedStore", "StoreStats", "FusedEmbeddingCollection",
           "runtime_edge", "validate_deltas"]

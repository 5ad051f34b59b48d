"""Embedding tier: spec, stores, the prefetch pipeline and the fused lookup
collection."""

from .cached import CachedStore
from .collection import FusedEmbeddingCollection
from .host import HostBackedStore
from .prefetch import PrefetchPipeline, StagingOverflowError
from .spec import FusedEmbeddingSpec
from .store import (DenseStore, EmbeddingStore, StoreStats, runtime_edge,
                    validate_deltas)

__all__ = ["FusedEmbeddingSpec", "EmbeddingStore", "DenseStore",
           "CachedStore", "HostBackedStore", "PrefetchPipeline",
           "StagingOverflowError", "StoreStats", "FusedEmbeddingCollection",
           "runtime_edge", "validate_deltas"]

"""Embedding tier: spec, stores, and the fused lookup collection."""

from .collection import FusedEmbeddingCollection
from .spec import FusedEmbeddingSpec
from .store import DenseStore, EmbeddingStore, runtime_edge

__all__ = ["FusedEmbeddingSpec", "EmbeddingStore", "DenseStore",
           "FusedEmbeddingCollection", "runtime_edge"]

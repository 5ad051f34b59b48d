"""Avazu/Criteo-schema CTR id streams, seeded with numpy.

Counterpart of ``repro.data.synthetic``. The schemas are the reference's
(the same heavy-tailed per-field cardinalities, from the same numpy
seeds); the sampler is numpy's, so it follows the same popularity laws
but not the reference's exact ids (those come from ``jax.random``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DatasetSchema", "AVAZU", "CRITEO", "sample_ids", "SKEWS"]

SKEWS = ("quadratic", "uniform", "zipf")


@dataclasses.dataclass(frozen=True)
class DatasetSchema:
    name: str
    field_sizes: tuple[int, ...]
    seed: int = 0

    @property
    def k(self) -> int:
        return len(self.field_sizes)

    def scaled(self, max_field: int) -> "DatasetSchema":
        """Cap per-field cardinality (small-memory test variant)."""
        return DatasetSchema(
            name=f"{self.name}-cap{max_field}",
            field_sizes=tuple(min(n, max_field) for n in self.field_sizes),
            seed=self.seed)


def _heavy_tail_sizes(k: int, big: list[int], seed: int) -> tuple[int, ...]:
    """A few huge fields + many small ones (log-uniform 2..10k)."""
    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.uniform(np.log(2), np.log(10_000), size=k)).astype(int)
    sizes = np.maximum(sizes, 2)
    for i, n in enumerate(big):
        sizes[i * (k // max(len(big), 1)) % k] = n
    return tuple(int(s) for s in sizes)


# Published field counts: Avazu 24 fields, Criteo 39 fields.
AVAZU = DatasetSchema(
    name="avazu",
    field_sizes=_heavy_tail_sizes(24, big=[2_000_000, 500_000, 8_000], seed=11),
    seed=11)

CRITEO = DatasetSchema(
    name="criteo",
    field_sizes=_heavy_tail_sizes(39, big=[5_000_000, 1_300_000, 300_000, 10_000],
                                  seed=7),
    seed=7)


def sample_ids(schema: DatasetSchema, batch: int, *, step: int = 0,
               seed: int | None = None, skew: str = "quadratic",
               zipf_exponent: float = 1.1) -> np.ndarray:
    """(batch, k) int32 ids, field i in [0, field_sizes[i]); a pure
    function of (seed, step).

    ``skew`` selects the id popularity law:
      "quadratic"  square the uniform (mild low-id skew, the default)
      "uniform"    no skew
      "zipf"       bounded zipf, P(id = r) ∝ (r+1)^-zipf_exponent, by
                   inverse CDF of the continuous bounded power law
    """
    seed = schema.seed if seed is None else seed
    rng = np.random.default_rng([seed, step])
    sizes = np.asarray(schema.field_sizes, dtype=np.int64)[None, :]
    u = rng.random((batch, schema.k))
    if skew == "quadratic":
        ids = np.floor(u * u * sizes)
    elif skew == "uniform":
        ids = np.floor(u * sizes)
    elif skew == "zipf":
        s = float(zipf_exponent)
        n = sizes.astype(np.float64)
        if abs(s - 1.0) < 1e-9:
            x = np.power(n, u)
        else:
            x = np.power(1.0 + u * (np.power(n, 1.0 - s) - 1.0),
                         1.0 / (1.0 - s))
        ids = np.floor(x) - 1
    else:
        raise ValueError(f"unknown skew {skew!r}; expected one of {SKEWS}")
    return np.clip(ids, 0, sizes - 1).astype(np.int32)

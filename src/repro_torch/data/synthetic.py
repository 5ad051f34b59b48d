"""Avazu/Criteo-schema CTR id streams, seeded with numpy.

Counterpart of ``repro.data.synthetic``. The schemas are the reference's
(the same heavy-tailed per-field cardinalities, from the same numpy
seeds); the samplers are numpy's, so they follow the same popularity laws
but not the reference's exact ids (those come from ``jax.random``).
:func:`zipf_ids` is the reference's zipf law; its map from uniforms to
ids, :func:`zipf_ids_from_uniform`, is the reference's float32
arithmetic, so the same uniforms give the same ids.

:func:`synthetic_batch` is the reference's labelled training batch: ids
of one skew law, and labels drawn as ``u < sigmoid(planted_effect(ids))``
(a hidden per-(field, id) logit effect), so AUC and LogLoss measure
something. It is a pure function of ``(seed, step)``: everything is drawn
on the CPU, then moved to the device, so the card and the CPU see the
same batches and a restarted run replays the same stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import cpu_trig, resolve_device

__all__ = ["DatasetSchema", "AVAZU", "CRITEO", "make_schema", "sample_ids",
           "SKEWS", "zipf_ids", "zipf_ids_from_uniform",
           "skewed_ids_from_uniform",
           "planted_effect", "planted_labels", "synthetic_batch"]

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


def make_schema(name: str, k: int, n_per_field: int, seed: int = 0
                ) -> DatasetSchema:
    """Uniform schema for sensitivity sweeps (paper §V-F)."""
    return DatasetSchema(name=name, field_sizes=(n_per_field,) * k, seed=seed)


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


def zipf_ids_from_uniform(u, field_sizes: tuple[int, ...],
                          exponent: float = 1.1) -> np.ndarray:
    """Uniforms ``u`` in [0, 1) of shape (b, k) -> zipf ids (b, k) int32.

    P(id = r) ∝ (r+1)^-exponent, id < n_i, by inverse CDF on the
    continuous bounded power law (exact for exponent 1: ``x = n^u``), in
    float32 as the reference computes it (``synthetic.py:75-107``). Each
    power is taken in float64 and rounded to float32: XLA's float32 power
    is that close to correctly rounded, numpy's ``powf`` is not.
    """
    sizes = np.asarray(field_sizes, dtype=np.float32)[None, :]
    u = np.asarray(u, dtype=np.float32)
    s = float(exponent)
    one = np.float32(1.0)

    def power(a, b):
        return np.power(np.float64(a), np.float64(b)).astype(np.float32)
    if abs(s - 1.0) < 1e-9:
        x = power(sizes, u)                          # cdf ∝ log x
    else:
        # inverse of F(x) = (x^(1-s) - 1) / (n^(1-s) - 1) on [1, n]
        x = power(one + u * (power(sizes, np.float32(1.0 - s)) - one),
                  np.float32(1.0 / (1.0 - s)))
    ids = np.floor(x).astype(np.int32) - 1
    return np.clip(ids, 0, np.asarray(field_sizes, np.int32)[None, :] - 1)


def zipf_ids(rng: np.random.Generator | int, batch: int,
             field_sizes: tuple[int, ...],
             exponent: float = 1.1) -> np.ndarray:
    """(batch, k) int32 zipf-skewed ids, field i in [0, field_sizes[i]),
    from float32 uniforms of ``rng`` (a numpy Generator, or a seed for
    one). Exponent 0 gives uniform traffic."""
    if not isinstance(rng, np.random.Generator):
        rng = np.random.default_rng(rng)
    u = rng.random((batch, len(field_sizes)), dtype=np.float32)
    return zipf_ids_from_uniform(u, field_sizes, exponent)


def skewed_ids_from_uniform(u, field_sizes: tuple[int, ...],
                            skew: str = "quadratic",
                            zipf_exponent: float = 1.1) -> np.ndarray:
    """float32 uniforms ``u`` (b, k) -> (b, k) int32 ids of one skew law,
    in the reference's float32 arithmetic (``synthetic.py:136-147``):
    "quadratic" ``min(int(u·u·n), n - 1)``, "uniform" ``min(int(u·n),
    n - 1)``, "zipf" :func:`zipf_ids_from_uniform`."""
    u = np.asarray(u, dtype=np.float32)
    if skew == "zipf":
        return zipf_ids_from_uniform(u, field_sizes, zipf_exponent)
    n = np.asarray(field_sizes, dtype=np.int32)[None, :]
    if skew == "quadratic":
        x = u * u * n.astype(np.float32)
    elif skew == "uniform":
        x = u * n.astype(np.float32)
    else:
        raise ValueError(f"unknown skew {skew!r}; expected one of {SKEWS}")
    return np.minimum(x.astype(np.int32), n - 1)


def planted_effect(ids: torch.Tensor, k: int) -> torch.Tensor:
    """Hidden per-(field, id) logit effects summed over the k fields,
    (b, k) ids -> (b,) float32: the reference's ``_planted_effect``, a
    deterministic, wide-spectrum function of the id scaled by 1/√k."""
    f = torch.arange(k, dtype=torch.float32, device=ids.device)
    phase = ids.to(torch.float32) * (0.618033988 + 0.1 * f)[None, :]
    effects = cpu_trig(torch.sin, phase * 12.9898) \
        + 0.5 * cpu_trig(torch.cos, phase * 78.233)
    return _field_sum(effects) / torch.sqrt(
        torch.tensor(k, dtype=torch.float32, device=ids.device))


def _field_sum(effects: torch.Tensor) -> torch.Tensor:
    """(b, k) -> (b,): the sum over fields in the order the reference's
    CPU backend (XLA) reduces a row, so the sums round alike: a row longer
    than 32 splits into windows of 32 with the padding spread evenly
    (k = 39: fields 0-19 and 20-38), each window summed in order, then the
    windows' sums in order."""
    k = effects.shape[-1]
    bounds = [0, k]
    if k > 32:
        n = -(-k // 32)
        left = (32 * n - k) // 2
        bounds = [0] + [32 * i - left for i in range(1, n)] + [k]
    total = None
    for lo, hi in zip(bounds, bounds[1:]):
        part = effects[:, lo]
        for i in range(lo + 1, hi):
            part = part + effects[:, i]
        total = part if total is None else total + part
    return total


def planted_labels(ids: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(b,) float32 labels ``u < sigmoid(planted_effect(ids))`` for
    uniforms ``u`` (b,)."""
    logits = planted_effect(ids, ids.shape[-1])
    return (u < torch.sigmoid(logits)).to(torch.float32)


def synthetic_batch(schema: DatasetSchema, step: int, batch: int, *,
                    seed: int | None = None, skew: str = "quadratic",
                    zipf_exponent: float = 1.1,
                    device: torch.device | str | None = None
                    ) -> dict[str, torch.Tensor]:
    """Pure function (schema, step) -> ``{"ids": (b, k) int32, "labels":
    (b,) float32}`` on ``device`` (CUDA unless the caller says "cpu").

    The id and label uniforms come from one numpy generator seeded with
    ``[seed, step]`` (``seed`` defaults to the schema's), on the CPU;
    ``skew`` takes the reference's three laws (see
    :func:`skewed_ids_from_uniform`).
    """
    device = resolve_device(device)
    seed = schema.seed if seed is None else seed
    rng = np.random.default_rng([seed, step])
    u_ids = rng.random((batch, schema.k), dtype=np.float32)
    u_lab = rng.random((batch,), dtype=np.float32)
    ids = torch.from_numpy(skewed_ids_from_uniform(
        u_ids, schema.field_sizes, skew, zipf_exponent))
    labels = planted_labels(ids, torch.from_numpy(u_lab))
    return {"ids": ids.to(device), "labels": labels.to(device)}

"""repro_torch's cached tier against the reference's.

``CachedStore`` with fp32 and int8 rows: built from the same table as the
reference's store, it holds the same tensors bitwise (codes and scales
included); its one-hot and pooled lookups equal a ``DenseStore``'s bitwise;
on the same observed traffic ``refresh`` admits the same hot set and
``StoreStats`` count the same; ``apply_deltas`` leaves the same backing,
cache and scales. Whole models over a cached store match the reference at
every level (``rtol=1e-5, atol=1e-6``): fp32 against the reference's
``DenseStore`` logits, int8 against the reference's int8 ``CachedStore`` on
one device. A plan compiled with ``runtime_provider`` serves refreshed and
delta-updated tensors with no rebuild.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ctr_spec as jax_ctr_spec  # noqa: E402
from repro.core import compile_plan as jax_compile_plan  # noqa: E402
from repro.embedding import CachedStore as JaxCachedStore  # noqa: E402
from repro.embedding import (  # noqa: E402
    FusedEmbeddingCollection as JaxCollection)
from repro.embedding import FusedEmbeddingSpec as JaxSpec  # noqa: E402
from repro.embedding import validate_deltas as jax_validate  # noqa: E402
from repro.models.ctr import CTR_MODELS as JAX_MODELS  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.bridge import load_jax_params  # noqa: E402
from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.core import LEVELS, compile_plan  # noqa: E402
from repro_torch.data import CRITEO, sample_ids  # noqa: E402
from repro_torch.embedding import (CachedStore, DenseStore,  # noqa: E402
                                   FusedEmbeddingCollection,
                                   FusedEmbeddingSpec, validate_deltas)
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402

FIELDS = (60, 7, 350, 90)
SPEC = FusedEmbeddingSpec(field_sizes=FIELDS, dim=8)
JSPEC = JaxSpec(field_sizes=FIELDS, dim=8)
SCHEMA = CRITEO.scaled(2_000)
SCHEMA_OFFSETS = np.concatenate([[0], np.cumsum(SCHEMA.field_sizes)[:-1]])
SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_000)
LADDER_TOL = dict(rtol=1e-5, atol=1e-6)
ROW_DTYPES = [None, "int8"]
LEAVES = ("backing", "cache", "slot_of_row", "backing_scale", "cache_scale")


def make_pair(capacity=48, row_dtype=None):
    """The reference's dense params and cached store + subtree, and the
    port's dense and cached collections over the same table."""
    jdense = JaxCollection(JSPEC)
    pd = jdense.init(jax.random.PRNGKey(0))
    jstore = JaxCachedStore(JSPEC, capacity=capacity, row_dtype=row_dtype)
    jcached = JaxCollection(JSPEC, store=jstore)
    pc = jstore.from_dense(pd)
    table = torch.from_numpy(np.array(pd["mega_table"]))
    dense = FusedEmbeddingCollection(SPEC, device="cpu")
    dense.store.adopt({"mega_table": table})
    store = CachedStore(SPEC, capacity, row_dtype, device="cpu")
    store.from_dense({"mega_table": table})
    cached = FusedEmbeddingCollection(SPEC, store=store)
    return (jdense, pd, jcached, jstore, pc), (dense, cached, store)


def traffic(batch=128, seed=0, zipf=False):
    rng = np.random.default_rng(seed)
    if zipf:
        cols = [np.minimum(rng.zipf(1.3, size=batch) - 1, s - 1)
                for s in FIELDS]
    else:
        cols = [rng.integers(0, s, size=batch) for s in FIELDS]
    return np.stack(cols, axis=1).astype(np.int32)


def assert_state_equal(store, jparams):
    for leaf in LEAVES:
        if leaf in jparams:
            np.testing.assert_array_equal(getattr(store, leaf).numpy(),
                                          np.asarray(jparams[leaf]), leaf)
    assert set(store.runtime_keys) == {k for k in LEAVES if k in jparams}


def assert_stats_equal(store, jstore):
    for f in ("hits", "misses", "refreshes", "gather_bytes", "quant_rows",
              "quant_bytes_saved", "delta_rows"):
        assert getattr(store.stats, f) == getattr(jstore.stats, f), f


# ---------------------------------------------------------------------------
# store state and lookups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_from_dense_state_matches_reference(row_dtype):
    (_, _, _, jstore, pc), (_, _, store) = make_pair(row_dtype=row_dtype)
    assert_state_equal(store, pc)
    assert_stats_equal(store, jstore)
    assert store.runtime_keys == jstore.runtime_keys
    assert store.describe() == jstore.describe()
    np.testing.assert_array_equal(store._slot_of_row, jstore._slot_of_row)


@pytest.mark.parametrize("zipf", [False, True])
@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_onehot_lookup_bitwise(row_dtype, zipf):
    (jdense, pd, jcached, _, pc), (dense, cached, _) = make_pair(
        row_dtype=row_dtype)
    ids = traffic(zipf=zipf)
    got = cached(torch.from_numpy(ids))
    want = np.asarray(jcached.apply(pc, jnp.asarray(ids), strategy="jnp"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cached(torch.from_numpy(ids), strategy="torch").numpy(), want)
    if row_dtype is None:
        assert torch.equal(got, dense(torch.from_numpy(ids)))


@pytest.mark.parametrize("h", [1, 3, 5])
@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_multihot_lookup_bitwise(row_dtype, h):
    (jdense, pd, jcached, _, pc), (dense, cached, _) = make_pair(
        row_dtype=row_dtype)
    rng = np.random.default_rng(h)
    ids = np.stack([traffic(64, seed=10 + j) for j in range(h)], axis=-1)
    mask = rng.integers(0, 2, size=ids.shape).astype(np.float32)
    args = (torch.from_numpy(ids), torch.from_numpy(mask))
    got = cached.forward_multihot(*args)
    want = jcached.apply_multihot(pc, jnp.asarray(ids), jnp.asarray(mask),
                                  strategy="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want_pl = jcached.apply_multihot(pc, jnp.asarray(ids[:8]),
                                     jnp.asarray(mask[:8]),
                                     strategy="pallas", interpret=True)
    np.testing.assert_array_equal(got[:8].numpy(), np.asarray(want_pl))
    if row_dtype is None:
        assert torch.equal(got, dense.forward_multihot(*args))
        torch.testing.assert_close(
            cached.forward_multihot(*args, strategy="torch"),
            dense.forward_multihot(*args, strategy="torch"), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# admission, refresh, deltas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_refresh_matches_reference(row_dtype):
    (jdense, pd, jcached, jstore, pc), (dense, cached, store) = make_pair(
        row_dtype=row_dtype)
    for seed, zipf in ((0, True), (1, False), (2, True)):
        ids = traffic(seed=seed, zipf=zipf)
        jcached.observe(ids)
        cached.observe(ids)
    assert_stats_equal(store, jstore)
    assert store.cached_traffic_fraction == jstore.cached_traffic_fraction
    old = {k: v for k, v in store.runtime_tensors().items()}
    pc = jstore.refresh(pc)
    store.refresh()
    assert_state_equal(store, pc)
    np.testing.assert_array_equal(store._slot_of_row, jstore._slot_of_row)
    assert_stats_equal(store, jstore)
    assert store.cached_traffic_fraction == jstore.cached_traffic_fraction
    assert store.backing is old["backing"]               # not republished
    assert store.cache is not old["cache"]               # a fresh tensor
    ids = traffic(seed=3, zipf=True)
    jcached.observe(ids)
    cached.observe(ids)
    assert_stats_equal(store, jstore)
    np.testing.assert_array_equal(
        cached(torch.from_numpy(ids)).numpy(),
        np.asarray(jcached.apply(pc, jnp.asarray(ids), strategy="jnp")))


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_apply_deltas_matches_reference(row_dtype):
    (_, _, jcached, jstore, pc), (_, cached, store) = make_pair(
        row_dtype=row_dtype)
    ids = traffic(seed=4, zipf=True)
    jcached.observe(ids)
    cached.observe(ids)
    pc = jstore.refresh(pc)
    store.refresh()
    rng = np.random.default_rng(5)
    hot = np.flatnonzero(store._slot_of_row >= 0)[:6]
    cold = np.flatnonzero(store._slot_of_row < 0)[:6]
    row_ids = np.concatenate([hot, cold, hot[:2]])      # duplicates: last wins
    new_rows = rng.normal(size=(row_ids.size, SPEC.dim)).astype(np.float32)
    new_rows[0] = 0.0                                   # an all-zero row
    before = {k: v.clone() for k, v in store.runtime_tensors().items()}
    refs = store.runtime_tensors()
    pc, n_ref = jstore.apply_deltas(pc, row_ids, new_rows)
    n = store.apply_deltas(row_ids, torch.from_numpy(new_rows))
    assert n == n_ref == 12
    assert_state_equal(store, pc)
    assert_stats_equal(store, jstore)
    for k, v in refs.items():                  # never written in place
        assert torch.equal(v, before[k]), k
    assert store.backing is not refs["backing"]
    assert store.apply_deltas(np.zeros(0, np.int64),
                              np.zeros((0, SPEC.dim), np.float32)) == 0


def test_validate_deltas_matches_reference():
    rng = np.random.default_rng(0)
    ids = np.array([3, 9, 3, 0, 9])
    rows = rng.normal(size=(5, SPEC.dim)).astype(np.float32)
    got = validate_deltas(SPEC, ids, torch.from_numpy(rows))
    want = jax_validate(JSPEC, ids, rows)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for bad in ([SPEC.zero_row], [-1]):
        with pytest.raises(ValueError, match="zero row"):
            validate_deltas(SPEC, bad, rows[:1])
    with pytest.raises(ValueError, match="shape"):
        validate_deltas(SPEC, [1, 2], rows[:1])


def test_dense_store_refuses_deltas_and_cached_checks_its_inputs():
    dense = DenseStore(SPEC, device="cpu")
    with pytest.raises(NotImplementedError, match="online deltas"):
        dense.apply_deltas([0], np.zeros((1, SPEC.dim), np.float32))
    assert CachedStore(SPEC, 10**9, device="cpu").capacity == SPEC.rows
    with pytest.raises(ValueError):
        CachedStore(SPEC, 0, device="cpu")
    with pytest.raises(ValueError, match="row_dtype"):
        CachedStore(SPEC, 4, "fp8", device="cpu")
    store = CachedStore(SPEC, 4, device="cpu")
    store.slot_of_row[0] = 4                    # a slot past the cache
    with pytest.raises(ValueError, match=r"\[-1, 4\)"):
        store.resync()
    store.slot_of_row[0] = 1                    # slot 1 twice, slot 0 never
    with pytest.raises(ValueError, match="slots"):
        store.resync()


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_observe_clips_malformed_ids_like_the_reference(row_dtype):
    (_, _, jcached, jstore, _), (_, cached, store) = make_pair(
        row_dtype=row_dtype)
    ids = traffic(16, seed=6)
    ids[0] = [-5, 2**31 - 1, 10**8, 3]
    jcached.observe(ids)
    cached.observe(torch.from_numpy(ids))
    cached.observe(ids[1])                              # a single (k,) row
    jcached.observe(ids[1])
    assert_stats_equal(store, jstore)
    np.testing.assert_array_equal(store._counts, jstore._counts)


# ---------------------------------------------------------------------------
# models over a cached store
# ---------------------------------------------------------------------------

def model_pair(name, row_dtype, capacity=64):
    """The reference's dense and cached models on one key, and the port's
    cached model loaded from the reference's cached tree."""
    jspec = jax_ctr_spec(name, "criteo", **SPEC_KW)
    key = jax.random.PRNGKey(0)
    jdense = JAX_MODELS[name](jspec)
    jstore = JaxCachedStore(jspec.embedding_spec(), capacity=capacity,
                            row_dtype=row_dtype)
    jcached = JAX_MODELS[name](jspec, store=jstore)
    spec = ctr_spec(name, "criteo", **SPEC_KW)
    model = CTR_MODELS[name](spec, CachedStore(
        spec.embedding_spec(), capacity, row_dtype, device="cpu"))
    return (jdense, jdense.init(key), jcached, jcached.init(key), jstore,
            model)


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
@pytest.mark.parametrize("name", list(CTR_MODELS))
def test_cached_models_match_reference_at_every_level(name, row_dtype):
    jdense, pd, jcached, pc, jstore, model = model_pair(name, row_dtype)
    load_jax_params(model, pc)
    ids = sample_ids(SCHEMA, 32, seed=11)
    jmodel, jparams = (jdense, pd) if row_dtype is None else (jcached, pc)
    want = np.asarray(jax_compile_plan(jmodel, jparams, "dual", 32)(
        jnp.asarray(ids)))
    for level in LEVELS:
        plan = compile_plan(model, level, 32, device="cpu")
        got = plan(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, want, **LADDER_TOL,
                                   err_msg=f"{name}/{level}")
        assert plan.key.store == jstore.describe()


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_runtime_provider_serves_refresh_and_deltas_without_rebuild(
        row_dtype):
    jdense, pd, jcached, pc, jstore, model = model_pair("dcnv2", row_dtype)
    load_jax_params(model, pc)
    store = model.embedding.store
    jplan = jax_compile_plan(jcached, pc, "dual", 16)
    plan = compile_plan(model, "dual", 16, device="cpu",
                        runtime_provider=model.store_runtime_env)
    pinned = compile_plan(model, "dual", 16, device="cpu")
    assert plan.runtime_inputs == jplan.runtime_inputs
    assert plan.runtime_inputs[0].startswith("emb:")
    ids = sample_ids(SCHEMA, 16, seed=3, skew="zipf")
    first = plan.predict(ids)
    model.embedding.observe(ids)
    jcached.embedding.observe(ids)
    store.refresh()
    pc = {**pc, "emb": jstore.refresh(pc["emb"])}
    np.testing.assert_array_equal(plan.predict(ids), first)  # refresh: same
    rng = np.random.default_rng(0)
    rows = np.unique(ids[:4] + SCHEMA_OFFSETS[None, :])
    vals = rng.normal(size=(rows.size, 8)).astype(np.float32) * 0.05
    store.apply_deltas(rows, vals)
    emb, _ = jstore.apply_deltas(pc["emb"], rows, vals)
    pc = {**pc, "emb": emb}
    got = plan.predict(ids)
    want = jax_compile_plan(jcached, pc, "dual", 16).predict(ids)
    np.testing.assert_allclose(got, want, **LADDER_TOL)
    assert not np.array_equal(got[:4], first[:4])
    np.testing.assert_array_equal(
        got, compile_plan(model, "dual", 16, device="cpu").predict(ids))
    # the default provider keeps the tensors bound at compile time
    np.testing.assert_array_equal(pinned.predict(ids), first)



def test_device_never_dequantizes_an_int8_store(monkeypatch):
    spec = ctr_spec("dcnv2", "criteo", **SPEC_KW)
    store = CachedStore(spec.embedding_spec(), 32, "int8", device="cpu")

    def no_fp32_table(*_):
        raise AssertionError("the whole int8 table was dequantized")
    monkeypatch.setattr(quant, "dequantize_rows", no_fp32_table)
    model = CTR_MODELS["dcnv2"](spec, store)
    assert model.device == torch.device("cpu")
    plan = compile_plan(model, "dual", 8, device="cpu",
                        runtime_provider=model.store_runtime_env)
    assert plan.predict(sample_ids(SCHEMA, 8)).shape == (8,)
    with pytest.raises(AssertionError, match="dequantized"):
        store.dense_view()


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_use_store_adopts_bit_for_bit(row_dtype):
    spec = ctr_spec("widedeep", "criteo", **SPEC_KW)
    model = CTR_MODELS["widedeep"](spec, device="cpu").init(
        torch.Generator().manual_seed(0))
    table = model.embedding.dense_view().clone()
    ids = torch.from_numpy(sample_ids(SCHEMA, 16))
    want = model(ids)
    store = CachedStore(spec.embedding_spec(), 64, row_dtype, device="cpu")
    assert model.use_store(store) is model
    assert model.embedding.store is store
    if row_dtype is None:
        assert torch.equal(store.backing, table)
        assert store.backing.data_ptr() != table.data_ptr()
        assert torch.equal(model(ids), want)
    else:
        q, s = quant.quantize_rows(table)
        assert torch.equal(store.backing, q)
        assert torch.equal(store.backing_scale, s)
        back = DenseStore(spec.embedding_spec(), device="cpu")
        back.adopt(dict(store.named_buffers()))
        assert torch.equal(back.mega_table, quant.dequantize_rows(q, s))
    with pytest.raises(ValueError, match="different embedding spec"):
        FusedEmbeddingCollection(
            dataclasses.replace(spec.embedding_spec(), dim=4), store=store)


def test_load_state_dict_and_bridge_resync_the_host_map():
    jspec = jax_ctr_spec("dcnv2", "criteo", **SPEC_KW)
    jm = JAX_MODELS["dcnv2"](jspec, store=JaxCachedStore(
        jspec.embedding_spec(), capacity=16))
    jp = jm.init(jax.random.PRNGKey(1))
    jm.embedding.observe(sample_ids(SCHEMA, 64, seed=2, skew="zipf"))
    jp = {**jp, "emb": jm.embedding.store.refresh(jp["emb"])}
    jmap = jm.embedding.store._slot_of_row
    assert not np.array_equal(jmap[:16], np.arange(16))   # not the seed map
    spec = ctr_spec("dcnv2", "criteo", **SPEC_KW)
    model = CTR_MODELS["dcnv2"](spec, CachedStore(spec.embedding_spec(), 16,
                                                  device="cpu"))
    load_jax_params(model, jp)
    np.testing.assert_array_equal(model.embedding.store._slot_of_row, jmap)
    twin = CTR_MODELS["dcnv2"](spec, CachedStore(spec.embedding_spec(), 16,
                                                 device="cpu"))
    twin.load_state_dict(model.state_dict())
    np.testing.assert_array_equal(twin.embedding.store._slot_of_row, jmap)
    # observe counts against the loaded map, as the reference's does
    jstats = jm.embedding.store.stats
    hits, misses = jstats.hits, jstats.misses
    ids = sample_ids(SCHEMA, 32, seed=9, skew="zipf")
    jm.embedding.observe(ids)
    twin.embedding.observe(ids)
    assert twin.embedding.store.stats.hits == jstats.hits - hits > 0
    assert twin.embedding.store.stats.misses == jstats.misses - misses

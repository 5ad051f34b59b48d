"""repro_torch's host tier against the reference's.

``HostBackedStore`` (fp32 and int8 rows) and its ``PrefetchPipeline``,
driven with the same ids as the reference's: after ``from_dense``,
``stage``, ``prefetch_hint`` + ``wait_idle``, ``refresh`` and
``apply_deltas`` the host maps, the LRU order, the free slots, the staging
buffer and the backing equal the reference's, the device tensors equal
the reference's full snapshot (the port uploads only what changed), and
every ``StoreStats`` field counts the same. A staging overflow raises with
nothing changed and splits into the reference's chunks; the mmap tier
round-trips through ``open``. DCNv2 and Wide&Deep over a host store match
the reference's scores at every level the store serves (``rtol=1e-5,
atol=1e-6``), and the port's fp32 host plan is bitwise its own dense plan
through staging, refresh, deltas and chunked serving.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ctr_spec as jax_ctr_spec  # noqa: E402
from repro.core import compile_plan as jax_compile_plan  # noqa: E402
from repro.embedding import (  # noqa: E402
    FusedEmbeddingCollection as JaxCollection)
from repro.embedding import FusedEmbeddingSpec as JaxSpec  # noqa: E402
from repro.embedding import HostBackedStore as JaxHostStore  # noqa: E402
from repro.embedding import (  # noqa: E402
    StagingOverflowError as JaxOverflow)
from repro.models.ctr import CTR_MODELS as JAX_MODELS  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.bridge import load_jax_params  # noqa: E402
from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.core import compile_plan  # noqa: E402
from repro_torch.data import CRITEO, sample_ids  # noqa: E402
from repro_torch.embedding import (DenseStore,  # noqa: E402
                                   FusedEmbeddingCollection,
                                   FusedEmbeddingSpec, HostBackedStore,
                                   StagingOverflowError, StoreStats)
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402

FIELDS = (60, 7, 350, 90)
SPEC = FusedEmbeddingSpec(field_sizes=FIELDS, dim=8)
JSPEC = JaxSpec(field_sizes=FIELDS, dim=8)
SCHEMA = CRITEO.scaled(2_000)
SCHEMA_OFFSETS = np.concatenate([[0], np.cumsum(SCHEMA.field_sizes)[:-1]])
SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_000)
LADDER_TOL = dict(rtol=1e-5, atol=1e-6)
ROW_DTYPES = [None, "int8"]
STAT_FIELDS = [f.name for f in dataclasses.fields(StoreStats)]


@pytest.fixture
def stores():
    """Stores made by a test; their prefetch workers are stopped after."""
    made = []
    yield made
    for s in made:
        s.pipeline.stop()


def make_pair(stores, capacity=48, staging_capacity=64, row_dtype=None,
              backing_path=None, jax_path=None):
    """The reference's dense params and host store + subtree, and the
    port's dense collection and host store over the same table."""
    jdense = JaxCollection(JSPEC)
    pd = jdense.init(jax.random.PRNGKey(0))
    jstore = JaxHostStore(JSPEC, capacity=capacity,
                          staging_capacity=staging_capacity,
                          row_dtype=row_dtype, backing_path=jax_path)
    jhost = JaxCollection(JSPEC, store=jstore)
    ph = jstore.from_dense(pd)
    table = torch.from_numpy(np.array(pd["mega_table"]))
    dense = FusedEmbeddingCollection(SPEC, device="cpu")
    dense.store.adopt({"mega_table": table})
    store = HostBackedStore(SPEC, capacity, staging_capacity,
                            backing_path=backing_path, row_dtype=row_dtype,
                            device="cpu")
    store.from_dense({"mega_table": table})
    host = FusedEmbeddingCollection(SPEC, store=store)
    stores += [jstore, store]
    return (jhost, jstore, ph), (dense, host, store)


def traffic(batch=8, seed=0, zipf=False):
    rng = np.random.default_rng(seed)
    if zipf:
        cols = [np.minimum(rng.zipf(1.3, size=batch) - 1, s - 1)
                for s in FIELDS]
    else:
        cols = [rng.integers(0, s, size=batch) for s in FIELDS]
    return np.stack(cols, axis=1).astype(np.int32)


def assert_same_state(store, jstore, ph):
    """Host state, device tensors (against the reference's full snapshot
    ``ph``) and every counter."""
    for leaf in jstore.runtime_keys:
        np.testing.assert_array_equal(getattr(store, leaf).numpy(),
                                      np.asarray(ph[leaf]), leaf)
    assert store.runtime_keys == jstore.runtime_keys
    np.testing.assert_array_equal(store._slot_of_row, jstore._slot_of_row)
    np.testing.assert_array_equal(store.host_view(), jstore.host_view())
    if store.quantized:
        np.testing.assert_array_equal(store.host_scale_view(),
                                      jstore.host_scale_view())
    p, j = store.pipeline, jstore.pipeline
    for got, want in zip(p.snapshot()[:3], j.snapshot()[:3]):
        np.testing.assert_array_equal(got, want)
    assert list(p._lru.items()) == list(j._lru.items())
    assert p._free == j._free
    assert p.n_prefetched == j.n_prefetched
    for f in STAT_FIELDS:
        assert getattr(store.stats, f) == getattr(jstore.stats, f), f


# ---------------------------------------------------------------------------
# store state against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_state_matches_reference_through_stage_hint_refresh_deltas(
        stores, row_dtype):
    (jhost, jstore, ph), (dense, host, store) = make_pair(
        stores, row_dtype=row_dtype)
    assert_same_state(store, jstore, ph)
    assert store.describe() == jstore.describe()
    # serve-time staging, with LRU evictions once the 64 slots fill up
    for seed in range(6):
        ids = traffic(seed=seed)
        ph = jstore.stage(ph, ids)
        store.stage(ids)
        assert_same_state(store, jstore, ph)
        got = host(torch.from_numpy(ids)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jhost.apply(ph, jnp.asarray(ids),
                                        strategy="jnp")))
        if row_dtype is None:
            np.testing.assert_array_equal(got, dense(torch.from_numpy(ids)))
    assert store.stats.staged_rows > 64       # the buffer wrapped around
    # an async hint, then the batch it announced
    ids = traffic(seed=10)
    jstore.prefetch_hint(ids)
    store.prefetch_hint(ids)
    assert jstore.pipeline.wait_idle(10.0) and store.pipeline.wait_idle(10.0)
    assert store.pipeline.n_prefetched > 0
    assert_same_state(store, jstore, ph)      # nothing uploaded yet
    ph = jstore.stage(ph, ids)
    store.stage(ids)
    assert_same_state(store, jstore, ph)
    assert store.stats.prefetched_rows > 0
    # observe + refresh: hot rows move into the cache, out of staging
    for seed in range(3):
        ids = traffic(64, seed=20 + seed, zipf=True)
        jhost.observe(ids)
        host.observe(torch.from_numpy(ids))
    ph = jstore.refresh(ph)
    store.refresh()
    assert_same_state(store, jstore, ph)
    assert store.cached_traffic_fraction == jstore.cached_traffic_fraction
    # deltas on cached, staged and unresolved rows (a duplicate: last wins)
    staged = np.flatnonzero(store.pipeline.snapshot()[2] >= 0)[:4]
    hot = np.flatnonzero(store._slot_of_row >= 0)[:4]
    cold = np.flatnonzero((store._slot_of_row < 0)
                          & (store.pipeline.snapshot()[2] < 0))[:4]
    row_ids = np.concatenate([hot, staged, cold, hot[:1]])
    vals = np.random.default_rng(1).normal(
        size=(row_ids.size, SPEC.dim)).astype(np.float32)
    ph, n_ref = jstore.apply_deltas(ph, row_ids, vals)
    assert store.apply_deltas(row_ids, torch.from_numpy(vals)) == n_ref == 12
    assert_same_state(store, jstore, ph)
    ids = traffic(seed=30)
    ph = jstore.stage(ph, ids)
    store.stage(ids)
    assert_same_state(store, jstore, ph)
    np.testing.assert_array_equal(
        host(torch.from_numpy(ids)).numpy(),
        np.asarray(jhost.apply(ph, jnp.asarray(ids), strategy="jnp")))
    assert store.apply_deltas(np.zeros(0, np.int64),
                              np.zeros((0, SPEC.dim), np.float32)) == 0


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_upload_moves_only_what_changed(stores, row_dtype):
    """A staging upload copies the changed slots and map entries, far less
    than the reference's per-batch snapshot (the whole staging buffer and
    map); an all-hit batch copies nothing."""
    _, (_, _, store) = make_pair(stores, staging_capacity=256,
                                 row_dtype=row_dtype)
    ids = traffic(16, seed=1)
    before = store.upload_bytes
    store.stage(ids)
    staged = store.stats.staged_rows
    row = 8 + SPEC.wire_row_bytes + 8 + 4     # slot, row (+scale), map entry
    pad = 4 * 8                               # at most 8 bytes per segment
    assert 0 < store.upload_bytes - before <= staged * row + pad
    snapshot = sum(t.numel() * t.element_size() for k, t in
                   store.runtime_tensors().items() if k.startswith("staging"))
    assert store.upload_bytes - before < snapshot / 2
    before = store.upload_bytes
    store.stage(ids)                          # everything already staged
    assert store.upload_bytes == before
    assert store.stats.prefetched_rows == staged


def test_overflow_raises_with_nothing_changed_and_splits_like_reference(
        stores):
    (jhost, jstore, ph), (_, host, store) = make_pair(
        stores, capacity=1, staging_capacity=SPEC.k)
    ids = traffic(64, seed=7)
    snap = store.pipeline.snapshot()
    tensors = {k: v.clone() for k, v in store.runtime_tensors().items()}
    with pytest.raises(JaxOverflow):
        jstore.stage(ph, ids)
    with pytest.raises(StagingOverflowError):
        store.stage(ids)
    assert store.stats.staging_overflows == jstore.stats.staging_overflows == 1
    for a, b in zip(snap, store.pipeline.snapshot()):
        np.testing.assert_array_equal(a, b)
    for k, v in tensors.items():
        assert torch.equal(v, getattr(store, k)), k
    chunks = store.split_for_staging(ids)
    want = jstore.split_for_staging(ids)
    assert len(chunks) == len(want) > 1
    for c, w in zip(chunks, want):
        np.testing.assert_array_equal(c, w)
        ph = jstore.stage(ph, c)
        store.stage(c)
        assert_same_state(store, jstore, ph)
        np.testing.assert_array_equal(
            host(torch.from_numpy(c)).numpy(),
            np.asarray(jhost.apply(ph, jnp.asarray(c), strategy="jnp")))


def test_constructor_checks_like_reference():
    with pytest.raises(ValueError, match="staging_capacity"):
        HostBackedStore(SPEC, 8, staging_capacity=SPEC.k - 1, device="cpu")
    multi = dataclasses.replace(SPEC, multi_hot=3)
    with pytest.raises(ValueError, match="staging_capacity"):
        HostBackedStore(multi, 8, staging_capacity=3 * SPEC.k - 1,
                        device="cpu")
    with pytest.raises(ValueError):
        HostBackedStore(SPEC, 0, device="cpu")
    s = HostBackedStore(SPEC, 10**9, device="cpu")
    assert (s.capacity, s.staging_capacity) == (SPEC.rows, 256)
    assert JaxHostStore(JSPEC, 10**9).staging_capacity == 256
    with pytest.raises(RuntimeError, match="no backing"):
        s.host_view()
    with pytest.raises(NotImplementedError, match="host memory"):
        s.dense_view()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            HostBackedStore(SPEC, 8)


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
def test_mmap_round_trip_and_read_only_refuses_deltas(stores, tmp_path,
                                                      row_dtype):
    (jhost, jstore, ph), (dense, host, store) = make_pair(
        stores, staging_capacity=256, row_dtype=row_dtype,
        backing_path=tmp_path / "port.bin", jax_path=tmp_path / "ref.bin")
    assert isinstance(store.host_view(), np.memmap)
    np.testing.assert_array_equal(np.fromfile(tmp_path / "port.bin",
                                              store.host_view().dtype),
                                  np.fromfile(tmp_path / "ref.bin",
                                              jstore.host_view().dtype))
    ids = traffic(32, seed=11)
    store.stage(ids)
    want = host(torch.from_numpy(ids))
    assert store.describe() == jstore.describe()
    for mode in ("r", "r+"):
        again = HostBackedStore.open(SPEC, 48, tmp_path / "port.bin",
                                     staging_capacity=256,
                                     row_dtype=row_dtype, mode=mode,
                                     device="cpu")
        stores.append(again)
        np.testing.assert_array_equal(again.host_view(), store.host_view())
        again.stage(ids)
        coll = FusedEmbeddingCollection(SPEC, store=again)
        assert torch.equal(coll(torch.from_numpy(ids)), want)
        rows = np.array([3, 70])
        vals = np.full((2, SPEC.dim), 0.25, np.float32)
        if mode == "r":
            with pytest.raises(ValueError, match="read-only memmap"):
                again.apply_deltas(rows, vals)
        else:
            assert again.apply_deltas(rows, vals) == 2
    with pytest.raises(ValueError, match="mode"):
        HostBackedStore.open(SPEC, 48, tmp_path / "port.bin", mode="w",
                             device="cpu")
    reread = HostBackedStore.open(SPEC, 48, tmp_path / "port.bin",
                                  row_dtype=row_dtype, device="cpu")
    stores.append(reread)
    if row_dtype is None:                      # r+ wrote through to disk
        np.testing.assert_array_equal(reread.host_view()[[3, 70]], vals)
    else:
        q, scale = quant.quantize_rows(torch.from_numpy(vals))
        np.testing.assert_array_equal(reread.host_view()[[3, 70]], q.numpy())
        np.testing.assert_array_equal(reread.host_scale_view()[[3, 70]],
                                      scale.numpy())


def test_read_only_adopted_array_is_copied_on_the_first_delta(stores):
    jdense = JaxCollection(JSPEC)
    table = np.asarray(jdense.init(jax.random.PRNGKey(0))["mega_table"])
    assert not table.flags.writeable
    store = HostBackedStore(SPEC, 16, device="cpu")
    stores.append(store)
    store.adopt({"mega_table": table})
    assert store.host_view() is table          # kept as it is
    before = table.copy()
    store.apply_deltas([5], np.ones((1, SPEC.dim), np.float32))
    np.testing.assert_array_equal(table, before)
    assert store.host_view() is not table
    np.testing.assert_array_equal(store.host_view()[5], 1.0)


# ---------------------------------------------------------------------------
# models over a host store
# ---------------------------------------------------------------------------

def serve(store, plan, ids):
    """The reference engine's loop for one request: stage, or on overflow
    stage and predict chunk by chunk through the same plan."""
    try:
        store.stage(ids)
    except StagingOverflowError:
        out = []
        for chunk in store.split_for_staging(ids):
            store.stage(chunk)
            out.append(plan.predict(chunk))
        return np.concatenate(out)
    return plan.predict(ids)


@pytest.mark.parametrize("row_dtype", ROW_DTYPES)
@pytest.mark.parametrize("name", ["dcnv2", "widedeep"])
def test_host_models_match_reference(stores, name, row_dtype):
    """Port and reference host models on one key and the same ids: the
    port stages its own store and matches the reference's staged state
    and scores at every level a host store serves."""
    jspec = jax_ctr_spec(name, "criteo", **SPEC_KW)
    key = jax.random.PRNGKey(0)
    jdense = JAX_MODELS[name](jspec)
    pd = jdense.init(key)
    # staging sized above a batch's miss set (32 rows x 39 fields)
    jstore = JaxHostStore(jspec.embedding_spec(), capacity=64,
                          staging_capacity=32 * 39, row_dtype=row_dtype)
    jhost = JAX_MODELS[name](jspec, store=jstore)
    ph = jhost.init(key)
    spec = ctr_spec(name, "criteo", **SPEC_KW)
    store = HostBackedStore(spec.embedding_spec(), 64, 32 * 39,
                            row_dtype=row_dtype, device="cpu")
    stores += [jstore, store]
    model = CTR_MODELS[name](spec, store)
    store.adopt({"mega_table": np.asarray(pd["emb"]["mega_table"])})
    load_jax_params(model, ph)
    ids = sample_ids(SCHEMA, 32, seed=11, skew="zipf")
    ph = {**ph, "emb": jstore.stage(ph["emb"], ids)}
    store.stage(ids)
    assert_same_state(store, jstore, ph["emb"])
    jmodel, jparams = (jdense, pd) if row_dtype is None else (jhost, ph)
    want = np.asarray(jax_compile_plan(jmodel, jparams, "dual", 32)(
        jnp.asarray(ids)))
    for level in ("fused_emb", "fused_all", "dual"):
        plan = compile_plan(model, level, 32, device="cpu",
                            runtime_provider=model.store_runtime_env)
        got = plan(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, want, **LADDER_TOL,
                                   err_msg=f"{name}/{level}")
        assert plan.key.store == jstore.describe()
    with pytest.raises(NotImplementedError):       # as in the reference
        compile_plan(model, "naive", 32, device="cpu")


@pytest.mark.parametrize("staging_capacity", [16 * 39, 39])
def test_fp32_host_plan_is_bitwise_dense_through_the_serve_loop(
        stores, staging_capacity):
    """Hint t+1, stage (or chunk on overflow), predict, observe; refresh
    every 3 requests and one delta batch halfway, replayed on a dense
    model: scores bitwise equal, one plan, no recompile."""
    spec = ctr_spec("dcnv2", "criteo", **SPEC_KW)
    gen = torch.Generator().manual_seed(0)
    dense = CTR_MODELS["dcnv2"](spec, device="cpu").init(gen)
    model = CTR_MODELS["dcnv2"](spec, device="cpu")
    model.load_state_dict(dense.state_dict())
    store = HostBackedStore(spec.embedding_spec(), 64, staging_capacity,
                            device="cpu")
    stores.append(store)
    assert model.use_store(store) is model
    assert store.device_bytes() == ((64 + staging_capacity) * 8 * 4
                                    + 2 * spec.embedding_spec().rows * 4)
    plan = compile_plan(model, "dual", 16, device="cpu",
                        runtime_provider=model.store_runtime_env)
    dplan = compile_plan(dense, "dual", 16, device="cpu")
    reqs = [sample_ids(SCHEMA, 16, step=r, skew="zipf") for r in range(8)]
    rng = np.random.default_rng(3)
    for r, ids in enumerate(reqs):
        if r + 1 < len(reqs):
            store.prefetch_hint(reqs[r + 1])
        got = serve(store, plan, ids)
        model.embedding.observe(ids)
        np.testing.assert_array_equal(got, dplan.predict(ids), f"req {r}")
        if (r + 1) % 3 == 0:
            store.refresh()
        if r == 3:
            rows = np.unique(np.concatenate([
                (reqs[5] + SCHEMA_OFFSETS[None, :]).ravel()[:24],
                rng.choice(spec.embedding_spec().zero_row, 24)]))
            vals = rng.normal(size=(rows.size, 8)).astype(np.float32)
            store.apply_deltas(rows, vals)
            dense.embedding.store.mega_table[torch.from_numpy(rows)] = \
                torch.from_numpy(vals)
    assert store.stats.refreshes == 2 and store.stats.delta_rows > 0
    assert (store.stats.staging_overflows > 0) == (staging_capacity == 39)
    assert store.stats.prefetched_rows > 0


def test_bridged_host_store_resyncs_its_host_mirrors(stores):
    """A reference host-store subtree (refreshed and staged) loads into the
    port's buffers of the same names; the store then takes its cache map
    and staging area from them, so its next stage and observe count as
    the reference's do."""
    jspec = jax_ctr_spec("dcnv2", "criteo", **SPEC_KW)
    jstore = JaxHostStore(jspec.embedding_spec(), capacity=16,
                          staging_capacity=8 * 39)
    jm = JAX_MODELS["dcnv2"](jspec, store=jstore)
    jp = jm.init(jax.random.PRNGKey(1))
    jm.embedding.observe(sample_ids(SCHEMA, 64, seed=2, skew="zipf"))
    emb = jstore.refresh(jp["emb"])
    emb = jstore.stage(emb, sample_ids(SCHEMA, 8, seed=3))
    jp = {**jp, "emb": emb}
    spec = ctr_spec("dcnv2", "criteo", **SPEC_KW)
    store = HostBackedStore(spec.embedding_spec(), 16, 8 * 39, device="cpu")
    stores += [jstore, store]
    model = CTR_MODELS["dcnv2"](spec, store)
    store.adopt({"mega_table": jstore.host_view()})
    load_jax_params(model, jp)
    np.testing.assert_array_equal(store._slot_of_row, jstore._slot_of_row)
    for got, want in zip(store.pipeline.snapshot()[:3],
                         jstore.pipeline.snapshot()[:3]):
        np.testing.assert_array_equal(got, want)
    assert sorted(store.pipeline._lru.items()) == sorted(
        jstore.pipeline._lru.items())
    assert sorted(store.pipeline._free) == sorted(jstore.pipeline._free)
    ids = sample_ids(SCHEMA, 8, seed=4)
    s0 = (jstore.stats.staged_rows, jstore.stats.prefetched_rows)
    jp["emb"] = jstore.stage(jp["emb"], ids)
    store.stage(ids)
    assert (store.stats.staged_rows, store.stats.prefetched_rows) == (
        jstore.stats.staged_rows - s0[0], jstore.stats.prefetched_rows - s0[1])
    np.testing.assert_array_equal(
        compile_plan(model, "dual", 8, device="cpu").predict(ids),
        jax_compile_plan(jm, jp, "dual", 8).predict(ids))
    # the same through load_state_dict (a port-to-port copy)
    twin = CTR_MODELS["dcnv2"](spec, HostBackedStore(
        spec.embedding_spec(), 16, 8 * 39, device="cpu"))
    stores.append(twin.embedding.store)
    twin.embedding.store.adopt({"mega_table": store.host_view()})
    twin.load_state_dict(model.state_dict())
    np.testing.assert_array_equal(twin.embedding.store._slot_of_row,
                                  jstore._slot_of_row)
    np.testing.assert_array_equal(twin.embedding.store.pipeline.snapshot()[2],
                                  store.pipeline.snapshot()[2])


def test_dense_store_passes_staging_through():
    dense = DenseStore(SPEC, device="cpu")
    ids = traffic(4)
    assert dense.needs_staging is False and HostBackedStore.needs_staging
    assert dense.stage(ids) is None and dense.prefetch_hint(ids) is None
    chunks = dense.split_for_staging(ids)
    assert len(chunks) == 1 and np.array_equal(chunks[0], ids)

"""repro_torch's multi-device serving against the reference.

Counterpart of every case of ``tests/test_serving_mesh.py`` and of
``tests/test_embedding_store.py:169-205``, on the port's CPU meshes
(single-controller: every position in this process, so the (2, 1) and
(4, 2) cases run here without the reference's 8-device flag). The
reference's engines and plans run on its one CPU device and the port's
model takes the same parameters (``load_jax_params``). Scores agree
within ``rtol=1e-5, atol=1e-6`` (``tests/test_serving_mesh.py:84``); a
refresh or a delta push on a mesh is bitwise across the swap with zero
recompiles, and the published tensors carry the plans'
``runtime_shardings``: the backing row-sharded over ``model``, the
cache and ``slot_of_row`` replicated, batches over ``data``. Then the
serving CLI with ``--mesh``.
"""

import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import repro.serving as jserving  # noqa: E402
from repro.configs import ctr_spec as jax_ctr_spec  # noqa: E402
from repro.core import compile_plan as jax_compile_plan  # noqa: E402
from repro.data.synthetic import zipf_ids as jax_zipf_ids  # noqa: E402
from repro.launch import serve as jax_cli  # noqa: E402
from repro.models.ctr import CTR_MODELS as JAX_MODELS  # noqa: E402
from repro_torch.bridge import load_jax_params  # noqa: E402
from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.core import compile_plan, place_params  # noqa: E402
from repro_torch.data import CRITEO  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.embedding import CachedStore, HostBackedStore  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402
from repro_torch.serving import (BucketedBatch, InferenceEngine,  # noqa: E402
                                 ServingRuntime)

SCHEMA = CRITEO.scaled(2_000)
SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_000)
TOL = dict(rtol=1e-5, atol=1e-6)


def mesh_of(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices="cpu")


def make(model_name="widedeep"):
    """The port's spec, the reference's model and parameters, and the
    port's model on those parameters."""
    jmodel = JAX_MODELS[model_name](jax_ctr_spec(model_name, "criteo",
                                                 **SPEC_KW))
    params = jmodel.init(jax.random.PRNGKey(0))
    spec = ctr_spec(model_name, "criteo", **SPEC_KW)
    model = CTR_MODELS[model_name](spec, device="cpu")
    return spec, jmodel, params, load_jax_params(model, params)


def zipf_stream(n, seed=0, exponent=1.1):
    return np.asarray(jax_zipf_ids(jax.random.PRNGKey(seed), n,
                                   SCHEMA.field_sizes, exponent=exponent))


def serve_waves(eng, ids, waves=4):
    out = []
    for wave in np.array_split(ids, waves):
        eng.submit_many(list(wave))
        out.append(eng.serve_pending())
    out.append(eng.flush())
    return np.concatenate(out)


def store_of(spec, capacity, kind="cached"):
    if kind == "host":
        return HostBackedStore(spec.embedding_spec(), capacity, 4096,
                               device="cpu")
    return CachedStore(spec.embedding_spec(), capacity, device="cpu")


# --- the multi-device refresh acceptance -------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), (4, 2)])
def test_mesh_refresh_bitexact_vs_dense_baseline(shape):
    """Zipf traffic on a (2, 1) / (4, 2) mesh: a CachedStore engine
    matches the reference's dense 1-device engine, a refresh keeps
    scores bit-exact, and the plan cache reports zero recompiles across
    every refresh."""
    spec, jmodel, params, model = make()
    ids = zipf_stream(96)
    base = jserving.InferenceEngine(jmodel, params,
                                    policy=jserving.BucketedBatch((8, 16)))
    want = serve_waves(base, ids)

    mesh = mesh_of(shape)
    eng = InferenceEngine(model, mesh=mesh, store=store_of(spec, 128),
                          policy=BucketedBatch((8, 16)), refresh_every=2)
    eng.warmup()
    compiles = eng.stats.cache_misses
    plans = set(eng.cached_plans)

    got = serve_waves(eng, ids)          # auto-refreshes fire mid-stream
    np.testing.assert_allclose(got, want, **TOL)

    pre = eng.predict(ids[:16])
    eng.refresh_cache()
    post = eng.predict(ids[:16])
    np.testing.assert_array_equal(pre, post)      # bit-exact across swap
    assert eng.stats.emb_cache_refreshes > 0
    assert eng.stats.cache_misses == compiles     # zero recompiles
    assert set(eng.cached_plans) == plans
    assert all(key.sharded for key in plans)


@pytest.mark.parametrize("shape", [(2, 1), (4, 2)])
def test_mesh_refresh_publishes_placed_tensors(shape):
    """The swap publishes tensors placed to the plans' shardings: backing
    row-sharded over model (when the axis is > 1), cache and slot_of_row
    replicated; the same placement ``place_params`` gives them."""
    spec, _, _, model = make()
    mesh = mesh_of(shape)
    eng = InferenceEngine(model, mesh=mesh, store=store_of(spec, 64),
                          policy=BucketedBatch((8,)))
    eng.predict(zipf_stream(32))
    eng.refresh_cache()
    pub = eng.published
    plan = eng.plan_for(8)
    for leaf in ("backing", "cache", "slot_of_row"):
        sh = pub[f"emb:{leaf}"].sharding
        assert sh.mesh == mesh, leaf
        recorded = plan.runtime_shardings[f"emb:{leaf}"]
        assert sh.is_equivalent_to(recorded, pub[f"emb:{leaf}"].ndim), (
            leaf, sh, recorded)
    backing_dims = tuple(pub["emb:backing"].sharding.spec)
    if shape[1] > 1:
        assert backing_dims[0] == "model", backing_dims
        assert pub["emb:backing"].local((0, 1)).shape[0] == \
            spec.embedding_spec().rows // 2
    assert all(a is None for a in tuple(pub["emb:cache"].sharding.spec))
    assert pub["emb:cache"].local((1, 0)) is model.embedding.store.cache


@pytest.mark.parametrize("shape", [(1, 2), (4, 2)])
def test_mesh_deltas_bitwise_against_a_meshless_engine(shape):
    """A delta push on a mesh lands like one without: scores of the mesh
    engine equal a mesh-less CachedStore engine given the same pushes
    (bitwise on a model-only mesh), zero recompiles, placed publish."""
    spec, _, _, model = make("dcnv2")
    _, _, _, twin = make("dcnv2")
    ids = zipf_stream(64, seed=2)
    eng = InferenceEngine(model, mesh=mesh_of(shape),
                          store=store_of(spec, 128),
                          policy=BucketedBatch((16,)))
    ref = InferenceEngine(twin, store=store_of(spec, 128),
                          policy=BucketedBatch((16,)), device="cpu")
    eng.warmup()
    compiles = eng.stats.cache_misses
    rng = np.random.default_rng(7)
    rows = rng.choice(spec.embedding_spec().rows - 1, 300, replace=False)
    vals = rng.normal(size=(300, 8)).astype(np.float32)
    for e in (eng, ref):
        e.predict(ids)
        assert e.push_update(rows, vals) == 300
    got, want = eng.predict(ids), ref.predict(ids)
    if shape[0] == 1:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)
    assert eng.stats.cache_misses == compiles
    assert eng.stats.emb_version == 1
    assert tuple(eng.published["emb:backing"].sharding.spec) == \
        ("model", None)


def test_host_store_engine_on_a_mesh_matches_the_meshless_engine():
    """A HostBackedStore bound to the mesh: every staging upload reaches
    the placed tensors every step reads; scores and staging counters
    equal a mesh-less host engine's."""
    spec, _, _, model = make("dcnv2")
    _, _, _, twin = make("dcnv2")
    ids = zipf_stream(64, seed=3)
    stores = [store_of(spec, 64, "host"), store_of(spec, 64, "host")]
    try:
        eng = InferenceEngine(model, mesh=mesh_of((2, 2)), store=stores[0],
                              policy=BucketedBatch((8, 16)),
                              refresh_every=2)
        ref = InferenceEngine(twin, store=stores[1], device="cpu",
                              policy=BucketedBatch((8, 16)),
                              refresh_every=2)
        np.testing.assert_allclose(serve_waves(eng, ids),
                                   serve_waves(ref, ids), **TOL)
        for name in ("emb_staged_rows", "emb_cache_refreshes",
                     "emb_cache_hits", "emb_h2d_bytes"):
            assert getattr(eng.stats, name) == getattr(ref.stats, name)
        assert eng.stats.emb_cache_refreshes > 0
        staging = eng.published["emb:staging"]
        assert staging.sharding.is_fully_replicated
        assert staging.local((1, 1)) is stores[0].staging
    finally:
        for s in stores:
            s.pipeline.stop()


# --- resolved plan shardings -------------------------------------------------

def test_plan_input_shardings_batch_over_data_axis():
    _, _, _, model = make()
    mesh = mesh_of((4, 2))
    plan = compile_plan(model, "dual", 16, mesh=mesh)
    assert plan.mesh is mesh
    assert tuple(plan.input_shardings["ids"].spec) == ("data", None)


def test_plan_input_shardings_odd_batch_falls_back_to_replication():
    """A batch size the data axis doesn't divide compiles (fit_spec drops
    the axis) and still serves correctly."""
    _, jmodel, params, model = make()
    ids = zipf_stream(6)
    want = jax_compile_plan(jmodel, params, "dual", 6).predict(ids)
    plan = compile_plan(model, "dual", 6, mesh=mesh_of((4, 2)))
    assert tuple(plan.input_shardings["ids"].spec)[0] is None
    np.testing.assert_allclose(plan.predict(ids), want, **TOL)


def test_plan_runtime_shardings_follow_store_partition_spec():
    spec, _, _, model = make()
    model.use_store(store_of(spec, 64))
    plan = compile_plan(model, "dual", 8, mesh=mesh_of((4, 2)),
                        runtime_provider=model.store_runtime_env)
    rt = plan.runtime_shardings
    assert tuple(rt["emb:backing"].spec) == ("model", None)
    assert rt["emb:cache"].is_fully_replicated
    assert rt["emb:slot_of_row"].is_fully_replicated
    assert not rt["emb:backing"].is_fully_replicated
    assert set(plan.runtime_inputs) == set(rt)


def test_data_only_mesh_replicates_tables_and_shards_batches():
    """``--mesh data=N`` style: no model axis; tables replicate, batches
    still shard over data."""
    _, jmodel, params, model = make()
    ids = zipf_stream(16)
    want = jax_compile_plan(jmodel, params, "dual", 16).predict(ids)
    mesh = mesh_of((8,), ("data",))
    plan = compile_plan(model, "dual", 16, mesh=mesh)
    assert tuple(plan.input_shardings["ids"].spec) == ("data", None)
    assert place_params(model, mesh)["emb"]["mega_table"].sharding \
        .is_fully_replicated
    np.testing.assert_allclose(plan.predict(ids), want, **TOL)


def test_eager_levels_serve_on_mesh():
    """The levels below "dual" dispatch op by op over placed tensors; they
    agree with the unsharded plan too ("naive" included)."""
    _, jmodel, params, model = make()
    ids = zipf_stream(8)
    want = jax_compile_plan(jmodel, params, "dual", 8).predict(ids)
    mesh = mesh_of((4, 2))
    for level in ("naive", "fused_emb", "fused_all"):
        got = compile_plan(model, level, 8, mesh=mesh).predict(ids)
        np.testing.assert_allclose(got, want, **TOL, err_msg=level)


# --- runtime-level mesh serving ----------------------------------------------

def test_serving_runtime_shares_mesh_and_refreshes_placed():
    """ServingRuntime(mesh=...) hands the mesh to every hosted engine and
    its refresh_all republishes placed tensors."""
    spec, _, _, m1 = make("widedeep")
    _, jm2, p2, m2 = make("dcn")
    mesh = mesh_of((4, 2))
    rt = ServingRuntime(mesh=mesh)
    rt.add_model("widedeep", m1, policy=BucketedBatch((8,)),
                 store=store_of(spec, 64))
    rt.add_model("dcn", m2, policy=BucketedBatch((8,)))
    assert rt.engine("widedeep").mesh is mesh
    assert rt.engine("dcn").mesh is mesh

    ids = zipf_stream(32)
    pre = rt.predict("widedeep", ids)
    assert rt.refresh_all() == 1
    post = rt.predict("widedeep", ids)
    np.testing.assert_array_equal(pre, post)
    pub = rt.engine("widedeep").published
    assert tuple(pub["emb:backing"].sharding.spec) == ("model", None)

    base = jserving.InferenceEngine(jm2, p2,
                                    policy=jserving.BucketedBatch((8,)))
    np.testing.assert_allclose(rt.predict("dcn", ids), base.predict(ids),
                               **TOL)


# --- placement by structure (tests/test_embedding_store.py:169-205) ----------

def test_partition_spec_shards_store_tables_by_structure():
    """Placement follows the store's partition_spec: the cached layout's
    leaves hold no "mega" yet the backing row-shards; cache tiers
    replicate; dense layers replicate."""
    spec = ctr_spec("dcnv2", "criteo", **SPEC_KW)
    model = CTR_MODELS["dcnv2"](spec, store=CachedStore(
        spec.embedding_spec(), 64, device="cpu"))
    model.init(torch.Generator().manual_seed(0))
    placed = place_params(model, mesh_of((1, 1)))
    assert tuple(placed["emb"]["backing"].sharding.spec)[:1] == ("model",)
    assert tuple(placed["emb"]["cache"].sharding.spec) == ()
    assert tuple(placed["emb"]["slot_of_row"].sharding.spec) == ()
    assert tuple(placed["head"]["w"].sharding.spec) == ()


@pytest.mark.parametrize("model_name", ["dcnv2", "widedeep"])
def test_cached_model_on_mesh_matches_dense(model_name):
    """The port's cached model on a (1, 1) mesh is bitwise its DenseStore
    plan (the reference holds its own to 1e-6 and misses it for DCNv2),
    and within tolerance of the reference's dense plan."""
    spec, jmodel, params, dense = make(model_name)
    ids = rows_of(16)
    want = compile_plan(dense, "dual", 16, device="cpu").predict(ids)
    np.testing.assert_allclose(want, jax_compile_plan(
        jmodel, params, "dual", 16).predict(ids), **TOL)
    _, _, _, cmodel = make(model_name)
    cmodel.use_store(store_of(spec, 128))
    got = compile_plan(cmodel, "dual", 16, device="cpu").predict(ids)
    np.testing.assert_array_equal(got, want)
    got_mesh = compile_plan(cmodel, "dual", 16,
                            mesh=mesh_of((1, 1))).predict(ids)
    np.testing.assert_array_equal(got_mesh, want)


def rows_of(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, size=n) for s in SCHEMA.field_sizes],
                    axis=1).astype(np.int32)


# --- the CLI -----------------------------------------------------------------

def _counter_lines(text: str) -> list[str]:
    out = []
    for line in text.splitlines():
        if line.startswith("[serve"):
            line = re.sub(r"p(50|99)=[\d.]+ms", "", line)
            out.append(re.sub(r"mean_score=[\d.]+", "", line))
    return out


def test_cli_serves_on_a_cpu_mesh(capsys, monkeypatch):
    """``serve --device cpu --mesh data=4,model=2 --store cached`` prints
    the reference's mesh line and the reference CLI's counters (its
    1-device run here; its own 8-device run in test_torch_mesh.py)."""
    flags = ["--store", "cached", "--requests", "48"]
    cli.main(["--device", "cpu", "--mesh", "data=4,model=2", *flags])
    got = _counter_lines(capsys.readouterr().out)
    assert got[0] == "[serve] mesh {'data': 4, 'model': 2} over 8 devices"
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    jax_cli.main()
    want = _counter_lines(capsys.readouterr().out)
    assert got[1:] == want and len(want) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs 8 devices, found 0"):
        cli.main(["--mesh", "data=4,model=2", *flags])

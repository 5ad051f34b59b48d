"""repro_torch's multi-device CTR path on CPU meshes, against the
reference.

The port's mesh is single-controller: ``make_mesh(..., devices="cpu")``
puts any number of positions on the CPU in this one process, so every
case here runs without spawned ranks. Held against the reference:

* the sharding rules (``mesh_batch_axes``, ``batch_specs``,
  ``drop_axis``, ``fit_spec``, ``ctr_param_specs``) spec for spec, the
  reference's functions given the port's mesh (they read only its axis
  names and sizes);
* ``apply_sharded`` against the reference's 1-device lookup, bitwise
  (each row comes from exactly one shard; the one exception is an entry
  of -0.0, which the sum with the other shards' zeros returns as +0.0, as
  the reference's ``psum`` does), and the pooled lookup within ``rtol
  1e-5, atol 1e-5`` (the shards' partial sums add in another order);
* mesh plans: on a mesh with only a model axis, bitwise the port's
  mesh-less plan (all four models, fp32 and int8 compute, dense, cached
  and host stores); with a data axis, within ``rtol 1e-5, atol 1e-6`` of
  it (another BLAS blocking at b/D rows) and of the reference's 1-device
  plan;
* ``CTRLoader(mesh=)`` and the compressed data-parallel step;
* in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
  set before JAX loads (as ``tests/test_distributed.py`` runs its
  bodies), the reference's own (4, 2) and (2, 4) results: its mesh plan,
  its ``apply_sharded`` and its compressed step.
"""

import os
import re
import sys

if __name__ == "__main__":      # the subprocess: 8 host devices for JAX
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import subprocess  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ctr_spec as jax_ctr_spec  # noqa: E402
from repro.core import compile_plan as jax_compile_plan  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.embedding import CachedStore as JaxCachedStore  # noqa: E402
from repro.embedding import FusedEmbeddingCollection as JaxCollection  # noqa: E402,E501
from repro.embedding import FusedEmbeddingSpec as JaxSpec  # noqa: E402
from repro.models.ctr import CTR_MODELS as JAX_MODELS  # noqa: E402
from repro_torch.bridge import load_jax_params  # noqa: E402
from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.core import (LEVELS, compile_plan, place_params,  # noqa: E402
                              sharded_vocab_lookup)
from repro_torch.data import CRITEO, CTRLoader, synthetic_batch  # noqa: E402
from repro_torch.distributed import (P, Placed, batch_specs,  # noqa: E402
                                     ctr_param_specs, data_groups, drop_axis,
                                     fit_spec, fit_spec_tree,
                                     input_shardings, make_mesh,
                                     make_test_mesh, mesh_batch_axes, place)
from repro_torch.embedding import (CachedStore, FusedEmbeddingCollection,  # noqa: E402,E501
                                   FusedEmbeddingSpec, HostBackedStore)
from repro_torch.kernels import multi_table_lookup as mtl  # noqa: E402
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402
from repro_torch.quant import quantize_rows  # noqa: E402
from repro_torch.training import (compressed_psum_mean,  # noqa: E402
                                  make_compressed_dp_step)

#: 2,001-row field cap: the mega-table has 27,728 rows, which model = 2,
#: 4 and 8 divide, so every model axis here really splits the table
SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_001)
SCHEMA = CRITEO.scaled(2_001)
TOL = dict(rtol=1e-5, atol=1e-6)          # tests/test_serving_mesh.py:84
POOL_TOL = dict(rtol=1e-5, atol=1e-5)     # tests/test_kernels.py:20
MODELS = ("dcn", "dcnv2", "deepfm", "widedeep")
#: (shape, axes) of every mesh the plan tests run; (8,) is data only
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "8": ((8,), ("data",))}
#: the lookup test's schema (tests/distributed_inner.py:17-18)
LOOKUP_SPEC = dict(field_sizes=(7, 30, 3, 12), dim=8, pad_rows_to=4)


def cpu_mesh(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, devices="cpu")


def model_only(mesh) -> bool:
    return all(n == 1 for a, n in mesh.shape.items() if a != "model")


def rows_of(n, seed=0, field_sizes=SCHEMA.field_sizes):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, size=n) for s in field_sizes],
                    axis=1).astype(np.int32)


def jax_model(name):
    spec = jax_ctr_spec(name, "criteo", **SPEC_KW)
    return JAX_MODELS[name](spec), JAX_MODELS[name](spec).init(
        jax.random.PRNGKey(0))


def port_model(name, store=None):
    """The port's model on the reference's parameters, over ``store``
    ("dense", "cached", "cached_int8", "host")."""
    _, params = jax_model(name)
    spec = ctr_spec(name, "criteo", **SPEC_KW)
    model = load_jax_params(CTR_MODELS[name](spec, device="cpu"), params)
    es = spec.embedding_spec()
    if store in ("cached", "cached_int8"):
        model.use_store(CachedStore(es, 128, "int8" if store.endswith(
            "int8") else None, device="cpu"))
    elif store == "host":
        model.use_store(HostBackedStore(es, 128, 4096, device="cpu"))
    return model


def _mask_ids(names):
    """Kernel names without the ``id(model)`` DCN's tails carry."""
    return tuple(re.sub(r"_\d{6,}_", "_ID_", n) for n in names)


def predict(model, plan, ids):
    store = model.embedding.store
    if store.needs_staging:
        store.stage(ids)
    return plan.predict(ids)


# --- sharding rules ----------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [
    ((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
    ((8,), ("data",)), ((1, 1), ("data", "model")),
    ((2, 2, 2), ("pod", "data", "model")), ((8,), ("model",))])
def test_sharding_rules_match_the_reference(shape, axes):
    mesh = make_mesh(shape, axes, devices="cpu")
    assert mesh_batch_axes(mesh) == jshd.mesh_batch_axes(mesh)
    batch = {"ids": np.zeros((12, 39), np.int32),
             "labels": np.zeros((12,), np.float32)}
    got = batch_specs(mesh, batch)
    want = jshd.batch_specs(mesh, batch)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    for spec in (P("model", None), P(("data", "model"), None),
                 P("data", "model"), P(None, "data"), P()):
        jspec = jshd.P(*spec)
        assert tuple(drop_axis(spec, "data")) == \
            tuple(jshd.drop_axis(jspec, "data"))
        for dims in ((6, 8), (16, 3), (27_728, 8), (27_718, 1), (1, 1)):
            named = [a for d in spec for a in
                     ((d,) if isinstance(d, str) else (d or ()))]
            if not set(named) <= set(axes):
                continue
            assert tuple(fit_spec(mesh, spec, dims)) == \
                tuple(jshd.fit_spec(mesh, jspec, dims)), (spec, dims)
    shapes = {"ids": np.zeros((6, 39)), "w": np.zeros((5, 4))}
    fitted = fit_spec_tree(mesh, batch_specs(mesh, shapes), shapes)
    assert {k: tuple(v) for k, v in fitted.items()} == {
        k: tuple(v) for k, v in jshd.fit_spec_tree(
            mesh, jshd.batch_specs(mesh, shapes), shapes).items()}
    named = input_shardings(mesh, shapes)
    assert named["ids"].mesh is mesh and named["ids"].spec == fitted["ids"]


def test_ctr_param_specs_match_the_reference():
    model = port_model("deepfm", "cached")
    got = ctr_param_specs(model.tensor_tree())
    jmodel, jparams = jax_model("deepfm")
    jparams = jmodel.use_store(JaxCachedStore(
        jax_ctr_spec("deepfm", "criteo", **SPEC_KW).embedding_spec(),
        capacity=128), jparams)
    want = jshd.ctr_param_specs(jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jparams))

    def flat(tree, path=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{path}/{k}"))
            return out
        if isinstance(tree, list):
            out = {}
            for i, v in enumerate(tree):
                out.update(flat(v, f"{path}/{i}"))
            return out
        return {path: tuple(tree)}
    assert flat(got) == flat(jax.tree.map(
        tuple, want, is_leaf=lambda s: isinstance(s, jshd.P)))
    assert flat(got)["/emb/backing"] == ("model", None)
    assert flat(got)["/emb/cache"] == ()


def test_make_mesh_devices(monkeypatch):
    mesh = make_test_mesh(2, 4, devices="cpu")
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.device_set == (torch.device("cpu"),)
    assert make_test_mesh(1, 2, pod=2, devices="cpu").axis_names == (
        "pod", "data", "model")
    assert mesh == make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    with pytest.raises(ValueError, match="8 positions"):
        make_mesh((2, 4), ("data", "model"), ["cpu"] * 4)
    with pytest.raises(ValueError, match="for the CPU"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        make_mesh((4,), ("model",), "cuda:0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 8 devices, found 0"):
        make_mesh((2, 4), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((4,), ("model",), ["cuda:0"] * 4)


def test_place_views_shares_and_round_trips():
    mesh = cpu_mesh("4x2")
    t = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    rows = place(t, mesh, P("model", None))
    assert isinstance(rows, Placed) and rows.shape == t.shape
    assert not rows.sharding.is_fully_replicated
    for pos in np.ndindex(4, 2):
        local = rows.local(pos)
        assert torch.equal(local, t[4 * pos[1]:4 * pos[1] + 4])
        assert local.data_ptr() == t[4 * pos[1]].data_ptr()   # a view
    assert rows.local((0, 1)) is rows.local((3, 1))     # one per slice
    assert torch.equal(rows.full(), t)
    assert place(rows, mesh, P("model")) is rows        # already placed
    rep = place(t, mesh, P())
    assert rep.sharding.is_fully_replicated
    assert all(rep.local(p) is t for p in np.ndindex(4, 2))
    cols = place(t, mesh, P(None, ("data", "model")))
    assert cols.local((3, 1)).is_contiguous()
    assert torch.equal(cols.full(), t)
    with pytest.raises(ValueError, match="fit_spec"):
        place(torch.zeros(6, 3), mesh, P("data"))
    assert rows.sharding.is_equivalent_to(
        place(t, mesh, P("model", None)).sharding, 2)
    one = cpu_mesh("1x1")
    assert place(t, one, P("model")).sharding.is_fully_replicated


def test_data_groups_order_batch_then_model():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices="cpu")
    groups = data_groups(mesh)
    assert groups == [[(0, 0, 0), (0, 0, 1)], [(0, 1, 0), (0, 1, 1)],
                      [(1, 0, 0), (1, 0, 1)], [(1, 1, 0), (1, 1, 1)]]
    assert data_groups(cpu_mesh("8")) == [[(i,)] for i in range(8)]
    assert data_groups(make_mesh((2, 3), ("data", "x"), devices="cpu")) \
        == [[(0, 0)], [(1, 0)]]


# --- the vocab-parallel lookup -----------------------------------------------

def lookup_pair(store="dense"):
    """The reference's collection and the port's, same table (-0.0 in a
    few entries), and ids (b = 16)."""
    jspec = JaxSpec(**LOOKUP_SPEC)
    jemb = JaxCollection(jspec)
    params = jemb.init(jax.random.PRNGKey(0))
    table = np.asarray(params["mega_table"]).copy()
    table[[1, 20, 40], 0] = -0.0
    params = {"mega_table": jnp.asarray(table)}
    spec = FusedEmbeddingSpec(**LOOKUP_SPEC)
    emb = FusedEmbeddingCollection(spec, device="cpu")
    emb.store.mega_table.copy_(torch.from_numpy(table))
    if store != "dense":
        emb = FusedEmbeddingCollection(spec, store=CachedStore(
            spec, 16, "int8" if store == "cached_int8" else None,
            device="cpu"))
        emb.store.adopt({"mega_table": torch.from_numpy(table)})
    ids = rows_of(16, field_sizes=spec.field_sizes)
    ids[0, :] = (1, 13, 3, 0)               # rows 1, 20, 40, 40: the -0.0s
    return jemb, params, emb, ids


@pytest.mark.parametrize("mesh_name", ["1x4", "4x2", "2x1", "8"])
@pytest.mark.parametrize("store", ["dense", "cached", "cached_int8"])
def test_apply_sharded_is_the_one_device_lookup(mesh_name, store,
                                                monkeypatch):
    """Bitwise the 1-device lookup, but a -0.0 entry comes back +0.0
    wherever the table is really split: the other shards' zeros are added
    to it, as the reference's psum adds them."""
    jemb, params, emb, ids = lookup_pair(store)
    mesh = cpu_mesh(mesh_name)
    want = emb(torch.from_numpy(ids))
    if store == "dense":
        np.testing.assert_array_equal(want.numpy(), np.asarray(
            jemb.apply(params, jnp.asarray(ids), strategy="jnp")))
    calls = []
    plain = {"dense": "mtl_gather_plain",
             "cached": "mtl_gather_two_level_plain",
             "cached_int8": "mtl_gather_two_level_q8_plain"}[store]
    real = getattr(mtl, plain)
    monkeypatch.setattr(mtl, plain,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = emb.apply_sharded(torch.from_numpy(ids), mesh)
    assert torch.equal(got, want)                 # -0.0 == +0.0 here
    split = mesh.shape.get("model", 1) > 1
    negz = torch.signbit(want) & (want == 0)
    assert negz.any() == (store != "cached_int8")  # int8 rows lose -0.0
    assert (torch.signbit(got[negz]) != split).all()
    n_data = mesh.shape.get("data", 1)
    assert len(calls) == n_data * mesh.shape.get("model", 1)


@pytest.mark.parametrize("mesh_name", ["1x4", "4x2"])
@pytest.mark.parametrize("store", ["dense", "cached", "cached_int8"])
def test_pooled_sharded_lookup_within_tolerance(mesh_name, store):
    jemb, params, emb, _ = lookup_pair(store)
    rng = np.random.default_rng(3)
    spec = emb.spec
    ids = np.stack([rng.integers(0, s, size=(16, 5))
                    for s in spec.field_sizes], axis=1).astype(np.int32)
    mask = rng.integers(0, 2, size=ids.shape).astype(np.float32)
    want = emb.forward_multihot(torch.from_numpy(ids),
                                torch.from_numpy(mask))
    if store == "dense":
        np.testing.assert_allclose(want.numpy(), np.asarray(
            jemb.apply_multihot(params, jnp.asarray(ids),
                                jnp.asarray(mask), strategy="jnp")),
                                   **POOL_TOL)
    got = emb.apply_multihot_sharded(torch.from_numpy(ids),
                                     torch.from_numpy(mask),
                                     cpu_mesh(mesh_name))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **POOL_TOL)


@pytest.mark.parametrize("kernel", ["multihot", "two_level", "two_level_q8"])
def test_tiered_shard_plain_versions_sum_to_the_whole(kernel):
    """The row-shard argument of K2-K4's plain versions: shards of any
    split sum to the whole lookup (pooled within tolerance; one-hot
    exactly), out-of-range and masked ids included."""
    rng = np.random.default_rng(5)
    n, d, k, h, c = 97, 8, 5, 3, 11
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    table[-1] = 0.0
    q, scale = quantize_rows(table)
    som = torch.full((n,), -1, dtype=torch.int32)
    hot = torch.from_numpy(rng.choice(n, c, replace=False))
    som[hot] = torch.arange(c, dtype=torch.int32)
    offsets = torch.tensor([0, 10, 30, 50, 70], dtype=torch.int32)
    for hh in (1, h):
        ids = torch.from_numpy(rng.integers(-3, 40, size=(6, k, hh))
                               .astype(np.int32))
        mask = torch.from_numpy(rng.integers(0, 2, size=(6, k, hh))
                                .astype(np.float32))

        def run(lo, hi, shard):
            r = slice(lo, hi)
            if kernel == "multihot":
                return mtl.mtl_gather_multihot(ids, mask, offsets, table[r],
                                               shard=shard)
            if kernel == "two_level":
                return mtl.mtl_gather_two_level(
                    ids, offsets, som[r], table[hot], table[r], mask,
                    shard=shard)
            return mtl.mtl_gather_two_level_q8(
                ids, offsets, som[r], q[hot], scale[hot], q[r], scale[r],
                mask, shard=shard)
        whole = run(0, n, None)
        for cuts in ((0, 40, n), (0, 1, 50, 96, n), (0, n)):
            parts = [run(a, b, (a, n)) for a, b in zip(cuts, cuts[1:])]
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            if hh == 1:
                assert torch.equal(total, whole), cuts
            np.testing.assert_allclose(total.numpy(), whole.numpy(),
                                       **POOL_TOL)
        with pytest.raises(ValueError, match="does not fit"):
            run(10, n, (20, n))


def test_sharded_vocab_lookup_zeroes_ids_outside_the_table():
    _, _, emb, _ = lookup_pair()
    table = emb.dense_view()
    for name in ("1x4", "4x2", "1x1"):
        placed = place(table, cpu_mesh(name), P("model", None))
        ids = torch.tensor([[0, 5, table.shape[0] - 1],
                            [table.shape[0], -1, 17]])
        got = sharded_vocab_lookup(placed, ids)
        assert got.shape == (2, 3, table.shape[1])
        assert torch.equal(got[0], table[ids[0]])
        assert torch.equal(got[1, 2], table[17])
        assert not got[1, :2].any()


# --- plans -------------------------------------------------------------------

@pytest.mark.parametrize("store", ["dense", "cached", "cached_int8", "host"])
@pytest.mark.parametrize("model_name", MODELS)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_plan_against_the_meshless_plan(mesh_name, model_name, store):
    """Model axis only: bitwise. With a data axis: within tolerance (and
    in practice bitwise on the CPU's BLAS too)."""
    model = port_model(model_name, store)
    mesh = cpu_mesh(mesh_name)
    ids = rows_of(16, seed=1)
    try:
        for cd in ("fp32", "int8"):
            base = compile_plan(model, "dual", 16, device="cpu",
                                compute_dtype=cd,
                                runtime_provider=model.store_runtime_env)
            want = predict(model, base, ids)
            plan = compile_plan(model, "dual", 16, mesh=mesh,
                                compute_dtype=cd,
                                runtime_provider=model.store_runtime_env)
            assert plan.key.sharded and plan.mesh is mesh
            assert _mask_ids(plan.stats.kernels_used) == \
                _mask_ids(base.stats.kernels_used)
            assert plan.stats.queue == base.stats.queue
            assert plan.order == base.order
            got = predict(model, plan, ids)
            if model_only(mesh):
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, **TOL)
    finally:
        if store == "host":
            model.embedding.store.pipeline.stop()


@pytest.mark.parametrize("compute_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("model_name", MODELS)
def test_mesh_plans_match_the_reference_one_device_plan(model_name,
                                                        compute_dtype):
    jmodel, params = jax_model(model_name)
    ids = rows_of(16, seed=2)
    want = jax_compile_plan(jmodel, params, "dual", 16,
                            compute_dtype=compute_dtype).predict(ids)
    model = port_model(model_name)
    for name in ("4x2", "1x4", "8"):
        got = compile_plan(model, "dual", 16, mesh=cpu_mesh(name),
                           compute_dtype=compute_dtype).predict(ids)
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


@pytest.mark.parametrize("level", LEVELS)
def test_every_level_serves_on_a_mesh(level):
    jmodel, params = jax_model("widedeep")
    ids = rows_of(8, seed=3)
    want = jax_compile_plan(jmodel, params, "dual", 8).predict(ids)
    model = port_model("widedeep")
    base = compile_plan(model, level, 8, device="cpu").predict(ids)
    for name in ("4x2", "1x4"):
        got = compile_plan(model, level, 8, mesh=cpu_mesh(name)).predict(ids)
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
        if name == "1x4":
            np.testing.assert_array_equal(got, base)


def test_mesh_plan_gathers_every_lookup_per_shard(monkeypatch):
    """One K1 a model shard a batch shard for each table (DeepFM's d = 32
    and d = 1 tables), and the plan's recorded shardings."""
    model = port_model("deepfm")
    mesh = cpu_mesh("4x2")
    plan = compile_plan(model, "dual", 16, mesh=mesh)
    assert tuple(plan.input_shardings["ids"].spec) == ("data", None)
    assert plan.runtime_shardings == {}
    calls = []
    real = mtl.mtl_gather_plain
    monkeypatch.setattr(mtl, "mtl_gather_plain",
                        lambda *a: calls.append(a[2].shape[0]) or real(*a))
    plan.predict(rows_of(16))
    rows = model.spec.embedding_spec().rows
    assert sorted(calls) == [rows // 2] * 16


def test_place_params_follows_the_partition_spec():
    model = port_model("dcnv2", "cached_int8")
    mesh = cpu_mesh("4x2")
    placed = place_params(model, mesh)
    assert tuple(placed["emb"]["backing"].sharding.spec) == ("model", None)
    for leaf in ("cache", "slot_of_row", "backing_scale", "cache_scale"):
        assert placed["emb"][leaf].sharding.is_fully_replicated, leaf
    assert placed["head"]["w"].sharding.is_fully_replicated
    assert placed["mlp"][0]["w"].local((3, 1)) is model.mlp[0].w
    data_only = place_params(model, cpu_mesh("8"))
    assert data_only["emb"]["backing"].sharding.is_fully_replicated


def test_ctr_loader_places_batches_over_data():
    mesh = cpu_mesh("4x2")
    loader = CTRLoader(SCHEMA, 16, mesh=mesh, device="cpu")
    batch = loader(3)
    want = synthetic_batch(SCHEMA, 3, 16, device="cpu")
    assert tuple(batch["ids"].sharding.spec) == ("data", None)
    assert tuple(batch["labels"].sharding.spec) == ("data",)
    for pos in np.ndindex(4, 2):
        rows = slice(4 * pos[0], 4 * pos[0] + 4)
        assert torch.equal(batch["ids"].local(pos), want["ids"][rows])
        assert torch.equal(batch["labels"].local(pos), want["labels"][rows])
    assert [s for s, _ in loader.iter_prefetch(0, 3)] == [0, 1, 2]


# --- the compressed data-parallel step ---------------------------------------

def _lsq(params, batch):
    return torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)


def _lsq_inputs():
    """tests/distributed_inner.py:41-46's problem, drawn from numpy."""
    rng = np.random.default_rng(0)
    return ({"w": rng.normal(size=(8, 4)).astype(np.float32)},
            {"x": rng.normal(size=(16, 8)).astype(np.float32),
             "y": rng.normal(size=(16, 4)).astype(np.float32)})


def _torch_tree(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("mesh_name", ["4x2", "2x1", "8"])
def test_compressed_step_matches_the_exact_step(mesh_name):
    params, batch = _lsq_inputs()
    params, batch = _torch_tree(params), _torch_tree(batch)
    mesh = cpu_mesh(mesh_name)
    loss_c, grads_c = make_compressed_dp_step(_lsq, mesh)(params, batch)
    w = params["w"].clone().requires_grad_(True)
    loss_e = _lsq({"w": w}, batch)
    grad_e, = torch.autograd.grad(loss_e, w)
    assert abs(float(loss_c) - float(loss_e.detach())) < 1e-5
    rel = float((grads_c["w"] - grad_e).abs().max() / grad_e.abs().max())
    assert rel < 0.02, rel
    # the step also takes a batch placed over the data axis
    pb = {k: place(v, mesh, P("data")) for k, v in batch.items()}
    loss_p, grads_p = make_compressed_dp_step(_lsq, mesh)(params, pb)
    assert torch.equal(loss_p, loss_c)
    assert torch.equal(grads_p["w"], grads_c["w"])


def test_compressed_psum_mean_is_the_reference_arithmetic():
    """Against a numpy transcription of compression.py:33-56: shared
    scale = max over ranks of max|block| / 127 floored at 1e-12, int8
    codes summed in int32, dequantized and divided by the rank count;
    zero blocks stay exactly zero, and the padding past the last block
    is cut."""
    rng = np.random.default_rng(1)
    xs = [rng.normal(size=(3, 300)).astype(np.float32) for _ in range(4)]
    xs[2][0, :256] = 0.0
    for x in xs:
        x[0, :256] = 0.0
    got = compressed_psum_mean([torch.from_numpy(x) for x in xs]).numpy()
    flat = [np.pad(x.reshape(-1), (0, (-x.size) % 256)).reshape(-1, 256)
            for x in xs]
    scale = np.max([np.abs(b).max(1, keepdims=True) / np.float32(127.0)
                    for b in flat], axis=0)
    scale = np.maximum(scale, np.float32(1e-12)).astype(np.float32)
    total = sum(np.clip(np.round(b / scale), -127, 127).astype(np.int32)
                for b in flat)
    want = ((total.astype(np.float32) * scale) / np.float32(4.0)) \
        .reshape(-1)[:900].reshape(3, 300)
    np.testing.assert_array_equal(got, want)
    assert not got[0, :256].any()
    exact = np.mean(xs, axis=0)
    assert np.abs(got - exact).max() <= scale.max()


# --- the reference's own multi-device results (subprocess) -------------------

SUBPROCESS_CASES = ("plan_4x2", "lookup_2x4", "compressed_4x2", "cli_4x2")


@pytest.mark.parametrize("case", SUBPROCESS_CASES)
def test_matches_the_reference_on_its_own_mesh(case):
    """Re-runs this file as a script with 8 JAX host devices (set before
    JAX loads, as tests/test_distributed.py does) so the reference builds
    its own (4, 2) / (2, 4) mesh results, and holds the port's to them."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(repo, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run([sys.executable, os.path.abspath(__file__), case],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, f"{case}:\n{out.stdout}\n{out.stderr}"
    assert f"{case} OK" in out.stdout, out.stdout


def _case_plan_4x2():
    """The reference's (4, 2) "dual" plan (GSPMD over 8 host devices),
    fp32 and int8 compute, against the port's (4, 2) CPU mesh plan."""
    from repro.compat import make_mesh as jax_make_mesh
    assert jax.device_count() == 8
    jmesh = jax_make_mesh((4, 2), ("data", "model"))
    ids = rows_of(16, seed=4)
    for name in ("dcnv2", "deepfm"):
        jmodel, params = jax_model(name)
        model = port_model(name)
        for cd in ("fp32", "int8"):
            want = jax_compile_plan(jmodel, params, "dual", 16, mesh=jmesh,
                                    compute_dtype=cd).predict(ids)
            got = compile_plan(model, "dual", 16, mesh=cpu_mesh("4x2"),
                               compute_dtype=cd).predict(ids)
            np.testing.assert_allclose(got, want, **TOL)


def _case_lookup_2x4():
    """tests/distributed_inner.py's sharded_lookup, both packages."""
    from repro.launch.mesh import make_test_mesh as jax_test_mesh
    jemb, params, emb, ids = lookup_pair()
    jmesh = jax_test_mesh(2, 4)
    with jmesh:
        want = jax.jit(lambda p, i: jemb.apply_sharded(p, i, jmesh))(
            params, jnp.asarray(ids))
    got = emb.apply_sharded(torch.from_numpy(ids),
                            make_test_mesh(2, 4, devices="cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _case_compressed_4x2():
    """The reference's compressed step on its (4, 2) mesh: the port's
    loss within 1e-5 and every gradient entry within one quantization
    step (the shared scale of its block)."""
    from repro.launch.mesh import make_test_mesh as jax_test_mesh
    from repro.training.compression import (BLOCK, make_compressed_dp_step
                                            as jax_step)
    params, batch = _lsq_inputs()
    jmesh = jax_test_mesh(4, 2)

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)
    with jmesh:
        jl, jg = jax.jit(jax_step(jloss, jmesh))(
            {"w": jnp.asarray(params["w"])},
            {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = make_compressed_dp_step(_lsq, make_test_mesh(
        4, 2, devices="cpu"))(_torch_tree(params), _torch_tree(batch))
    assert abs(float(tl) - float(jl)) < 1e-5
    # the shared scale of each block, from the exact per-rank gradients
    w = torch.from_numpy(params["w"])
    grads = []
    for r in range(4):
        wr = w.clone().requires_grad_(True)
        rows = {k: torch.from_numpy(v[4 * r:4 * r + 4])
                for k, v in batch.items()}
        grads.append(torch.autograd.grad(_lsq({"w": wr}, rows), wr)[0])
    flat = torch.stack([g.reshape(-1) for g in grads]).abs()
    step = float(flat.max()) / 127.0
    assert flat.numel() <= BLOCK * 4
    diff = np.abs(tg["w"].numpy() - np.asarray(jg["w"])).max()
    assert diff <= step * (1 + 1e-6), (diff, step)


def _case_cli_4x2():
    """``serve --mesh data=4,model=2 --store cached``: the reference's
    lines on 8 host devices, the port's on 8 CPU positions."""
    import contextlib
    import io
    import re
    from repro.launch import serve as jax_cli
    from repro_torch.launch import serve as cli
    flags = ["--mesh", "data=4,model=2", "--store", "cached",
             "--requests", "48"]

    def lines(text):
        out = []
        for line in text.splitlines():
            if line.startswith("[serve"):
                line = re.sub(r"p(50|99)=[\d.]+ms", "", line)
                out.append(re.sub(r"mean_score=[\d.]+", "", line))
        return out
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", "cpu", *flags])
    got = lines(buf.getvalue())
    buf = io.StringIO()
    sys.argv = ["serve", *flags]
    with contextlib.redirect_stdout(buf):
        jax_cli.main()
    want = lines(buf.getvalue())
    assert got == want, (got, want)
    assert got[0] == "[serve] mesh {'data': 4, 'model': 2} over 8 devices"


if __name__ == "__main__":
    case = sys.argv[1]
    globals()[f"_case_{case}"]()
    print(f"{case} OK")

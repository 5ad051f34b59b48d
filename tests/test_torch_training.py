"""repro_torch's CTR training path against the reference's: metrics, the
labelled synthetic batch, AdamW, loss gradients, checkpoints (in both
directions), the train loop and the ``train_ctr`` driver, on the CPU.

Inputs come from numpy seeds; parameters from the reference's
``model.init`` through ``load_jax_params``; the same numpy batch goes
through both packages. On the CPU the kernels' autograd Functions run the
plain versions forward and their own backward formulas, so these tests
hold those formulas against ``jax.value_and_grad``. The card's side of
the same Functions is in ``tests/test_torch_cuda.py``.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.training as jtraining  # noqa: E402
from repro.configs import ctr_spec as jax_ctr_spec  # noqa: E402
from repro.data.synthetic import CRITEO as JAX_CRITEO  # noqa: E402
from repro.data.synthetic import _planted_effect  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    synthetic_batch as jax_synthetic_batch)
from repro.models.ctr import CTR_MODELS as JAX_MODELS  # noqa: E402
import repro_torch.launch.train_ctr as train_ctr  # noqa: E402
from repro_torch.bridge import load_jax_params  # noqa: E402
from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.core import compile_plan  # noqa: E402
from repro_torch.data import (CRITEO, SKEWS, CTRLoader,  # noqa: E402
                              planted_effect, planted_labels,
                              skewed_ids_from_uniform, synthetic_batch)
from repro_torch.embedding import CachedStore  # noqa: E402
from repro_torch.kernels import autograd as kad  # noqa: E402
from repro_torch.kernels.fused_cross import (  # noqa: E402
    fused_cross_v1_plain, fused_cross_v2_plain)
from repro_torch.kernels.fused_fm import (  # noqa: E402
    fused_fm_second_order_plain)
from repro_torch.kernels.multi_table_lookup import (  # noqa: E402
    mtl_gather_plain)
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402
from repro_torch.training import (AdamWConfig, TrainLoopConfig,  # noqa: E402
                                  TrainState, adamw_init, adamw_update, global_norm,
                                  latest_step, logloss, make_ctr_step,
                                  restore_checkpoint, roc_auc,
                                  run_train_loop, save_checkpoint)
from repro_torch.training.optimizer import tree_flatten  # noqa: E402

SCHEMA = CRITEO.scaled(2_000)
SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_000)
CPU = torch.device("cpu")
#: two packages, two BLAS and reduction orders (``tests/test_system.py:42``)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def jax_pair(name, seed=0):
    spec = jax_ctr_spec(name, "criteo", **SPEC_KW)
    jmodel = JAX_MODELS[name](spec)
    return jmodel, jmodel.init(jax.random.PRNGKey(seed))


def port_model(name, jparams=None, seed=0):
    model = CTR_MODELS[name](ctr_spec(name, "criteo", **SPEC_KW),
                             device="cpu")
    if jparams is None:
        return model.init(torch.Generator().manual_seed(seed))
    return load_jax_params(model, jparams)


def np_batch(step, b):
    """A port batch as numpy arrays, fed to both packages."""
    batch = synthetic_batch(SCHEMA, step, b, device="cpu")
    return {k: v.numpy() for k, v in batch.items()}


def leaves_by_key(tree):
    return {"/".join(map(str, p)): t for p, t in tree_flatten(tree)}


def jax_leaves_by_key(tree):
    return {jtraining.checkpoint._leaf_key(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# metrics and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "constant", "one_class"])
def test_metrics_equal_the_reference(case):
    rng = np.random.default_rng(0)
    labels = (rng.random(1000) < 0.3).astype(np.float32)
    scores = rng.random(1000)
    if case == "ties":
        scores = np.round(scores * 8) / 8
    elif case == "constant":
        scores = np.full(1000, 0.5)
    elif case == "one_class":
        labels = np.ones(1000, np.float32)
    got, want = roc_auc(labels, scores), jtraining.roc_auc(labels, scores)
    assert (np.isnan(got) and np.isnan(want)) or got == want
    assert logloss(labels, scores) == jtraining.logloss(labels, scores)


def test_planted_effect_matches_reference():
    """torch's sin/cos differ from XLA's by one ulp on ~3.5% of these
    phases; through the 39-term sum (rounded in the reference's order)
    that moves a value by up to 2 ulps of the sum, 4.8e-7 after the
    1/sqrt(39): one ulp of a value in [4, 8) is 4.77e-7, so the bound
    is 5e-7."""
    rng = np.random.default_rng(0)
    u = rng.random((8192, CRITEO.k), dtype=np.float32)
    for skew in SKEWS:
        ids = skewed_ids_from_uniform(u, CRITEO.field_sizes, skew)
        got = planted_effect(torch.from_numpy(ids), CRITEO.k).numpy()
        want = np.asarray(_planted_effect(
            jnp.asarray(ids), jnp.asarray(JAX_CRITEO.field_sizes)))
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-7,
                                   err_msg=skew)


def test_label_rule_and_skew_laws_match_reference():
    """The same uniforms give the reference's ids (its float32
    arithmetic, ``synthetic.py:136-147``) and its labels
    (``u < sigmoid(_planted_effect(ids))``)."""
    rng = np.random.default_rng(1)
    u = rng.random((4096, CRITEO.k), dtype=np.float32)
    u_lab = rng.random(4096, dtype=np.float32)
    sizes = jnp.asarray(JAX_CRITEO.field_sizes, dtype=jnp.int32)
    uj = jnp.asarray(u)
    want_ids = {
        "quadratic": jnp.minimum((uj * uj * sizes[None, :]).astype(
            jnp.int32), sizes - 1),
        "uniform": jnp.minimum((uj * sizes[None, :]).astype(jnp.int32),
                               sizes - 1)}
    for skew, want in want_ids.items():
        got = skewed_ids_from_uniform(u, CRITEO.field_sizes, skew)
        np.testing.assert_array_equal(got, np.asarray(want))
        labels = planted_labels(torch.from_numpy(got), torch.from_numpy(u_lab))
        want_labels = (jnp.asarray(u_lab) < jax.nn.sigmoid(
            _planted_effect(want, sizes))).astype(jnp.float32)
        np.testing.assert_array_equal(labels.numpy(),
                                      np.asarray(want_labels))


@pytest.mark.parametrize("skew", SKEWS)
def test_synthetic_batch_schema_and_label_rate(skew):
    """Shapes, dtypes and ranges of the reference's batch; the same law,
    so the label rates of the two packages' own draws agree within
    sampling noise (binomial sd ~0.004 at 16k rows)."""
    b = 16_384
    got = synthetic_batch(SCHEMA, 3, b, skew=skew, device="cpu")
    want = jax.tree.map(np.asarray, jax_synthetic_batch(
        JAX_CRITEO.scaled(2_000), 3, b, skew=skew))
    assert got["ids"].dtype == torch.int32 and got["ids"].shape == (b, 39)
    assert got["labels"].dtype == torch.float32
    assert got["labels"].shape == (b,)
    ids = got["ids"].numpy()
    assert (ids >= 0).all() and (ids < np.asarray(SCHEMA.field_sizes)).all()
    assert set(np.unique(got["labels"].numpy())) <= {0.0, 1.0}
    assert abs(got["labels"].numpy().mean() - want["labels"].mean()) < 0.03
    with pytest.raises(ValueError, match="unknown skew"):
        synthetic_batch(SCHEMA, 0, 4, skew="pareto", device="cpu")


def test_data_pipeline_determinism():
    a = synthetic_batch(SCHEMA, 7, 32, device="cpu")
    b = synthetic_batch(SCHEMA, 7, 32, device="cpu")
    assert torch.equal(a["ids"], b["ids"])
    assert torch.equal(a["labels"], b["labels"])
    c = synthetic_batch(SCHEMA, 8, 32, device="cpu")
    assert not torch.equal(a["ids"], c["ids"])


def test_ctr_loader_is_the_step_indexed_stream():
    loader = CTRLoader(SCHEMA, 16, device="cpu")
    steps = []
    for step, batch in loader.iter_prefetch(5, 4, depth=2):
        steps.append(step)
        want = synthetic_batch(SCHEMA, step, 16, device="cpu")
        assert torch.equal(batch["ids"], want["ids"])
        assert torch.equal(loader(step)["labels"], want["labels"])
    assert steps == [5, 6, 7, 8]
    # over a mesh (ported): the same stream, rows split over data
    from repro_torch.distributed import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
    placed = CTRLoader(SCHEMA, 16, mesh=mesh, device="cpu")(5)
    want = synthetic_batch(SCHEMA, 5, 16, device="cpu")
    assert torch.equal(placed["ids"].full(), want["ids"])
    assert torch.equal(placed["labels"].local((1, 0)), want["labels"][8:])


def test_data_entry_points_never_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_batch(SCHEMA, 0, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CTRLoader(SCHEMA, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_ctr.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(rng, scale):
    shapes = {"emb": {"mega_table": (27_718, 8)},
              "mlp": [{"w": (64, 32), "b": (32,)}, {"w": (32, 1), "b": (1,)}],
              "fm_bias": (1,)}
    return jax.tree.map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("clip", [0.05, 1e3], ids=["clip_on", "clip_off"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state_dtype, weight_decay, clip):
    """One update of the same state (step 5, nonzero moments) with the
    same gradients. Parameters and float32 moments at rtol 1e-6, with an
    atol for values that cancel to near zero: 5e-8 (a few ulps at 0.1,
    5e-5 of the step lr) for parameters, because XLA's CPU sqrt is not
    correctly rounded (0.5% of results one ulp off) and a small ``v``
    magnifies the step's rounding; 1e-6 of the leaf's largest moment for
    moments, because with the clip on the global norm is a float32 sum in
    another order (XLA reduces in windows of 32), one ulp apart, and
    ``b1·m + (1 - b1)·g`` cancels. For the same reason a bf16 moment whose
    float32 value sits within an ulp of a rounding tie may round the
    other way: at most one bf16 ulp, on a handful of elements."""
    rng = np.random.default_rng(0)
    p, g, m0, v0 = (_tree(rng, 0.05), _tree(rng, 0.01), _tree(rng, 1e-3),
                    _tree(rng, 1e-3))
    v0 = jax.tree.map(np.square, v0)
    kw = dict(lr=1e-3, weight_decay=weight_decay, clip_norm=clip,
              state_dtype=state_dtype)
    jcfg, cfg = jtraining.AdamWConfig(**kw), AdamWConfig(**kw)
    jdt = jnp.dtype(state_dtype)
    jstate = jtraining.TrainState(
        step=jnp.asarray(5, jnp.int32), params=jax.tree.map(jnp.asarray, p),
        m=jax.tree.map(lambda a: jnp.asarray(a, jdt), m0),
        v=jax.tree.map(lambda a: jnp.asarray(a, jdt), v0))
    tdt = getattr(torch, state_dtype)
    state = TrainState(
        step=torch.tensor(5, dtype=torch.int32),
        params=jax.tree.map(torch.tensor, p),
        m=jax.tree.map(lambda a: torch.tensor(a).to(tdt), m0),
        v=jax.tree.map(lambda a: torch.tensor(a).to(tdt), v0))
    jstate, jm = jtraining.adamw_update(
        jstate, jax.tree.map(jnp.asarray, g), jcfg)
    state, m = adamw_update(state, jax.tree.map(torch.tensor, g), cfg)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert int(state.step) == int(jstate.step) == 6
    assert state.step.dtype == torch.int32
    for name in ("params", "m", "v"):
        got = leaves_by_key(getattr(state, name))
        want = jax_leaves_by_key(getattr(jstate, name))
        assert got.keys() == want.keys()
        for key, t in got.items():
            a = t.float().numpy()
            b = want[key].astype(np.float32)
            if name == "params":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=5e-8,
                                           err_msg=key)
                continue
            assert t.dtype == tdt
            atol = 1e-6 * np.abs(b).max()
            if state_dtype == "bfloat16" and clip < 1:
                np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=atol,
                                           err_msg=key)
                assert (a != b).mean() < 1e-4, key
            else:
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=atol,
                                           err_msg=key)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    g = _tree(rng, 0.3)
    np.testing.assert_allclose(
        float(global_norm(jax.tree.map(torch.tensor, g))),
        float(jtraining.optimizer.global_norm(jax.tree.map(jnp.asarray, g))),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# gradients of the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_name", list(CTR_MODELS))
def test_loss_gradients_match_reference(model_name):
    """``model.loss`` + autograd (the kernels' Functions on the CPU) against
    ``jax.value_and_grad(model.loss)`` on the same parameters and batch."""
    jmodel, jparams = jax_pair(model_name)
    model = port_model(model_name, jparams)
    params = model.param_tree()
    batch = np_batch(0, 256)
    jloss, jgrads = jax.value_and_grad(jmodel.loss)(
        jparams, jax.tree.map(jnp.asarray, batch))
    loss = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **GRAD_TOL)
    want = jax_leaves_by_key(jgrads)
    got = leaves_by_key(params)
    assert got.keys() == want.keys()
    for key, t in got.items():
        assert t.grad is not None, key
        np.testing.assert_allclose(t.grad.numpy(), want[key], **GRAD_TOL,
                                   err_msg=key)
    emb = params["emb"]["mega_table"].grad
    assert emb.abs().sum() > 0


def _jax_step_fn(jmodel, jcfg):
    @jax.jit
    def step_fn(state, batch):
        loss, grads = jax.value_and_grad(jmodel.loss)(state.params, batch)
        state, m = jtraining.adamw_update(state, grads, jcfg)
        return state, {"loss": loss, **m}
    return step_fn


@pytest.mark.parametrize("model_name", list(CTR_MODELS))
def test_loss_curve_matches_reference(model_name):
    """Five AdamW steps on the same batches: the losses agree at rtol 1e-4.
    Parameters are not compared after several steps: Adam's
    ``m / (sqrt(v) + eps)`` turns ulp-level differences in near-zero
    gradients into lr-sized steps."""
    jmodel, jparams = jax_pair(model_name)
    model = port_model(model_name, jparams)
    kw = dict(lr=1e-3)
    jstep = _jax_step_fn(jmodel, jtraining.AdamWConfig(**kw))
    step = make_ctr_step(model, AdamWConfig(**kw))
    jstate = jtraining.adamw_init(jparams, jtraining.AdamWConfig(**kw))
    state = adamw_init(model.param_tree(), AdamWConfig(**kw))
    for s in range(5):
        batch = np_batch(s, 128)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {s}")


def test_training_learns_and_metrics_improve():
    model = port_model("dcnv2")
    opt = AdamWConfig(lr=3e-3)
    state = adamw_init(model.param_tree(), opt)
    step = make_ctr_step(model, opt)
    losses = []
    for s in range(120):
        state, m = step(state, synthetic_batch(SCHEMA, s, 256, device="cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    val = synthetic_batch(SCHEMA, 999, 2048, device="cpu")
    with torch.no_grad():
        probs = model.predict_proba(val["ids"]).numpy()
    auc = roc_auc(val["labels"].numpy(), probs)
    assert auc > 0.55, f"planted signal not learned (auc={auc})"


def test_tiered_stores_refuse_training():
    model = port_model("dcnv2")
    model.use_store(CachedStore(model.spec.embedding_spec(), 256,
                                device="cpu"))
    batch = synthetic_batch(SCHEMA, 0, 8, device="cpu")
    with pytest.raises(TypeError, match="DenseStore"):
        model.param_tree()
    with pytest.raises(TypeError, match="DenseStore"):
        model.loss(batch)
    with torch.no_grad():
        assert torch.isfinite(model.loss(batch))


def test_plans_record_no_autograd_graph():
    """A model whose buffers require grad serves through ``compile_plan``
    without a graph; its own forward (the training path) builds one."""
    model = port_model("deepfm")
    model.param_tree()
    ids = synthetic_batch(SCHEMA, 0, 16, device="cpu")["ids"]
    plan = compile_plan(model, "dual", 16, device="cpu")
    out = plan(ids)
    assert not out.requires_grad and out.grad_fn is None
    assert model(ids).grad_fn is not None


# ---------------------------------------------------------------------------
# the kernels' autograd Functions, on the CPU
# ---------------------------------------------------------------------------

def _grads(fn, *inputs):
    inputs = [t.detach().clone().requires_grad_(t.is_floating_point())
              for t in inputs]
    out = fn(*inputs)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(out.shape)).astype(np.float32))
    out.backward(g)
    return out.detach(), [t.grad for t in inputs if t.is_floating_point()]


@pytest.mark.parametrize("d", [8, 1])
def test_gather_function_matches_plain_autograd(d):
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((300, d)).astype(np.float32))
    offsets = torch.tensor([0, 100, 200], dtype=torch.int32)
    ids = torch.from_numpy(rng.integers(-3, 110, (512, 3)).astype(np.int32))
    out, (grad,) = _grads(lambda t: kad.mtl_gather(ids, offsets, t), table)
    want_out, (want,) = _grads(lambda t: mtl_gather_plain(ids, offsets, t),
                               table)
    assert torch.equal(out, want_out)
    torch.testing.assert_close(grad, want, rtol=1e-6, atol=1e-6)
    _, (again,) = _grads(lambda t: kad.mtl_gather(ids, offsets, t), table)
    assert torch.equal(grad, again)


@pytest.mark.parametrize("layer0", [True, False])
@pytest.mark.parametrize("kind", ["v2", "v1"])
def test_cross_functions_match_plain_autograd(kind, layer0):
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x0, x = t(64, 40), t(64, 40)
    if kind == "v2":
        args, fn, plain = (x0, t(64, 40)), kad.fused_cross_v2, \
            fused_cross_v2_plain
    else:
        args, fn, plain = (x0, t(64, 1), t(40)), kad.fused_cross_v1, \
            fused_cross_v1_plain
    if layer0:
        def call(f):
            return lambda *a: f(*a, a[0])
    else:
        args = args + (x,)

        def call(f):
            return f
    out, grads = _grads(call(fn), *args)
    want_out, want = _grads(call(plain), *args)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for got, exp in zip(grads, want):
        torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-6)


def test_fm_function_matches_plain_autograd():
    v = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 39, 8)).astype(np.float32))
    out, (grad,) = _grads(kad.fused_fm_second_order, v)
    want_out, (want,) = _grads(fused_fm_second_order_plain, v)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(grad, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _states(state_dtype):
    jmodel, jparams = jax_pair("deepfm")
    model = port_model("deepfm", jparams)
    kw = dict(lr=1e-3, state_dtype=state_dtype)
    jstate = jtraining.adamw_init(jparams, jtraining.AdamWConfig(**kw))
    state = adamw_init(model.param_tree(), AdamWConfig(**kw))
    batch = np_batch(0, 64)
    jstate, _ = _jax_step_fn(jmodel, jtraining.AdamWConfig(**kw))(
        jstate, jax.tree.map(jnp.asarray, batch))
    return jstate, model, state


def _fresh(state):
    from repro_torch.training.optimizer import tree_map
    return tree_map(lambda t: torch.full_like(t, 7), state)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_into_port_bitwise(tmp_path,
                                                         state_dtype):
    jstate, _, state = _states(state_dtype)
    jtraining.save_checkpoint(str(tmp_path), 1, jstate)
    target = _fresh(state)
    assert restore_checkpoint(str(tmp_path), 1, target) is target
    want = jax_leaves_by_key(jstate)
    got = leaves_by_key(target)
    assert got.keys() == want.keys()
    assert "0" in got and "1/emb/mega_table" in got and "3/mlp/2/w" in got
    for key, t in got.items():
        w = want[key]
        if state_dtype == "bfloat16" and w.dtype.itemsize == 2:
            w = w.view(np.int16)
            t = t.view(torch.int16)
        np.testing.assert_array_equal(t.numpy(), w, err_msg=key)


def test_port_checkpoint_restores_into_reference_bitwise(tmp_path):
    jstate, model, state = _states("float32")
    batch = np_batch(0, 64)
    state, _ = make_ctr_step(model, AdamWConfig(lr=1e-3))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    save_checkpoint(str(tmp_path), 1, state)
    with open(tmp_path / "step_1" / "manifest.json") as f:
        manifest = json.load(f)
    keys = [leaf["key"] for leaf in manifest["leaves"]]
    assert keys == list(jax_leaves_by_key(jstate))
    back = jtraining.restore_checkpoint(str(tmp_path), 1, jstate)
    got = jax_leaves_by_key(back)
    for key, t in leaves_by_key(state).items():
        np.testing.assert_array_equal(got[key], t.detach().numpy(),
                                      err_msg=key)
        assert got[key].dtype == t.detach().numpy().dtype, key


def test_checkpoint_atomicity(tmp_path):
    tree = {"w": torch.arange(10.0), "b": torch.ones((3, 3))}
    save_checkpoint(str(tmp_path), 5, tree)
    # a stale tmp dir from a crashed writer must be ignored
    (tmp_path / ".tmp_step_7").mkdir()
    assert latest_step(str(tmp_path)) == 5
    back = restore_checkpoint(str(tmp_path), 5,
                              {"w": torch.zeros(10), "b": torch.zeros(3, 3)})
    assert torch.equal(back["w"], tree["w"])
    assert torch.equal(back["b"], tree["b"])
    with pytest.raises(ValueError, match="target has"):
        restore_checkpoint(str(tmp_path), 5, {"w": torch.zeros(10),
                                              "c": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 5, {"w": torch.zeros(11),
                                              "b": torch.zeros(3, 3)})


def test_checkpoint_restart_resumes_exactly(tmp_path):
    """6 steps unbroken equal 3 steps, a fresh process's restore, then 3
    more: bitwise on the CPU."""
    opt = AdamWConfig(lr=1e-3)

    def run(total, ckpt):
        model = port_model("dcn")
        cfg = TrainLoopConfig(total_steps=total, ckpt_every=3,
                              ckpt_dir=str(tmp_path / ckpt), log_every=100)
        state, hist = run_train_loop(
            make_ctr_step(model, opt), adamw_init(model.param_tree(), opt),
            CTRLoader(SCHEMA, 64, device="cpu"), cfg)
        return state, hist

    s1, h1 = run(6, "a")
    run(3, "b")
    s2, h2 = run(6, "b")
    assert [r["step"] for r in h2] == [4, 5, 6]
    assert [r["loss"] for r in h1[3:]] == [r["loss"] for r in h2]
    for (key, a), (_, b) in zip(tree_flatten(s1), tree_flatten(s2)):
        assert torch.equal(a, b), key
    assert sorted(os.listdir(tmp_path / "b")) == ["step_3", "step_6"]


def test_train_loop_keeps_the_newest_checkpoints(tmp_path):
    model = port_model("widedeep")
    opt = AdamWConfig(lr=1e-3)
    cfg = TrainLoopConfig(total_steps=5, ckpt_every=1, keep_ckpts=2,
                          ckpt_dir=str(tmp_path), log_every=2)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _, hist = run_train_loop(make_ctr_step(model, opt),
                                 adamw_init(model.param_tree(), opt),
                                 CTRLoader(SCHEMA, 32, device="cpu"), cfg)
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    assert [r["step"] for r in hist] == [1, 2, 3, 4, 5]
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("[train] step 2 sec=")
    assert "loss=" in lines[0] and "grad_norm=" in lines[0]


def test_train_ctr_cli_on_cpu(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.train_ctr --device cpu`` on a small
    spec: the example's lines, a checkpoint, and a resume."""
    monkeypatch.setattr(train_ctr, "CRITEO", SCHEMA)
    monkeypatch.setattr(
        train_ctr, "ctr_spec",
        lambda *a, **kw: ctr_spec(*a, **{**kw, **SPEC_KW}))
    monkeypatch.setattr(train_ctr, "VAL_ROWS", 512)
    args = ["--device", "cpu", "--steps", "3", "--batch", "64",
            "--ckpt-dir", str(tmp_path)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_ctr.main(args)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("model: dcnv2/criteo  params = ")
    assert lines[-2].startswith("val AUC = ") and "LogLoss = " in lines[-2]
    assert lines[-1].startswith("first-loss ")
    assert latest_step(str(tmp_path)) == 3
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_ctr.main(args[:3] + ["5"] + args[4:])
    assert "[train] resumed from step 3" in out.getvalue()
    assert latest_step(str(tmp_path)) == 5

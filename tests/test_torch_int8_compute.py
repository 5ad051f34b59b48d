"""repro_torch's int8 dense compute (K12, the activation quantizer and
``compute_dtype="int8"``) against the reference.

``quant.quantize_channels`` and the plain version of the int8 dense layer
(what ``ops.dense_matmul_q8`` runs on CPU tensors) are held bitwise against
the reference's, on its own test shapes and on ±127 codes whose int32 sum
passes 2**24, against its jitted "jnp" path and its Pallas kernel in
interpret mode: the int32 sum is exact and the epilogue is the same
``fma(fp32(acc) * hscale, wscale, bias)``. Whole int8 plans of every model
match the reference's ``compile_plan(compute_dtype="int8")`` at every level
on bridged weights at the level-ladder tolerance (``rtol=1e-5, atol=1e-6``;
the cross and head GEMMs are fp32 through two different CPU BLAS
libraries, and under jit the reference's activation quantizer multiplies
by 1/127 where its eager one divides, one ulp on some scales), with the
same ``ExecutorStats`` counters. The CUDA kernel is held against the plain
version in ``tests/test_torch_cuda.py``, on a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.configs import ctr_spec as jax_ctr_spec  # noqa: E402
from repro.core import compile_plan as jax_compile_plan  # noqa: E402
from repro.embedding import CachedStore as JaxCachedStore  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.ctr import CTR_MODELS as JAX_MODELS  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.bridge import load_jax_params  # noqa: E402
from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.core import (COMPUTE_DTYPES, LEVELS, OpGraph,  # noqa: E402
                              compile_plan, plan_key_for)
from repro_torch.data import CRITEO, sample_ids  # noqa: E402
from repro_torch.embedding import CachedStore  # noqa: E402
from repro_torch.kernels import KERNELS, ops  # noqa: E402
from repro_torch.kernels.dense_matmul import (MAX_FAN_IN, dmm_q8,  # noqa: E402
                                              dmm_q8_plain, pack_weight,
                                              pad_k)
from repro_torch.kernels.quantize import (quantize_rows_q8,  # noqa: E402
                                          quantize_rows_q8_plain)
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402
from repro_torch.models.ctr.common import emit_mlp_ops, mlp_layers  # noqa: E402

SCHEMA = CRITEO.scaled(2_000)
SCHEMA_OFFSETS = np.concatenate([[0], np.cumsum(SCHEMA.field_sizes)[:-1]])
SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_000)
LADDER_TOL = dict(rtol=1e-5, atol=1e-6)
Q8_SCORE_GATE = 1e-2          # per-score |int8 - fp32| (accuracy_parity.py:13)


def q8_layer(rng, b, fan_in, fan_out):
    """The reference test's layer (``tests/test_kernels.py:509-514``)."""
    h = rng.normal(size=(b, fan_in)).astype(np.float32)
    w = rng.normal(size=(fan_in, fan_out)).astype(np.float32)
    bias = rng.normal(size=(fan_out,)).astype(np.float32)
    return h, w, bias


def port_layer(h, w, bias, relu):
    wq, ws = quant.quantize_channels(torch.from_numpy(w))
    return ops.dense_matmul_q8(torch.from_numpy(h), pack_weight(wq), ws,
                               torch.from_numpy(bias), relu=relu).numpy()


def ref_layer(h, w, bias, relu, strategy, **kw):
    wq, ws = jquant.quantize_channels(jnp.asarray(w))
    return np.asarray(jops.dense_matmul_q8(jnp.asarray(h), wq, ws,
                                           jnp.asarray(bias), relu=relu,
                                           strategy=strategy, **kw))


# ---------------------------------------------------------------------------
# quant: channels, and the activation scale
# ---------------------------------------------------------------------------

def test_quantize_channels_bitwise_vs_reference():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(96, 40)) * rng.uniform(0.01, 2.0, size=40)
         ).astype(np.float32)
    w[:, 5] = 0.0                                   # an all-zero channel
    q, s = quant.quantize_channels(torch.from_numpy(w))
    jq, js = jquant.quantize_channels(jnp.asarray(w))
    assert q.dtype == torch.int8 and tuple(q.shape) == (96, 40)
    assert s.dtype == torch.float32 and tuple(s.shape) == (1, 40)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert not q[:, 5].any() and s[0, 5] == np.float32(quant.SCALE_EPS)
    np.testing.assert_array_equal(
        quant.dequantize_channels(q, s).numpy(),
        np.asarray(jquant.dequantize_channels(jq, js)))


def test_absmax_scale_is_unchanged_a_true_division():
    """The 0-d divisor is a device fill now; the scale is still
    ``max|x| / 127`` divided (not multiplied by a rounded 1/127), bitwise
    the reference's eager quantizer, row- and column-wise."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(512, 48)) * rng.uniform(0.001, 5.0, size=(512, 1))
         ).astype(np.float32)
    x[3] = 0.0
    for dim in (-1, 0):
        got = quant.absmax_scale(torch.from_numpy(x), dim=dim).numpy()
        amax = np.abs(x).max(axis=dim, keepdims=True)
        want = np.maximum(amax / np.float32(127.0),
                          np.float32(quant.SCALE_EPS)).astype(np.float32)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(jquant.absmax_scale(jnp.asarray(x), axis=dim)))
    recip = np.abs(x).max(axis=-1, keepdims=True) * np.float32(1.0 / 127.0)
    got = quant.absmax_scale(torch.from_numpy(x)).numpy()
    assert np.any(got != recip)      # the division shows on these rows


# ---------------------------------------------------------------------------
# the activation quantizer (kernels/quantize.py) == the reference's, bitwise
# ---------------------------------------------------------------------------

def activations(rng, b, fan_in):
    """Rows of very different scales; row 1 all zero, row 2 a row whose
    scale is exactly 2**-4 and whose every other ``x / scale`` is
    ``k + 0.5``, so round half to even decides each code."""
    h = (rng.normal(size=(b, fan_in))
         * rng.uniform(1e-3, 10.0, size=(b, 1))).astype(np.float32)
    h[1] = 0.0
    s = np.float32(2.0**-4)
    h[2] = (((np.arange(fan_in) % 254) - 127 + 0.5) * s).astype(np.float32)
    h[2, 0] = 127 * s
    return h


@pytest.mark.parametrize("b,fan_in", [(3, 1), (5, 7), (33, 80), (64, 1248)])
def test_quantize_rows_q8_bitwise_vs_reference(b, fan_in):
    h = activations(np.random.default_rng(b + fan_in), b, fan_in)
    hq, hs = quantize_rows_q8(torch.from_numpy(h))
    assert quantize_rows_q8.launches == 0           # CPU: no kernel launch
    assert hq.dtype == torch.int8 and tuple(hq.shape) == (b, fan_in)
    assert hs.dtype == torch.float32 and tuple(hs.shape) == (b, 1)
    js = jquant.absmax_scale(jnp.asarray(h), axis=-1)
    jq = jquant.quantize(jnp.asarray(h), js)
    np.testing.assert_array_equal(hs.numpy(), np.asarray(js))
    np.testing.assert_array_equal(hq.numpy(), np.asarray(jq))
    assert hs[1, 0] == np.float32(quant.SCALE_EPS) and not hq[1].any()
    assert hs[2, 0] == 2.0**-4
    np.testing.assert_array_equal(hq[2].numpy(),
                                  np.rint(h[2] * 16).astype(np.int8))


@pytest.mark.parametrize("relu", [True, False])
def test_nan_and_inf_rows_match_the_reference(relu):
    """A row holding a NaN gets a NaN scale, an inf row an inf scale, and
    codes of 0 in both, as in the reference; the int8 layer then gives
    both rows NaN outputs (``0 · inf``), through the ReLU too. The CUDA
    kernels are held to this plain version on a card."""
    rng = np.random.default_rng(11)
    h, w, bias = q8_layer(rng, 8, 40, 24)
    h[3, 5] = np.nan
    h[4, 0] = np.inf
    h[5, 9] = -np.inf
    hq, hs = quantize_rows_q8(torch.from_numpy(h))
    js = jquant.absmax_scale(jnp.asarray(h), axis=-1)
    np.testing.assert_array_equal(hs.numpy(), np.asarray(js))  # NaN == NaN
    np.testing.assert_array_equal(
        hq.numpy(), np.asarray(jquant.quantize(jnp.asarray(h), js)))
    assert np.isnan(hs[3, 0].item()) and np.isinf(hs.numpy()[4:6, 0]).all()
    assert not hq[3:6].any()
    got = port_layer(h, w, bias, relu)
    np.testing.assert_array_equal(got, ref_layer(h, w, bias, relu, "jnp"))
    assert np.isnan(got[3:6]).all() and np.isfinite(np.delete(got, [3, 4, 5],
                                                              axis=0)).all()


def test_quantize_rows_q8_checks_its_inputs():
    h = torch.randn((4, 16), generator=torch.Generator().manual_seed(0))
    with pytest.raises(TypeError):
        quantize_rows_q8(h.double())
    with pytest.raises(ValueError, match="rank"):
        quantize_rows_q8(h.reshape(-1))
    with pytest.raises(ValueError, match="contiguous"):
        quantize_rows_q8(h.t())
    with pytest.raises(ValueError, match="columns"):
        quantize_rows_q8(h[:, :0])
    with pytest.raises(ValueError, match="meta"):
        quantize_rows_q8(h.to("meta"))
    assert "quantize_rows_q8" in KERNELS


def test_dense_matmul_q8_quantizes_through_the_wrapper(monkeypatch):
    """``ops.dense_matmul_q8`` quantizes its activations with
    ``quantize_rows_q8`` (one kernel launch on CUDA) and nothing else."""
    seen = []

    def spy(h):
        seen.append(tuple(h.shape))
        return quantize_rows_q8_plain(h)

    monkeypatch.setattr(ops, "quantize_rows_q8", spy)
    rng = np.random.default_rng(4)
    h, w, bias = q8_layer(rng, 6, 40, 24)
    wq, ws = jquant.quantize_channels(jnp.asarray(w))
    got = ops.dense_matmul_q8(torch.from_numpy(h),
                              pack_weight(torch.from_numpy(np.array(wq))),
                              torch.from_numpy(np.array(ws)),
                              torch.from_numpy(bias))
    assert seen == [(6, 40)]
    np.testing.assert_array_equal(got.numpy(),
                                  ref_layer(h, w, bias, True, "jnp"))


# ---------------------------------------------------------------------------
# K12's plain version == the reference's int8 dense layer, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("b,fan_in,fan_out", [
    (1, 1, 1), (4, 16, 8), (32, 80, 96), (33, 7, 5),
])
def test_dense_matmul_q8_bitwise_vs_reference(relu, b, fan_in, fan_out):
    rng = np.random.default_rng(b * 101 + fan_in)
    h, w, bias = q8_layer(rng, b, fan_in, fan_out)
    got = port_layer(h, w, bias, relu)
    np.testing.assert_array_equal(got, ref_layer(h, w, bias, relu, "jnp"))
    np.testing.assert_array_equal(
        got, ref_layer(h, w, bias, relu, "pallas", interpret=True))


@pytest.mark.parametrize("relu", [True, False])
def test_dense_matmul_q8_sum_above_2_24_is_exact(relu):
    """Codes of ±127 everywhere at fan_in 1152: |acc| reaches 127² · 1152
    = 18,580,608 > 2**24, where an fp32 sum of the products would round."""
    rng = np.random.default_rng(2)
    b, fan_in, fan_out = 8, 1152, 24
    h = (rng.choice([-1.0, 1.0], size=(b, fan_in))
         * rng.uniform(0.5, 2.0, size=(b, 1))).astype(np.float32)
    w = (rng.choice([-1.0, 1.0], size=(fan_in, fan_out))
         * rng.uniform(0.01, 0.1, size=fan_out)).astype(np.float32)
    w[:, 0] = np.abs(w[:, 0]) * np.sign(h[0])    # row 0 x col 0: all +
    w[:, 1] = -np.abs(w[:, 1]) * np.sign(h[1])   # row 1 x col 1: all -
    bias = rng.normal(size=(fan_out,)).astype(np.float32)
    hscale = quant.absmax_scale(torch.from_numpy(h))
    hq = quant.quantize(torch.from_numpy(h), hscale)
    wq, ws = quant.quantize_channels(torch.from_numpy(w))
    assert bool((hq.abs() == 127).all()) and bool((wq.abs() == 127).all())
    acc = hq.long() @ wq.long()
    assert int(acc[0, 0]) == 127 * 127 * fan_in > 2**24
    assert int(acc[1, 1]) == -127 * 127 * fan_in
    got = port_layer(h, w, bias, relu)
    np.testing.assert_array_equal(got, ref_layer(h, w, bias, relu, "jnp"))
    np.testing.assert_array_equal(
        got, ref_layer(h, w, bias, relu, "pallas", interpret=True))
    # the epilogue on the exact sum; an fp32 sum would be off here
    want00 = np.float32(np.float64(np.float32(np.float32(acc[0, 0].item())
                                              * hscale[0, 0].item()))
                        * np.float64(ws[0, 0].item())
                        + np.float64(bias[0]))
    assert got[0, 0] == (max(want00, 0.0) if relu else want00)


@pytest.mark.parametrize("relu", [True, False])
def test_dense_matmul_q8_error_bound_vs_fp32(relu):
    """Within the grid-step budget of the fp32 layer, as the reference's
    test bounds it (``tests/test_kernels.py:537``)."""
    rng = np.random.default_rng(7)
    b, fan_in, fan_out = 16, 64, 32
    h, w, bias = q8_layer(rng, b, fan_in, fan_out)
    exact = h @ w + bias[None, :]
    if relu:
        exact = np.maximum(exact, 0.0)
    got = port_layer(h, w, bias, relu)
    hs = quant.absmax_scale(torch.from_numpy(h)).numpy()
    ws = quant.quantize_channels(torch.from_numpy(w))[1].numpy()
    habs, wabs = np.abs(h), np.abs(w)
    bound = (habs @ (np.ones_like(wabs) * ws) * 0.5
             + (np.ones_like(habs) * hs) @ wabs * 0.5
             + fan_in * hs * ws * 0.25) + 1e-5
    assert np.all(np.abs(got - exact) <= bound)


def test_dmm_q8_checks_its_inputs():
    rng = np.random.default_rng(3)
    hq = torch.from_numpy(rng.integers(-127, 128, size=(4, 16)).astype(np.int8))
    wq_t = torch.from_numpy(rng.integers(-127, 128, size=(8, 16)).astype(np.int8))
    hs, ws, b = torch.ones((4, 1)), torch.ones((1, 8)), torch.zeros((1, 8))
    assert torch.equal(dmm_q8(hq, hs, wq_t, ws, b),
                       dmm_q8_plain(hq, hs, wq_t, ws, b))
    assert dmm_q8.launches == 0                    # CPU: no kernel launch
    with pytest.raises(ValueError):
        dmm_q8(hq, hs, wq_t[:, :15].contiguous(), ws, b)
    with pytest.raises(ValueError):
        dmm_q8(hq, hs, wq_t.t(), ws, b)            # not contiguous
    with pytest.raises(ValueError):
        dmm_q8(hq, hs[:3], wq_t, ws, b)
    with pytest.raises(TypeError):
        dmm_q8(hq.float(), hs, wq_t, ws, b)
    assert MAX_FAN_IN * 127 * 127 < 2**31 <= (MAX_FAN_IN + 1) * 127 * 127
    assert "dmm_q8" in KERNELS


@pytest.mark.parametrize("b,fan_in,fan_out", [(33, 7, 5), (1, 1, 1)])
def test_pad_k_keeps_the_int32_sum(b, fan_in, fan_out):
    """The wrapper's padding (rows of 16 bytes for the kernel's TMA
    copies): zero columns past K leave the layer unchanged, bitwise."""
    rng = np.random.default_rng(b + fan_in)
    hq = torch.from_numpy(rng.integers(-127, 128, size=(b, fan_in))
                          .astype(np.int8))
    wq_t = torch.from_numpy(rng.integers(-127, 128, size=(fan_out, fan_in))
                            .astype(np.int8))
    hs = torch.from_numpy(rng.uniform(0.01, 1, size=(b, 1))
                          .astype(np.float32))
    ws = torch.from_numpy(rng.uniform(0.01, 1, size=(1, fan_out))
                          .astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(1, fan_out)).astype(np.float32))
    hp, wp = pad_k(hq, 16), pad_k(wq_t, 16)
    assert tuple(hp.shape) == (b, 16) and tuple(wp.shape) == (fan_out, 16)
    assert hp.is_contiguous() and hp.data_ptr() % 16 == 0
    assert not hp[:, fan_in:].any() and torch.equal(hp[:, :fan_in], hq)
    for relu in (True, False):
        assert torch.equal(dmm_q8_plain(hp, hs, wp, ws, bias, relu=relu),
                           dmm_q8_plain(hq, hs, wq_t, ws, bias, relu=relu))
    assert pad_k(hp, 16) is hp                       # already as TMA takes it
    view = torch.zeros(3 + b * 16, dtype=torch.int8)[3:].view(b, 16)
    assert view.data_ptr() % 16 != 0 and pad_k(view, 16) is not view


# ---------------------------------------------------------------------------
# int8 plans against the reference's
# ---------------------------------------------------------------------------

def model_pair(name, seed=0, hidden=64):
    kw = dict(SPEC_KW, hidden=hidden)
    jmodel = JAX_MODELS[name](jax_ctr_spec(name, "criteo", **kw))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = load_jax_params(
        CTR_MODELS[name](ctr_spec(name, "criteo", **kw), device="cpu"),
        jparams)
    return jmodel, jparams, model


@pytest.mark.parametrize("model_name", list(CTR_MODELS))
def test_int8_plans_match_reference_at_every_level(model_name):
    """The reference's op-by-op levels run jitted per op, as its plans do:
    with jit off its epilogue rounds the product and the add separately."""
    jmodel, jparams, model = model_pair(model_name)
    ids = sample_ids(SCHEMA, 32, seed=11)
    for level in LEVELS:
        jplan = jax_compile_plan(jmodel, jparams, level, 32,
                                 compute_dtype="int8")
        want = np.asarray(jplan(jnp.asarray(ids)))
        plan = compile_plan(model, level, 32, device="cpu",
                            compute_dtype="int8")
        got = plan(torch.from_numpy(ids)).numpy()
        assert got.shape == want.shape == (32, 1)
        np.testing.assert_allclose(got, want, **LADDER_TOL,
                                   err_msg=f"{model_name}/{level}")
        assert plan.stats.queue == jplan.stats.queue
        for field in ("compute_dtype", "mlp_quant_matmuls",
                      "mlp_quant_weight_bytes",
                      "mlp_quant_weight_bytes_saved", "n_ops_before",
                      "n_ops_after", "n_fused_groups"):
            assert getattr(plan.stats, field) == getattr(jplan.stats, field), \
                field
        assert plan.key.compute_dtype == jplan.key.compute_dtype == "int8"


@pytest.mark.parametrize("model_name", list(CTR_MODELS))
def test_int8_plan_scores_close_to_fp32(model_name):
    _, _, model = model_pair(model_name)
    ids = sample_ids(SCHEMA, 16, seed=5)
    p32 = compile_plan(model, "dual", 16, device="cpu")
    p8 = compile_plan(model, "dual", 16, device="cpu", compute_dtype="int8")
    assert p32.key != p8.key
    s32, s8 = p32.predict(ids), p8.predict(ids)
    assert 0 < float(np.abs(s32 - s8).max()) < Q8_SCORE_GATE


def test_compute_dtype_is_plan_identity():
    _, _, model = model_pair("dcn")
    k32 = plan_key_for(model, "dual", 16)
    k8 = plan_key_for(model, "dual", 16, compute_dtype="int8")
    assert k32 != k8
    assert k32.compute_dtype == "fp32" and k8.compute_dtype == "int8"
    assert set(COMPUTE_DTYPES) == {"fp32", "int8"}
    plan = compile_plan(model, "dual", 16, device="cpu", compute_dtype="int8")
    assert plan.key == k8 and plan.stats.compute_dtype == "int8"


def test_unknown_compute_dtype_raises():
    _, _, model = model_pair("dcn")
    with pytest.raises(ValueError, match="compute_dtype"):
        compile_plan(model, "dual", 16, device="cpu", compute_dtype="int4")
    with pytest.raises(ValueError, match="compute_dtype"):
        model.build_graph("dual", compute_dtype="bf16")


def test_int8_plan_stats_counters():
    _, _, model = model_pair("widedeep")
    st = compile_plan(model, "dual", 16, device="cpu",
                      compute_dtype="int8").stats
    assert st.compute_dtype == "int8" and st.mlp_quant_matmuls == 3
    fp32_bytes = st.mlp_quant_weight_bytes + st.mlp_quant_weight_bytes_saved
    assert fp32_bytes / st.mlp_quant_weight_bytes >= 3.5
    st32 = compile_plan(model, "dual", 16, device="cpu").stats
    assert st32.compute_dtype == "fp32"
    assert st32.mlp_quant_matmuls == st32.mlp_quant_weight_bytes == 0


def test_full_width_mlp_counters():
    """DCNv2's full-width MLP (1248 -> 1024 -> 1024 -> 1024): the weight
    bytes ``chip_smoke.py`` checks on the card, 3.99x below fp32."""
    layers = mlp_layers((1248, 1024, 1024, 1024), device=torch.device("cpu"),
                        dtype=torch.float32)
    for layer in layers:
        layer.reset_parameters(torch.Generator().manual_seed(0))
    g = OpGraph(["x"])
    out = emit_mlp_ops(g, layers, "x", "implicit", prefix="deep",
                       final_act=True, compute_dtype="int8")
    assert out == "deep_a2" and [op.name for op in g.ops] == \
        ["deep_q8gemm0", "deep_q8gemm1", "deep_q8gemm2"]
    assert all(op.is_gemm for op in g.ops)
    assert g.meta == {"compute_dtype": "int8", "mlp_quant_matmuls": 3,
                      "mlp_quant_weight_bytes": 3_387_392,
                      "mlp_quant_weight_bytes_saved": 10_113_024}


# ---------------------------------------------------------------------------
# the full int8 stack: int8 rows + int8 compute across refresh and deltas
# ---------------------------------------------------------------------------

def cached_pair(row_dtype, capacity=64):
    jspec = jax_ctr_spec("dcnv2", "criteo", **SPEC_KW)
    jstore = JaxCachedStore(jspec.embedding_spec(), capacity=capacity,
                            row_dtype=row_dtype)
    jmodel = JAX_MODELS["dcnv2"](jspec, store=jstore)
    pc = jmodel.init(jax.random.PRNGKey(0))
    spec = ctr_spec("dcnv2", "criteo", **SPEC_KW)
    model = load_jax_params(CTR_MODELS["dcnv2"](spec, CachedStore(
        spec.embedding_spec(), capacity, row_dtype, device="cpu")), pc)
    return jmodel, jstore, pc, model


def test_cached_int8_stack_serves_refresh_and_deltas_without_rebuild():
    jmodel, jstore, pc, model = cached_pair("int8")
    store = model.embedding.store
    plan = compile_plan(model, "dual", 16, device="cpu",
                        runtime_provider=model.store_runtime_env,
                        compute_dtype="int8")
    assert plan.key.compute_dtype == "int8" and "int8" in plan.key.store
    ids = sample_ids(SCHEMA, 16, seed=3, skew="zipf")
    first = plan.predict(ids)
    model.embedding.observe(ids)
    jmodel.embedding.observe(ids)
    store.refresh()
    pc = {**pc, "emb": jstore.refresh(pc["emb"])}
    np.testing.assert_array_equal(plan.predict(ids), first)   # refresh: same
    rng = np.random.default_rng(0)
    rows = np.unique(ids[:4] + SCHEMA_OFFSETS[None, :])
    vals = rng.normal(size=(rows.size, 8)).astype(np.float32) * 0.05
    store.apply_deltas(rows, vals)
    emb, _ = jstore.apply_deltas(pc["emb"], rows, vals)
    pc = {**pc, "emb": emb}
    got = plan.predict(ids)
    want = jax_compile_plan(jmodel, pc, "dual", 16,
                            compute_dtype="int8").predict(ids)
    np.testing.assert_allclose(got, want, **LADDER_TOL)
    assert not np.array_equal(got[:4], first[:4])
    np.testing.assert_array_equal(
        got, compile_plan(model, "dual", 16, device="cpu",
                          compute_dtype="int8").predict(ids))
    assert store.stats.refreshes == 1


def test_fp32_rows_int8_compute_is_bitwise_a_dense_plan():
    """A store is a memory choice: fp32 cached rows under int8 compute give
    the dense store's int8-compute scores bitwise, deltas included."""
    _, _, dense = model_pair("dcnv2")
    model = cached_pair(None)[3]                   # the same key, so the
    assert torch.equal(dense.embedding.dense_view(),       # same weights
                       model.embedding.store.backing)
    plans = [compile_plan(m, "dual", 16, device="cpu",
                          runtime_provider=m.store_runtime_env,
                          compute_dtype="int8") for m in (dense, model)]
    ids = sample_ids(SCHEMA, 16, seed=8)
    model.embedding.observe(ids)
    model.embedding.store.refresh()
    rows = np.unique(ids[:3] + SCHEMA_OFFSETS[None, :])
    vals = np.random.default_rng(1).normal(size=(rows.size, 8)).astype(
        np.float32) * 0.05
    model.embedding.store.apply_deltas(rows, vals)
    dense.embedding.store.mega_table.index_copy_(
        0, torch.from_numpy(rows), torch.from_numpy(vals))
    a, b = (p.predict(ids) for p in plans)
    np.testing.assert_array_equal(a, b)

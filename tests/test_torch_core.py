"""repro_torch core: fusion and Alg.-2 schedules equal the reference's name
for name, plans pad and reject like the reference's, the port's own level
ladder holds, the package never imports JAX, and it never moves to the
CPU on its own.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ctr_spec as jax_ctr_spec  # noqa: E402
from repro.core import DualParallelExecutor as JaxExecutor  # noqa: E402
from repro.core import Op as JaxOp  # noqa: E402
from repro.core.scheduler import (  # noqa: E402
    breadth_first_schedule as jax_breadth_first)
from repro.models.ctr import CTR_MODELS as JAX_MODELS  # noqa: E402
from repro_torch.bridge import load_jax_params  # noqa: E402
from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.core import (BRANCH_ORDERS, LEVELS,  # noqa: E402
                              DualParallelExecutor, Op, breadth_first_schedule,
                              compile_plan)
from repro_torch.data import CRITEO, SKEWS, sample_ids  # noqa: E402
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SCHEMA = CRITEO.scaled(2_000)
SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_000)
CPU = torch.device("cpu")


def make_pair(model_name):
    jmodel = JAX_MODELS[model_name](jax_ctr_spec(model_name, "criteo",
                                                 **SPEC_KW))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = CTR_MODELS[model_name](ctr_spec(model_name, "criteo", **SPEC_KW),
                                   device="cpu")
    return jmodel, jparams, load_jax_params(model, jparams)


def _mask_ids(names):
    """DCN's hints carry ``id(model)`` — equal only up to that number."""
    return tuple(re.sub(r"dcn_v1_tail_\d+_", "dcn_v1_tail_ID_", n)
                 for n in names)


# ---------------------------------------------------------------------------
# executor bookkeeping == reference, name for name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_name", list(CTR_MODELS))
def test_executor_stats_match_reference(model_name):
    jmodel, jparams, model = make_pair(model_name)
    runs = [(level, "longer_first") for level in LEVELS] + \
        [("dual", order) for order in BRANCH_ORDERS[1:]]
    for level, order in runs:
        jex = JaxExecutor(jmodel.build_graph, level=level, branch_order=order)
        jgraph, jorder = jex.prepare(jparams)
        ex = DualParallelExecutor(model.build_graph, level=level,
                                  branch_order=order)
        graph, porder = ex.prepare()
        want, got = jex.stats, ex.stats
        msg = f"{model_name}/{level}/{order}"
        assert got.queue == want.queue, msg
        assert porder == jorder, msg
        assert got.n_ops_before == want.n_ops_before, msg
        assert got.n_ops_after == want.n_ops_after, msg
        assert got.n_fused_groups == want.n_fused_groups, msg
        assert got.schedule_policy == want.schedule_policy, msg
        assert _mask_ids(got.kernels_used) == _mask_ids(want.kernels_used), msg
        assert [op.module for op in graph.ops] == \
            [op.module for op in jgraph.ops], msg


@pytest.mark.parametrize("ne,ni", [(3, 3), (2, 4), (4, 2), (0, 3)])
def test_breadth_first_schedule_matches_reference(ne, ni):
    def ops(op_cls, prefix, n, module):
        return [op_cls(f"{prefix}{i}", lambda x: x, ("in",), f"{prefix}o{i}",
                       module=module) for i in range(n)]
    for first in ("longer", "shorter", "explicit", "implicit"):
        got = breadth_first_schedule(ops(Op, "e", ne, "explicit"),
                                     ops(Op, "i", ni, "implicit"),
                                     first=first)
        want = jax_breadth_first(ops(JaxOp, "e", ne, "explicit"),
                                 ops(JaxOp, "i", ni, "implicit"),
                                 first=first)
        assert got.queue == want.queue, first
        assert {k: s.ops for k, s in got.streams.items()} == \
            {k: s.ops for k, s in want.streams.items()}
    with pytest.raises(ValueError):
        breadth_first_schedule([], [], first="sideways")


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_name", list(CTR_MODELS))
def test_level_ladder_is_numerically_invariant(model_name):
    """Paper Table I on the port: every level computes the same logits."""
    _, _, model = make_pair(model_name)
    ids = torch.from_numpy(sample_ids(SCHEMA, 64, seed=1))
    outs = {}
    for level in LEVELS:
        step = DualParallelExecutor(model.build_graph, level=level).build(CPU)
        outs[level] = step({"ids": ids}).numpy()
    for level, out in outs.items():
        np.testing.assert_allclose(out, outs["naive"], rtol=1e-5, atol=1e-6,
                                   err_msg=level)
    np.testing.assert_allclose(model(ids).numpy(), outs["naive"],
                               rtol=1e-5, atol=1e-6)


def test_plan_predict_pads_and_rejects_oversize():
    _, _, model = make_pair("dcnv2")
    plan = compile_plan(model, "dual", 8, device="cpu")
    ids = sample_ids(SCHEMA, 8, seed=0)
    full = plan.predict(ids)
    assert full.shape == (8,) and np.all((full > 0) & (full < 1))
    np.testing.assert_allclose(plan.predict(ids[:3]), full[:3],
                               rtol=1e-6, atol=1e-6)
    one = plan.predict(ids[0])                   # (k,) row accepted
    np.testing.assert_allclose(one, full[:1], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        plan.predict(np.concatenate([ids, ids]))


@pytest.mark.parametrize("model_name", list(CTR_MODELS))
def test_model_compile_matches_the_reference(model_name):
    """``model.compile(...)`` delegates to ``compile_plan`` as the
    reference's does: the plan's scores equal the reference's
    ``model.compile(params, batch_size=8).predict(ids)`` on the same
    parameters (tests/test_plan.py:87's tolerance), and a plan through
    ``compile_plan`` bitwise."""
    jmodel, jparams, model = make_pair(model_name)
    ids = sample_ids(SCHEMA, 8, seed=2)
    plan = model.compile(batch_size=8, device="cpu")
    assert (plan.level, plan.batch_size) == ("dual", 8)
    got = plan.predict(ids)
    np.testing.assert_allclose(
        got, jmodel.compile(jparams, batch_size=8).predict(ids),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        got, compile_plan(model, "dual", 8, device="cpu").predict(ids))


def test_plan_captures_schedule_and_stats():
    _, _, model = make_pair("dcnv2")
    plan = compile_plan(model, "dual", 16, device="cpu")
    assert plan.stats.schedule_policy == "breadth_first"
    assert plan.batch_size == 16 and plan.level == "dual"
    assert plan.graph.is_valid_order(list(plan.order))
    assert plan.compile_ms > 0 and plan.runtime_inputs == ()
    assert plan.key.model == model.spec.name
    assert plan.stats.embedding_store == model.embedding.store.describe()


def test_plan_invalid_level_and_order_rejected():
    _, _, model = make_pair("dcn")
    with pytest.raises(ValueError):
        compile_plan(model, "warp", 8, device="cpu")
    with pytest.raises(ValueError):
        compile_plan(model, "dual", 8, device="cpu", branch_order="sideways")
    with pytest.raises(ValueError):
        DualParallelExecutor(model.build_graph, branch_order="random")


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_never_imports_jax_or_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    names = {path.relative_to(REPO).as_posix() for path in files}
    assert {f"src/repro_torch/{m}.py" for m in (
        "training/__init__", "training/metrics", "training/optimizer",
        "training/checkpoint", "training/train_loop", "data/pipeline",
        "kernels/autograd", "launch/train_ctr", "distributed/__init__",
        "distributed/mesh", "distributed/sharding",
        "training/compression", "launch/mesh", "launch/steps",
        "analysis/__init__", "analysis/hw", "analysis/analytic",
        "analysis/roofline", "launch/dryrun")} <= names
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_readme_port_snippet_runs():
    """The README's port snippet is skipped by the docs test (the JAX CI
    has no PyTorch); it runs here instead."""
    lines = (REPO / "README.md").read_text().splitlines()
    start = lines.index("## The PyTorch/CUDA port (`repro_torch`)")
    begin = lines.index("```python", start) + 1
    end = lines.index("```", begin)
    exec(compile("\n".join(lines[begin:end]), "README.md", "exec"), {})


def test_entry_points_never_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ctr_spec("dcnv2", "criteo", **SPEC_KW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CTR_MODELS["dcnv2"](spec)
    model = CTR_MODELS["dcnv2"](spec, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compile_plan(model, "dual", 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compile_plan(model, "dual", 8, device="cuda")


def test_compile_plan_rejects_a_model_on_another_device(monkeypatch):
    model = CTR_MODELS["dcn"](ctr_spec("dcn", "criteo", **SPEC_KW),
                              device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="model lives on cpu"):
        compile_plan(model, "dual", 8, device="cuda")
    with pytest.raises(ValueError):
        CTR_MODELS["dcn"](model.spec, device="meta")


def test_bridge_rejects_a_mismatched_tree():
    jmodel, jparams, model = make_pair("widedeep")
    with pytest.raises(KeyError):
        load_jax_params(model, {**jparams, "extra": np.zeros(3)})
    with pytest.raises(ValueError):
        load_jax_params(model, {k: v for k, v in jparams.items()
                                if k != "wide_bias"})
    with pytest.raises(ValueError):
        load_jax_params(model, {**jparams, "wide_bias": np.zeros(2)})


def test_own_init_draws_the_reference_distributions():
    spec = ctr_spec("dcn", "criteo", **SPEC_KW)
    model = CTR_MODELS["dcn"](spec, device="cpu").init(
        torch.Generator().manual_seed(0))
    table = model.embedding.dense_view()
    zero_row = model.embedding.spec.zero_row
    assert torch.all(table[zero_row:] == 0)
    assert abs(table[:zero_row].std().item() - 0.05) < 2e-3
    w = model.mlp[0].w
    assert abs(w.std().item() - np.sqrt(2.0 / sum(w.shape))) < 2e-3
    assert torch.all(model.mlp[0].b == 0)
    cw = model.cross[0].w
    assert abs(cw.std().item() - 1 / np.sqrt(spec.input_dim)) < 0.01
    again = CTR_MODELS["dcn"](spec, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert torch.equal(again.embedding.dense_view(), table)


def test_full_width_config_of_record():
    spec = ctr_spec("dcnv2", "criteo", embed_dim=32, hidden=1024)
    assert spec.k == 39 and spec.input_dim == 1248
    assert spec.embedding_spec().rows == 6_648_548
    assert spec.hidden == (1024, 1024, 1024) and spec.cross_layers == 3


@pytest.mark.parametrize("skew", SKEWS)
def test_sample_ids_in_range_and_seeded(skew):
    a = sample_ids(CRITEO, 512, step=3, skew=skew)
    assert a.shape == (512, 39) and a.dtype == np.int32
    assert np.all(a >= 0) and np.all(a < np.asarray(CRITEO.field_sizes))
    assert np.array_equal(a, sample_ids(CRITEO, 512, step=3, skew=skew))
    assert not np.array_equal(a, sample_ids(CRITEO, 512, step=4, skew=skew))

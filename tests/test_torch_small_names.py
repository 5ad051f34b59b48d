"""Five small public names of the reference that the port carries:
``data.make_schema``, ``models.ctr.make_ctr_model``, ``CTRModel.n_params``,
``FusedEmbeddingSpec.n_params`` and ``Schedule.stream_of``, each equal to
the reference's on the same inputs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ctr_spec as jax_ctr_spec  # noqa: E402
from repro.core import Op as JaxOp  # noqa: E402
from repro.core.scheduler import (  # noqa: E402
    breadth_first_schedule as jax_breadth_first)
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models.ctr import make_ctr_model as jax_make_ctr_model  # noqa: E402
from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.core import Op, breadth_first_schedule  # noqa: E402
from repro_torch.data import make_schema  # noqa: E402
from repro_torch.models.ctr import CTR_MODELS, make_ctr_model  # noqa: E402

SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_000)


@pytest.mark.parametrize("k,n,seed", [(1, 1, 0), (26, 1000, 0),
                                      (100, 50_000, 3)])
def test_make_schema_equals_the_reference(k, n, seed):
    got = make_schema("sweep", k, n, seed=seed)
    want = jsyn.make_schema("sweep", k, n, seed=seed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.k == want.k == k


@pytest.mark.parametrize("name", list(CTR_MODELS))
def test_make_ctr_model_and_n_params_equal_the_reference(name):
    spec = ctr_spec(name, "criteo", **SPEC_KW)
    model = make_ctr_model(name, spec, device="cpu")
    assert type(model) is CTR_MODELS[name] and model.spec == spec
    jmodel = jax_make_ctr_model(name, jax_ctr_spec(name, "criteo", **SPEC_KW))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    assert model.n_params(model.param_tree()) == jmodel.n_params(jparams)
    assert model.n_params(model.tensor_tree()) == jmodel.n_params(jparams)


@pytest.mark.parametrize("pad_rows_to", [1, 64])
@pytest.mark.parametrize("name", ["dcnv2", "deepfm"])
def test_embedding_spec_n_params_equals_the_reference(name, pad_rows_to):
    """The mega-table's elements (rows padded to ``pad_rows_to``, and the
    zero row), for the main and the wide/FM table."""
    got = ctr_spec(name, "criteo", **SPEC_KW)
    want = jax_ctr_spec(name, "criteo", **SPEC_KW)
    for g, w in ((got.embedding_spec(), want.embedding_spec()),
                 (got.wide_spec(), want.wide_spec())):
        g = dataclasses.replace(g, pad_rows_to=pad_rows_to)
        w = dataclasses.replace(w, pad_rows_to=pad_rows_to)
        assert g.n_params == w.n_params == g.rows * g.dim


def test_schedule_stream_of_equals_the_reference():
    def ops(op_cls, prefix, n, module):
        return [op_cls(f"{prefix}{i}", lambda x: x, ("in",), f"{prefix}o{i}",
                       module=module) for i in range(n)]
    got = breadth_first_schedule(ops(Op, "e", 3, "explicit"),
                                 ops(Op, "i", 2, "implicit"))
    want = jax_breadth_first(ops(JaxOp, "e", 3, "explicit"),
                             ops(JaxOp, "i", 2, "implicit"))
    for name in want.queue:
        assert got.stream_of(name) == want.stream_of(name)
    assert {got.stream_of(n) for n in got.queue} == set(got.streams)
    for sched in (got, want):
        with pytest.raises(KeyError):
            sched.stream_of("absent")
    assert np.all([got.stream_of(f"e{i}") != got.stream_of("i0")
                   for i in range(3)])

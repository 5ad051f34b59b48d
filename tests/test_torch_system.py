"""The whole slice against the reference: the same parameters (the
reference's ``init`` through ``repro_torch.bridge``) and the same numpy
ids through the reference's ``compile_plan`` and the port's, at every
level, for every CTR model.

Logits agree at ``rtol=atol=1e-5``: the two packages multiply through
different CPU BLAS libraries. The reference's op-by-op levels run with
jit disabled — the same ops, dispatched primitive by primitive — which
skips some sixty one-off compiles per plan.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ctr_spec as jax_ctr_spec  # noqa: E402
from repro.core import compile_plan as jax_compile_plan  # noqa: E402
from repro.models.ctr import CTR_MODELS as JAX_MODELS  # noqa: E402
from repro_torch.bridge import load_jax_params  # noqa: E402
from repro_torch.configs import ctr_spec  # noqa: E402
from repro_torch.core import LEVELS, compile_plan  # noqa: E402
from repro_torch.data import CRITEO, sample_ids  # noqa: E402
from repro_torch.models.ctr import CTR_MODELS  # noqa: E402

SCHEMA = CRITEO.scaled(2_000)
SPEC_KW = dict(embed_dim=8, hidden=64, max_field=2_000)


@pytest.mark.parametrize("model_name", list(CTR_MODELS))
def test_logits_match_reference_at_every_level(model_name):
    jmodel = JAX_MODELS[model_name](jax_ctr_spec(model_name, "criteo",
                                                 **SPEC_KW))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = CTR_MODELS[model_name](ctr_spec(model_name, "criteo", **SPEC_KW),
                                   device="cpu")
    load_jax_params(model, jparams)
    ids = sample_ids(SCHEMA, 32, seed=11)
    for level in LEVELS:
        if level == "dual":
            jplan = jax_compile_plan(jmodel, jparams, level, 32)
            want = np.asarray(jplan(jax.numpy.asarray(ids)))
        else:
            with jax.disable_jit():
                jplan = jax_compile_plan(jmodel, jparams, level, 32)
                want = np.asarray(jplan(jax.numpy.asarray(ids)))
        plan = compile_plan(model, level, 32, device="cpu")
        got = plan(torch.from_numpy(ids)).numpy()
        assert got.shape == want.shape == (32, 1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{model_name}/{level}")
        assert plan.stats.queue == jplan.stats.queue


@pytest.mark.parametrize("model_name", ["deepfm", "widedeep"])
def test_scores_match_reference_predict(model_name):
    """``predict`` end to end, partial batch included."""
    jmodel = JAX_MODELS[model_name](jax_ctr_spec(model_name, "criteo",
                                                 **SPEC_KW))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = load_jax_params(
        CTR_MODELS[model_name](ctr_spec(model_name, "criteo", **SPEC_KW),
                               device="cpu"), jparams)
    ids = sample_ids(SCHEMA, 13, seed=2, skew="zipf")
    want = jax_compile_plan(jmodel, jparams, "dual", 16).predict(ids)
    got = compile_plan(model, "dual", 16, device="cpu").predict(ids)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

"""repro_torch's cell builder (``launch/steps.py``) and
``configs.input_specs`` against the reference's on the CPU.

* ``input_specs`` of the ten archs × four shapes: keys, shapes, dtypes.
* A ``Cell``'s policy, microbatch count, optimizer-state dtype and spec
  trees (parameters through the stacking map, optimizer state, inputs)
  equal the reference's ``Cell`` built on the same mesh (the reference
  reads only its axis names and sizes), on (2, 2), (2, 4) and both
  production meshes, at published shapes (the port's model on ``meta``).
* ``train_step_fn`` with 1, 2 and 4 microbatches against the reference's
  jitted step on a 1-device mesh: the loss and every leaf of the state
  after two steps within ``rtol 1e-4, atol 1e-5``.
* ``prefill_fn`` and ``decode_fn`` of all ten reduced archs against the
  reference's cells on its own 8-device (2, 4) mesh (this file re-run as
  a script with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
  once for every case): logits within ``rtol 1e-4, atol 1e-5``, greedy
  tokens equal, decode steps across the sequence shards' boundaries.
* ``lower()`` traces each kind of reduced qwen3-4b on ``meta`` tensors.
"""

import json
import os
import sys

if __name__ == "__main__":      # the subprocess: 8 host devices for JAX
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import subprocess  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.compat import make_mesh as jax_make_mesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.training.optimizer import adamw_init as jax_adamw_init  # noqa: E402
from repro_torch.bridge import load_lm_params, stacked_lm_tree  # noqa: E402
from repro_torch.distributed import Placed, make_mesh  # noqa: E402
from repro_torch.launch.steps import Cell, build_cell  # noqa: E402
from repro_torch.training import adamw_init  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STACKED = ("layers", "mamba", "encoder", "decoder")


@contextlib.contextmanager
def patched(arch: str, shapes: dict, **overrides):
    """Both packages' ``arch`` config reduced (with ``overrides``) and
    ``SHAPES`` cut to ``shapes`` {name: (seq, batch)} while inside."""
    mods = [importlib.import_module(f"{pkg.__name__}.{pkg._ARCH_MODULES[arch]}")
            for pkg in (JC, TC)]
    saved = [m.CONFIG for m in mods]
    saved_shapes = [dict(pkg.SHAPES) for pkg in (JC, TC)]
    try:
        for m in mods:
            m.CONFIG = m.CONFIG.reduced(**overrides)
        for pkg in (JC, TC):
            for name, (seq, batch) in shapes.items():
                pkg.SHAPES[name] = pkg.ShapeCell(name, seq, batch,
                                                 pkg.SHAPES[name].kind)
        yield
    finally:
        for m, cfg in zip(mods, saved):
            m.CONFIG = cfg
        for pkg, old in zip((JC, TC), saved_shapes):
            pkg.SHAPES.clear()
            pkg.SHAPES.update(old)


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def flat_jax(tree, is_leaf=None) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {tuple(_key(k) for k in path): leaf for path, leaf in flat}


def flat_port(tree, path=(), stacked=True) -> dict:
    """{reference path: leaf, or the list of a stacked group's layers}."""
    out: dict = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_port(v, path + (k,), stacked))
    elif isinstance(tree, list) and stacked:
        for v in tree:
            for p, leaf in flat_port(v, path).items():
                out.setdefault(p, []).append(leaf)
    else:
        out[path] = tree
    return out


def same_specs(port_tree, jax_tree):
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa
    want = flat_jax(jax_tree, is_spec)
    got = flat_port(port_tree)
    assert set(got) == set(want)
    for path, spec in want.items():
        spec = tuple(spec)
        if path[0] in STACKED:
            assert all(tuple(s) == spec[1:] for s in got[path]), (path, spec)
        else:
            assert tuple(got[path]) == spec, (path, got[path], spec)


@pytest.mark.parametrize("arch", JC.ARCH_NAMES)
def test_input_specs_are_the_reference_specs(arch):
    for shape in JC.SHAPES:
        want = flat_jax(JC.input_specs(arch, shape))
        got = flat_port(TC.input_specs(arch, shape), stacked=False)
        assert set(got) == set(want), (shape, set(got) ^ set(want))
        for path, sds in want.items():
            leaf = got[path]
            if path[-1] == "index":
                assert leaf == 0 and sds.shape == () \
                    and sds.dtype == jnp.int32
                continue
            assert leaf.device.type == "meta", path
            assert tuple(leaf.shape) == sds.shape, (shape, path)
            assert leaf.dtype == getattr(torch, str(sds.dtype)), path


@pytest.fixture(scope="module")
def jax_cells():
    """The reference's ``Cell`` on the port's mesh, its ``eval_shape`` of
    ``init`` (the same abstract tree for every cell of one config)
    memoised per config: the test builds 160 cells."""
    memo: dict = {}
    real = jax.eval_shape

    def eval_shape(fn, *args, **kwargs):
        owner = fn.__closure__[0].cell_contents if fn.__closure__ else None
        cfg = getattr(getattr(owner, "model", None), "cfg", None)
        if not isinstance(owner, jsteps.Cell) or args or kwargs:
            return real(fn, *args, **kwargs)
        if cfg not in memo:
            memo[cfg] = real(fn)
        return memo[cfg]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "eval_shape", eval_shape)
        yield jsteps.Cell


@pytest.mark.parametrize("mesh_name", MESHES)
def test_cell_specs_policy_and_microbatches_are_the_reference_cell(
        mesh_name, jax_cells):
    shape, axes = MESHES[mesh_name]
    mesh = make_mesh(shape, axes, "meta")
    for arch in JC.ARCH_NAMES:
        for shape_name in JC.SHAPES:
            want = jax_cells(arch, shape_name, mesh)
            got = Cell(arch, shape_name, mesh, device="meta")
            tag = (arch, shape_name)
            assert got.policy == want.policy, tag
            assert got.n_micro == want.n_micro, tag
            # bf16 AdamW state above 30 B parameters, counted exactly:
            # the reference's jnp.prod of a shape is int32 and wraps for
            # phi3.5-moe's and llama4's expert stacks, so it keeps fp32
            # state for both (ROADMAP, reference caveats)
            n = sum(int(np.prod(x.shape, dtype=np.int64))
                    for x in jax.tree.leaves(want.param_shapes))
            wrapped = sum(int(jnp.prod(jnp.asarray(x.shape)))
                          for x in jax.tree.leaves(want.param_shapes))
            assert got.opt_cfg.state_dtype == (
                "bfloat16" if n > 30_000_000_000 else "float32"), tag
            assert want.opt_cfg.state_dtype == (
                "bfloat16" if wrapped > 30_000_000_000 else "float32"), tag
            assert (got.opt_cfg.state_dtype == want.opt_cfg.state_dtype) \
                == (arch not in WRAPPED_COUNT), tag
            assert got.opt_cfg.__dict__ == {
                **want.opt_cfg.__dict__,
                "state_dtype": got.opt_cfg.state_dtype}, tag
            assert (got.decode_ctx is None) == (
                getattr(want.model, "decode_ctx", None) is None), tag
            if got.decode_ctx is not None:
                assert got.decode_ctx.batch_axes \
                    == want.model.decode_ctx.batch_axes, tag
            same_specs(got.pspecs, want.pspecs)
            st, jst = got.state_specs(), want.state_specs()
            assert tuple(st.step) == tuple(jst.step) == ()
            for part in ("params", "m", "v"):
                same_specs(getattr(st, part), getattr(jst, part))
            got_in, want_in = got.input_shardspecs(), \
                want.input_shardspecs()
            assert set(got_in) == set(want_in), tag
            for key in got_in:
                is_spec = lambda s: isinstance(  # noqa: E731
                    s, jax.sharding.PartitionSpec)
                w = {p: tuple(s) for p, s in
                     flat_jax(want_in[key], is_spec).items()}
                g = {p: tuple(s) for p, s in
                     flat_port(got_in[key], stacked=False).items()}
                assert g == w, (tag, key)


#: archs whose parameter count the reference's int32 product wraps
WRAPPED_COUNT = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b")
TRAIN_ARCHS = ("qwen3-4b", "phi3.5-moe-42b-a6.6b", "whisper-small")
#: AdamW's eps in the train comparison. At the default 1e-8 the first
#: step is g / (|g| + eps), a sign: rounding noise on a gradient entry
#: near zero flips it (phi3.5-moe at n_micro 4: one ``wo`` entry of
#: layer 1, its m and v within 1e-9 of the reference's, lands 1.86e-5
#: apart). At 1e-3 the step is smooth in g for such entries, on both
#: cells alike.
TRAIN_EPS = 1e-3


def _train_batch(cfg, b: int, s: int):
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.normal(size=(b, s, cfg.d_model)) * 0.1
                           ).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_train_step_matches_the_reference_cell(arch, n_micro):
    with patched(arch, {"train_4k": (16, 8)}):
        jmesh = jax_make_mesh((1, 1), ("data", "model"))
        jcell = jsteps.Cell(arch, "train_4k", jmesh)
        cell = Cell(arch, "train_4k", make_mesh((1, 1), ("data", "model"),
                                                "cpu"))
        assert cell.policy == jcell.policy
        assert cell.opt_cfg.__dict__ == jcell.opt_cfg.__dict__
        jcell.n_micro = cell.n_micro = n_micro
        jcell.opt_cfg = dataclasses.replace(jcell.opt_cfg, eps=TRAIN_EPS)
        cell.opt_cfg = dataclasses.replace(cell.opt_cfg, eps=TRAIN_EPS)
        params = jcell.model.init(jax.random.PRNGKey(0))
        load_lm_params(cell.model, jax.tree.map(np.asarray, params))
        jstate = jax_adamw_init(params, jcell.opt_cfg)
        state = adamw_init(cell.model.param_tree(), cell.opt_cfg)
        batch = _train_batch(cell.cfg, 8, 16)
        jstep = jax.jit(jcell.train_step_fn())
        step = cell.train_step_fn()
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        for _ in range(2):
            with jmesh:
                jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
            state, m = step(state, tbatch)
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       **TOL)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), **TOL)
        assert int(state.step) == int(jstate.step) == 2
        for part in ("params", "m", "v"):
            got = flat_jax(stacked_lm_tree(getattr(state, part)))
            want = flat_jax(getattr(jstate, part))
            assert set(got) == set(want)
            for path, w in want.items():
                np.testing.assert_allclose(got[path], np.asarray(w),
                                           err_msg=f"{part} {path}", **TOL)


def test_train_step_refuses_a_batch_the_microbatches_do_not_cut():
    with patched("smollm-360m", {"train_4k": (8, 6)}):
        cell = Cell("smollm-360m", "train_4k",
                    make_mesh((1, 1), ("data", "model"), "cpu"))
        cell.n_micro = 4
        state = adamw_init(cell.model.param_tree(), cell.opt_cfg)
        with pytest.raises(ValueError, match="microbatches"):
            cell.train_step_fn()(state, {"tokens": torch.zeros(
                6, 8, dtype=torch.long)})


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, Placed):
        yield from tree._local.values()
    elif torch.is_tensor(tree):
        yield tree


@pytest.mark.parametrize("shape,kind", [("train_4k", "train"),
                                        ("prefill_32k", "prefill"),
                                        ("decode_32k", "decode")])
def test_lower_traces_each_kind_on_meta(shape, kind):
    """The reference's ``cell_lowering`` (tests/distributed_inner.py:
    100-116): reduced qwen3-4b with qk-norm at seq 64, batch 8 on a (2, 4)
    CPU mesh; ``lower()`` runs the step on ``meta`` tensors and returns
    only ``meta`` tensors, with the ops it dispatched."""
    with patched("qwen3-4b", {shape: (64, 8)}, qk_norm=True):
        cell = build_cell("qwen3-4b", shape,
                          make_mesh((2, 4), ("data", "model"), "cpu"))
        assert cell.model.device.type == "cpu"
        record, got_kind = cell.lower()
    assert got_kind == kind
    tensors = list(_tensors(record.outputs))
    assert tensors and all(t.device.type == "meta" for t in tensors)
    assert record.ops["bmm"] + record.ops["mm"] > 0
    assert record.n_ops == sum(record.ops.values()) and record.seconds > 0
    if kind == "decode":
        cache = record.outputs[1]
        assert isinstance(cache["k"], Placed) and cache["index"] == 1


# --- the reference's cells on its own 8-device mesh (subprocess) -------------

SUBPROCESS_CASES = tuple(JC.ARCH_NAMES)
PROMPT, S_MAX, N_IMG, N_FRAMES, STEPS = 6, 16, 2, 8, 6


def _prefill_inputs(cfg, rng):
    b = 4
    n_tok = PROMPT - (N_IMG if cfg.family == "vlm" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, n_tok)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(size=(b, N_FRAMES, cfg.d_model)) * 0.1
                         ).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.normal(size=(b, N_IMG, cfg.d_model))
                               * 0.02).astype(np.float32)
    return out


def _model_prefill(model, inputs, params=None):
    """The decode cells' starting cache: a prefill of ``PROMPT`` rows
    into an ``S_MAX``-slot cache (``N_FRAMES`` of memory for whisper)."""
    fam = model.cfg.family
    call = (lambda f, *a, **k: f(params, *a, **k)) if params is not None \
        else (lambda f, *a, **k: f(*a, **k))
    b = inputs["tokens"].shape[0]
    if fam == "encdec":
        cache = model.init_cache(b, S_MAX, N_FRAMES)
        return call(model.prefill, inputs["tokens"], inputs["frames"],
                    cache)
    cache = model.init_cache(b, 0 if fam == "ssm" else S_MAX)
    if fam == "vlm":
        return call(model.prefill, inputs["tokens"], cache,
                    patch_embeds=inputs["patch_embeds"])
    return call(model.prefill, inputs["tokens"], cache)


def _case(arch: str):
    """``prefill_fn`` and ``decode_fn`` of both packages' cells, the
    reference's on its (2, 4) mesh of host devices."""
    from repro.launch.mesh import make_test_mesh as jax_test_mesh
    jmesh = jax_test_mesh(2, 4)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    with patched(arch, {"prefill_32k": (PROMPT, 4),
                        "decode_32k": (S_MAX, 4)}):
        jpre = jsteps.build_cell(arch, "prefill_32k", jmesh)
        jdec = jsteps.build_cell(arch, "decode_32k", jmesh)
        pre = build_cell(arch, "prefill_32k", mesh)
        dec = build_cell(arch, "decode_32k", mesh)
        params = jpre.model.init(jax.random.PRNGKey(0))
        host = jax.tree.map(np.asarray, params)
        for cell in (pre, dec):
            load_lm_params(cell.model, host)
        assert (dec.decode_ctx is None) == (dec.cfg.family == "ssm")
        inputs = _prefill_inputs(pre.cfg, np.random.default_rng(5))
        tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
        jin = {k: jnp.asarray(v) for k, v in inputs.items()}
        with jmesh:
            jl, _ = jax.jit(jpre.prefill_fn())(params, jin)
        tl, _ = pre.prefill_fn()(tin)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert (tl.argmax(-1).numpy() == np.asarray(jl.argmax(-1))).all()

        jl, jcache = _model_prefill(jdec.model, jin, params)
        tl, cache = _model_prefill(dec.model, tin)
        jstep = jax.jit(jdec.decode_fn())
        step = dec.decode_fn()
        for _ in range(STEPS):
            nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
            assert (tl.argmax(-1).numpy() == nxt[:, 0]).all()
            with jmesh:
                jl, jcache = jstep(params, {"tokens": jnp.asarray(nxt),
                                            "cache": jcache})
            tl, cache = step({"tokens": torch.from_numpy(nxt),
                              "cache": cache})
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.fixture(scope="module")
def reference_run():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(repo, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", SUBPROCESS_CASES)
def test_prefill_and_decode_match_the_reference_cells_on_its_mesh(
        case, reference_run):
    assert reference_run[case] == "OK", reference_run[case]


if __name__ == "__main__":
    assert jax.device_count() == 8
    results = {}
    for name in SUBPROCESS_CASES:
        try:
            _case(name)
            results[name] = "OK"
        except Exception:   # reported per case by the parent test
            results[name] = traceback.format_exc()
    print(json.dumps(results))

"""repro_torch's LM mesh against the reference's on the CPU: the
logical-axis rules, the parameter and cache specs of all ten archs, the
``shard`` hook each family calls, ``flash_decode_sharded`` and the
sequence-parallel decode.

The reference's rule functions read only a mesh's axis names and sizes,
so they take the port's ``Mesh`` as they are. Parameter trees differ in
layout: the reference stacks a group's layers along a leading dim, the
port keeps a leaf a layer, so a port spec of ``layers/3/attn/wq`` is the
reference's spec of ``layers/attn/wq`` without its leading None.

``flash_decode_sharded`` is held to the reference's own ``shard_map`` on
its 8-device (2, 4) mesh: this file re-runs itself as a script with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set before JAX
loads (as ``tests/test_distributed.py`` runs its bodies), once for all
its cases; outputs within ``rtol 1e-5, atol 1e-6``, caches bitwise.
"""

import json
import os
import sys

if __name__ == "__main__":      # the subprocess: 8 host devices for JAX
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses  # noqa: E402
import subprocess  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models.lm import make_lm_model as jax_make_lm_model  # noqa: E402
from repro_torch.bridge import load_lm_params  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed import P, Placed, make_mesh, place  # noqa: E402
from repro_torch.launch import make_production_mesh  # noqa: E402
from repro_torch.models.lm import layers as L  # noqa: E402
from repro_torch.models.lm import make_lm_model  # noqa: E402

DECODE_TOL = dict(rtol=2e-4, atol=2e-4)    # tests/distributed_inner.py:75
FLASH_TOL = dict(rtol=1e-5, atol=1e-6)
#: name -> (shape, axes) of every mesh the rules are held on
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x2x2": ((1, 2, 2), ("pod", "data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STACKED = ("layers", "mamba", "encoder", "decoder")


def mesh_of(name: str):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes, "meta")


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def jax_specs(tree) -> dict:
    """{path: spec as a tuple} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return {tuple(_key(k) for k in path): tuple(s) for path, s in flat}


def port_specs(tree, path=()) -> dict:
    """{path in the reference's layout: spec} of a port spec tree, a
    stacked group's per-layer leaves listed per layer."""
    out: dict = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(port_specs(v, path + (k,)))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            for p, s in port_specs(v, path).items():
                out.setdefault(p, []).append(s)
    else:
        out[path] = tree
    return out


def assert_same_specs(port_tree, jax_tree, stacked=True):
    """Every reference leaf's spec is the port's, leaf by leaf through
    the stacking map: a stacked leaf's spec starts with None and the rest
    is each layer's spec in the port (a replicated leaf's is empty in
    both)."""
    want = jax_specs(jax_tree)
    got = port_specs(port_tree)
    assert set(got) == set(want)
    for path, spec in want.items():
        mine = got[path]
        if stacked and path[0] in STACKED:
            assert not spec or spec[0] is None, (path, spec)
            assert all(tuple(s) == spec[1:] for s in mine), (path, mine,
                                                              spec)
        else:
            assert tuple(mine) == spec, (path, mine, spec)


# ---------------------------------------------------------------------------
# rules and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
def test_logical_rules_are_the_reference_rules(name):
    mesh = mesh_of(name)
    assert shd.LOGICAL_RULES(mesh) == jshd.LOGICAL_RULES(mesh)
    assert shd.LOGICAL_RULES_FSDP(mesh) == jshd.LOGICAL_RULES_FSDP(mesh)


def test_shard_hook_checks_the_axes_and_returns_x_itself():
    mesh = mesh_of("2x4")
    for policy in ("tp_fsdp", "fsdp"):
        shard = shd.make_shard_fn(mesh, policy)
        x = torch.zeros(4, 3, 8)
        assert shard(x, ("batch", "seq", "embed")) is x
        assert shard(x, ("batch", None, "unknown")) is x
        with pytest.raises(ValueError, match="logical axes"):
            shard(x, ("batch", "seq"))
    no_model = make_mesh((2,), ("data",), "meta")
    shard = shd.make_shard_fn(no_model)
    assert shard(torch.zeros(2, 4), ("batch", "embed")) is not None
    with pytest.raises(ValueError, match="no axis"):
        shard(torch.zeros(2, 4), ("batch", "heads"))


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("size", ["reduced", "published"])
def test_param_specs_are_the_reference_specs(arch, size):
    """``param_specs`` (llama4 with its token-replicate rules),
    ``fsdp_param_specs`` and ``fit_spec_tree`` on (2, 4) and the
    production mesh, from a ``meta`` init against ``jax.eval_shape``."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if size == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tree = make_lm_model(cfg, device="meta").tensor_tree()
    jm = jax_make_lm_model(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    specs = shd.param_specs(cfg.family, tree, cfg)
    jspecs = jshd.param_specs(jcfg.family, shapes, jcfg)
    assert_same_specs(specs, jspecs)
    fsdp = shd.fsdp_param_specs(specs)
    jfsdp = jshd.fsdp_param_specs(jspecs)
    assert_same_specs(fsdp, jfsdp)
    for name in ("2x4", "16x16"):
        mesh = mesh_of(name)
        for s, js in ((specs, jspecs), (fsdp, jfsdp)):
            assert_same_specs(shd.fit_spec_tree(mesh, s, tree),
                              jshd.fit_spec_tree(mesh, js, shapes))
    if cfg.moe_token_replicate:
        rule = specs["layers"][0]["moe"]["w_gate"]
        assert rule == P("model", None, "data")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_are_the_reference_specs(arch):
    cfg = get_config(arch).reduced()
    jm = jax_make_lm_model(jax_get_config(arch).reduced())
    model = make_lm_model(cfg, device="meta")
    args = (4, 16, 8) if cfg.family == "encdec" else (4, 16)
    cache = model.init_cache(*args)
    jcache = jax.eval_shape(lambda: jm.init_cache(*args))
    for name in ("2x4", "1x2x2", "16x16"):
        mesh = mesh_of(name)
        for seq_shard in (True, False):
            got = shd.cache_specs(cfg.family, mesh, cache, seq_shard)
            want = jshd.cache_specs(cfg.family, mesh, jcache, seq_shard)
            assert_same_specs(got, want, stacked=False)
            assert_same_specs(shd.fit_spec_tree(mesh, got, cache),
                              jshd.fit_spec_tree(mesh, want, jcache),
                              stacked=False)


# ---------------------------------------------------------------------------
# the shard hook in every family
# ---------------------------------------------------------------------------

def _recorder(calls: set):
    def shard(x, logical_axes):
        calls.add((tuple(logical_axes), tuple(int(n) for n in x.shape)))
        return x
    return shard


def _family_inputs(cfg, rng, b=2, s=6):
    tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = (rng.normal(size=(b, 8, cfg.d_model)) * 0.1
                           ).astype(np.float32)
    if cfg.family == "vlm":
        extra["patch_embeds"] = (rng.normal(size=(b, 4, cfg.d_model))
                                 * 0.02).astype(np.float32)
    return tokens, extra


def _cache_args(cfg, b, s_max, extra):
    if cfg.family == "encdec":
        return (b, s_max, extra["frames"].shape[1])
    if cfg.family == "vlm":
        return (b, s_max + extra["patch_embeds"].shape[1])
    return (b, s_max)


def _run_all(model, tokens, extra, params=None):
    """forward, loss, prefill and two decode steps of a model of either
    package; returns the outputs."""
    jax_side = params is not None
    fam = model.cfg.family
    if jax_side:
        tok = jnp.asarray(tokens)
        ext = {k: jnp.asarray(v) for k, v in extra.items()}
        call = lambda f, *a, **kw: f(params, *a, **kw)  # noqa: E731
    else:
        tok = torch.from_numpy(tokens).long()
        ext = {k: torch.from_numpy(v) for k, v in extra.items()}
        call = lambda f, *a, **kw: f(*a, **kw)  # noqa: E731
    outs = [call(model.forward, tok, *ext.values())]
    outs.append(call(model.loss, {"tokens": tok, **ext}))
    cache = model.init_cache(*_cache_args(model.cfg, tok.shape[0], 10, extra))
    if fam == "encdec":
        logits, cache = call(model.prefill, tok, ext["frames"], cache)
    elif fam == "vlm":
        logits, cache = call(model.prefill, tok, cache, **ext)
    else:
        logits, cache = call(model.prefill, tok, cache)
    outs.append(logits)
    for _ in range(2):
        nxt = logits.argmax(-1)[:, None]
        logits, cache = call(model.decode_step, nxt, cache)
        outs.append(logits)
    return outs


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_each_family_calls_shard_where_the_reference_does(arch):
    """The (logical axes, shape) pairs ``forward``, ``loss``, ``prefill``
    and ``decode_step`` pass to ``shard`` are the reference's, as a set;
    with the hook the outputs are bitwise the hook-less model's."""
    cfg = get_config(arch).reduced()
    jcfg = jax_get_config(arch).reduced()
    tokens, extra = _family_inputs(cfg, np.random.default_rng(0))
    want, got = set(), set()
    jm = jax_make_lm_model(jcfg, _recorder(want))
    params = jm.init(jax.random.PRNGKey(0))
    _run_all(jm, tokens, extra, params)
    host = jax.tree.map(np.asarray, params)
    hooked = load_lm_params(make_lm_model(cfg, _recorder(got),
                                          device="cpu"), host)
    plain = load_lm_params(make_lm_model(cfg, device="cpu"), host)
    outs = _run_all(hooked, tokens, extra)
    assert got == want
    for a, b in zip(outs, _run_all(plain, tokens, extra)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# flash_decode_sharded and the sharded decode
# ---------------------------------------------------------------------------

FLASH_SHAPE = dict(b=4, s=32, h=4, kv=2, hd=16)
#: the write position in the first shard, at the first slot of the
#: second, and in the last shard of the (2, 4) mesh's 8-slot shards
FLASH_INDICES = (3, 8, 29)


def flash_inputs(seed: int = 0):
    c = FLASH_SHAPE
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(c["b"], 1, c["h"], c["hd"])).astype(np.float32)
    kc, vc = (rng.normal(size=(c["b"], c["s"], c["kv"], c["hd"]))
              .astype(np.float32) for _ in range(2))
    kn, vn = (rng.normal(size=(c["b"], 1, c["kv"], c["hd"]))
              .astype(np.float32) for _ in range(2))
    return q, kc, vc, kn, vn


def port_flash(mesh, batch_axes, idx, update, seed=0):
    q, kc, vc, kn, vn = (torch.from_numpy(a) for a in flash_inputs(seed))
    ctx = L.DecodeShardCtx(mesh=mesh, batch_axes=batch_axes)
    out, kc, vc = L.flash_decode_sharded(
        q, kc, vc, kn if update else None, vn if update else None, idx, ctx)
    return out, kc.full(), vc.full()


def test_flash_decode_sharded_matches_the_mesh_less_attention():
    """Against ``_sdpa_decode`` over the whole cache (the update written
    into a copy), every batch and sequence layout of a CPU mesh."""
    q, kc, vc, kn, vn = (torch.from_numpy(a) for a in flash_inputs(1))
    for shape, b_ax in (((2, 4), "data"), ((2, 4), None), ((1, 4), "data"),
                        ((4, 1), "data"), ((2, 2), ("data",))):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        for idx in (0, 5, 15, 16, 31):
            k2, v2 = kc.clone(), vc.clone()
            k2[:, idx], v2[:, idx] = kn[:, 0], vn[:, 0]
            want = L._sdpa_decode(q, k2, v2, torch.arange(32) <= idx)
            got, k3, v3 = port_flash(mesh, b_ax, idx, True, seed=1)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            assert torch.equal(k3, k2) and torch.equal(v3, v2)


def test_flash_decode_writes_the_placed_cache_in_place():
    """A cache already placed as the context lays it out is written in
    place (no copy), in the one sequence shard that owns the index; a
    write at or past the cache raises."""
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    q, kc, vc, kn, vn = (torch.from_numpy(a) for a in flash_inputs())
    spec = P("data", "model", None, None)
    pk, pv = place(kc, mesh, spec), place(vc, mesh, spec)
    ctx = L.DecodeShardCtx(mesh=mesh, batch_axes="data")
    _, k2, v2 = L.flash_decode_sharded(q, pk, pv, kn, vn, 12, ctx)
    assert k2 is pk and v2 is pv
    assert torch.equal(pk.local((1, 1))[:, 4], kn[2:, 0])
    assert torch.equal(pk.local((0, 2)), kc[:2, 16:24])
    for bad in (32, 40, -1):
        with pytest.raises(IndexError, match="outside"):
            L.flash_decode_sharded(q, pk, pv, kn, vn, bad, ctx)


def test_placed_layer_view_writes_through():
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    x = torch.arange(3 * 4 * 6, dtype=torch.float32).reshape(3, 4, 6)
    placed = place(x, mesh, P(None, "data", "model"))
    layer = placed[1]
    assert isinstance(layer, Placed) and tuple(layer.shape) == (4, 6)
    assert layer.sharding.spec == P("data", "model")
    torch.testing.assert_close(layer.full(), x[1])
    layer.local((1, 0))[0, 0] = -1.0
    assert placed.full()[1, 2, 0] == -1.0
    with pytest.raises(ValueError, match="split"):
        place(x, mesh, P("data"))[0]
    with pytest.raises(IndexError):
        placed[3]


FAMILY_ARCHS = ("llama3-8b", "phi3.5-moe-42b-a6.6b", "pixtral-12b",
                "zamba2-1.2b", "whisper-small")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_sharded_decode_step_matches_the_mesh_less_step(arch):
    """dense, moe, vlm, hybrid and encdec: a ``decode_ctx`` over a (2, 2)
    CPU mesh against the same model without one, steps across the
    sequence shards' boundary (16 slots, 8 a shard), within the
    reference's ``rtol 2e-4, atol 2e-4``; the placed caches' contents
    are the mesh-less caches'."""
    cfg = get_config(arch).reduced()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    model = make_lm_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    tokens, extra = _family_inputs(cfg, np.random.default_rng(2), b=4)
    tok = torch.from_numpy(tokens).long()
    ext = {k: torch.from_numpy(v) for k, v in extra.items()}
    args = _cache_args(cfg, 4, 16, extra)
    if cfg.family == "encdec":
        args = (4, 16, 8)
        logits, cache = model.prefill(tok, ext["frames"],
                                      model.init_cache(*args))
    elif cfg.family == "vlm":
        logits, cache = model.prefill(tok, model.init_cache(4, 16), **ext)
    else:
        logits, cache = model.prefill(tok, model.init_cache(*args))
    twin = shd.tree_map(lambda t: t.clone() if torch.is_tensor(t) else t,
                        cache)
    ctx = L.DecodeShardCtx(mesh=mesh, batch_axes="data")
    for _ in range(6):
        nxt = logits.argmax(-1)[:, None]
        model.decode_ctx = None
        logits, cache = model.decode_step(nxt, cache)
        model.decode_ctx = ctx
        got, twin = model.decode_step(nxt, twin)
        torch.testing.assert_close(got, logits, **DECODE_TOL)
    kv = twin["shared"] if cfg.family == "hybrid" else twin
    assert isinstance(kv["k"], Placed)
    whole = cache["shared"] if cfg.family == "hybrid" else cache
    for key in ("k", "v") + (("xk", "xv") if "xk" in kv else ()):
        torch.testing.assert_close(kv[key].full(), whole[key], **DECODE_TOL)


def test_sharded_decode_raises_at_the_end_of_the_cache():
    cfg = get_config("qwen3-4b").reduced()
    model = make_lm_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    model.decode_ctx = L.DecodeShardCtx(
        mesh=make_mesh((2, 2), ("data", "model"), "cpu"), batch_axes="data")
    cache = model.init_cache(2, 8)
    cache["index"] = 8
    with pytest.raises(IndexError, match="outside"):
        model.decode_step(torch.zeros(2, 1, dtype=torch.long), cache)


def test_meta_models_and_meshes_hold_no_storage(monkeypatch):
    """``"meta"`` is a device for every position of a mesh and for an LM
    model; CUDA without a card still raises, and the CTR models refuse
    ``meta`` as before."""
    cfg = get_config("llama3-8b")                  # published: 8 B params
    model = make_lm_model(cfg, device="meta")
    assert all(t.device.type == "meta" for t in model.state_dict().values())
    mesh = make_mesh((2, 2), ("data", "model"), "meta")
    assert {d.type for d in mesh.device_set} == {"meta"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_lm_model(cfg.reduced())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((2,), ("data",), ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="all be CUDA, all CPU or all"):
        make_mesh((2,), ("data",), ["cpu", "meta"])


def test_production_meshes():
    mesh = make_production_mesh(devices="meta")
    assert mesh.shape == {"data": 16, "model": 16}
    pods = make_production_mesh(multi_pod=True, devices="meta")
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert pods.first_device.type == "meta"
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True)


# --- the reference's own shard_map on 8 host devices (subprocess) ------------

SUBPROCESS_CASES = tuple(
    f"flash_{'update' if update else 'read'}_{'data' if b_ax else 'none'}_"
    f"{idx}" for update in (True, False) for b_ax in (True, False)
    for idx in FLASH_INDICES)


def _case(name: str):
    """One flash decode on the reference's (2, 4) mesh and the port's."""
    from repro.launch.mesh import make_test_mesh as jax_test_mesh
    from repro.models.lm import layers as JL
    _, kind, b_ax, idx = name.split("_")
    update, b_ax, idx = kind == "update", ("data" if b_ax == "data"
                                           else None), int(idx)
    q, kc, vc, kn, vn = flash_inputs()
    jmesh = jax_test_mesh(2, 4)
    ctx = JL.DecodeShardCtx(mesh=jmesh, batch_axes=b_ax, seq_axis="model")
    args = [jnp.asarray(a) for a in (q, kc, vc, kn, vn)]
    if not update:
        args[3] = args[4] = None
    with jmesh:
        want = jax.jit(lambda q, kc, vc, kn, vn, i: JL.flash_decode_sharded(
            q, kc, vc, kn, vn, i, ctx))(*args, jnp.int32(idx))
    got = port_flash(make_mesh((2, 4), ("data", "model"), "cpu"), b_ax, idx,
                     update)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **FLASH_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def reference_run():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(repo, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    out = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", SUBPROCESS_CASES)
def test_flash_decode_matches_the_reference_on_its_own_mesh(case,
                                                            reference_run):
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

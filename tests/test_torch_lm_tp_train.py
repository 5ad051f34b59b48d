"""Train cells on split weights (``Cell.place_params`` of a train cell,
``TensorParallel``'s uses and ``grads``, ``training.loss_and_grads`` and
``make_train_step`` over placed pieces) on CPU meshes, in fp32 at ``rtol
1e-4, atol 1e-5`` (the LM-training tolerance) unless a test says
otherwise.

* The reduced train cells of the eight attention archs on (2, 2) and
  (1, 4) against the port's mesh-less step from the same parameters and
  batch: the loss, every gradient leaf, then ``grad_norm`` and params, m
  and v after one AdamW update; ``n_micro`` 1 and 2, each with ``remat``
  on and off. granite-8b,
  smollm-360m and whisper-small train under pure FSDP (``auto``), the
  others under TP × FSDP.
* The placed state: every piece of params, m and v is its spec's slice
  of the mesh-less state before and after steps (params on the model's
  own storage), and the positions holding one slice hold equal tensors.
* The bytes between positions of reduced llama3's step on (2, 2), with
  and without remat, are a hand count.
* A resume through ``run_train_loop`` is bitwise an unbroken run, and the
  split state's checkpoint restores into the mesh-less state.
* ``place_params`` accepts the published train cells of the ten archs
  on meta (2, 2) and (1, 4) meshes under ``auto`` (the recurrent
  families' split steps: ``tests/test_torch_lm_tp_train_recurrent.py``).
* The reference's partitioned train step (its ``Cell`` on its (2, 4) mesh
  of host devices, jitted with ``in_shardings=(state specs, input
  specs)`` and ``out_shardings=(state specs, None)``) against the port's
  placed cell on a CPU (2, 4) mesh at ``rtol = atol = 2e-4``
  (``tests/distributed_inner.py:75``): qwen3-4b, smollm-360m (pure
  FSDP), llama4-maverick and whisper-small (pure FSDP); this file re-run
  as a script with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``.
"""

import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import traceback

if __name__ == "__main__":      # the subprocess: 8 host devices for JAX
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.distributed import Placed, make_mesh  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.steps import Cell, build_cell  # noqa: E402
from repro_torch.training import (TrainLoopConfig, adamw_update,  # noqa: E402
                                  restore_checkpoint, run_train_loop)
from repro_torch.training.train_loop import loss_and_grads  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
REF_TOL = dict(rtol=2e-4, atol=2e-4)    # tests/distributed_inner.py:75
TRAIN_EPS = 1e-3                        # as tests/test_torch_lm_cells.py
AXES = ("data", "model")
ARCHS = ("llama3-8b", "granite-8b", "smollm-360m", "qwen3-4b",
         "pixtral-12b", "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
         "whisper-small")
FSDP_ARCHS = ("granite-8b", "smollm-360m", "whisper-small")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, S, N_IMG = 8, 8, 2


@contextlib.contextmanager
def patched(arch: str, shapes: dict, pkgs=(TC,), **overrides):
    """``arch``'s config reduced (with ``overrides``) and ``SHAPES`` cut to
    ``shapes`` {name: (seq, batch)} in each package of ``pkgs`` while
    inside."""
    mods = [importlib.import_module(f"{pkg.__name__}.{pkg._ARCH_MODULES[arch]}")
            for pkg in pkgs]
    saved = [m.CONFIG for m in mods]
    saved_shapes = [dict(pkg.SHAPES) for pkg in pkgs]
    try:
        for m in mods:
            m.CONFIG = m.CONFIG.reduced(**overrides)
        for pkg in pkgs:
            for name, (seq, batch) in shapes.items():
                pkg.SHAPES[name] = pkg.ShapeCell(name, seq, batch,
                                                 pkg.SHAPES[name].kind)
        yield
    finally:
        for m, cfg in zip(mods, saved):
            m.CONFIG = cfg
        for pkg, old in zip(pkgs, saved_shapes):
            pkg.SHAPES.clear()
            pkg.SHAPES.update(old)


def _batch(cfg, b: int = B, s: int = S, seed: int = 3) -> dict:
    """A train batch of ``s`` positions a row (pixtral: ``N_IMG`` of them
    patches), numpy."""
    rng = np.random.default_rng(seed)
    n_img = N_IMG if cfg.family == "vlm" else 0
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s - n_img)
                                  ).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(size=(b, s, cfg.d_model)) * 0.1
                         ).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.normal(size=(b, n_img, cfg.d_model))
                               * 0.02).astype(np.float32)
    return out


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree, path=()):
    """(path, leaf) of a tree of dicts and lists (a spec ``P`` is a
    leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _cells(arch: str, shape, remat: bool, n_micro: int, seed: int = 0,
           **overrides):
    """A reduced train cell of ``arch`` (with config ``overrides``) on a
    CPU mesh of ``shape`` with its parameters placed, and its mesh-less
    twin on the same parameters."""
    with patched(arch, {"train_4k": (S, B)}, remat=remat, **overrides):
        split = build_cell(arch, "train_4k", make_mesh(shape, AXES, "cpu"))
        plain = build_cell(arch, "train_4k",
                           make_mesh((1, 1), AXES, "cpu"))
    split.model.init(torch.Generator().manual_seed(seed))
    plain.model.load_state_dict(split.model.state_dict())
    for cell in (split, plain):
        cell.n_micro = n_micro
        cell.opt_cfg = dataclasses.replace(cell.opt_cfg, eps=TRAIN_EPS)
    split.place_params()
    return split, plain


def _close_states(got, want, **tol) -> None:
    """params, m and v of a split state (assembled) against a mesh-less
    one."""
    for part in ("params", "m", "v"):
        for (path, g), (_, w) in zip(_flat(getattr(got, part)),
                                     _flat(getattr(want, part))):
            torch.testing.assert_close(g.full(), w.detach(),
                                       msg=f"{part} {path}", **tol)


#: each arch on both meshes, one and two microbatches, remat on and off
CASES = [(a, m, n, r) for a in ARCHS for m in MESHES for n in (1, 2)
         for r in (False, True)]


@pytest.mark.parametrize("arch,mesh_name,n_micro,remat", CASES, ids=[
    f"{a}-{m}-micro{n}-{'remat' if r else 'saved'}" for a, m, n, r in CASES])
def test_split_step_matches_the_mesh_less_step(arch, mesh_name, n_micro,
                                               remat):
    split, plain = _cells(arch, MESHES[mesh_name], remat, n_micro)
    assert split.policy == ("fsdp" if arch in FSDP_ARCHS else "tp_fsdp")
    batch = _torch(_batch(split.cfg))
    got, want = split.train_state(), plain.train_state()
    ls, gs = loss_and_grads(split.model, got.params, batch, n_micro)
    lp, gp = loss_and_grads(plain.model, want.params, batch, n_micro)
    torch.testing.assert_close(ls, lp, **TOL)
    for (path, g), (_, w), (_, spec) in zip(_flat(gs), _flat(gp),
                                            _flat(split.pspecs)):
        assert isinstance(g, Placed) and g.sharding.spec == spec, path
        torch.testing.assert_close(g.full(), w, msg=str(path), **TOL)
    got, ms = adamw_update(got, gs, split.opt_cfg)
    want, mp = adamw_update(want, gp, plain.opt_cfg)
    torch.testing.assert_close(ms["grad_norm"], mp["grad_norm"], **TOL)
    _close_states(got, want, **TOL)


def _check_placed(cell: Cell, state, want) -> None:
    """Each piece of ``state``'s params, m and v is its ``state_specs``
    slice of ``want`` (a mesh-less state); the pieces of params on the
    model's device are views of its buffers; the holders of one slice
    hold equal tensors; a split leaf is whole nowhere."""
    weights = dict(_flat(cell.model.tensor_tree()))
    specs = cell.state_specs()
    n_split = 0
    for part in ("params", "m", "v"):
        for (path, pl), (_, spec), (_, w) in zip(
                _flat(getattr(state, part)), _flat(getattr(specs, part)),
                _flat(getattr(want, part))):
            assert isinstance(pl, Placed) and pl.sharding.spec == spec
            assert pl.sharding.mesh == cell.mesh
            split = not pl.sharding.is_fully_replicated
            n_split += split
            for key, holders in pl.holders().items():
                first = pl.local(holders[0])
                for pos in holders:
                    assert torch.equal(pl.local(pos), first), (path, pos)
                sl = tuple(slice(a, b) for a, b in key)
                torch.testing.assert_close(first, w.detach()[sl],
                                           msg=f"{part} {path}", **TOL)
                if split:
                    assert first.numel() < w.numel(), (part, path)
                if part == "params":
                    assert first.untyped_storage().data_ptr() == \
                        weights[path].untyped_storage().data_ptr(), path
    assert n_split > 0


@pytest.mark.parametrize("arch,mesh_name", [("llama3-8b", "2x2"),
                                            ("smollm-360m", "1x4")])
def test_placed_state_holds_its_spec_slices(arch, mesh_name):
    """Before and after two steps of ``train_step_fn()`` (remat on, two
    microbatches), against the mesh-less cell's steps."""
    split, plain = _cells(arch, MESHES[mesh_name], True, 2)
    got, want = split.train_state(), plain.train_state()
    _check_placed(split, got, want)
    step, plain_step = split.train_step_fn(), plain.train_step_fn()
    for seed in (3, 4):
        batch = _torch(_batch(split.cfg, seed=seed))
        got, ms = step(got, batch)
        want, mp = plain_step(want, batch)
        for k in ("loss", "grad_norm"):
            torch.testing.assert_close(ms[k], mp[k], **TOL)
        _check_placed(split, got, want)
    assert int(got.step) == 2


def _hand_count(cfg, b_row: int, s: int, remat: bool, f32: int = 4,
                tok: int = 4) -> dict:
    """Bytes between positions of one split train step of a reduced dense
    cell on (2, 2) (TP × FSDP; two batch rows of ``b_row`` rows of ``s``
    int32 tokens; one loss chunk of the ``c = s - 1`` positions with a
    target; untied head; heads per position).

    Forward: per layer the normed activation to model position 1 and the
    partial sums back, for attention and the MLP (``tp_reduce``); the
    loss's normed chunk to position 1 (``tp_reduce``), the targets there
    and its fp32 max, sum of exponentials and target logit back, and the
    second row's loss to the first position (``vocab``); the embedding's
    ids and partials (``vocab``); every matrix gathered over ``data`` at
    each position: the whole matrix's bytes (``fsdp_gather``).
    Backward: every send of a tensor that needs a gradient sent back
    (the activations and partials, the chunk, the sum and target logit,
    the row's loss; not the ids, targets or max); the loss chunk
    recomputed (its sends again and the head regathered), and with remat
    every layer's forward sends and gathers again. Gradients: every
    matrix's bytes once (each piece gets the other row's part), and
    each of the 2·L + 1 norms from the second row to the first position
    and from there to the three other holders (``grad_reduce``)."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    q_cols, kv_cols = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    c = s - 1
    act = 2 * b_row * s * d * f32            # one (b_row, s, d) a row
    chunk = 2 * b_row * c * d * f32
    stat = 2 * b_row * c * f32               # one (b_row, c) fp32 a row
    ids, targets = 2 * b_row * s * tok, 2 * b_row * c * tok
    layers_tp = L * 4 * act
    layer_w = (d * (2 * q_cols + 2 * kv_cols) + 3 * d * f) * f32
    table = v * d * f32
    return {
        "tp_reduce": 2 * (layers_tp + chunk) + chunk
        + (layers_tp if remat else 0),
        "fsdp_gather": 3 * table + L * layer_w * (2 if remat else 1),
        "vocab": (ids + act + targets + 3 * stat + f32)
        + (act + 2 * stat + f32) + (targets + 3 * stat),
        "heads": 0, "moe_tokens": 0, "merge": 0, "state": 0,
        "grad_reduce": L * layer_w + 2 * table + (2 * L + 1) * 4 * d * f32,
    }


@pytest.mark.parametrize("remat", (False, True))
def test_moved_bytes_are_a_hand_count_on_a_2x2_mesh(remat):
    """Reduced llama3 (fp32; 4 heads, 2 kv heads of 16, d 64, f 128,
    vocab 256, 2 layers), batch 8 of 8 tokens on (2, 2), one
    microbatch."""
    split, _ = _cells("llama3-8b", (2, 2), remat, 1)
    tp = split.tp
    tp.moved.clear()
    split.train_step_fn()(split.train_state(), _torch(_batch(split.cfg)))
    assert tp.bytes_by_kind() == _hand_count(split.cfg, B // 2, S, remat)
    # every position gathers the same bytes
    assert len(set(tp.by_position("fsdp_gather").values())) == 1


def test_resume_is_bitwise_and_restores_into_the_mesh_less_state(tmp_path):
    """``run_train_loop`` over a split llama3 cell on (2, 2): 4 steps
    unbroken against 2 steps, then a resume from that checkpoint into a
    fresh cell for 2 more (bitwise: losses, params, m, v); the split
    state's checkpoint restores into a mesh-less cell's state."""
    batches = [_torch(_batch(TC.get_config("llama3-8b").reduced(),
                             seed=10 + k)) for k in range(4)]

    def run(total, ckpt_dir, resume):
        split, plain = _cells("llama3-8b", (2, 2), True, 1)
        state, hist = run_train_loop(
            split.train_step_fn(), split.train_state(),
            lambda step: batches[step],
            TrainLoopConfig(total_steps=total, ckpt_every=2,
                            ckpt_dir=str(ckpt_dir), resume=resume,
                            log_every=100))
        return state, hist, plain

    whole, hist, _ = run(4, tmp_path / "a", "none")
    run(2, tmp_path / "b", "none")
    resumed, hist_b, plain = run(4, tmp_path / "b", "auto")
    assert [h["loss"] for h in hist_b] == [h["loss"] for h in hist[2:]]
    for part in ("params", "m", "v"):
        for (path, a), (_, b) in zip(_flat(getattr(whole, part)),
                                     _flat(getattr(resumed, part))):
            assert torch.equal(a.full(), b.full()), (part, path)
    target = plain.train_state()
    restore_checkpoint(str(tmp_path / "a"), 4, target)
    assert int(target.step) == 4
    for part in ("params", "m", "v"):
        for (path, a), (_, b) in zip(_flat(getattr(whole, part)),
                                     _flat(getattr(target, part))):
            assert torch.equal(a.full(), b.detach()), (part, path)


@pytest.mark.parametrize("arch", ARCHS + ("rwkv6-7b", "zamba2-1.2b"))
@pytest.mark.parametrize("mesh_name", MESHES)
def test_place_params_accepts_the_published_train_cells(arch, mesh_name):
    """On meta tensors under ``auto``, the ten archs: pure FSDP (every
    position a batch row, no tensor parallelism, weights gathered over
    both axes) for the three archs the reference measured to fit, TP ×
    FSDP for the rest; the state's moments placed as their parameters,
    bf16 for the very large archs."""
    cell = Cell(arch, "train_4k", make_mesh(MESHES[mesh_name], AXES,
                                            "meta"), device="meta")
    tp = cell.place_params()
    assert cell.tp is tp
    if arch in FSDP_ARCHS:
        assert cell.policy == "fsdp" and tp.model_axis is None
        assert len(tp.rows) == 4 and tp.gather_axes == AXES
    else:
        assert cell.policy == "tp_fsdp" and tp.model_axis == "model"
        assert [len(r) for r in tp.rows] == [MESHES[mesh_name][1]] * \
            MESHES[mesh_name][0]
    state = cell.train_state()
    big = arch in ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b")
    for (_, p), (_, m) in zip(_flat(state.params), _flat(state.m)):
        assert isinstance(m, Placed) and m.sharding == p.sharding
        assert m.dtype == (torch.bfloat16 if big else torch.float32)
    wq = {"whisper-small": lambda m: m.decoder[0].attn.wq,
          "rwkv6-7b": lambda m: m.layers[0].wr,
          "zamba2-1.2b": lambda m: m.mamba[0].w_in}.get(
              arch, lambda m: m.layers[0].attn.wq)(cell.model)
    pl = tp.placed(wq)
    assert pl.sharding.spec == (shd.P(None, ("data", "model"))
                                if arch in FSDP_ARCHS
                                else shd.P("data", "model"))


# --- the reference's partitioned train step on its own 8-device mesh ---------

SUBPROCESS_CASES = ("qwen3-4b", "smollm-360m", "llama4-maverick-400b-a17b",
                    "whisper-small")
#: qk-norm on for qwen3-4b, as in tests/test_torch_lm_tp.py
SUBPROCESS_OVERRIDES = {"qwen3-4b": {"qk_norm": True}}
REF_SEQ, REF_B = 16, 8


def _case(arch: str, **overrides):
    """One step of the reference's train cell (its config reduced with
    ``overrides``) compiled on its (2, 4) mesh against the port's placed
    cell on a CPU (2, 4) mesh, from the same parameters and batch."""
    import jax
    import jax.numpy as jnp
    import repro.configs as JC
    from repro.distributed import sharding as jshd
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_test_mesh
    from repro.training.optimizer import adamw_init as jax_adamw_init
    from repro_torch.bridge import load_lm_params, stacked_lm_tree

    jmesh = make_test_mesh(2, 4)
    mesh = make_mesh((2, 4), AXES, "cpu")
    with patched(arch, {"train_4k": (REF_SEQ, REF_B)}, pkgs=(JC, TC),
                 **overrides):
        jcell = jsteps.build_cell(arch, "train_4k", jmesh)
        cell = build_cell(arch, "train_4k", mesh)
    assert cell.policy == jcell.policy
    assert cell.n_micro == jcell.n_micro == 1
    jcell.opt_cfg = dataclasses.replace(jcell.opt_cfg, eps=TRAIN_EPS)
    cell.opt_cfg = dataclasses.replace(cell.opt_cfg, eps=TRAIN_EPS)
    params = jcell.model.init(jax.random.PRNGKey(0))
    load_lm_params(cell.model, jax.tree.map(np.asarray, params))
    cell.place_params()
    named = lambda t: jshd.to_named(jmesh, t)    # noqa: E731
    st_named = named(jax.tree.map(lambda s: s, jcell.state_specs(),
                                  is_leaf=lambda s: isinstance(
                                      s, jax.sharding.PartitionSpec)))
    in_named = named(jcell.input_shardspecs())
    batch = _batch(cell.cfg, REF_B, REF_SEQ, seed=5)
    with jmesh:
        step = jax.jit(jcell.train_step_fn(),
                       in_shardings=(st_named, in_named),
                       out_shardings=(st_named, None))
        jstate, jm = step(
            jax.device_put(jax_adamw_init(params, jcell.opt_cfg), st_named),
            jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                           in_named))
    state, m = cell.train_step_fn()(cell.train_state(), _torch(batch))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), err_msg=k,
                                   **REF_TOL)
    for part in ("params", "m", "v"):
        got = dict(_flat(stacked_lm_tree(shd.tree_map(
            lambda x: x.full(), getattr(state, part)))))
        want = jax.tree_util.tree_flatten_with_path(getattr(jstate, part))[0]
        assert len(got) == len(want)
        for path, w in want:
            key = tuple(getattr(k, "key", getattr(k, "idx", k))
                        for k in path)
            np.testing.assert_allclose(got[key], np.asarray(w),
                                       err_msg=f"{part} {key}", **REF_TOL)


@pytest.fixture(scope="module")
def partitioned_run():
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
def test_split_step_matches_the_reference_partitioned_step(
        case, partitioned_run):
    assert partitioned_run[case] == "OK", partitioned_run[case]


if __name__ == "__main__":
    import jax
    assert jax.device_count() == 8
    results = {}
    for name in SUBPROCESS_CASES:
        try:
            _case(name, **SUBPROCESS_OVERRIDES.get(name, {}))
            results[name] = "OK"
        except Exception:   # reported per case by the parent test
            results[name] = traceback.format_exc()
    print(json.dumps(results))

"""Serving cells on split weights (``Cell.place_params``,
``repro_torch.distributed.tensor_parallel``) on CPU meshes.

* The prefill and decode cells of the ten archs (``reduced()``, fp32) on
  (2, 2) and (1, 4) meshes, parameters placed, against the port's
  mesh-less step and the reference's mesh-less ``prefill``/
  ``decode_step`` on the same parameters: logits within ``rtol = atol =
  2e-4`` (``tests/distributed_inner.py:75``), greedy tokens equal over 6
  decode steps; rwkv6 and zamba2 also with 4 heads on (1, 4) (their heads
  per position; zamba2's 292 ``w_in`` columns cut mid-segment).
* The recurrent state caches are placed by ``cache_specs``: every
  position's tensor of every state leaf is its spec's slice of the
  mesh-less cache, before and after decode steps, updated in place and
  never assembled whole; ``long_500k`` (b = 1) cells too.
* Every placed leaf holds its spec's slice (a view of the weight) and no
  position holds whole a leaf its spec splits.
* Both attention layouts (heads split on kv groups on (2, 2); gathered on
  the row's first position on (1, 4)), both MoE layouts (llama4's F over
  data in its prefill cell), MoE routing per batch shard, a vocab the
  model axis does not divide.
* The split embedding is bitwise the whole gather and raises on an id
  outside the table.
* The bytes between positions are a hand count for reduced llama3's
  prefill and decode and rwkv6's decode on (2, 2).
* ``place_params`` accepts the recurrent families' serving and train
  cells and the attention families' train cells.
* The reference's own partitioned cells (its ``Cell`` on its (2, 4) mesh
  of host devices, compiled with its parameters and inputs put by
  ``to_named(cell.pspecs)`` and the cell's input specs, the shapes cut as
  ``tests/distributed_inner.py:100-116`` cuts them), qwen3-4b,
  llama4-maverick, rwkv6 and zamba2, against the port's placed cells on a CPU (2, 4) mesh
  (this file re-run as a script with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``).
"""

import contextlib
import functools
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
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.models.lm import make_lm_model as jax_make_lm_model  # noqa: E402
from repro_torch.bridge import load_lm_params  # noqa: E402
from repro_torch.distributed import Placed, make_mesh  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.tensor_parallel import Cols  # noqa: E402
from repro_torch.launch.steps import Cell, build_cell  # noqa: E402
from repro_torch.models.lm import moe as TM  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)        # tests/distributed_inner.py:75
ARCHS = ("llama3-8b", "granite-8b", "smollm-360m", "qwen3-4b",
         "pixtral-12b", "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
         "whisper-small", "rwkv6-7b", "zamba2-1.2b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, PROMPT, S_MAX, N_IMG, N_FRAMES, STEPS = 4, 6, 16, 2, 8, 6


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


def _inputs(cfg, b: int = B, prompt: int = PROMPT, seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    n_tok = prompt - (N_IMG if cfg.family == "vlm" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, n_tok)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = (rng.normal(size=(b, N_FRAMES, cfg.d_model)) * 0.1
                         ).astype(np.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.normal(size=(b, N_IMG, cfg.d_model))
                               * 0.02).astype(np.float32)
    return out


def _prefill(model, inputs: dict, s_max: int, params=None):
    """``model``'s prefill of ``inputs`` into an ``s_max``-slot cache
    (the reference's with ``params``)."""
    fam = model.cfg.family
    call = (lambda f, *a, **k: f(params, *a, **k)) if params is not None \
        else (lambda f, *a, **k: f(*a, **k))
    b = inputs["tokens"].shape[0]
    if fam == "encdec":
        return call(model.prefill, inputs["tokens"], inputs["frames"],
                    model.init_cache(b, s_max, N_FRAMES))
    cache = model.init_cache(b, s_max)
    if fam == "vlm":
        return call(model.prefill, inputs["tokens"], cache,
                    patch_embeds=inputs["patch_embeds"])
    return call(model.prefill, inputs["tokens"], cache)


def _torch(inputs: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


@functools.lru_cache(maxsize=None)
def reference_run(arch: str, **overrides):
    """The reference's mesh-less prefill of the ``PROMPT`` rows into
    ``S_MAX`` slots (its last logits, which the cache's length does not
    change), then ``STEPS`` greedy decode steps: (host parameters,
    prefill logits, [decode logits])."""
    cfg = JC.get_config(arch).reduced(**overrides)
    model = jax_make_lm_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    inputs = {k: jnp.asarray(v) for k, v in _inputs(cfg).items()}
    logits, cache = _prefill(model, inputs, S_MAX, params)
    pre = logits
    out = []
    for _ in range(STEPS):
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, cache = model.decode_step(params, nxt, cache)
        out.append(np.asarray(logits))
    return jax.tree.map(np.asarray, params), np.asarray(pre), out


def _cells(arch: str, shape, params, **overrides):
    """The placed prefill and decode cells and a mesh-less decode cell,
    all on ``params``."""
    with patched(arch, {"prefill_32k": (PROMPT, B),
                        "decode_32k": (S_MAX, B)}, **overrides):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        pre = build_cell(arch, "prefill_32k", mesh)
        dec = build_cell(arch, "decode_32k", mesh)
        plain = build_cell(arch, "decode_32k",
                           make_mesh((1, 1), ("data", "model"), "cpu"))
    for cell in (pre, dec, plain):
        load_lm_params(cell.model, params)
    pre.place_params()
    dec.place_params()
    return pre, dec, plain


#: (arch, mesh, config overrides): the ten archs on both meshes, whisper
#: with a vocabulary ``fit_spec`` leaves whole over ``model`` (as
#: whisper-small's 51,865 rows are), and the recurrent families with four
#: heads over four positions (reduced rwkv6 has one head, which the
#: column split cuts; reduced zamba2 two)
SPLIT_CASES = [(a, m, ()) for a in ARCHS for m in MESHES] + [
    ("whisper-small", "2x2", (("vocab", 255),)),
    ("rwkv6-7b", "1x4", (("ssm_head_dim", 16),)),
    ("zamba2-1.2b", "1x4", (("ssm_head_dim", 32),))]


@pytest.mark.parametrize("arch,mesh_name,overrides", SPLIT_CASES, ids=[
    "-".join([a, m] + [f"{k}{v}" for k, v in o]) for a, m, o in SPLIT_CASES])
def test_split_cells_match_the_mesh_less_step_and_the_reference(
        arch, mesh_name, overrides):
    params, want_pre, want_dec = reference_run(arch, **dict(overrides))
    pre, dec, plain = _cells(arch, MESHES[mesh_name], params,
                             **dict(overrides))
    inputs = _torch(_inputs(pre.cfg))
    got, cache = pre.prefill_fn()(inputs)
    mesh_less, _ = _prefill(plain.model, inputs, PROMPT)
    torch.testing.assert_close(got, mesh_less, **TOL)
    np.testing.assert_allclose(got.numpy(), want_pre, **TOL)
    # the prefill's KV caches leave whole, its recurrent states placed
    fam = pre.cfg.family
    if fam == "ssm":
        assert isinstance(cache["tm_state"], Placed)
    elif fam == "hybrid":
        assert isinstance(cache["shared"]["k"], torch.Tensor)
        assert isinstance(cache["mamba"]["ssm"], Placed)
    else:
        assert isinstance(cache["k"], torch.Tensor)

    ls, cs = _prefill(dec.model, inputs, S_MAX)
    lp, cp = _prefill(plain.model, inputs, S_MAX)
    split_step, plain_step = dec.decode_fn(), plain.decode_fn()
    for want in want_dec:
        nxt = lp.argmax(-1)[:, None]
        assert torch.equal(ls.argmax(-1), lp.argmax(-1))
        ls, cs = split_step({"tokens": nxt, "cache": cs})
        lp, cp = plain_step({"tokens": nxt, "cache": cp})
        torch.testing.assert_close(ls, lp, **TOL)
        np.testing.assert_allclose(ls.numpy(), want, **TOL)
        assert (ls.argmax(-1).numpy() == want.argmax(-1)).all()
    if pre.cfg.family != "ssm":            # RWKV6's cache has no index
        assert cs["index"] == PROMPT + STEPS


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _shapes(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _shapes(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ("qwen3-4b", "phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b",
                                  "whisper-small"))
def test_placed_leaves_hold_their_spec_slices(arch):
    """Each position's tensor of every leaf is its spec's slice of the
    weight, a view on the weight's own device; a leaf the spec splits is
    whole nowhere."""
    params = reference_run(arch)[0]
    pre, dec, _ = _cells(arch, (2, 2), params)
    for cell in (pre, dec):
        weights = dict(_shapes(cell.model.tensor_tree()))
        n_split = 0
        for path, pl in _shapes(cell.tp.tree):
            w = weights[path]
            split = not pl.sharding.is_fully_replicated
            n_split += split
            for pos in np.ndindex(cell.mesh.devices.shape):
                local = pl.local(pos)
                sl = pl.sharding.local_slices(pos, w.shape)
                assert torch.equal(local, w[sl]), (path, pos)
                assert local.untyped_storage().data_ptr() \
                    == w.untyped_storage().data_ptr(), (path, pos)
                if split:
                    assert local.numel() < w.numel(), (path, pos)
        assert n_split > 0


def test_both_attention_layouts_are_reached(monkeypatch):
    """Heads stay per position where the split falls on kv groups (2 kv
    heads over 2 positions) and gather on the row's first position where
    it does not (2 kv heads over 4)."""
    calls = []
    real = Cols.gathered
    monkeypatch.setattr(Cols, "gathered", lambda self, kind: (
        calls.append(kind), real(self, kind))[1])
    params = reference_run("llama3-8b")[0]
    inputs = _torch(_inputs(TC.get_config("llama3-8b").reduced()))
    for shape, gathers in (((2, 2), 0), ((1, 4), 3 * 2)):
        calls.clear()
        pre, _, _ = _cells("llama3-8b", shape, params)
        pre.prefill_fn()(inputs)
        assert len(calls) == gathers, shape     # q, k, v in each layer


@pytest.mark.parametrize("arch,cell_shape,tokens_move", [
    ("llama4-maverick-400b-a17b", "prefill_32k", True),
    ("llama4-maverick-400b-a17b", "decode_32k", False),
    ("phi3.5-moe-42b-a6.6b", "prefill_32k", False)])
def test_moe_layouts(arch, cell_shape, tokens_move, monkeypatch):
    """llama4's prefill cell keeps F split over data and sends the
    expert slots along the data axis (the reference's
    ``moe_token_replicate``); its decode cell (data dropped) and
    phi3.5-moe gather the experts' D over data instead."""
    seen = []
    real = TM.axis_line
    monkeypatch.setattr(TM, "axis_line", lambda *a: (
        seen.append(a[2]), real(*a))[1])
    params = reference_run(arch)[0]
    pre, dec, plain = _cells(arch, (2, 2), params)
    cell = pre if cell_shape == "prefill_32k" else dec
    cfg = cell.cfg
    w_gate = cell.model.layers[0].moe.w_gate
    assert (cell.tp.placed(w_gate).split_dim("data") == 2) == tokens_move
    inputs = _torch(_inputs(cfg))
    got, _ = _prefill(cell.model, inputs, S_MAX)
    want, _ = _prefill(plain.model, inputs, S_MAX)
    torch.testing.assert_close(got, want, **TOL)
    assert bool(seen) == tokens_move


def test_moe_routes_each_batch_shard_alone_when_it_holds_whole_groups():
    """phi3.5-moe's prefill of 256 tokens a row on (2, 2): each batch
    shard's 512 tokens are one routing group, routed on its own row."""
    params = reference_run("phi3.5-moe-42b-a6.6b")[0]
    pre, _, plain = _cells("phi3.5-moe-42b-a6.6b", (2, 2), params)
    inputs = _torch(_inputs(pre.cfg, prompt=256, seed=7))
    pre.tp.moved.clear()
    got, _ = _prefill(pre.model, inputs, 256)
    want, _ = _prefill(plain.model, inputs, 256)
    torch.testing.assert_close(got, want, **TOL)
    # tokens never leave their rows: only the expert slots and combine
    # columns of model shard 1 move (to and from (i, 1))
    by_pos = pre.tp.by_position("moe_tokens")
    assert by_pos[(0, 0)] == by_pos[(0, 1)] == by_pos[(1, 0)] \
        == by_pos[(1, 1)] > 0


@pytest.mark.parametrize("arch,vocab", [("llama3-8b", None),
                                        ("whisper-small", 255)])
def test_split_embedding_is_bitwise_the_whole_gather(arch, vocab):
    """Vocab over model (256 rows) or whole (255 rows, which ``fit_spec``
    leaves whole, as whisper-small's 51,865); an id outside the table
    raises as ``F.embedding`` does."""
    over = {} if vocab is None else {"vocab": vocab}
    cfg = TC.get_config(arch).reduced(**over)
    for shape in MESHES.values():
        with patched(arch, {"prefill_32k": (PROMPT, B)}, **over):
            cell = build_cell(arch, "prefill_32k",
                              make_mesh(shape, ("data", "model"), "cpu"))
        cell.model.init(torch.Generator().manual_seed(0))
        tp = cell.place_params()
        table = cell.model.embed
        assert (tp.model_dim(table) is None) == (vocab is not None)
        ids = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, (B, 9)))
        ids[0, :3] = torch.tensor([0, cfg.vocab - 1, cfg.vocab // 2])
        got = tp.embed(table, ids).whole("vocab")
        assert torch.equal(got, table[ids])
        for bad in (-1, cfg.vocab):
            ids[1, 2] = bad
            with pytest.raises(IndexError):
                tp.embed(table, ids)


def _hand_count(cfg, b_row: int, s: int, fsdp: bool, tok: int,
                f32: int = 4) -> dict:
    """Bytes between positions of a reduced dense step on (2, 2) with
    ``s`` new tokens a row (two rows): the activation to model position
    1 and the partial sums back twice a layer and once at the head
    (``tp_reduce``), the FSDP gathers (every position one piece of every
    matrix), the embedding's ids and partials, the logits' columns and
    row 1 to the first position (``vocab``)."""
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    q_cols, kv_cols = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    act = 2 * b_row * s * d * f32                # one (b_row, s, d) a row
    last = 2 * b_row * 1 * d * f32
    out = {"tp_reduce": L * 4 * act + last}
    layer = d * (2 * q_cols + 2 * kv_cols) + 3 * d * f
    out["fsdp_gather"] = (L * layer + 2 * v * d) * f32 if fsdp else 0
    out["vocab"] = (2 * b_row * s * tok + act + 2 * b_row * v // 2 * f32
                    + b_row * v * f32)
    return out


def test_moved_bytes_are_a_hand_count_on_a_2x2_mesh():
    """Reduced llama3 (fp32; 4 heads, 2 kv heads of 16, d 64, f 128,
    vocab 256, 2 layers), batch 4 on (2, 2): heads stay per position.
    Prefill of 6 (TP × FSDP, every matrix a quarter a position): each
    row's model position 1 sends its k/v heads, row 1 both positions', to
    the cache on the first device (``heads``). Decode (TP only) at slots
    6 and 8 of 16 (8 a sequence shard): q, k and v to the row's first
    position and ``o``'s second half back (``heads``); the merge sends q,
    the max both ways, ``l`` and ``o`` within each row, and the new k/v
    rows to model position 1 only once slot 8 is its shard's
    (``merge``)."""
    cfg = TC.get_config("llama3-8b").reduced()
    params = reference_run("llama3-8b")[0]
    pre, dec, _ = _cells("llama3-8b", (2, 2), params)
    f32, b_row, hd = 4, B // 2, cfg.hd
    inputs = _torch(_inputs(cfg))
    pre.tp.moved.clear()
    pre.prefill_fn()(inputs)
    want = _hand_count(cfg, b_row, PROMPT, fsdp=True, tok=4)   # int32 ids
    kv_piece = b_row * PROMPT * (cfg.n_kv_heads // 2) * hd * f32
    want["heads"] = cfg.n_layers * 2 * 3 * kv_piece
    want.update(moe_tokens=0, merge=0, state=0, grad_reduce=0)
    assert pre.tp.bytes_by_kind() == want

    _, cache = _prefill(dec.model, inputs, S_MAX)
    step = dec.decode_fn()
    h_half, kv_half = cfg.n_heads // 2 * hd, cfg.n_kv_heads // 2 * hd
    for idx, writes in ((6, 0), (8, 1)):
        cache["index"] = idx
        dec.tp.moved.clear()
        step({"tokens": torch.zeros(B, 1, dtype=torch.long), "cache": cache})
        want = _hand_count(cfg, b_row, 1, fsdp=False, tok=8)
        want["heads"] = cfg.n_layers * 2 * b_row * (
            h_half + 2 * kv_half + h_half) * f32
        q = b_row * cfg.n_heads * hd * f32
        stat = b_row * cfg.n_heads * f32         # (b, kv, g, 1): a max, l
        merge = 2 * (q + 3 * stat + q)           # o is q's size
        merge += writes * 2 * 2 * b_row * cfg.n_kv_heads * hd * f32
        want.update(moe_tokens=0, merge=cfg.n_layers * merge, state=0,
                    grad_reduce=0)
        assert dec.tp.bytes_by_kind() == want, idx
        by_pos = dec.tp.by_position("merge")
        assert by_pos[(0, 1)] == by_pos[(1, 1)] == cfg.n_layers * (
            merge // 2)


def test_rwkv6_moved_bytes_are_a_hand_count_on_a_2x2_mesh():
    """Reduced rwkv6 with 4 heads of 16 (fp32; d 64, f 128, vocab 256, 2
    layers), batch 4 on (2, 2), one decode step (TP only): heads 2 a
    position. A layer, for each row's model position 1: the time mix's
    four shifted inputs and the channel mix's two go to it, and three
    partial sums (``wo``, ``wcv``) and the gate's columns (``wcr``) come
    back (``tp_reduce``), as do its ``ln_x`` sum of squares and the
    row's ``rsqrt`` (4 bytes a token each); its half of the decay's
    columns goes to it (``heads``); ``tm_prev`` and ``cm_prev``, replicated
    over ``model``, reach it from the row's first position (``state``;
    ``tm_state`` is split by heads and written where it was computed).
    The embedding and head as in ``_hand_count``."""
    over = (("ssm_head_dim", 16),)
    cfg = TC.get_config("rwkv6-7b").reduced(**dict(over))
    params = reference_run("rwkv6-7b", **dict(over))[0]
    _, dec, _ = _cells("rwkv6-7b", (2, 2), params, **dict(over))
    f32, b_row, d = 4, B // 2, cfg.d_model
    _, cache = _prefill(dec.model, _torch(_inputs(cfg)), S_MAX)
    dec.tp.moved.clear()
    dec.decode_fn()({"tokens": torch.zeros(B, 1, dtype=torch.long),
                     "cache": cache})
    act = b_row * d * f32                 # one row's (b_row, 1, d)
    layer = {"tp_reduce": 8 * act + act // 2 + 2 * b_row * f32,
             "heads": act // 2, "state": 2 * act}
    want = _hand_count(cfg, b_row, 1, fsdp=False, tok=8)
    want = {"tp_reduce": 2 * cfg.n_layers * layer["tp_reduce"] + 2 * act,
            "fsdp_gather": 0, "vocab": want["vocab"],
            "heads": 2 * cfg.n_layers * layer["heads"], "moe_tokens": 0,
            "merge": 0, "state": 2 * cfg.n_layers * layer["state"],
            "grad_reduce": 0}
    assert dec.tp.bytes_by_kind() == want


@pytest.mark.parametrize("arch,shape,policy", [
    ("rwkv6-7b", "train_4k", "tp_fsdp"),
    ("zamba2-1.2b", "train_4k", "tp_fsdp")])
def test_place_params_refuses_what_is_not_split_yet(arch, shape, policy):
    """The recurrent families' published train cells, refused while their
    losses ran only the unsplit recurrence, are placed: on meta tensors
    under TP × FSDP, two batch rows of two model positions, and no state
    cache placed (a train step starts every scan from zeros); the split
    step itself is held in
    ``tests/test_torch_lm_tp_train_recurrent.py``."""
    cell = Cell(arch, shape, make_mesh((2, 2), ("data", "model"), "meta"),
                device="meta")
    tp = cell.place_params()
    assert cell.tp is tp and tp.train
    assert cell.policy == policy and tp.model_axis == "model"
    assert [len(r) for r in tp.rows] == [2, 2]
    w = cell.model.layers[0].wr if arch == "rwkv6-7b" \
        else cell.model.mamba[0].w_in
    assert tp.placed(w).sharding.spec == shd.P("data", "model")
    assert not any(t.requires_grad for t in cell.model.state_dict().values())


@pytest.mark.parametrize("arch,policy", [("qwen3-4b", "tp_fsdp"),
                                         ("whisper-small", "fsdp")])
def test_place_params_accepts_the_attention_train_cells(arch, policy):
    """Published shapes on meta tensors: the train cell's parameters are
    placed, under TP × FSDP or pure FSDP (no model axis for tensor
    parallelism, every position a batch row); the split step itself is
    held in ``tests/test_torch_lm_tp_train.py``."""
    cell = Cell(arch, "train_4k", make_mesh((2, 2), ("data", "model"),
                                            "meta"), device="meta")
    tp = cell.place_params()
    assert cell.tp is tp and cell.policy == policy
    assert len(tp.rows) == (2 if policy == "tp_fsdp" else 4)
    assert (tp.model_axis is None) == (policy == "fsdp")


@pytest.mark.parametrize("arch", ("rwkv6-7b", "zamba2-1.2b"))
@pytest.mark.parametrize("shape", ("prefill_32k", "decode_32k",
                                   "long_500k"))
def test_place_params_accepts_the_recurrent_serving_cells(arch, shape):
    """Published shapes on meta tensors: the heads split over ``model``
    (64 of 64 for both), ``u``/``conv_w``/``ln_y`` as their rules say."""
    cell = Cell(arch, shape, make_mesh((2, 2), ("data", "model"), "meta"),
                device="meta")
    tp = cell.place_params()
    assert cell.tp is tp and tp.head_sites(64)[0][1][1:] == (32, 64)
    if arch == "rwkv6-7b":
        layer = cell.model.layers[0]
        assert tp.model_dim(layer.u) == 0 and tp.model_dim(layer.wr) == 1
    else:
        layer = cell.model.mamba[0]
        assert (tp.model_dim(layer.conv_w), tp.model_dim(layer.ln_y),
                tp.model_dim(layer.w_in), tp.model_dim(layer.a_log)) \
            == (1, 0, 1, None)


#: (arch, mesh, overrides, shape): per-head layouts on both meshes, the
#: conv state ``fit_spec`` leaves whole over ``model``, and ``long_500k``
#: (b = 1, a batch the data axis does not split: its positions (1, j)
#: hold replicas)
STATE_CASES = [
    ("rwkv6-7b", "2x2", (("ssm_head_dim", 16),), "decode_32k"),
    ("zamba2-1.2b", "1x4", (("ssm_head_dim", 32),), "decode_32k"),
    ("rwkv6-7b", "2x2", (("ssm_head_dim", 16),), "long_500k"),
    ("zamba2-1.2b", "2x2", (), "long_500k")]


@pytest.mark.parametrize("arch,mesh_name,overrides,shape", STATE_CASES,
                         ids=["-".join([a, m, s] + [f"{k}{v}" for k, v in o])
                              for a, m, o, s in STATE_CASES])
def test_placed_states_hold_their_spec_slices(arch, mesh_name, overrides,
                                              shape, monkeypatch):
    """After a split prefill and each of 4 split decode steps, every
    position's tensor of every state leaf is its fitted ``cache_specs``
    slice of the mesh-less cache (within ``TOL``), the same tensor as
    before (written in place), a proper slice where the spec splits; no
    state is assembled or gathered whole in a step; logits and greedy
    tokens as the mesh-less step's."""
    params = reference_run(arch, **dict(overrides))[0]
    b = TC.SHAPES[shape].batch if shape == "long_500k" else B
    with patched(arch, {shape: (S_MAX, b)}, **dict(overrides)):
        mesh = make_mesh(MESHES[mesh_name], ("data", "model"), "cpu")
        dec = build_cell(arch, shape, mesh)
        plain = build_cell(arch, shape,
                           make_mesh((1, 1), ("data", "model"), "cpu"))
    for cell in (dec, plain):
        load_lm_params(cell.model, params)
    tp = dec.place_params()
    inputs = _torch(_inputs(dec.cfg, b=b))
    ls, cs = _prefill(dec.model, inputs, S_MAX)
    lp, cp = _prefill(plain.model, inputs, S_MAX)
    torch.testing.assert_close(ls, lp, **TOL)
    states = cs["mamba"] if "mamba" in cs else cs
    ref = cp["mamba"] if "mamba" in cp else cp
    specs = shd.fit_spec_tree(mesh, shd.cache_specs(None, mesh, ref), ref)
    if "conv" in states:       # the reference's k-1 axis over model
        assert shd.cache_specs(None, mesh, ref)["conv"][2] == "model"
        assert specs["conv"][2] is None
    held = {}
    for key, pl in states.items():
        assert isinstance(pl, Placed) and pl.sharding.spec == specs[key]
        held[key] = {pos: pl.local(pos) for pos in np.ndindex(
            mesh.devices.shape)}

    def check():
        n_split = 0
        for key, pl in states.items():
            whole = ref[key]
            split = not pl.sharding.is_fully_replicated
            n_split += split
            for pos in np.ndindex(mesh.devices.shape):
                local = pl.local(pos)
                assert local is held[key][pos], (key, pos)
                want = whole[pl.sharding.local_slices(pos, whole.shape)]
                torch.testing.assert_close(local, want, **TOL)
                if pl.sharding.shards(2) > 1:
                    assert local.numel() < whole.numel(), (key, pos)
        return n_split

    assert check() > 0
    split_step, plain_step = dec.decode_fn(), plain.decode_fn()
    for _ in range(4):
        nxt = lp.argmax(-1)[:, None]
        tp.moved.clear()
        with monkeypatch.context() as m:
            for name in ("full", "gather"):
                m.setattr(Placed, name, lambda *a, **k: pytest.fail(
                    "a placed value assembled in a split step"))
            ls, cs = split_step({"tokens": nxt, "cache": cs})
        lp, cp = plain_step({"tokens": nxt, "cache": cp})
        torch.testing.assert_close(ls, lp, **TOL)
        assert torch.equal(ls.argmax(-1), lp.argmax(-1))
        check()
        # the positions holding a replica of a slice they did not compute
        assert tp.bytes_by_kind()["state"] > 0


# --- the reference's partitioned cells on its own 8-device mesh -------------

SUBPROCESS_CASES = ("qwen3-4b", "llama4-maverick-400b-a17b", "rwkv6-7b",
                    "zamba2-1.2b")
#: config overrides in the subprocess: qk-norm on, and the recurrent
#: families with four heads, split over the model axis of 4
SUBPROCESS_OVERRIDES = {"qwen3-4b": {"qk_norm": True},
                        "rwkv6-7b": {"ssm_head_dim": 16},
                        "zamba2-1.2b": {"ssm_head_dim": 32}}
REF_SEQ, REF_B, REF_PROMPT = 64, 8, 6       # tests/distributed_inner.py


def _case(arch: str):
    """The reference's prefill and decode cells compiled on its (2, 4)
    mesh with ``in_shardings`` from its specs, called on parameters and
    inputs put by them, against the port's placed cells on a CPU (2, 4)
    mesh."""
    from repro.distributed import sharding as jshd
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_test_mesh as jax_test_mesh
    jmesh = jax_test_mesh(2, 4)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    over = SUBPROCESS_OVERRIDES.get(arch, {})
    shapes = {"prefill_32k": (REF_SEQ, REF_B), "decode_32k": (REF_SEQ, REF_B)}
    with patched(arch, shapes, pkgs=(JC, TC), **over):
        cells = {}
        for shape in shapes:
            jcell = jsteps.build_cell(arch, shape, jmesh)
            cell = build_cell(arch, shape, mesh)
            cells[shape] = jcell, cell
    jpre, pre = cells["prefill_32k"]
    jdec, dec = cells["decode_32k"]
    params = jpre.model.init(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, params)
    for cell in (pre, dec):
        load_lm_params(cell.model, host)
        cell.place_params()
    named = lambda t: jshd.to_named(jmesh, t)    # noqa: E731
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, pre.cfg.vocab, (REF_B, REF_SEQ)).astype(np.int32)
    with jmesh:
        step = jax.jit(jpre.prefill_fn(), in_shardings=(
            named(jpre.pspecs), named(jpre.input_shardspecs())))
        jl, _ = step(jax.device_put(params, named(jpre.pspecs)),
                     jax.device_put({"tokens": jnp.asarray(tokens)},
                                    named(jpre.input_shardspecs())))
    tl, _ = pre.prefill_fn()({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert (tl.argmax(-1).numpy() == np.asarray(jl.argmax(-1))).all()

    prompt = {"tokens": tokens[:, :REF_PROMPT]}
    jl, jcache = _prefill(jdec.model, {k: jnp.asarray(v) for k, v in
                                       prompt.items()}, REF_SEQ, params)
    tl, cache = _prefill(dec.model, _torch(prompt), REF_SEQ)
    jparams = jax.device_put(params, named(jdec.pspecs))
    in_named = named(jdec.input_shardspecs())
    with jmesh:
        jstep = jax.jit(jdec.decode_fn(), in_shardings=(
            named(jdec.pspecs), in_named))
    step = dec.decode_fn()
    for _ in range(STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        assert (tl.argmax(-1).numpy() == nxt[:, 0]).all()
        with jmesh:
            jl, jcache = jstep(jparams, jax.device_put(
                {"tokens": jnp.asarray(nxt), "cache": jcache}, in_named))
        tl, cache = step({"tokens": torch.from_numpy(nxt), "cache": cache})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


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
def test_placed_cells_match_the_reference_partitioned_cells(
        case, partitioned_run):
    assert partitioned_run[case] == "OK", partitioned_run[case]


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

"""Cells built on ``meta`` and placed piece by piece
(``Cell(..., device="meta")``, ``Cell.place_params(seed=)``) on CPU
meshes: a model that no one device holds, each piece drawn where it
lies by the model's own init law.

* A reduced arch of each family (dense, vlm, moe, encdec, ssm, hybrid) on
  (2, 2) and (1, 4) meshes: its split prefill and decode steps against
  the mesh-less step of the same pieces assembled whole at ``rtol = atol
  = 2e-4`` (``tests/distributed_inner.py:75``), greedy tokens equal over
  6 decode steps; its split train step against the assembled whole's at
  ``rtol 1e-4, atol 1e-5`` (loss, every gradient, ``grad_norm``, params,
  m and v after one AdamW update, eps 1e-3).
* The pieces: the same when placed twice and whatever device list the
  mesh is given; other for another seed; one tensor a slice and device,
  no whole split leaf anywhere, the model's own tensors left on ``meta``;
  the assembled leaves follow the init's law (norms ones, zeros, the
  normals' scale).
* ``place_params`` refuses a seed for loaded weights and a meta model
  without one.

The reference's own partitioned cells on the assembled pieces of
meta-placed llama4-maverick and zamba2 cells run with the other
partitioned cases, in ``tests/test_torch_lm_tp.py`` (prefill and decode)
and ``tests/test_torch_lm_tp_train.py`` (the train step).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import Placed, make_mesh  # noqa: E402
from repro_torch.launch.steps import Cell, build_cell  # noqa: E402
from repro_torch.training import adamw_update  # noqa: E402
from repro_torch.training.train_loop import loss_and_grads  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from test_torch_lm_tp import (N_FRAMES, PROMPT, S_MAX, STEPS,  # noqa: E402
                              _inputs, _prefill)
from test_torch_lm_tp_train import (AXES, MESHES, TRAIN_EPS,  # noqa: E402
                                    _batch, _flat, _torch, patched)

SERVE_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/distributed_inner.py:75
TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)
#: one arch of each family; rwkv6 and zamba2 with four heads (reduced
#: rwkv6's one head is ill-conditioned in fp32 training, and four heads
#: split over the model axis)
FAMILIES = {"dense": ("llama3-8b", {}), "vlm": ("pixtral-12b", {}),
            "moe": ("llama4-maverick-400b-a17b", {}),
            "encdec": ("whisper-small", {}),
            "ssm": ("rwkv6-7b", {"ssm_head_dim": 16}),
            "hybrid": ("zamba2-1.2b", {"ssm_head_dim": 32})}
B, S = 8, 8           # the train batch, as tests/test_torch_lm_tp_train.py
SEED = 11


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: its tensors are tiny and
    its ops many, and the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NoMetaReads(TorchDispatchMode):
    """While active, an op given both ``meta`` and other tensors raises
    (the CPU runs such an op on the meta tensor's missing values): a
    split step must read the placed pieces, never the model's own
    ``meta`` tensors."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = [a for a in (*args, *kwargs.values())
                for a in (a if isinstance(a, (list, tuple)) else (a,))
                if isinstance(a, torch.Tensor)]
        if {t.is_meta for t in flat} == {True, False}:
            raise AssertionError(f"{func} reads a meta tensor")
        return func(*args, **kwargs)


def _meta_cells(family: str, shape: str, mesh, seed: int = SEED):
    """``family``'s reduced ``shape`` cell built on ``meta`` over ``mesh``
    and placed from ``seed``, and a mesh-less cell (a (1, 1) CPU mesh)
    holding the same pieces assembled whole."""
    arch, over = FAMILIES[family]
    shapes = {"prefill_32k": (PROMPT, 4), "decode_32k": (S_MAX, 4),
              "train_4k": (S, B)}
    with patched(arch, {shape: shapes[shape]}, **over):
        cell = Cell(arch, shape, mesh, device="meta")
        whole = build_cell(arch, shape, make_mesh((1, 1), AXES, "cpu"))
    tp = cell.place_params(seed=seed)
    if shape == "train_4k" and family == "ssm":
        _draw_u(tp)
    with torch.no_grad():
        for (path, t), (_, pl) in zip(_flat(whole.model.tensor_tree()),
                                      _flat(tp.tree), strict=True):
            t.copy_(pl.full("cpu"))
    for c in (cell, whole):
        c.opt_cfg = dataclasses.replace(c.opt_cfg, eps=TRAIN_EPS)
    return cell, whole


def _draw_u(tp) -> None:
    """rwkv6's bonus ``u`` pieces redrawn from N(0, 0.5²), as
    ``chip_smoke.split_train_cell`` draws them: at the init's zeros the
    first WKV output is exactly 0 and ``ln_x`` scales layer 0's ``u``
    gradient by rsqrt(eps) = 1e3, so that no two fp32 evaluations of it
    hold each other at ``TRAIN_TOL`` (ROADMAP, Reference caveats)."""
    for path, pl in _flat(tp.tree):
        if path[-1] == "u":
            for key, holders in pl.holders().items():
                gen = torch.Generator().manual_seed(hash(key) % 2**31)
                with torch.no_grad():
                    t = pl.local(holders[0])
                    t.copy_(0.5 * torch.randn(t.shape, generator=gen))


def _inputs_of(cfg) -> dict:
    inputs = _torch(_inputs(cfg))
    if cfg.family == "encdec":
        assert inputs["frames"].shape[1] == N_FRAMES
    return inputs


CASES = [(f, m) for f in FAMILIES for m in MESHES]


@pytest.mark.parametrize("family,mesh_name", CASES,
                         ids=[f"{f}-{m}" for f, m in CASES])
def test_split_serving_steps_match_the_pieces_assembled_whole(family,
                                                              mesh_name):
    mesh = make_mesh(MESHES[mesh_name], AXES, "cpu")
    pre, whole = _meta_cells(family, "prefill_32k", mesh)
    assert pre.model.device == torch.device("cpu")
    inputs = _inputs_of(pre.cfg)
    with _NoMetaReads():
        got, _ = pre.prefill_fn()(inputs)
    want, _ = whole.prefill_fn()(inputs)
    torch.testing.assert_close(got, want, **SERVE_TOL)

    dec, whole = _meta_cells(family, "decode_32k", mesh)
    with _NoMetaReads():
        ls, cs = _prefill(dec.model, inputs, S_MAX)
    lp, cp = _prefill(whole.model, inputs, S_MAX)
    torch.testing.assert_close(ls, lp, **SERVE_TOL)
    split_step, plain_step = dec.decode_fn(), whole.decode_fn()
    for _ in range(STEPS):
        assert torch.equal(ls.argmax(-1), lp.argmax(-1))
        nxt = lp.argmax(-1)[:, None]
        with _NoMetaReads():
            ls, cs = split_step({"tokens": nxt, "cache": cs})
        lp, cp = plain_step({"tokens": nxt, "cache": cp})
        torch.testing.assert_close(ls, lp, **SERVE_TOL)


@pytest.mark.parametrize("family,mesh_name", CASES,
                         ids=[f"{f}-{m}" for f, m in CASES])
def test_split_train_step_matches_the_pieces_assembled_whole(family,
                                                             mesh_name):
    split, whole = _meta_cells(family, "train_4k",
                               make_mesh(MESHES[mesh_name], AXES, "cpu"))
    batch = _torch(_batch(split.cfg))
    got, want = split.train_state(), whole.train_state()
    with _NoMetaReads():
        ls, gs = loss_and_grads(split.model, got.params, batch,
                                split.n_micro)
    lp, gp = loss_and_grads(whole.model, want.params, batch, whole.n_micro)
    torch.testing.assert_close(ls, lp, **TRAIN_TOL)
    for (path, g), (_, w) in zip(_flat(gs), _flat(gp), strict=True):
        assert isinstance(g, Placed), path
        torch.testing.assert_close(g.full(), w, msg=str(path), **TRAIN_TOL)
    with _NoMetaReads():
        got, ms = adamw_update(got, gs, split.opt_cfg)
    want, mp = adamw_update(want, gp, whole.opt_cfg)
    torch.testing.assert_close(ms["grad_norm"], mp["grad_norm"], **TRAIN_TOL)
    for part in ("params", "m", "v"):
        for (path, g), (_, w) in zip(_flat(getattr(got, part)),
                                     _flat(getattr(want, part)),
                                     strict=True):
            torch.testing.assert_close(g.full(), w.detach(),
                                       msg=f"{part} {path}", **TRAIN_TOL)


def _pieces(cell) -> dict:
    """(leaf path, slice key, device) -> the piece, once each."""
    out = {}
    for path, pl in _flat(cell.tp.tree):
        for pos in np.ndindex(cell.mesh.devices.shape):
            out.setdefault((path, pl.slice_key(pos),
                            cell.mesh.devices[pos]), pl.local(pos))
    return out


@pytest.mark.parametrize("family", ("moe", "hybrid"))
def test_pieces_depend_on_the_seed_leaf_and_slice_alone(family):
    """A TP × FSDP train cell (slices over both axes): placed twice, and
    on a mesh given its devices as a list, the same pieces bitwise;
    another seed, other pieces; one tensor a slice and device, shaped as
    its slice; the model's own tensors stay on ``meta``."""
    cells = [_meta_cells(family, "train_4k", make_mesh((2, 2), AXES, devs),
                         seed)[0]
             for devs, seed in (("cpu", SEED), ("cpu", SEED),
                                ([torch.device("cpu")] * 4, SEED),
                                ("cpu", SEED + 1))]
    first = _pieces(cells[0])
    for other in cells[1:3]:
        again = _pieces(other)
        assert again.keys() == first.keys()
        for key, t in first.items():
            assert torch.equal(again[key], t), key
    moved = _pieces(cells[3])
    assert sum(not torch.equal(moved[k], t) for k, t in first.items()) > \
        len(first) // 2
    cell = cells[0]
    for path, pl in _flat(cell.tp.tree):
        for key, holders in pl.holders().items():
            assert len({id(pl.local(q)) for q in holders}) == 1, path
            assert tuple(pl.local(holders[0]).shape) == tuple(
                b - a for a, b in key)
    assert all(t.is_meta for _, t in _flat(cell.model.tensor_tree()))


def test_assembled_pieces_follow_the_init_law():
    """llama3's reduced train cell: norms ones, the N(0, 1)·scale leaves
    at their scale (1/√d for the projections, 0.02 for the embedding)
    within 10%, mean near zero."""
    cell, whole = _meta_cells("dense", "train_4k",
                              make_mesh((2, 2), AXES, "cpu"))
    m, d = whole.model, whole.cfg.d_model
    assert torch.equal(m.layers[0].ln1, torch.ones_like(m.layers[0].ln1))
    assert torch.equal(m.final_norm, torch.ones_like(m.final_norm))
    for t, scale in ((m.embed, 0.02), (m.layers[0].attn.wq, d ** -0.5),
                     (m.layers[1].mlp.w_gate, d ** -0.5)):
        assert abs(float(t.std()) / scale - 1) < 0.1
        assert abs(float(t.mean())) < 0.1 * scale


def test_on_mesh_runs_the_same_weights_on_another_device_list():
    """``Cell.on_mesh``: the cell over another mesh of its shape shares
    the model's tensors, keeps its own hook, decode context and
    placement, and its split decode steps are bitwise the cell's."""
    with patched("llama3-8b", {"decode_32k": (S_MAX, 4)}):
        cell = build_cell("llama3-8b", "decode_32k",
                          make_mesh((2, 2), AXES, "cpu"))
    cell.model.init(torch.Generator().manual_seed(SEED))
    twin = cell.on_mesh(make_mesh((2, 2), AXES, [torch.device("cpu")] * 4))
    assert twin.model is not cell.model
    assert twin.model.layers[0].attn.wq is cell.model.layers[0].attn.wq
    assert twin.decode_ctx.mesh is twin.mesh is not cell.mesh
    tp, tp_twin = cell.place_params(), twin.place_params()
    assert cell.tp is tp and twin.tp is tp_twin
    inputs = _inputs_of(cell.cfg)
    la, ca = _prefill(cell.model, inputs, S_MAX)
    lb, cb = _prefill(twin.model, inputs, S_MAX)
    for _ in range(3):
        assert torch.equal(la, lb)
        nxt = la.argmax(-1)[:, None]
        la, ca = cell.decode_fn()({"tokens": nxt, "cache": ca})
        lb, cb = twin.decode_fn()({"tokens": nxt, "cache": cb})
    assert torch.equal(la, lb) and tp.moved == tp_twin.moved
    with pytest.raises(ValueError, match="shaped"):
        cell.on_mesh(make_mesh((1, 4), AXES, "cpu"))


def test_place_params_asks_for_a_seed_exactly_for_a_meta_model():
    mesh = make_mesh((2, 2), AXES, "cpu")
    with patched("llama3-8b", {"decode_32k": (S_MAX, 4)}):
        loaded = build_cell("llama3-8b", "decode_32k", mesh)
        meta = Cell("llama3-8b", "decode_32k", mesh, device="meta")
    with pytest.raises(ValueError, match="seed"):
        loaded.place_params(seed=0)
    with pytest.raises(ValueError, match="seed"):
        meta.place_params()

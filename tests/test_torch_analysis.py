"""repro_torch's analysis (``analysis/{hw,analytic,roofline}.py``) and the
counts of ``Cell.lower()``'s trace against the reference's on the CPU.

* Twins of ``tests/test_analysis.py``'s ``test_model_flops_6nd``,
  ``test_moe_active_params`` and ``test_analyze_cell_int8_companion_terms``
  (the last over a ``Lowered`` of a traced product where the reference
  compiles ``a @ b``).
* ``param_stats``, ``model_flops`` and every ``hbm_bytes_per_device``
  component equal to the reference's for the ten archs × four shapes at
  256 and 512 chips and 1 and 2 microbatches.
* ``Lowered.flops`` equal to ``parse_hlo(...).dot_flops`` of the
  reference's compiled step on the same reduced config and shapes: a
  prefill and a decode step of each family exactly; a remat train step
  within ``TRAIN_FLOPS_RTOL`` above it, the port never below (see
  ``test_remat_train_flops_are_the_reference_hlo_dot_flops``).
* The ``parse_hlo`` tests' counterparts: a Python loop of L products
  counts L·2n³, a checkpointed block counts its forward twice under
  backward; and the trace's live bytes and bytes between positions.
"""

import contextlib
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.analysis.analytic as JA  # noqa: E402
import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.analysis.hlo_parse import parse_hlo  # noqa: E402
from repro.compat import make_mesh as jax_make_mesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.analysis import analytic as TA  # noqa: E402
from repro_torch.analysis import hw  # noqa: E402
from repro_torch.analysis.roofline import (RooflineReport,  # noqa: E402
                                           analyze_cell)
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch.steps import (Lowered, Trace, build_cell,  # noqa: E402
                                      position_bytes)

# one arch of each family
FAMILIES = {"dense": "qwen3-4b", "moe": "phi3.5-moe-42b-a6.6b",
            "ssm": "rwkv6-7b", "hybrid": "zamba2-1.2b",
            "encdec": "whisper-small", "vlm": "pixtral-12b"}
# The port's remat train step counts at least the reference's FLOPs and at
# most this share more: PyTorch runs the backward of a per-step
# matrix-vector product (RWKV6's wkv and Mamba's scan) as a K = 1 bmm,
# which XLA rewrites to a multiply, and ``torch.utils.checkpoint``
# recomputes a block's forward up to its last saved tensor (the MoE
# layer's combine einsum) where JAX recomputes only what the backward
# reads. 4.4% on phi3.5-moe, 1.8% on rwkv6, 0.9% on zamba2; 0 elsewhere.
TRAIN_FLOPS_RTOL = 0.05


@contextlib.contextmanager
def patched(arch: str, shapes: dict, **overrides):
    """Both packages' ``arch`` config reduced (with ``overrides``) and
    ``SHAPES`` cut to ``shapes`` {name: (seq, batch)} while inside."""
    mods = [importlib.import_module(
        f"{pkg.__name__}.{pkg._ARCH_MODULES[arch]}") for pkg in (JC, TC)]
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


# ---------------------------------------------------------------------------
# the twins of tests/test_analysis.py
# ---------------------------------------------------------------------------

def test_model_flops_6nd():
    st = TA.param_stats("llama3-8b")
    assert 7.5e9 < st["total"] < 9e9          # ~8B
    mf = TA.model_flops("llama3-8b", "train_4k")
    n = st["active"] - st["embed"]
    assert mf == 6.0 * n * 256 * 4096


def test_moe_active_params():
    st = TA.param_stats("phi3.5-moe-42b-a6.6b")
    assert st["active"] < st["total"] / 2     # top-2 of 16 experts
    assert 35e9 < st["total"] < 50e9


def test_analyze_cell_int8_companion_terms():
    """The int8 twin of each roofline cell: GEMMs at the int8 tensor-core
    peak (1,979 TOP/s against bf16's 989 TFLOP/s on the H100 sheet, where
    the v5e's is exactly double), the weights-read HBM component at ~1/4
    bytes, both
    arithmetic intensities populated (int8 strictly higher: the same
    FLOPs over fewer bytes)."""
    n = 64
    a, b = (torch.empty(n, n, device="meta") for _ in range(2))
    with Trace() as tr:
        out = a @ b
    lowered = Lowered(tr.ops, out, 0.0, flops=tr.flops,
                      peak_live_bytes=tr.live.peak)
    assert lowered.flops == 2 * n**3
    rep = analyze_cell("llama3-8b", "train_4k", "pod", 512, lowered)

    np.testing.assert_allclose(
        rep.compute_s_int8,
        rep.compute_s * hw.PEAK_FLOPS_BF16 / hw.PEAK_OPS_INT8, rtol=1e-12)
    assert rep.compute_s_int8 < rep.compute_s / 2.0
    an = TA.analytic_cost("llama3-8b", "train_4k", 512, rep.n_micro)
    w_read = an.components["weights_read"]
    assert w_read > 0
    np.testing.assert_allclose(
        rep.memory_s_int8,
        (an.hbm_bytes_per_device - 0.75 * w_read) / hw.HBM_BW, rtol=1e-12)
    assert rep.memory_s_int8 < rep.memory_s
    assert rep.arith_intensity_int8 > rep.arith_intensity > 0.0
    # the dry-run record schema: new fields serialize with the rest
    d = dataclasses.asdict(rep)
    for k in ("compute_s_int8", "memory_s_int8", "arith_intensity",
              "arith_intensity_int8"):
        assert k in d


def test_roofline_report_has_the_reference_fields():
    from repro.analysis.roofline import RooflineReport as JReport
    assert [(f.name, f.default) for f in dataclasses.fields(RooflineReport)] \
        == [(f.name, f.default) for f in dataclasses.fields(JReport)]


def test_analyze_cell_terms_from_the_trace():
    """Each term from its count: FLOPs and the live peak split over the
    chips, the busiest position's bytes over NVLink (by kind in the
    breakdown, nonzero kinds in ``KINDS`` order), H100 rates."""
    low = Lowered(None, None, 0.0, flops=512 * 10**12,
                  peak_live_bytes=512 * 2**30, moved_bytes=9 * 10**9,
                  arg_bytes=70 * 10**9, out_bytes=5 * 10**9,
                  moved_by_kind={"merge": 3 * 10**9, "state": 0,
                                 "tp_reduce": 6 * 10**9})
    rep = analyze_cell("qwen3-4b", "decode_32k", "multipod", 512, low)
    an = TA.analytic_cost("qwen3-4b", "decode_32k", 512)
    assert rep.hlo_dot_flops_per_device == 10**12
    assert rep.raw_cost_analysis_flops == 512 * 10**12
    assert rep.compute_s == 10**12 / hw.PEAK_FLOPS_BF16
    assert rep.memory_s == an.hbm_bytes_per_device / hw.HBM_BW
    assert rep.collective_s == 9e9 / hw.NVLINK_BW == 0.02
    assert rep.collective_breakdown == {"tp_reduce": 6 * 10**9,
                                        "merge": 3 * 10**9}
    assert list(rep.collective_breakdown) == ["tp_reduce", "merge"]
    assert rep.dominant == "collective"
    assert rep.temp_bytes == 2**30
    assert rep.useful_ratio == an.model_flops / 512 / 10**12
    # 70 + 1.07 + 5 GB: over the sheet's 80 GB only with 4 GB more
    assert rep.fits_hbm
    low.out_bytes = 9 * 10**9
    assert not analyze_cell("qwen3-4b", "decode_32k", "multipod", 512,
                            low).fits_hbm


def test_hw_is_the_h100_sxm_sheet():
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_OPS_INT8, hw.PEAK_FLOPS_FP32,
            hw.HBM_BW, hw.HBM_BYTES, hw.NVLINK_BW) == (
        989e12, 1979e12, 67e12, 3.35e12, 80e9, 450e9)
    from repro.analysis.hw import DTYPE_BYTES
    assert hw.DTYPE_BYTES == DTYPE_BYTES


# ---------------------------------------------------------------------------
# the analytic model against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stats():
    """The reference's ``param_stats`` memoised per arch (each call is an
    ``eval_shape`` of the whole model; the grid asks 480 times)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JA, "param_stats",
                   functools.lru_cache(maxsize=None)(JA.param_stats))
        yield JA


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_analytic_model_is_the_reference_model(jax_stats, arch):
    assert TA.param_stats(arch) == jax_stats.param_stats(arch)
    for shape in TC.SHAPES:
        assert TA.model_flops(arch, shape) \
            == jax_stats.model_flops(arch, shape)
        for chips in (256, 512):
            for n_micro in (1, 2):
                got = TA.hbm_bytes_per_device(arch, shape, chips, n_micro)
                want = jax_stats.hbm_bytes_per_device(arch, shape, chips,
                                                      n_micro)
                assert got.components == want.components, (shape, chips)
                assert got.hbm_bytes_per_device \
                    == want.hbm_bytes_per_device
                assert got.model_flops == want.model_flops
                assert TA.analytic_cost(arch, shape, chips, n_micro) \
                    == got


def test_expert_count_sums_every_layer():
    """The port's layers are a list of per-layer dicts: the expert
    weights of every layer count, as the reference's stacked leaf."""
    for arch in ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"):
        cfg = TC.get_config(arch)
        st = TA.param_stats(arch)
        expert = (st["total"] - st["active"]) * cfg.n_experts \
            / (cfg.n_experts - cfg.top_k)
        assert expert == pytest.approx(
            cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff,
            rel=1e-9)


def test_cache_index_counts_as_an_int32():
    """A decode cell's cache bytes count the port's Python ``index`` as
    the reference's 0-d int32: 4 bytes."""
    cell = TC.SHAPES["decode_32k"]
    cache = TC.input_specs("smollm-360m", "decode_32k")["cache"]
    assert isinstance(cache["index"], int)
    tensors = sum(t.numel() * t.element_size() for k, t in cache.items()
                  if k != "index")
    assert TA._cache_bytes("smollm-360m", cell) == tensors + 4


# ---------------------------------------------------------------------------
# the trace's FLOPs against the reference's compiled HLO
# ---------------------------------------------------------------------------

def _both_flops(arch: str, shape: str, **overrides) -> tuple[float, int]:
    """(reference ``dot_flops``, port ``Lowered.flops``) of one reduced
    cell at seq 32, batch 4 on a one-position mesh (the reference's
    per-device HLO is then the global step, as the trace is)."""
    with patched(arch, {shape: (32, 4)}, **overrides):
        jcell = jsteps.build_cell(arch, shape,
                                  jax_make_mesh((1, 1), ("data", "model")))
        lowered, _ = jcell.lower()
        want = parse_hlo(lowered.compile().as_text()).dot_flops
        cell = build_cell(arch, shape,
                          make_mesh((1, 1), ("data", "model"), "meta"))
        assert cell.n_micro == jcell.n_micro
        return want, cell.lower()[0].flops


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("family", FAMILIES)
def test_trace_flops_are_the_reference_hlo_dot_flops(family, shape):
    want, got = _both_flops(FAMILIES[family], shape)
    assert want > 0 and got == want


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_train_flops_are_the_reference_hlo_dot_flops(family):
    """Exact for the dense, encdec and vlm families; see
    ``TRAIN_FLOPS_RTOL`` for the other three."""
    want, got = _both_flops(FAMILIES[family], "train_4k", remat=True)
    assert want <= got <= want * (1 + TRAIN_FLOPS_RTOL), (want, got)
    if family in ("dense", "encdec", "vlm"):
        assert got == want


def test_loop_of_products_counts_every_trip():
    """``parse_hlo``'s loop correction has no counterpart to need: a
    Python loop of L products dispatches L of them."""
    L, n = 7, 64
    x = torch.empty(n, n, device="meta")
    w = torch.empty(L, n, n, device="meta")
    with Trace() as tr:
        for i in range(L):
            x = x @ w[i]
    assert tr.flops == 2 * n**3 * L
    assert tr.ops["mm"] == L


def test_checkpointed_block_counts_its_forward_twice_under_backward():
    from torch.utils.checkpoint import checkpoint

    n = 32
    w1, w2 = (torch.empty(n, n, device="meta", requires_grad=True)
              for _ in range(2))
    x = torch.empty(n, n, device="meta", requires_grad=True)

    def block(h):
        return torch.tanh(h @ w1) @ w2

    with Trace() as plain:
        block(x).sum().backward()
    with Trace() as remat:
        checkpoint(block, x, use_reentrant=False).sum().backward()
    gemm = 2 * n**3
    assert plain.flops == 6 * gemm                 # 2 forward, 4 backward
    # the recompute stops at the last tensor the backward saved: tanh's
    # output, so the first product runs again and the second does not
    assert remat.flops == 7 * gemm


def test_live_bytes_count_created_storages_until_freed():
    n = 16
    a = torch.empty(n, n, device="meta")
    b = torch.empty(n, n, device="meta")
    size = n * n * 4
    with Trace() as tr:
        t1 = a @ b
        t2 = t1 @ b
        v = t2.T                 # a view: no new storage
        t2.add_(1)               # in place: none either
        del t1
        t3 = v @ b
        del t2, v, t3
        a.mul_(2)                # an input, written in place
    assert tr.live.peak == 2 * size
    assert tr.live.now == 0


def test_position_bytes_split_by_the_fitted_spec():
    mesh = make_mesh((2, 4), ("data", "model"), "meta")
    x = torch.empty(8, 16, device="meta")                  # 512 B
    specs = {"a": P("data", None), "b": P(None, ("data", "model")),
             "c": P(), "index": P()}
    tree = {"a": x, "b": x, "c": x, "index": 3}
    assert position_bytes(mesh, specs, tree) == 256 + 64 + 512 + 4


def test_lower_counts_the_reference_fields_per_position():
    """A reduced qwen3 train cell on (2, 2): the arguments are the
    parameters, AdamW's moments and step and the tokens, the outputs the
    new parameters and moments and two fp32 metrics, each split by its
    fitted spec; the trace's live peak leaves the arguments out; the
    split step's busiest position's bytes between positions."""
    with patched("qwen3-4b", {"train_4k": (64, 8)}):
        mesh = make_mesh((2, 2), ("data", "model"), "meta")
        cell = build_cell("qwen3-4b", "train_4k", mesh)
        low, kind = cell.lower()
        tokens = position_bytes(mesh, cell.input_shardspecs(),
                                cell.inputs_sds)
        params = position_bytes(mesh, cell.pspecs, cell.param_shapes)
    assert kind == "train" and low.trace == "split"
    per_pos = {}
    for (_, pos), n in low.moved.items():
        per_pos[pos] = per_pos.get(pos, 0) + n
    assert sorted(per_pos) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert low.moved_bytes == max(per_pos.values()) == per_pos[(0, 0)]
    assert low.moved_bytes == sum(low.moved_by_kind.values())
    assert {"tp_reduce", "fsdp_gather", "vocab", "grad_reduce"} \
        <= set(low.moved_by_kind)
    whole = sum(t.numel() * 4 for t in _leaves(cell.param_shapes))
    assert whole / 4 <= params < whole
    assert tokens == 8 * 64 * 4 // 2                  # batch over data
    assert low.arg_bytes == 3 * params + 4 + tokens   # fp32 moments
    assert low.out_bytes == 3 * params + 8
    assert 0 < low.peak_live_bytes and low.flops > 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_moved_bytes_is_the_hand_count_on_a_2x2_mesh():
    """Reduced qwen3 decode on (data 2, model 2), batch 8, split: each
    batch row of 4 works on its own positions, (i, 0) and (i, 1). Per
    layer, on every position: the row's q to its other position and that
    position's local max, the row's max, ``l`` and ``o`` back (``merge``;
    the new k/v rows are at slot 0's owner, the row's first position,
    already); q's, k's and v's columns joined on the first position and
    the attention output's columns sent back to ``wo``'s rows
    (``heads``); the normed activation to the other position and the
    partial sums back, for attention and the MLP (``tp_reduce``). Then
    the head's input (``tp_reduce``); the token ids and the embedding's
    partials, the logits' columns to the row's first position and the
    second row's logits to the first position (``vocab``). The unplaced
    decode of the same cell (whole weights, the cache split) copies in
    its merge alone (``DecodeShardCtx.moved``): per layer the first
    position sends the new k/v rows to the one other position owning
    slot 0 (data shard 1, model shard 0) and q to the three others; each
    batch row merges on its own first position, (0, 0) and (1, 0): it
    takes the local max of its row's other position and sends the row's
    max back, then takes that position's ``l`` and ``o``; row 1's output
    goes to the first position. A (1, 1) mesh copies nothing. A reduced
    llama3 train cell on (2, 2) gathers and reduces its hand count
    (``_hand_count``)."""
    from test_torch_lm_tp_train import _hand_count

    with patched("qwen3-4b", {"decode_32k": (64, 8)}):
        cfg = TC.get_config("qwen3-4b")
        cell = build_cell("qwen3-4b", "decode_32k",
                          make_mesh((2, 2), ("data", "model"), "meta"))
        low, _ = cell.lower()
        unplaced, _ = cell._lower("unplaced")
        one, _ = build_cell("qwen3-4b", "decode_32k", make_mesh(
            (1, 1), ("data", "model"), "meta")).lower()
    f32, b_local, tok = 4, 4, 4
    d, h, kv, hd, v = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.vocab
    q = b_local * h * hd * f32
    stat = b_local * h * f32                       # a max, or l
    o = b_local * h * hd * f32
    act = b_local * d * f32                        # one token a row
    cols = b_local * (h + 2 * kv) * hd * f32 // 2  # q, k, v: one half
    hand = {
        "merge": cfg.n_layers * (q + 3 * stat + o),
        "heads": cfg.n_layers * (cols + o // 2),
        "tp_reduce": cfg.n_layers * 4 * act + act,
        "vocab": b_local * tok + act + b_local * v * f32 // 2,
    }
    first = dict(hand, vocab=hand["vocab"] + b_local * v * f32)
    for pos in np.ndindex(2, 2):
        got = {k: n for (k, p), n in low.moved.items() if p == pos}
        assert got == (first if pos[1] == 0 else hand), pos
    assert low.moved_bytes == sum(first.values())
    assert low.moved_by_kind == first
    assert one.moved_bytes == 0 and one.trace == "unplaced"

    assert {k for k, _ in unplaced.moved} == {"merge"}
    moved = {pos: n for (_, pos), n in unplaced.moved.items()}
    kv_rows = 2 * b_local * kv * hd * f32          # k and v, one position
    per_layer = kv_rows + 3 * q + 3 * stat + 2 * o
    assert unplaced.moved_bytes == moved[(0, 0)] == cfg.n_layers * per_layer
    assert max(moved.values()) == moved[(0, 0)]
    assert moved[(0, 1)] == moved[(1, 1)] == cfg.n_layers * (q + 3 * stat
                                                             + o)
    assert moved[(1, 0)] == cfg.n_layers * (kv_rows + q + 3 * stat + 2 * o)
    assert unplaced.moved_by_kind == {"merge": unplaced.moved_bytes}

    for remat in (False, True):
        with patched("llama3-8b", {"train_4k": (8, 8)}, remat=remat):
            train = build_cell("llama3-8b", "train_4k", make_mesh(
                (2, 2), ("data", "model"), "meta"))
            low, _ = train.lower()
        want = _hand_count(train.cfg, 4, 8, remat)
        by_kind = {}
        for (k, _), n in low.moved.items():
            by_kind[k] = by_kind.get(k, 0) + n
        assert {k: by_kind[k] // 2 for k in ("fsdp_gather",
                                            "grad_reduce")} \
            == {k: want[k] for k in ("fsdp_gather", "grad_reduce")}

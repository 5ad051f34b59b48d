"""The dry run's trace of the split step (``Cell.lower`` over placed
parameters, ``TensorParallel``'s ``one_row``) on the CPU.

* One batch row traced and the others counted by symmetry against every
  row traced (``Cell._lower("all_rows")``): every position's bytes by
  kind, the busiest position's, and the FLOPs, exactly equal, on reduced
  cells on meta meshes of 8 positions: llama3-8b ``train_4k`` and
  ``decode_32k`` on (4, 2), its ``train_4k`` on (2, 2, 2) with the
  multipod axes, smollm-360m ``train_4k`` under pure FSDP, phi3.5-moe's
  ``decode_32k`` (a routing unit of every row) and ``train_4k`` (a unit a
  row), llama4-maverick's ``train_4k`` (its experts' F over ``data``,
  their products joined), whisper-small's (encoder-decoder) and
  pixtral-12b's (vision-language) ``train_4k`` and ``decode_32k``,
  rwkv6's and zamba2's ``decode_32k`` (their placed states), ``train_4k``
  (rwkv6 with and without remat) and ``prefill_32k`` with 4 heads, two
  head sites a row on (4, 2) and four on (2, 4) (the one-row trace scans
  a row's sites as one, ``TensorParallel.scan_sites``; every row traced
  scans each site), and a batch the mesh's rows do not divide (one row).
  The live-bytes peak, an estimate, lies between the every-row trace's
  and ``rows`` times it. A train step whose routing unit spans every row
  traces every row; a one-row placement refuses a mesh of real devices.
* The trace against an executed step: reduced llama3-8b's train and
  decode cells, rwkv6's train cell (remat) and zamba2's prefill cell
  placed on a CPU (2, 2) mesh with real tensors count what their meta
  traces count (``TensorParallel.moved``).
* The cost: with four sites a row and s = 64, the split trace of a
  recurrent train cell dispatches at most 1.5 times the unplaced step's
  ops.
* The records: every cell on a production mesh traces the split step.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from test_torch_lm_tp_train import (AXES, _batch, _cells, _torch,  # noqa: E402
                                    patched)

MULTIPOD = ("pod", "data", "model")
PHI = "phi3.5-moe-42b-a6.6b"
LLAMA4 = "llama4-maverick-400b-a17b"
#: the recurrent families' reduced configs with 4 heads
RWKV6 = {"ssm_head_dim": 16}
ZAMBA2 = {"ssm_head_dim": 32}

#: (arch, shape, mesh, axes, (seq, batch)), each on 8 positions
CASES = {
    "llama3-train": ("llama3-8b", "train_4k", (4, 2), AXES, (16, 8)),
    "llama3-decode": ("llama3-8b", "decode_32k", (4, 2), AXES, (64, 8)),
    "llama3-train-multipod": ("llama3-8b", "train_4k", (2, 2, 2), MULTIPOD,
                              (16, 8)),
    "smollm-train-fsdp": ("smollm-360m", "train_4k", (4, 2), AXES, (16, 8)),
    "phi-decode": (PHI, "decode_32k", (4, 2), AXES, (64, 8)),
    "phi-train": (PHI, "train_4k", (4, 2), AXES, (256, 8)),
    "llama4-train": (LLAMA4, "train_4k", (4, 2), AXES, (256, 8)),
    "llama3-decode-undivided": ("llama3-8b", "decode_32k", (4, 2), AXES,
                                (64, 6)),
    "whisper-train": ("whisper-small", "train_4k", (4, 2), AXES, (16, 8)),
    "whisper-decode": ("whisper-small", "decode_32k", (4, 2), AXES,
                       (64, 8)),
    "pixtral-train": ("pixtral-12b", "train_4k", (4, 2), AXES, (16, 8)),
    "pixtral-decode": ("pixtral-12b", "decode_32k", (4, 2), AXES, (64, 8)),
    "rwkv6-decode": ("rwkv6-7b", "decode_32k", (4, 2), AXES, (64, 8)),
    "zamba2-decode": ("zamba2-1.2b", "decode_32k", (4, 2), AXES, (64, 8)),
    # (..., config overrides): 4 heads, a row's head sites scanned as one
    "rwkv6-train": ("rwkv6-7b", "train_4k", (4, 2), AXES, (16, 8), RWKV6),
    "rwkv6-train-remat": ("rwkv6-7b", "train_4k", (4, 2), AXES, (16, 8),
                          {**RWKV6, "remat": True}),
    "rwkv6-prefill": ("rwkv6-7b", "prefill_32k", (4, 2), AXES, (16, 8),
                      RWKV6),
    "zamba2-train": ("zamba2-1.2b", "train_4k", (4, 2), AXES, (16, 8),
                     ZAMBA2),
    "zamba2-prefill": ("zamba2-1.2b", "prefill_32k", (4, 2), AXES, (16, 8),
                       ZAMBA2),
    "rwkv6-train-4-sites": ("rwkv6-7b", "train_4k", (2, 4), AXES, (16, 8),
                            RWKV6),
}


def _meta_cell(arch, shape, mesh_shape, axes, seq_batch, overrides=None):
    with patched(arch, {shape: seq_batch}, **(overrides or {})):
        return build_cell(arch, shape, make_mesh(mesh_shape, axes, "meta"))


@pytest.mark.parametrize("case", CASES)
def test_one_row_counts_what_every_row_counts(case):
    arch, shape, mesh_shape, axes = CASES[case][:4]
    cell = _meta_cell(*CASES[case])
    one, kind = cell.lower()
    full, _ = cell._lower("all_rows")
    assert (one.trace, full.trace) == ("split", "split")
    rows = 1 if case.endswith("undivided") else (
        8 if cell.policy == "fsdp" else math.prod(mesh_shape[:-1]))
    # each op of the traced row counts once a row: the rows' temporaries
    # held together, where the every-row trace frees a row's before the
    # next row's (1.0-7.0 times its peak on these cells)
    assert full.peak_live_bytes <= one.peak_live_bytes \
        <= rows * full.peak_live_bytes
    assert (one.rows, one.rows_traced, full.rows_traced) == (rows, 1, rows)
    assert +one.moved == +full.moved and one.moved
    assert one.moved_by_kind == full.moved_by_kind
    assert one.moved_bytes == full.moved_bytes > 0
    assert one.flops == full.flops > 0
    if rows > 1:
        assert one.n_ops < full.n_ops
    if kind == "train":
        assert one.moved_by_kind["fsdp_gather"] > 0
        assert one.moved_by_kind["grad_reduce"] > 0


def test_a_routing_unit_of_every_row_traces_every_row():
    """phi3.5-moe ``train_4k`` with 2 rows of 16 tokens a batch row: the
    routing group is the batch's 128 tokens, so the rows route as one
    unit (``moe._moe_split``) and the trace runs all four."""
    cell = _meta_cell(PHI, "train_4k", (4, 2), AXES, (16, 8))
    low, _ = cell.lower()
    full, _ = cell._lower("all_rows")
    assert (low.trace, low.rows, low.rows_traced) == ("split", 4, 4)
    assert +low.moved == +full.moved and low.flops == full.flops


def test_a_one_row_placement_needs_a_meta_mesh():
    with patched("llama3-8b", {"decode_32k": (64, 8)}):
        cell = build_cell("llama3-8b", "decode_32k",
                          make_mesh((2, 2), AXES, "cpu"))
    with pytest.raises(ValueError, match="meta meshes only"):
        cell._place(one_row=True)


def test_the_trace_counts_what_an_executed_step_copies():
    """Reduced llama3-8b on a CPU (2, 2) mesh, parameters placed: one
    train step (remat, TP × FSDP) and one decode step copy between
    positions exactly what the meta traces of the same cells count."""
    split, _ = _cells("llama3-8b", (2, 2), True, 1)
    split.tp.moved.clear()
    split.train_step_fn()(split.train_state(), _torch(_batch(split.cfg)))
    low, _ = split.lower()
    assert low.rows_traced == 1
    assert +low.moved == +split.tp.moved

    with patched("llama3-8b", {"decode_32k": (64, 8)}):
        dec = build_cell("llama3-8b", "decode_32k",
                         make_mesh((2, 2), AXES, "cpu"))
    dec.model.init(torch.Generator().manual_seed(0))
    tp = dec.place_params()
    cache = dec.model.init_cache(8, 64)
    dec.decode_fn()({"tokens": torch.zeros(8, 1, dtype=torch.int32),
                     "cache": cache})
    low, _ = dec.lower()
    assert low.rows_traced == 1
    assert +low.moved == +tp.moved
    per_pos = tp.by_position()
    assert low.moved_bytes == max(per_pos.values())


def test_recurrent_traces_count_what_executed_steps_copy():
    """Reduced rwkv6 (4 heads) and zamba2 (4 heads) on a CPU (2, 2) mesh,
    parameters placed: rwkv6's train step (remat, TP × FSDP) and zamba2's
    prefill (its ``state`` writes, the row's first site's B/C conv state
    among them) copy between positions exactly what their meta traces,
    each row's sites scanned as one, count."""
    split, _ = _cells("rwkv6-7b", (2, 2), True, 1, **RWKV6)
    split.tp.moved.clear()
    split.train_step_fn()(split.train_state(), _torch(_batch(split.cfg)))
    low, _ = split.lower()
    assert (low.trace, low.rows_traced, low.rows) == ("split", 1, 2)
    assert +low.moved == +split.tp.moved
    assert low.moved_by_kind["heads"] > 0

    with patched("zamba2-1.2b", {"prefill_32k": (16, 8)}, **ZAMBA2):
        pre = build_cell("zamba2-1.2b", "prefill_32k",
                         make_mesh((2, 2), AXES, "cpu"))
    pre.model.init(torch.Generator().manual_seed(0))
    tp = pre.place_params()
    tokens = torch.from_numpy(_batch(pre.cfg, 8, 16)["tokens"])
    pre.prefill_fn()({"tokens": tokens})
    low, _ = pre.lower()
    assert (low.trace, low.rows_traced, low.rows) == ("split", 1, 2)
    assert +low.moved == +tp.moved
    assert tp.bytes_by_kind()["state"] > 0
    per_pos = tp.by_position()
    assert low.moved_bytes == max(per_pos.values())


@pytest.mark.parametrize("arch,overrides", [("rwkv6-7b", RWKV6),
                                            ("zamba2-1.2b", ZAMBA2)],
                         ids=["rwkv6-7b", "zamba2-1.2b"])
def test_joined_sites_trace_about_the_unplaced_ops(arch, overrides):
    """Four head sites a row on (2, 4), s = 64: the one-row split trace
    dispatches at most 1.5 times the unplaced step's ops (its per-site
    sends, slices and the join are all it adds to the one scan)."""
    cell = _meta_cell(arch, "train_4k", (2, 4), AXES, (64, 8), overrides)
    one, _ = cell.lower()
    sites = cell._meta_twin()._place(True).head_sites(4)
    assert len(sites) == 1 and len(sites[0]) == 4
    unplaced, _ = cell._lower("unplaced")
    assert one.trace == "split" and unplaced.trace == "unplaced"
    assert one.flops == unplaced.flops
    assert one.n_ops <= 1.5 * unplaced.n_ops


@pytest.mark.parametrize("arch,shape,trace", [
    ("rwkv6-7b", "train_4k", "split"),
    ("zamba2-1.2b", "prefill_32k", "split"),
    ("rwkv6-7b", "decode_32k", "split"),
    ("llama3-8b", "prefill_32k", "split"),
])
def test_records_say_which_step_was_traced(arch, shape, trace):
    """A reduced cell's record on the pod mesh (16 batch rows): every
    cell traces the split step, one row of 16, rwkv6's and zamba2's train
    and prefill cells among them."""
    seq = 64 if TC.SHAPES[shape].kind == "decode" else 16
    with patched(arch, {shape: (seq, 32)}):
        rec = dryrun.run_cell(arch, shape, "pod", None)
    assert rec["status"] == "ok" and rec["trace"] == trace
    rl = rec["roofline"]
    assert (rec["rows_traced"], rec["rows"]) == (1, 16)
    assert rl["collective_s"] > 0
    assert sum(rl["collective_breakdown"].values()) \
        == rl["collective_bytes_per_device"]

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
  rwkv6's and zamba2's ``decode_32k`` (their placed states) and a batch
  the mesh's rows do not divide (one row). The live-bytes peak, an
  estimate, lies between the every-row trace's and ``rows`` times it. A
  train step whose routing unit spans every row traces every row; a
  one-row placement refuses a mesh of real devices.
* The trace against an executed step: reduced llama3-8b's train and
  decode cells placed on a CPU (2, 2) mesh with real tensors count what
  their meta traces count (``TensorParallel.moved``).
* The records: rwkv6's and zamba2's train and prefill cells trace the
  unplaced step; every other cell the split one.
"""

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
}


def _meta_cell(arch, shape, mesh_shape, axes, seq_batch):
    with patched(arch, {shape: seq_batch}):
        return build_cell(arch, shape, make_mesh(mesh_shape, axes, "meta"))


@pytest.mark.parametrize("case", CASES)
def test_one_row_counts_what_every_row_counts(case):
    arch, shape, mesh_shape, axes, seq_batch = CASES[case]
    cell = _meta_cell(arch, shape, mesh_shape, axes, seq_batch)
    one, kind = cell.lower()
    full, _ = cell._lower("all_rows")
    assert (one.trace, full.trace) == ("split", "split")
    rows = 1 if case.endswith("undivided") else (
        8 if cell.policy == "fsdp" else 4)
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


@pytest.mark.parametrize("arch,shape,trace", [
    ("rwkv6-7b", "train_4k", "unplaced"),
    ("zamba2-1.2b", "prefill_32k", "unplaced"),
    ("rwkv6-7b", "decode_32k", "split"),
    ("llama3-8b", "prefill_32k", "split"),
])
def test_records_say_which_step_was_traced(arch, shape, trace):
    """A reduced cell's record on the pod mesh (16 batch rows): rwkv6's
    and zamba2's train and prefill cells keep the unplaced step (no
    bytes between positions); every other cell traces the split step,
    one row of 16."""
    seq = 64 if TC.SHAPES[shape].kind == "decode" else 16
    with patched(arch, {shape: (seq, 32)}):
        rec = dryrun.run_cell(arch, shape, "pod", None)
    assert rec["status"] == "ok" and rec["trace"] == trace
    rl = rec["roofline"]
    if trace == "unplaced":
        assert rec["rows_traced"] == rec["rows"] == 1
        assert rl["collective_s"] == 0 and rl["collective_breakdown"] == {}
    else:
        assert (rec["rows_traced"], rec["rows"]) == (1, 16)
        assert rl["collective_s"] > 0
        assert sum(rl["collective_breakdown"].values()) \
            == rl["collective_bytes_per_device"]

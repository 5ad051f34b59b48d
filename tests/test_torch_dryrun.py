"""repro_torch's dry run (``launch/dryrun.py``) on the CPU.

* The grid: every (arch × shape × mesh) in the reference's order, the
  skips exactly ``applicable_shapes``' (80 cells, 16 skips).
* The CLI on whisper-small's ``decode_32k`` at full size on the pod mesh,
  in its spawned worker: the record file and ``summary.json``, a
  record's keys the reference's less ``compile_s`` plus ``lower_s``,
  ``n_ops``, ``trace`` and ``rows_traced`` of ``rows``, its roofline the
  reference's fields.
* A cell that raises gives a ``FAIL`` record and exit code 1; skips alone
  start no worker.
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import pytest

pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro.analysis.roofline import RooflineReport as JReport  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

# the reference's record (src/repro/launch/dryrun.py:40-52, 66-67)
JAX_RECORD_KEYS = {"arch", "shape", "mesh", "chips", "kind", "status",
                   "lower_s", "compile_s", "n_micro", "memory", "roofline"}
JAX_MEMORY_KEYS = {"arg_GiB", "out_GiB", "temp_GiB"}


def test_grid_skips_are_applicable_shapes():
    cells = dryrun.grid(TC.ARCH_NAMES, TC.SHAPES, ["pod", "multipod"])
    assert len(cells) == 80
    assert sum(reason != "run" for *_, reason in cells) == 16
    want = [(a, s, m, TC.applicable_shapes(a)[s]) for a in TC.ARCH_NAMES
            for s in TC.SHAPES for m in ("pod", "multipod")]
    assert cells == want
    for arch in TC.ARCH_NAMES:
        full = TC.get_config(arch).attention == "full"
        skipped = {s for a, s, _, r in cells if a == arch and r != "run"}
        assert skipped == ({"long_500k"} if full else set())


@pytest.fixture(scope="module")
def whisper_decode(tmp_path_factory):
    """``main`` for whisper-small's ``decode_32k`` on the pod mesh: one
    full-size trace in a spawned worker."""
    out = tmp_path_factory.mktemp("dryrun")
    dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k",
                 "--mesh", "pod", "--out", str(out)])
    return out


def test_cli_writes_the_reference_records(whisper_decode):
    summary = json.loads((whisper_decode / "summary.json").read_text())
    assert [r["status"] for r in summary] == ["ok"]
    rec = json.loads((whisper_decode /
                      "whisper-small__decode_32k__pod.json").read_text())
    assert rec == summary[0]
    assert set(rec) == JAX_RECORD_KEYS - {"compile_s"} | {
        "n_ops", "trace", "rows_traced", "rows"}
    assert set(rec["memory"]) == JAX_MEMORY_KEYS
    assert set(rec["roofline"]) == {f.name for f in
                                    dataclasses.fields(JReport)}
    assert (rec["chips"], rec["kind"], rec["n_micro"]) == (256, "decode", 1)
    # the split step, one batch row of 16 model positions traced
    assert (rec["trace"], rec["rows_traced"], rec["rows"]) == ("split", 1,
                                                               16)
    assert rec["n_ops"] > 10_000 and rec["lower_s"] > 0
    rl = rec["roofline"]
    assert rl["dominant"] in ("memory", "collective") and rl["fits_hbm"]
    assert rl["collective_bytes_per_device"] == sum(
        rl["collective_breakdown"].values()) > 0
    assert rl["collective_breakdown"]["merge"] > 0
    assert rl["note"]


class InProcess(ThreadPoolExecutor):
    """The pool ``main`` makes, run in this process so a patch reaches
    the cells."""

    def __init__(self, max_workers, mp_context=None,
                 max_tasks_per_child=None):
        super().__init__(max_workers)


def test_a_failing_cell_is_recorded_and_exits_1(monkeypatch, tmp_path,
                                                capsys):
    def fail(arch, shape, mesh_name, out_dir, roofline=True):
        raise RuntimeError(f"forced {arch} {shape} {mesh_name}")

    monkeypatch.setattr(dryrun, "ProcessPoolExecutor", InProcess)
    monkeypatch.setattr(dryrun, "run_cell", fail)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3-8b", "--mesh", "both",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert [(r["shape"], r["mesh"], r["status"]) for r in summary] == [
        (s, m, "skip" if s == "long_500k" else "FAIL")
        for s in TC.SHAPES for m in ("pod", "multipod")]
    assert all("forced llama3-8b" in r["error"] for r in summary
               if r["status"] == "FAIL")
    out = capsys.readouterr().out
    assert "[dryrun]   FAIL: llama3-8b train_4k pod" in out
    assert out.rstrip().endswith("total=8 ok=0 skip=2 fail=6")


def test_skips_alone_start_no_worker(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(dryrun, "ProcessPoolExecutor", None)
    dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k",
                 "--mesh", "both", "--out", str(tmp_path)])
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert [r["status"] for r in summary] == ["skip", "skip"]
    assert "total=2 ok=0 skip=2 fail=0" in capsys.readouterr().out


def test_main_needs_an_arch_or_all():
    with pytest.raises(SystemExit) as e:
        dryrun.main([])
    assert e.value.code == 2

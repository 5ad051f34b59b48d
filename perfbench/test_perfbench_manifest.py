"""The benchmark's manifest, its files, its imports and its counts."""

import ast
import json
import re

import pytest
import torch

from perfbench import manifest
from perfbench.reference import module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def man():
    return manifest.load()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["perfbench"]
    assert man["command"][1].startswith("perfbench/")
    assert all(_line(w) for w in man["command"])
    assert isinstance(man["run_seconds"], int) \
        and 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) < 64 * 1024


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(man, part):
    names = [e["name"] for e in man[part]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics(man):
    names = {m["name"] for m in man["end_to_end"] + man["per_layer"]}
    assert len(names) == len(man["end_to_end"]) + len(man["per_layer"])
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert callable(manifest.reader(m["name"]))


def test_every_cell_reports_what_it_must(man):
    cells = {c["name"] for c in man["workloads"]}
    e2e_names = {m["name"] for m in man["end_to_end"]}
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        e2e = {m["name"] for m in manifest.metrics_for(man, cell, 0)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = manifest.metrics_for(man, cell, 1)
        assert layer
        for m in layer:
            assert m["moves"] in e2e_names and m["moves"] in e2e


def test_cells_configs_and_traffic(man):
    used = {c["config"] for c in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    pairs = [(c["config"], c["traffic"]) for c in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in man["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] == 1 and _line(c["why"])
        assert NAME.match(c["traffic"]) and NAME.match(c["config"])
        tr = manifest.traffic(c["traffic"])
        assert tr["loop"] in ("closed", "open")
        assert max(tr["ladder"]) <= tr["pool_rows"]
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    for entry in man["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert entry["file"].startswith("perfbench/configs/")
        assert _line(entry["source"]) and _line(entry["why"])
        cfg = manifest.config(man, entry["name"])
        assert cfg["name"] == entry["name"]
        assert cfg["source"] == entry["source"]
        module(cfg["model"])
        limits = manifest.limits(entry["name"])["numbers"]
        assert limits["failed_requests"]["limit"] == 0
        assert limits["score_max_abs_err"]["limit"] > 0


def test_configurations_are_the_published_widths(man):
    for entry in man["configs"]:
        cfg = manifest.config(man, entry["name"])
        assert len(cfg["field_sizes"]) == 39
        assert sum(cfg["field_sizes"]) == 6_648_547
        assert cfg["embed_dim"] == 32 and cfg["hidden"] == [1024] * 3
        assert cfg["dtype"] == "float32"
    dcn = manifest.config(man, "dcnv2-synth39-d32")
    assert dcn["cross_layers"] == 3


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(manifest.HERE.rglob("*.py"))
    assert files
    for path in files:
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if not path.name.startswith("test_"):
            text = path.read_text()
            assert "BENCH_" not in text and "benchmarks/" not in text, path
    for path in (manifest.HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path


def test_step_operation_counts(man):
    step = manifest.count("step")
    dcn = manifest.config(man, "dcnv2-synth39-d32")
    fm = manifest.config(man, "deepfm-synth39-d32")
    assert step.flops_per_row(dcn) == 9_345_024 + 6_750_208 + 4_544
    assert step.flops_per_row(dcn) == 16_099_776
    # MLP, deep head, the FM term's 3,776 operations, the linear term's 39
    # and the two final adds
    assert step.flops_per_row(fm) == 6_750_208 + 2_048 + 3_776 + 39 + 2


def test_kernel_byte_counts(man):
    dcn = manifest.config(man, "dcnv2-synth39-d32")
    fm = manifest.config(man, "deepfm-synth39-d32")
    # three tails of (b, 1248) fp32: layer 0 reads x0 and xw, the later
    # two x0, xw and x; each writes its output
    assert manifest.count("cross").bytes_moved(dcn, 1024) \
        == 1024 * 1248 * 4 * 11
    assert manifest.count("fm").bytes_moved(fm, 1024) \
        == 1024 * (39 * 32 * 4 + 4)
    gather = manifest.count("gather")
    assert gather.table_widths(dcn) == [32]
    assert gather.table_widths(fm) == [32, 1]
    assert gather.bytes_moved(dcn, 1024, 1, 500) \
        == 1024 * 39 * 4 + 39 * 4 + 500 * 32 * 4 + 1024 * 39 * 32 * 4
    assert gather.bytes_moved(fm, 1024, 1, 500) \
        == gather.bytes_moved(dcn, 1024, 1, 500) \
        + 1024 * 39 * 4 + 39 * 4 + 500 * 4 + 1024 * 39 * 4
    for name in ("gather", "cross", "fm"):
        table = manifest.kernel_table(name)
        assert table["kernel"] == name and table["match"]

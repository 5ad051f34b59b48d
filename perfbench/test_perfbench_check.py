"""The check that decides ``correct``, driven on the CPU: the port's CPU
path against the plain reference, the run with the served path broken
underneath, and the control (the reference in TF32) at the
configurations' widths. The look for a card is skipped: ``Bench`` takes
the device."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import check, harness, ids, manifest, weights
from perfbench.reference import common, module

CELLS = {"dcnv2": "dcnv2.closed", "deepfm": "deepfm.closed"}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def small(cell: str, *, widths: bool = False):
    """The cell's configuration with tables capped at 40 rows a field
    (and, unless ``widths``, narrow layers), and its traffic at a few
    dozen rows a request."""
    man = manifest.load()
    c = manifest.workload(man, cell)
    cfg = dict(manifest.config(man, c["config"]))
    cfg["field_sizes"] = [min(n, 40) for n in cfg["field_sizes"]]
    if not widths:
        cfg.update(embed_dim=4, hidden=[16, 16, 16])
    tr = dict(manifest.traffic(c["traffic"]))
    tr.update(rows={"law": "log_uniform", "low": 8, "high": 48},
              ladder=[16, 32, 64], pool_rows=2048, check_requests=6,
              rate_per_s=80, warm_s=0.1)
    return cfg, tr


def run(cell, seed=2**31 + 11, trace=0, seconds=0.3, loop=None):
    cfg, tr = small(cell)
    if loop is not None:
        tr["loop"] = loop
    bench = harness.Bench(cell, device="cpu", config=cfg, traffic=tr)
    return bench.run(seed, seconds, trace, 0.0)


@pytest.mark.parametrize("cell,loop", [
    ("dcnv2.closed", None), ("deepfm.closed", None), ("dcnv2.closed", "open")],
    ids=["dcnv2.closed", "deepfm.closed", "dcnv2.open"])
def test_the_port_agrees_with_the_reference(cell, loop):
    result, lines, _ = run(cell, loop=loop)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0
    assert lines["score_max_abs_err"]["value"] \
        <= lines["score_max_abs_err"]["limit"]
    assert "setup_s" in result["metrics"]
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("cell,host", [
    ("dcnv2.closed", ["aten_ops_per_step.closed"])])
def test_a_traced_run_reads_its_host_counts(cell, host):
    result, _, _ = run(cell, trace=1)
    assert result["correct"] is True
    assert all(result["metrics"][m]["value"] > 0 for m in host)
    # no device on the CPU: no device metric, no busy time
    kind = cell.split(".")[1]
    assert f"device_idle.{kind}" not in result["metrics"]
    assert "gather_roofline.closed" not in result["metrics"]


def _altered(orig):
    def predict(self, ids_):
        out = orig(self, ids_).copy()
        out[0] += 1e-3
        return out
    return predict


def _half(orig):
    def predict(self, ids_):
        ids_ = np.asarray(ids_)
        kept = orig(self, ids_[:(len(ids_) + 1) // 2])
        rest = np.full(len(ids_) - len(kept), kept.mean(), kept.dtype)
        return np.concatenate([kept, rest])
    return predict


@pytest.mark.parametrize("fault", [_altered, _half],
                         ids=["answer_altered", "half_the_batch_left_out"])
@pytest.mark.parametrize("model", sorted(CELLS))
def test_a_broken_served_path_is_not_correct(model, fault, monkeypatch):
    from repro_torch.core.plan import InferencePlan
    monkeypatch.setattr(InferencePlan, "predict",
                        fault(InferencePlan.predict))
    result, lines, _ = run(CELLS[model])
    assert result["correct"] is False
    assert lines["score_max_abs_err"]["value"] \
        > lines["score_max_abs_err"]["limit"]


@pytest.mark.parametrize("model", sorted(CELLS))
def test_the_control_fails_at_the_configuration_widths(model):
    """The reference in TF32 against the reference in fp32, at the
    configuration's widths (tables capped, a few hundred rows): the gap
    passes the limit. The port's CPU path stays within it."""
    cell = CELLS[model]
    cfg, _ = small(cell, widths=True)
    ref = module(cfg["model"])
    limit = manifest.limits(manifest.workload(
        manifest.load(), cell)["config"])["numbers"]["score_max_abs_err"]
    pool = ids.zipf_pool(cfg["field_sizes"], 384, 1.1, 5, "cpu")
    w = weights.draw(ref.layout(cfg), 5, "cpu")
    want = common.scores(ref.logits, w, pool, cfg, "fp32", block=128)
    low = common.scores(ref.logits, w, pool, cfg, "tf32", block=128)
    assert check.compare([low], [want]) > limit["limit"]

    from repro_torch.models.ctr import CTRModelSpec, make_ctr_model
    extra = {"cross_layers": cfg["cross_layers"]} \
        if "cross_layers" in cfg else {}
    spec = CTRModelSpec(name=cfg["name"], field_sizes=tuple(cfg["field_sizes"]),
                        embed_dim=cfg["embed_dim"], hidden=tuple(cfg["hidden"]),
                        **extra)
    model_ = make_ctr_model(cfg["model"], spec, device="cpu")
    weights.draw(ref.layout(cfg), 5, "cpu",
                 out=weights.flatten(model_.tensor_tree()))
    got = model_.compile("dual", 128, device="cpu")
    served = np.concatenate([got.predict(pool[i:i + 128])
                             for i in range(0, len(pool), 128)])
    assert check.compare([served], [want]) <= limit["limit"]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      1.0 + 2**-12, -(1.0 + 2**-10)], dtype=torch.float32)
    assert common.round_tf32(x).tolist() == [1.0 + 2**-10, 1.0,
                                             1.0 + 2**-9, 1.0,
                                             -(1.0 + 2**-10)]


def _run_py(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "dcnv2.closed", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=env)


def test_run_refuses_without_the_program(tmp_path):
    import shutil
    shutil.copytree(manifest.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    out = _run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _run_py(manifest.ROOT, env)
    assert out.returncode != 0 and out.stdout == ""

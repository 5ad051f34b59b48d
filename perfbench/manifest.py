"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file the
manifest gives, and a traffic mix, ``traffic/<name>.json``. A metric's
reader is ``metrics/<name>.py``; a kernel's name table is
``kernels/<name>.json`` and its count ``counts/<name>.py``; the limits of
a configuration's compared numbers are ``limits/<name>.json``. A
configuration may name the engine its model is served by (``engine``,
``engines/<name>.py``; ``dense`` when it names none), and a traffic file
a loop other than the generator's own ``closed`` and ``open``
(``loops/<name>.py``). A configuration's operations a row are
``counts/flops_<model>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "ROOT", "load", "workload", "config", "traffic",
           "limits", "kernel_table", "peaks", "metrics_for", "reader",
           "count", "engine", "loop"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def workload(man: dict, name: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   f"{[c['name'] for c in man['workloads']]}")


def config(man: dict, name: str, root: Path = ROOT) -> dict:
    for entry in man["configs"]:
        if entry["name"] == name:
            return _json(Path(root) / entry["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(config_name: str) -> dict:
    return _json(HERE / "limits" / f"{config_name}.json")


def kernel_table(name: str) -> dict:
    return _json(HERE / "kernels" / f"{name}.json")


def peaks() -> dict:
    return _json(HERE / "peaks.json")


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_of_cell


def metrics_for(man: dict, cell: str, trace: int) -> list[dict]:
    """The metrics a run of ``cell`` prints: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``."""
    e2e = [m for m in man["end_to_end"] if _reports(m, cell, set())]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"] if _reports(m, cell, names)]


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def count(name: str):
    """The module ``counts/<name>.py``."""
    return importlib.import_module(f"perfbench.counts.{name}")


def engine(name: str):
    """The module ``engines/<name>.py``: ``build(model, traffic, device)``
    gives an engine with a ``predict(ids)``, every shape compiled, and
    ``close(engine)``, where it has one, stops what it started."""
    return importlib.import_module(f"perfbench.engines.{name}")


def loop(name: str):
    """The module ``loops/<name>.py``: ``schedule(traffic, seed, seconds,
    pool_rows)`` and ``run(traffic, engine, pool, sched, seconds,
    on_open=)``, as ``loadgen``'s own loops."""
    return importlib.import_module(f"perfbench.loops.{name}")

"""Each split cell of the dry run's grid traced twice in one worker
process: the split step (``Cell.lower()``, one batch row run) and the
unplaced step (``Cell._lower("unplaced")``), with the host seconds and
ATen ops of each, so that the two are measured in the same run.

Run from the repo root on the CPU (the number of worker processes
defaults to every core; an arch limits the cells to its own):

    PYTHONPATH=src python build/trace_cost.py [workers [arch]] \
        > build/trace_cost.json
"""

import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor


def cost(arch, shape, mesh_name):
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell

    mesh = make_production_mesh(multi_pod=mesh_name == "multipod",
                                devices="meta")
    cell = build_cell(arch, shape, mesh)
    out = {"arch": arch, "shape": shape, "mesh": mesh_name}
    for how in ("split", "unplaced"):
        t0 = time.perf_counter()
        low, _ = cell.lower() if how == "split" else cell._lower("unplaced")
        out[how] = {"seconds": time.perf_counter() - t0,
                    "trace_s": low.seconds, "n_ops": low.n_ops,
                    "trace": low.trace, "rows_traced": low.rows_traced,
                    "rows": low.rows}
    return out


def main():
    from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
    from repro_torch.launch.dryrun import grid

    cells = [c[:3] for c in grid(ARCH_NAMES, SHAPES, ["pod", "multipod"])
             if c[3] == "run" and c[0] in sys.argv[2:3] + (
                 [] if len(sys.argv) > 2 else [c[0]]) and not (
                 get_config(c[0]).family in ("ssm", "hybrid")
                 and SHAPES[c[1]].kind != "decode")]
    workers = int(sys.argv[1]) if len(sys.argv) > 1 else os.cpu_count()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing
                             .get_context("spawn"),
                             max_tasks_per_child=1) as pool:
        res = list(pool.map(cost, *zip(*cells)))
    json.dump(res, sys.stdout, indent=1)
    print()


if __name__ == "__main__":
    main()

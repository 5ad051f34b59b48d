"""Each split cell of the dry run's grid traced twice in one worker
process: the split step (``Cell.lower()``, one batch row run) and the
unplaced step (``Cell._lower("unplaced")``), with the host seconds and
ATen ops of each, so that the two are measured in the same run.

Run from the repo root on the CPU (the number of worker processes
defaults to every core; an arch limits the cells to its own):

    PYTHONPATH=src python build/trace_cost.py [workers [arch]] \
        > build/trace_cost.json

``recurrent`` in place of an arch takes rwkv6-7b's and zamba2-1.2b's
``train_4k`` and ``prefill_32k`` on both meshes instead, at published
width with the sequence cut to each of two lengths (default 16 and 48),
whose full-length traces take hours. A cut cell runs one microbatch; a
trace's ops a microbatch are linear in the sequence length, so each
record adds both traces' ops extrapolated to the cell's own length and
times its own microbatch count (``n_micro``):

    PYTHONPATH=src python build/trace_cost.py 4 recurrent 16,48
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


def cost_cut(arch, shape, mesh_name, seq):
    """``cost`` with ``shape``'s sequence cut to ``seq``, and the full
    cell's microbatch count."""
    import repro_torch.configs as TC
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell

    full = TC.SHAPES[shape]
    n_micro = build_cell(arch, shape, make_production_mesh(
        multi_pod=mesh_name == "multipod", devices="meta")).n_micro
    TC.SHAPES[shape] = TC.ShapeCell(shape, seq, full.batch, full.kind)
    return {**cost(arch, shape, mesh_name), "seq": seq, "n_micro": n_micro}


def recurrent(workers: int, seqs: list[int]) -> list:
    """The recurrent train and prefill cells' split and unplaced ops at
    each cut length, extrapolated to the full one."""
    from repro_torch.configs import SHAPES

    cells = [(a, sh, m, s) for a in ("rwkv6-7b", "zamba2-1.2b")
             for sh in ("train_4k", "prefill_32k")
             for m in ("pod", "multipod") for s in seqs]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing
                             .get_context("spawn"),
                             max_tasks_per_child=1) as pool:
        res = list(pool.map(cost_cut, *zip(*cells)))
    out = []
    for lo, hi in zip(res[::2], res[1::2]):
        full = SHAPES[lo["shape"]].seq
        rec = {k: lo[k] for k in ("arch", "shape", "mesh", "n_micro")}
        rec["cuts"] = [lo, hi]
        for how in ("split", "unplaced"):
            per = (hi[how]["n_ops"] - lo[how]["n_ops"]) / (hi["seq"]
                                                           - lo["seq"])
            rec[f"{how}_ops_at_{full}"] = round(lo["n_micro"] * (
                lo[how]["n_ops"] + per * (full - lo["seq"])))
        out.append(rec)
    return out


def main():
    from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
    from repro_torch.launch.dryrun import grid

    if sys.argv[2:3] == ["recurrent"]:
        seqs = [int(x) for x in (sys.argv[3] if len(sys.argv) > 3
                                 else "16,48").split(",")]
        json.dump(recurrent(int(sys.argv[1]), seqs), sys.stdout, indent=1)
        print()
        return
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

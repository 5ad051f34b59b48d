"""Multi-pod dry run: trace every (arch × shape) cell's step on ``meta``
tensors over the production mesh(es) and emit memory / cost / roofline
records.

Counterpart of ``repro.launch.dryrun``. Nothing is compiled and nothing
needs a card: each cell's ``Cell.lower()`` runs its step once on a
``meta`` twin of the (16, 16) or (2, 16, 16) mesh, and the records take
their FLOPs, bytes between positions and live bytes from that trace
(``repro_torch.analysis.roofline``). A record has ``lower_s`` (the
trace's wall seconds) and ``n_ops`` (the ATen ops it dispatched) where
the reference's has ``compile_s``, ``trace`` (``"split"``: the step on
weights split by the cell's specs, as the reference lowers the
partitioned step, on every production mesh; ``"unplaced"``, on whole
weights, only for a mesh of one position) and ``rows_traced`` of the
mesh's ``rows`` (batch rows run; the others are counted by symmetry).
A trace costs ~150-250 µs of host time an op: 6-750 s a cell, and about
an hour or more for rwkv6's and zamba2's train and prefill cells, whose
scans step through every token. So the cells run side by side in
spawned worker processes, one cell a process, as many processes as
cells or CPU cores, whichever is fewer; the records keep the grid's
order.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out build/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

from repro_torch.analysis.roofline import analyze_cell
from repro_torch.configs import (ARCH_NAMES, SHAPES, applicable_shapes,
                                 get_config)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell

__all__ = ["run_cell", "grid", "main"]


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: str | None,
             roofline: bool = True) -> dict:
    multi_pod = mesh_name == "multipod"
    mesh = make_production_mesh(multi_pod=multi_pod, devices="meta")
    chips = mesh.size
    t0 = time.time()
    cell = build_cell(arch, shape, mesh)
    lowered, kind = cell.lower()
    t_lower = time.time() - t0
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
        "kind": kind, "status": "ok",
        "lower_s": round(t_lower, 1), "n_ops": lowered.n_ops,
        "trace": lowered.trace, "rows_traced": lowered.rows_traced,
        "rows": lowered.rows, "n_micro": cell.n_micro,
        "memory": {
            "arg_GiB": round(lowered.arg_bytes / 2**30, 3),
            "out_GiB": round(lowered.out_bytes / 2**30, 3),
            "temp_GiB": round(lowered.peak_live_bytes / chips / 2**30, 3),
        },
    }
    print({"flops": lowered.flops, "n_ops": lowered.n_ops,
           "moved_bytes": lowered.moved_bytes,
           "peak_live_bytes": lowered.peak_live_bytes}, flush=True)
    if roofline:
        rep = analyze_cell(arch, shape, mesh_name, chips, lowered,
                           n_micro=cell.n_micro)
        rec["roofline"] = dataclasses.asdict(rep)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        safe = arch.replace(".", "_")
        with open(os.path.join(out_dir,
                               f"{safe}__{shape}__{mesh_name}.json"),
                  "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def grid(archs, shapes, meshes) -> list[tuple[str, str, str, str]]:
    """(arch, shape, mesh, "run" or the skip reason) in the records'
    order: arch, then shape, then mesh."""
    out = []
    for arch in archs:
        app = applicable_shapes(arch)
        for shape in shapes:
            for mesh_name in meshes:
                out.append((arch, shape, mesh_name, app[shape]))
    return out


def _cell_or_fail(arch: str, shape: str, mesh_name: str, out_dir,
                  roofline: bool) -> dict:
    """One cell's record in a worker: ``run_cell``'s, or a FAIL record
    with the traceback printed."""
    try:
        return run_cell(arch, shape, mesh_name, out_dir, roofline=roofline)
    except Exception as e:   # noqa: BLE001 — record and continue
        traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "FAIL", "error": repr(e)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, choices=list(ARCH_NAMES),
                    help="one architecture (default: with --all, every one)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch × shape) cell")
    ap.add_argument("--out", default=None, help="JSON output directory")
    ap.add_argument("--no-roofline", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    meshes = (["pod", "multipod"] if args.mesh == "both" else [args.mesh])
    if not args.all and args.arch is None:
        ap.error("pass --arch or --all")
    shapes = [args.shape] if args.shape else list(SHAPES)

    cells = grid(archs, shapes, meshes)
    runs = [c[:3] for c in cells if c[3] == "run"]
    futures = {}
    pool = None
    if runs:
        pool = ProcessPoolExecutor(
            max_workers=min(len(runs), os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1)
    try:
        # the recurrent train and prefill cells scan token by token and
        # take most of the grid's time: they start first
        for arch, shape, mesh_name in sorted(runs, key=lambda c: not (
                get_config(c[0]).family in ("ssm", "hybrid")
                and SHAPES[c[1]].kind != "decode")):
            print(f"[dryrun] CELL  {arch:28s} {shape:12s} {mesh_name}",
                  flush=True)
            futures[arch, shape, mesh_name] = pool.submit(
                _cell_or_fail, arch, shape, mesh_name, args.out,
                not args.no_roofline)
        results = []
        for arch, shape, mesh_name, reason in cells:
            if reason != "run":
                print(f"[dryrun] SKIP  {arch:28s} {shape:12s} "
                      f"{mesh_name}: {reason[:60]}", flush=True)
                results.append({"arch": arch, "shape": shape,
                                "mesh": mesh_name, "status": "skip",
                                "reason": reason})
                continue
            rec = futures[arch, shape, mesh_name].result()
            if rec["status"] == "ok":
                rl = rec.get("roofline", {})
                kinds = rl.get("collective_breakdown") or {"-": 0}
                top = max(kinds, key=kinds.get)
                print(f"[dryrun]   ok: {arch} {shape} {mesh_name} "
                      f"{rec['trace']} rows={rec['rows_traced']}/"
                      f"{rec['rows']} lower={rec['lower_s']}s "
                      f"ops={rec['n_ops']} "
                      f"temp={rec['memory']['temp_GiB']}GiB "
                      f"dominant={rl.get('dominant', '?')} "
                      f"collective={rl.get('collective_s', 0):.6g}s "
                      f"top={top}", flush=True)
            else:
                print(f"[dryrun]   FAIL: {arch} {shape} {mesh_name} "
                      f"{rec['error']}", flush=True)
            results.append(rec)
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"[dryrun] total={len(results)} ok={n_ok} skip={n_skip} "
          f"fail={n_fail}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(results, f, indent=1, default=str)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

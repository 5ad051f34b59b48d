"""One run of one cell: set-up, the measured window, the traced reduction
and the check. ``run.py`` drives it for one seed; ``control.py`` and
``knee.py`` reuse its pieces.

Set-up (``setup_s``) runs from the process's start to the window's
opening: the id pool drawn on the device, the port's model built and
filled with weights drawn from the seed, the engine that the
configuration names (``engines/<name>.py``; ``dense`` by default: the
model's ``DenseStore`` with the traffic's bucket ladder, every bucket
compiled by ``engine.warmup()``), every bucket run, and a second of the
cell's own sizes. The window then drives the engine as the traffic
file's loop says.
Once it has closed, the device's peak memory is read, the metrics of the
run are read, the program's state is freed, and the plain reference
scores a sample of the answered requests again (``check.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from perfbench import check, devtrace, ids, loadgen, manifest, weights
from perfbench.reference import module as reference_module

__all__ = ["Run", "Bench", "main", "forbidden_modules"]

#: top-level modules that may not be loaded in a run's process: JAX and the
#: JAX package the port was made from (compared whole, so ``repro_torch``
#: is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What one window produced, as the metric readers see it."""
    config: dict
    traffic: dict
    setup_s: float
    window: loadgen.Window
    trace: devtrace.Summary | None
    profile: tuple[float, float] | None      # host clock of the profiler
    pool: np.ndarray
    device: torch.device
    device_name: str
    ops_per_step: float | None = None        # ATen ops a step (traced run)
    _distinct: float | None = None

    def in_profile(self):
        """(request, share of its span inside the profiled part)."""
        if self.profile is None:
            return
        p0, p1 = self.profile
        for r in self.window.answered:
            lo, hi = max(r.sent, p0), min(r.done, p1)
            if hi > lo:
                yield r, (hi - lo) / max(r.done - r.sent, 1e-12)

    def rows_in_profile(self) -> float:
        return sum(r.rows * f for r, f in self.in_profile())

    def executed_in_profile(self) -> tuple[float, float]:
        """(steps, rows executed, padding included) of the requests in the
        profiled part, each request's weighted by its share there."""
        kind = manifest.engine(self.config.get("engine", "dense"))
        steps = rows = 0.0
        for r, f in self.in_profile():
            buckets = kind.steps(r.rows, self.traffic)
            steps += len(buckets) * f
            rows += sum(buckets) * f
        return steps, rows

    def distinct_rows_in_profile(self) -> float:
        """Distinct table rows of the requests in the profiled part, each
        request's weighted by its share there."""
        if self._distinct is None:
            total = 0.0
            for r, f in self.in_profile():
                rows = ids.global_rows(
                    self.pool[r.start_row:r.start_row + r.rows],
                    self.config["field_sizes"])
                if self.device.type == "cuda":
                    n = torch.unique(torch.from_numpy(rows).to(
                        self.device)).numel()
                else:
                    n = np.unique(rows).size
                total += n * f
            self._distinct = total
        return self._distinct

    def kernel_seconds(self, kernel: str) -> float | None:
        if self.trace is None:
            return None
        match = manifest.kernel_table(kernel)["match"]
        return sum(s for name, s in self.trace.device_s_by_name.items()
                   if any(m in name for m in match))

    def peak(self, key: str) -> float | None:
        return manifest.peaks().get(self.device_name, {}).get(key)

    @staticmethod
    def count(name: str):
        return manifest.count(name)


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unreadable"


class Bench:
    """One cell of ``BENCHMARK.json`` on one device. ``config``,
    ``traffic`` and ``limits`` replace the cell's files (the CPU tests run
    a cell at a small size this way)."""

    def __init__(self, workload: str, *, root=manifest.ROOT,
                 device="cuda", config: dict | None = None,
                 traffic: dict | None = None, limits: dict | None = None):
        man = manifest.load(root)
        self.cell = manifest.workload(man, workload)
        self.config = config if config is not None else manifest.config(
            man, self.cell["config"], root)
        self.traffic = traffic if traffic is not None else \
            manifest.traffic(self.cell["traffic"])
        self.limits = limits if limits is not None else \
            manifest.limits(self.cell["config"])
        self.metrics = {t: manifest.metrics_for(man, workload, t)
                        for t in (0, 1)}
        self.device = torch.device(device)
        self.ref = reference_module(self.config["model"])
        self.model = self.engine = None

    # -- set-up ----------------------------------------------------------
    def traffic_for(self, seed: int, seconds: float):
        tr = self.traffic
        pool = ids.zipf_pool(self.config["field_sizes"], int(tr["pool_rows"]),
                             float(tr["ids"]["exponent"]), seed, self.device)
        return pool, loadgen.schedule(tr, seed, seconds, len(pool))

    def build(self, seed: int) -> None:
        """The port's model with the seed's weights, and its engine with
        every bucket compiled. The configuration states fp32 with TF32
        off, and the program is run so."""
        from repro_torch.models.ctr import CTRModelSpec, make_ctr_model
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = self.config
        fields = {f.name for f in dataclasses.fields(CTRModelSpec)}
        spec = CTRModelSpec(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in cfg.items() if k in fields})
        self.model = make_ctr_model(cfg["model"], spec, device=self.device)
        self.load_weights(seed)
        self.engine = manifest.engine(cfg.get("engine", "dense")).build(
            self.model, self.traffic, self.device)

    def load_weights(self, seed: int) -> None:
        """The seed's weights, drawn into the model's own buffers."""
        weights.draw(self.ref.layout(self.config), seed, self.device,
                     out=weights.flatten(self.model.tensor_tree()))

    def warm(self, pool: np.ndarray) -> None:
        """Every bucket on real ids, then the traffic's ``warm_s`` seconds
        of the cell's threads sending requests of its sizes."""
        for b in self.traffic["ladder"]:
            for _ in range(2):
                self.engine.predict(pool[:b])
        secs = float(self.traffic["warm_s"])
        warm = loadgen.schedule({**self.traffic, "loop": "closed",
                                 "schedule_len": 64, "stratum": 64}, 0, secs,
                                len(pool))
        loadgen.closed_loop(self.engine.predict, pool, warm,
                            int(self.traffic["threads"]), secs)

    def free(self) -> None:
        kind = manifest.engine(self.config.get("engine", "dense"))
        if self.engine is not None and hasattr(kind, "close"):
            kind.close(self.engine)
        self.engine = self.model = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- the window --------------------------------------------------------
    def window(self, pool, sched, seconds: float, trace: int):
        tracer = None
        if trace:
            tracer = devtrace.Tracer(torch, 0.3 * seconds,
                                     min(3.0, 0.4 * seconds))
        w = loadgen.run_window(self.traffic, self.engine, pool, sched,
                               seconds,
                               on_open=tracer.on_open if tracer else None)
        if tracer is None:
            return w, None, None
        tracer.join()
        summary = devtrace.summarize(tracer.events(), tracer.p1 - tracer.p0)
        return w, summary, (tracer.p0, tracer.p1)

    def count_ops(self, pool, sched) -> tuple[float | None, int]:
        """ATen ops a step, counted on this thread once the window has
        closed, over the first requests of the window's schedule (8 steps
        at least)."""
        kind = manifest.engine(self.config.get("engine", "dense"))
        blocks, steps = [], 0
        for r, s in zip(sched.rows, sched.starts):
            blocks.append(pool[int(s):int(s) + int(r)])
            steps += len(kind.steps(int(r), self.traffic))
            if steps >= 8:
                break

        def call():
            for block in blocks:
                self.engine.predict(block)
        return devtrace.ops_per_step(torch, call)

    # -- the check -----------------------------------------------------------
    def compare(self, seed: int, pool, w: loadgen.Window,
                control: bool = False) -> dict:
        """The compared numbers; with ``control``, also the TF32
        reference's widest gap on the same sample."""
        reqs = check.sample(w.answered, int(self.traffic["check_requests"]),
                            seed)
        want = check.reference_scores(self.ref, self.config, seed,
                                      self.device, pool, reqs)
        err = check.compare([r.scores for r in reqs], want) if reqs \
            else math.inf
        out = {"score_max_abs_err": err, "failed_requests": w.failed,
               "requests_checked": len(reqs),
               "rows_checked": int(sum(r.rows for r in reqs))}
        if control:
            low = check.reference_scores(self.ref, self.config, seed,
                                         self.device, pool, reqs, "tf32")
            out["control_score_max_abs_err"] = check.compare(low, want)
        return out

    # -- one run ---------------------------------------------------------------
    def run(self, seed: int, seconds: float, trace: int,
            t_start: float) -> tuple[dict, dict, list]:
        """(the result's line, the compared numbers with their limits,
        notes for standard error)."""
        cuda = self.device.type == "cuda"
        marks = [("imports", time.perf_counter())]
        pool, sched = self.traffic_for(seed, seconds)
        marks.append(("ids", time.perf_counter()))
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        self.build(seed)
        marks.append(("model, weights, engine, buckets", time.perf_counter()))
        self.warm(pool)
        marks.append(("warm traffic", time.perf_counter()))
        if trace:
            devtrace.warm(torch)
            marks.append(("profiler", time.perf_counter()))
        if cuda:
            torch.cuda.synchronize(self.device)
        w, summary, profile = self.window(pool, sched, seconds, trace)
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        name = torch.cuda.get_device_name(self.device) if cuda else "cpu"
        ops, counted = self.count_ops(pool, sched) if trace else (None, 0)
        run = Run(config=self.config, traffic=self.traffic,
                  setup_s=w.t0 - t_start, window=w, trace=summary,
                  profile=profile, pool=pool,
                  device=self.device, device_name=name, ops_per_step=ops)
        metrics = {}
        for m in self.metrics[trace]:
            v = _finite(manifest.reader(m["name"])(run))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device = {"platform": "gpu" if cuda else "cpu", "kind": name,
                  "count": 1, "memory_peak_bytes": int(peak)}
        result = {"correct": False, "attempted": w.attempted,
                  "failed": w.failed, "metrics": metrics, "device": device}
        if summary is not None:
            device["busy_s"] = summary.busy_s
            device["window_s"] = summary.window_s
            top = sorted(summary.device_s_by_name.items(),
                         key=lambda kv: -kv[1])[:10]
            result["breakdown"] = {
                "device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in summary.idle_gaps[:10]]}
        notes = self.notes(w, run, summary)
        if trace:
            notes.append(f"ATen ops a step: {ops} over {counted} steps")
        last = t_start
        parts = []
        for what, t in marks:
            parts.append(f"{what} {t - last:.3f}")
            last = t
        notes.append("set-up s: " + ", ".join(parts))
        self.free()
        numbers = self.compare(seed, pool, w)
        correct, lines = check.judge(numbers, self.limits["numbers"])
        result["correct"] = bool(correct)
        result["check"] = {k: {"value": _finite(v["value"]),
                               "limit": v["limit"]}
                           for k, v in lines.items()}
        notes.append(f"checked {numbers['requests_checked']} requests, "
                     f"{numbers['rows_checked']} rows")
        return result, lines, notes

    def notes(self, w: loadgen.Window, run: Run, summary) -> list:
        ans = w.answered
        rows = sum(r.rows for r in ans)
        notes = [f"cell {self.cell['name']}: {w.attempted} requests, "
                 f"{len(ans)} answered, {rows} rows, window "
                 f"{w.t1 - w.t0:.3f} s to close, {w.t_end - w.t0:.3f} s "
                 f"to the last answer, set-up {run.setup_s:.3f} s"]
        if w.lateness_s is not None and len(w.lateness_s):
            late = w.lateness_s * 1e3
            notes.append(f"generator lateness ms: p50 "
                         f"{np.percentile(late, 50):.4f} p99 "
                         f"{np.percentile(late, 99):.4f} max {late.max():.4f}")
        if summary is not None:
            steps, rows = run.executed_in_profile()
            notes.append(f"trace: {steps:.1f} steps, {rows:.0f} rows "
                         f"executed, busy {summary.busy_s:.6f} s of "
                         f"{summary.window_s:.6f} s")
        if self.device.type == "cuda":
            notes.append(f"card: {card()}")
        return notes


def main(argv=None, *, t_start: float, root=manifest.ROOT) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = manifest.workload(manifest.load(root), args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    bench = Bench(args.workload, root=root, device="cuda")
    result, lines, notes = bench.run(args.seed, args.seconds, args.trace,
                                     t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: {bad} were loaded in this process",
              file=sys.stderr)
        return 4
    for note in notes:
        print(note, file=sys.stderr)
    for name, v in lines.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

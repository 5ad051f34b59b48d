"""The readings that a cell's limits are set from, in one process.

    python3 perfbench/control.py --workload dcnv2.closed --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 3 --out build/control.json

For every seed: the program's weights and ids drawn anew, a short window
at the cell's own load, and the check's numbers (the lower readings). For
the control seeds also the control: the plain reference in TF32, put in
the program's place, on the same sample (the upper readings). The
benchmark's own runs do not run this. On a card only.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    import argparse

    import torch

    from perfbench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    bench = harness.Bench(args.workload, device="cuda")
    rows = []
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        pool, sched = bench.traffic_for(seed, args.seconds)
        if i == 0:
            bench.build(seed)
        else:
            bench.load_weights(seed)
        bench.warm(pool)
        w = bench.window(pool, sched, args.seconds, 0)[0]
        nums = bench.compare(seed, pool, w, control=seed in control)
        nums.update(seed=seed, attempted=w.attempted,
                    seconds=time.perf_counter() - t)
        rows.append(nums)
        print(json.dumps(nums), flush=True)
    prog = [r["score_max_abs_err"] for r in rows]
    ctrl = [r["control_score_max_abs_err"] for r in rows
            if "control_score_max_abs_err" in r]
    summary = {"workload": args.workload, "card": harness.card(),
               "lower": max(prog), "program": prog,
               "upper": min(ctrl) if ctrl else None, "control": ctrl,
               "failed": sum(r["failed_requests"] for r in rows)}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"summary": summary,
                                              "runs": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

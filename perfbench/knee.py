"""The sweep that finds an open mix's knee: the highest offered rate at
which the backlog does not grow over the window and the generator keeps
to its schedule. Run once, when a cell is defined; the rate the cell
offers (0.8 of the knee) is then written into its traffic file.

    python3 perfbench/knee.py --workload <open cell> --seed 5 --seconds 8 \
        --rates 150,200,250,300 --out build/knee.json

One process, one engine; for each rate a window of the cell's mix at
that rate. A row: the rate offered and completed, latency p50 / p95 /
p99 from due time, the median latency of the first and of the last fifth
of the requests (a backlog that grows makes the last fifth wait longer),
the requests due but unanswered at the close, and the generator's p99
lateness. On a card only.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    import argparse

    import numpy as np
    import torch

    from perfbench import harness, loadgen

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("knee: no CUDA card", file=sys.stderr)
        return 3
    bench = harness.Bench(args.workload, device="cuda")
    if bench.traffic["loop"] != "open":
        print("knee: the cell's traffic is not an open loop", file=sys.stderr)
        return 2
    pool, _ = bench.traffic_for(args.seed, args.seconds)
    bench.build(args.seed)
    bench.warm(pool)
    table = []
    for rate in (float(r) for r in args.rates.split(",")):
        tr = {**bench.traffic, "rate_per_s": rate}
        sched = loadgen.schedule(tr, args.seed, args.seconds, len(pool))
        w = loadgen.open_loop(bench.engine.predict, pool, sched,
                              int(tr["threads"]), args.seconds)
        ans = sorted(w.answered, key=lambda r: r.due)
        lat = np.asarray([(r.done - r.due) * 1e3 for r in ans])
        fifth = max(1, len(ans) // 5)
        row = {"rate": rate, "offered_per_s": w.attempted / args.seconds,
               "completed_per_s": len(ans) / (w.t_end - w.t0),
               "p50_ms": float(np.percentile(lat, 50)),
               "p95_ms": float(np.percentile(lat, 95)),
               "p99_ms": float(np.percentile(lat, 99)),
               "first_fifth_p50_ms": float(np.median(lat[:fifth])),
               "last_fifth_p50_ms": float(np.median(lat[-fifth:])),
               "unanswered_at_close": sum(1 for r in ans if r.done > w.t1),
               "late_p99_ms": float(np.percentile(w.lateness_s, 99) * 1e3),
               "failed": w.failed}
        table.append(row)
        print(json.dumps(row), flush=True)
    out = {"workload": args.workload, "card": harness.card(),
           "seconds": args.seconds, "table": table}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
